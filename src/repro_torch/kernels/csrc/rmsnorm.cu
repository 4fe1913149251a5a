// RMSNorm forward: out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w,
// computed in fp32, stored in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm_fwd (Pallas TPU kernel).
//
// Bound on the H100: bytes (one read of x and w, one write of out, ~4
// operations per element), but what holds it back depends on R.  At the
// decode shape (R = 16 slots, D = 2048, ~135 KB) the bytes take 0.04 us:
// the kernel is pure latency, so what counts is how many dependent
// round trips to device memory a row costs.  At R >= 512 (prefill buckets,
// the SFT step's 4,096 rows, the reward step's 8,192) it is bandwidth
// work: the card has to keep enough 16-byte loads in flight.
//
// Design (rmsnorm_rows_kernel): a row is held in registers.  `tpr` threads
// (a power of two, 1..256) share a row, each with up to NV <= 8 vectors of
// VEC elements (16 bytes where the pointers, the row strides and D allow
// it, else 8, 4 or 2 bytes: never refused).  Each thread issues the loads
// of its slice of w and of x together, so a row costs one dependent
// memory latency; the sum of squares is reduced by warp shuffles, with
// one shared-memory exchange when a row spans several warps; the output
// is written from the registers, so x is read from device memory once.
// Vectors are raw 32-bit words, their elements converted by bit
// operations, and the kernel is instantiated for NV = 1, 2, 4, 8, so a
// thread keeps only the registers its vectors need (at one vector a
// thread, eight 256-thread blocks fit an SM).
// The host (kernels/rmsnorm.py::plan) picks VEC, `tpr` and the rows of a
// block: at small R a row is spread over up to 256 threads, each issuing
// one or two loads; at large R each thread keeps up to 8 vectors in
// flight and a block holds several rows (a warp per row at R = 4,096,
// D = 2048 bf16), so the grid fills the 132 SMs.
//
// A row that does not fit the register tile (rmsnorm_staged_kernel: more
// than 256 x 8 vectors, e.g. D = 12,288 in fp32) is one block's: its first
// pass loads x and w into shared memory while it sums the squares, the
// second writes from there, so x is still read once.  Past the shared
// memory (rmsnorm.py MAX_STAGED_BYTES: D past 28,160 in fp32) the second
// pass reads x and w again, from the L2.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // threads of a block
constexpr int kMaxVecs = 8;       // vectors a thread holds (rows kernel)
constexpr int kUnroll = 4;        // loads in flight a thread (staged)

// VEC consecutive elements of T as raw 32-bit words (a 2-byte vector in
// the low half of one word), loaded and stored as accesses of up to 16
// bytes; elements are read and written as fp32 by bit operations, so the
// whole vector stays in registers
template <typename T, int VEC>
struct Vec {
  static constexpr int kBytes = static_cast<int>(sizeof(T)) * VEC;
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t u[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        u[4 * i] = v.x;
        u[4 * i + 1] = v.y;
        u[4 * i + 2] = v.z;
        u[4 * i + 3] = v.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      u[0] = v.x;
      u[1] = v.y;
    } else if constexpr (kBytes == 4) {
      u[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      u[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }

  __device__ __forceinline__ void store(T* p) const {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        reinterpret_cast<uint4*>(p)[i] =
            make_uint4(u[4 * i], u[4 * i + 1], u[4 * i + 2], u[4 * i + 3]);
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<uint32_t*>(p) = u[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) =
          static_cast<unsigned short>(u[0]);
    }
  }

  __device__ __forceinline__ float get(int k) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(u[k]);
    } else {  // bf16: the upper 16 bits of an fp32
      const uint32_t w = u[k >> 1];
      return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }

  // element k, rounded to T (nearest even, as torch does)
  __device__ __forceinline__ void set(int k, float v) {
    if constexpr (sizeof(T) == 4) {
      u[k] = __float_as_uint(v);
    } else {
      const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      u[k >> 1] = (k & 1) ? ((u[k >> 1] & 0xffffu) | (h << 16))
                          : ((u[k >> 1] & 0xffff0000u) | h);
    }
  }
};

// the row's sum of squares over its `tpr` threads (tpr a power of two;
// `partial` holds one float per warp of the block)
__device__ __forceinline__ float row_sum(float ss, int tpr, float* partial) {
  const int width = tpr < 32 ? tpr : 32;
  for (int o = width / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr <= 32) return ss;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  const int w0 = (threadIdx.x / tpr) * (tpr / 32);
  float t = 0.f;
  for (int i = 0; i < tpr / 32; ++i) t += partial[w0 + i];
  return t;
}

// out[0:VEC] = x * rstd * w
template <typename T, typename W, int VEC>
__device__ __forceinline__ void write_vec(T* dst, const Vec<T, VEC>& xv,
                                          const Vec<W, VEC>& wv,
                                          float rstd) {
  Vec<T, VEC> o;
#pragma unroll
  for (int i = 0; i < Vec<T, VEC>::kWords; ++i) o.u[i] = 0u;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.set(k, xv.get(k) * rstd * wv.get(k));
  o.store(dst);
}

template <typename T, typename W, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const W* __restrict__ w,
            T* __restrict__ out, int R, int D, int64_t x_row_stride,
            int64_t out_row_stride, float eps, int tpr) {
  __shared__ float partial[kMaxThreads / 32];
  using XV = Vec<T, VEC>;
  using WV = Vec<W, VEC>;
  const int t = threadIdx.x % tpr;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / tpr) +
      threadIdx.x / tpr;
  const bool live = row < R;
  const int nvec = D / VEC;
  const T* xr = x + (live ? row : 0) * x_row_stride;
  XV xv[NV];
  WV wv[NV];
  // w and x in one round trip: every load is issued before any is used
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int c = u * tpr + t;
    if (c < nvec) {
      wv[u].load(w + c * VEC);
      if (live) xv[u].load(xr + c * VEC);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    if (live && u * tpr + t < nvec) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = xv[u].get(k);
        ss = fmaf(v, v, ss);
      }
    }
  }
  ss = row_sum(ss, tpr, partial);
  if (!live) return;
  const float rstd = rsqrtf(ss / static_cast<float>(D) + eps);
  T* orow = out + row * out_row_stride;
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int c = u * tpr + t;
    if (c < nvec) write_vec<T, W, VEC>(orow + c * VEC, xv[u], wv[u], rstd);
  }
}

template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_staged_kernel(const T* __restrict__ x, const W* __restrict__ w,
              T* __restrict__ out, int D, int64_t x_row_stride,
              int64_t out_row_stride, float eps, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float partial[kMaxThreads / 32];
  using XV = Vec<T, VEC>;
  using WV = Vec<W, VEC>;
  const int64_t row = blockIdx.x;
  const int nvec = D / VEC;
  const T* xr = x + row * x_row_stride;
  T* xs = reinterpret_cast<T*>(smem_raw);                      // (D,)
  W* ws = reinterpret_cast<W*>(smem_raw +                      // (D,)
                               ((sizeof(T) * D + 15) & ~size_t{15}));
  float ss = 0.f;
  for (int c0 = threadIdx.x; c0 < nvec; c0 += kUnroll * kMaxThreads) {
    XV xv[kUnroll];
    WV wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kMaxThreads;
      if (c < nvec) {
        xv[u].load(xr + c * VEC);
        if (staged) wv[u].load(w + c * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kMaxThreads;
      if (c < nvec) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = xv[u].get(k);
          ss = fmaf(v, v, ss);
        }
        if (staged) {
          xv[u].store(xs + c * VEC);
          wv[u].store(ws + c * VEC);
        }
      }
    }
  }
  ss = row_sum(ss, kMaxThreads, partial);
  const float rstd = rsqrtf(ss / static_cast<float>(D) + eps);
  T* orow = out + row * out_row_stride;
  for (int c = threadIdx.x; c < nvec; c += kMaxThreads) {
    XV xv;
    WV wv;
    xv.load((staged ? xs : xr) + c * VEC);
    wv.load((staged ? ws : w) + c * VEC);
    write_vec<T, W, VEC>(orow + c * VEC, xv, wv, rstd);
  }
}

template <typename T, typename W, int VEC>
int launch(const void* x, const void* w, void* out, int R, int D,
           int64_t x_row_stride, int64_t out_row_stride, float eps, int tpr,
           int rows_per_block, int staged_bytes, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  if (tpr > 0) {
    const int64_t blocks = (static_cast<int64_t>(R) + rows_per_block - 1) /
                           rows_per_block;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    // registers for the vectors a thread holds, rounded up to 1, 2, 4, 8
    const int nv = (D / VEC + tpr - 1) / tpr;
    auto kernel = nv <= 1   ? rmsnorm_rows_kernel<T, W, VEC, 1>
                  : nv <= 2 ? rmsnorm_rows_kernel<T, W, VEC, 2>
                  : nv <= 4 ? rmsnorm_rows_kernel<T, W, VEC, 4>
                            : rmsnorm_rows_kernel<T, W, VEC, kMaxVecs>;
    kernel<<<static_cast<unsigned>(blocks), tpr * rows_per_block, 0,
             stream>>>(xp, wp, op, R, D, x_row_stride, out_row_stride, eps,
                       tpr);
  } else {
    auto kernel = rmsnorm_staged_kernel<T, W, VEC>;
    if (staged_bytes > 0) {  // past 48 KB with the static partials
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, staged_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<R, kMaxThreads, staged_bytes, stream>>>(
        xp, wp, op, D, x_row_stride, out_row_stride, eps, staged_bytes > 0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch_vec(const void* x, const void* w, void* out, int R, int D,
               int64_t x_row_stride, int64_t out_row_stride, float eps,
               int vec, int tpr, int rows_per_block, int staged_bytes,
               cudaStream_t s) {
#define REPRO_RMS_VEC(V)                                                  \
  if (vec == V)                                                           \
    return launch<T, W, V>(x, w, out, R, D, x_row_stride, out_row_stride, \
                           eps, tpr, rows_per_block, staged_bytes, s);
  REPRO_RMS_VEC(1)
  REPRO_RMS_VEC(2)
  REPRO_RMS_VEC(4)
  if constexpr (sizeof(T) == 2) {
    REPRO_RMS_VEC(8)
  }
#undef REPRO_RMS_VEC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, out: (R, D) with unit stride along D; w: (D,).  x_dtype/w_dtype are
// repro::DtypeCode values.  The geometry comes from the host's plan
// (kernels/rmsnorm.py::plan): `vec` elements a load (16 bytes at most; it
// divides D, the row strides and every pointer's alignment), and either
// `tpr` threads a row with `rows_per_block` rows a block
// (rmsnorm_rows_kernel), or tpr = 0: one row a block through shared memory,
// `staged_bytes` of it (0: the second pass reads x and w again;
// rmsnorm_staged_kernel).  Returns a
// cudaError_t code (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int R,
                           int D, int64_t x_row_stride,
                           int64_t out_row_stride, float eps, int x_dtype,
                           int w_dtype, int vec, int tpr, int rows_per_block,
                           int staged_bytes, void* stream) {
  const bool pow2 = tpr > 0 && (tpr & (tpr - 1)) == 0;
  if (R < 0 || D < 1 || vec < 1 || D % vec ||
      (tpr > 0 && (!pow2 || rows_per_block < 1 ||
                   tpr * rows_per_block > kMaxThreads ||
                   (tpr * rows_per_block) % 32 ||
                   D / vec > tpr * kMaxVecs)) ||
      (tpr == 0 && staged_bytes < 0) || tpr < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define REPRO_RMS_ARGS                                                   \
  x, w, out, R, D, x_row_stride, out_row_stride, eps, vec, tpr,         \
      rows_per_block, staged_bytes, s
  if (x_dtype == repro::kF32 && w_dtype == repro::kF32)
    return launch_vec<float, float>(REPRO_RMS_ARGS);
  if (x_dtype == repro::kBF16 && w_dtype == repro::kBF16)
    return launch_vec<bf16, bf16>(REPRO_RMS_ARGS);
  if (x_dtype == repro::kBF16 && w_dtype == repro::kF32)
    return launch_vec<bf16, float>(REPRO_RMS_ARGS);
  if (x_dtype == repro::kF32 && w_dtype == repro::kBF16)
    return launch_vec<float, bf16>(REPRO_RMS_ARGS);
#undef REPRO_RMS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
