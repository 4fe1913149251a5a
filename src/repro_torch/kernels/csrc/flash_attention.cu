// Flash attention forward (prefill): causal / sliding-window GQA attention
// with an online softmax, queries aligned to the END of the keys
// (qpos = q_offset + i with q_offset = Lk - Lq).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
// (Pallas TPU kernel).
//
// Layout: q (B, KV, G, Lq, D), k/v (B, KV, Lk, D), out like q, each taken
// through its strides with a unit stride along D.  The model's
// (B, L, H, D) activations are passed as permuted views, so no layout copy
// is made (see kernels/ops.py).
//
// Bound on the H100: at the admission shape (B = 1, H = KV = 32, D = 64,
// Lq = Lk = 256, causal) the function moves ~4 MB and needs ~0.27 GFLOP, so
// the bytes bound it (a few microseconds at 3.35 TB/s) and the arithmetic is
// far below the tensor cores' rate.  This first kernel does its products on
// the CUDA cores in fp32 (no wgmma / mma.sync, no TMA): right first, fast
// later.  What it keeps out of device memory is the (Lq, Lk) score matrix:
// every score lives in registers only.
//
// Design: one block of 4 warps per (b, kv_head, g, 32-query tile).  The
// block stages its query tile in shared memory once, then walks the key axis
// in tiles of BK keys (64 for D <= 64) staged in shared memory as fp32 (K
// rows padded by one float so the lane-per-key column reads are free of bank
// conflicts).  Each warp owns 8 query rows; a lane owns BK/32 keys for the
// Q.K^T scores and D/32 output dimensions for P.V, with the probabilities
// passed between lanes by warp shuffles.  The running max m, sum l and the
// accumulator stay in fp32 registers.  Causal and window masks use the
// finite -1e30 of the reference; keys past Lk (the ragged last tile) get
// -inf so they never count, and tiles that every row of the block masks are
// skipped (exact: a skipped key would get probability 0, since every query
// row keeps its own diagonal key).  Rows past Lq are computed but not
// stored, so no block size has to divide Lq or Lk.
//
// LSE (training): given a non-null `lse` pointer, lane 0 of each warp also
// writes its rows' log-sum-exp m + log(max(l, 1e-20)) into a contiguous
// (B, KV, G, Lq) fp32 tensor, straight from the registers that hold the
// running max and sum.  The backward kernel (flash_attention_bwd.cu)
// recomputes the probabilities from it.  The serving call passes null and
// runs exactly as before.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kThreads = kWarps * 32;

template <int D>
struct Tile {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  static constexpr int BK = D >= 128 ? 32 : 64;  // keys per tile
  static constexpr int KPL = BK / 32;             // keys per lane
  static constexpr int DPL = D / 32;              // output dims per lane
  static constexpr int KS = D + 1;                // padded K row stride
  static constexpr int smem_bytes =
      static_cast<int>(sizeof(float)) * (kBQ * D + BK * KS + BK * D);
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, KV, G, Lq) contiguous, or null
  int64_t q_sb, q_sk, q_sg, q_sl;
  int64_t k_sb, k_sk, k_sl;
  int64_t v_sb, v_sk, v_sl;
  int64_t o_sb, o_sk, o_sg, o_sl;
  int B, KV, G, Lq, Lk;
  int causal;
  int window;  // < 0: no window
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  using TL = Tile<D>;
  constexpr int BK = TL::BK, KPL = TL::KPL, DPL = TL::DPL, KS = TL::KS;
  extern __shared__ float smem[];
  float* q_s = smem;               // [kBQ][D]
  float* k_s = q_s + kBQ * D;      // [BK][KS]
  float* v_s = k_s + BK * KS;      // [BK][D]

  const int q0 = blockIdx.x * kBQ;
  const int kvh = blockIdx.y / p.G, g = blockIdx.y % p.G;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * kRowsPerWarp;  // this warp's rows in the tile
  const int q_offset = p.Lk - p.Lq;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kvh * p.q_sk +
                g * p.q_sg;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sk;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sk;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + kvh * p.o_sk + g * p.o_sg;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    q_s[idx] = q0 + r < p.Lq
                   ? repro::to_float(qb[static_cast<int64_t>(q0 + r) * p.q_sl + d])
                   : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < DPL; ++u) acc[i][u] = 0.f;
  }

  // key range that at least one query row of this block attends
  const int q_end = min(q0 + kBQ, p.Lq);
  int k_hi = p.Lk;
  if (p.causal) k_hi = min(k_hi, q_offset + q_end);
  int k_lo = 0;
  if (p.window >= 0) k_lo = max(0, q_offset + q0 - p.window + 1);
  k_lo = (k_lo / BK) * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // previous tile consumed; q tile staged
    for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < p.Lk;
      const int64_t row = k0 + r;
      k_s[r * KS + d] = in ? repro::to_float(kb[row * p.k_sl + d]) : 0.f;
      v_s[r * D + d] = in ? repro::to_float(vb[row * p.v_sl + d]) : 0.f;
    }
    __syncthreads();

    // scores: lane owns keys t*32 + lane of the tile
    float s[kRowsPerWarp][KPL];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int t = 0; t < KPL; ++t) s[i][t] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[KPL];
#pragma unroll
      for (int t = 0; t < KPL; ++t) kv[t] = k_s[(t * 32 + lane) * KS + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = q_s[(row0 + i) * D + d];
#pragma unroll
        for (int t = 0; t < KPL; ++t) s[i][t] += qv * kv[t];
      }
    }

    // mask + online softmax update, one query row at a time
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qpos = q_offset + q0 + row0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int kpos = k0 + t * 32 + lane;
        float sv;
        if (kpos >= p.Lk) {
          sv = -INFINITY;  // ragged edge: not a key at all
        } else {
          const bool ok = (!p.causal || qpos >= kpos) &&
                          (p.window < 0 || qpos - kpos < p.window);
          sv = ok ? s[i][t] * p.scale : REPRO_NEG_INF;
        }
        s[i][t] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = repro::warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        s[i][t] = expf(s[i][t] - m_new);
        ps += s[i][t];
      }
      l[i] = l[i] * alpha + ps;  // per-lane partial; summed at the end
#pragma unroll
      for (int u = 0; u < DPL; ++u) acc[i][u] *= alpha;
      m[i] = m_new;
    }

    // P.V: lane owns output dims u*32 + lane
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const int j = t * 32 + jj;
        float vv[DPL];
#pragma unroll
        for (int u = 0; u < DPL; ++u) vv[u] = v_s[j * D + u * 32 + lane];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float pj = __shfl_sync(0xffffffffu, s[i][t], jj);
#pragma unroll
          for (int u = 0; u < DPL; ++u) acc[i][u] += pj * vv[u];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = q0 + row0 + i;
    const float lsum = fmaxf(repro::warp_sum(l[i]), 1e-20f);
    if (r < p.Lq) {
#pragma unroll
      for (int u = 0; u < DPL; ++u)
        ob[static_cast<int64_t>(r) * p.o_sl + u * 32 + lane] =
            repro::from_float<T>(acc[i][u] / lsum);
      if (p.lse != nullptr && lane == 0)
        p.lse[(static_cast<int64_t>(b * p.KV + kvh) * p.G + g) * p.Lq + r] =
            m[i] + logf(lsum);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  using TL = Tile<D>;
  static bool configured = false;  // dynamic shared memory may exceed 48 KB
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TL::smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((p.Lq + kBQ - 1) / kBQ, p.KV * p.G, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, TL::smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides (elements): q (b, kv, g, l), k (b, kv, l), v (b, kv, l),
// o (b, kv, g, l) — 14 values; the D axis has unit stride everywhere.
// window < 0 means no sliding window; lse may be null.  Returns a
// cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   const int64_t* strides, int B, int KV,
                                   int G, int Lq, int Lk, int D, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.q_sb = strides[0];
  p.q_sk = strides[1];
  p.q_sg = strides[2];
  p.q_sl = strides[3];
  p.k_sb = strides[4];
  p.k_sk = strides[5];
  p.k_sl = strides[6];
  p.v_sb = strides[7];
  p.v_sk = strides[8];
  p.v_sl = strides[9];
  p.o_sb = strides[10];
  p.o_sk = strides[11];
  p.o_sg = strides[12];
  p.o_sl = strides[13];
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return dispatch_d<float>(p, D, s);
  if (dtype == repro::kBF16) return dispatch_d<__nv_bfloat16>(p, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
