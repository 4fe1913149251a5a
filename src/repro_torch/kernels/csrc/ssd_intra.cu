// Mamba2 SSD intra-chunk pass.  For each (batch, chunk, head), over the
// chunk's q rows (ngroups = 1: B and C are shared by every head):
//
//   A_cs[i] = sum_{j <= i} dt[j] * A                                  (q,)
//   Y[i, :] = sum_{j <= i} (C[i] . B[j]) exp(A_cs[i] - A_cs[j]) dt[j] x[j, :]
//   S_c     = sum_j exp(A_cs[q-1] - A_cs[j]) dt[j] x[j, :]^T B[j, :]  (p, n)
//
// in fp32 math from X, B, C in fp32 or bf16 (dt and A fp32); Y is stored in
// X's dtype, S_c and A_cs in fp32.  The inter-chunk recurrence and the
// off-diagonal term stay outside, as in the reference
// (repro_torch/kernels/ops.py::ssd_scan).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_intra_fwd (Pallas TPU kernel).
//
// Bound on the H100: operations.  At one 256-token Mamba2-370M admission
// (h = 32, p = 64, n = 128) the function needs ~277 MFLOP (the causal pairs'
// C.B scores once per chunk, then Y and S_c per head) against ~3.3 MB moved,
// ~83 FLOP per byte: above the fp32 balance point of the card (67 TFLOP/s
// over 3.35 TB/s = 20), so the fp32 rate bounds it (~4 us).
//
// Design: SIMT, fp32 throughout.  The Pallas grid is one cell per (batch,
// chunk, head) that builds the whole (q, q) decay matrix; here the grid is
// (row tiles, head, batch * chunk), so that one admission fills the card
// (h * (q/32 + p/32) blocks: 320 for Mamba2 at q = 256):
//
// - every block recomputes A_cs (a scan over the q rows, accumulated in
//   fp64 and rounded once, cheaper than a second launch); the first writes
//   it out;
// - a "query" block owns 32 rows of Y and walks 64-row key tiles up to the
//   diagonal only (the upper triangle is never visited).  Per key tile it
//   stages B and x * dt as fp32 in shared memory, forms the 32 x 64 scores
//   (4 x 2 per thread, float4 dot products over n), and *selects* the
//   decayed score where i >= j: above the diagonal A_cs[i] - A_cs[j] > 0
//   and exp of it may overflow, so a 0/1 mask multiply would give
//   inf * 0 = NaN.  The decayed scores go to shared memory transposed, so
//   a thread's 4 rows are one float4, and Y accumulates in registers (4
//   rows x p/32 columns per thread);
// - a "state" block owns 32 rows of S_c's p and all n columns and walks
//   every key row once: S_c += (x * dt * decay)^T B, 4 x n/32 per thread;
// - both prefetch the next key tile's inputs into registers while they
//   compute on the current one, so the loads' latency overlaps the math.
//
// p is 32 or 64 and n is 32, 64 or 128 (template parameters: the register
// tiles and shared-memory strides are fixed at compile time; the reduced
// configs use 32 and 32, Zamba2-1.2B 64 and 64, Mamba2-370M 64 and 128).  Ragged q (any q >= 1;
// exact-length admission gives q = prompt length up to the chunk) is masked
// at every tile edge: staged rows past q are zero and are never written.
// Inputs are read through their element strides, so X, B and C may be
// strided slices of the conv output.  The C . B scores are the same for
// every head and are recomputed per head, as the Pallas kernel does;
// sharing them across heads and tensor cores (3xTF32 or bf16 operands) are
// later speed work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 32;         // query rows of a query block; p rows of a state block
constexpr int kK = 64;         // key rows per tile
constexpr int kWld = kQ + 4;   // row stride of the transposed decayed scores

struct Strides {               // element strides of the inputs
  int64_t x[5];                // X  (b, nc, q, h, p)
  int64_t dt[4];               // dt (b, nc, q, h)
  int64_t b[4];                // B  (b, nc, q, n)
  int64_t c[4];                // C  (b, nc, q, n)
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Inclusive prefix sum of dt[j] * A over the q rows, into acs: each thread
// sums a contiguous run of rows, then the runs' totals are scanned across
// the warp (shuffles) and the block (one total per warp).  The sums are
// accumulated in fp64 and rounded once to fp32, so they are the correctly
// rounded cumsum of the fp32 products whatever the order: the plain version
// rounds a fp64 cumsum too, and the two agree bit for bit.  (The decays are
// exp of differences of these sums, which reach ~100 in a chunk; a fp32 scan
// in another order moves them by an ulp, 1e-5 of the decay, and a model 48
// layers deep turns that into ~2e-4 of its logits.)
__device__ void chunk_cumsum(float* acs, const float* dts, float A, int q) {
  __shared__ double warp_total[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (q + kThreads - 1) / kThreads;
  const int j0 = min(tid * per, q), j1 = min(j0 + per, q);
  double run = 0.0;
  for (int j = j0; j < j1; ++j) run += static_cast<double>(dts[j] * A);
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl += warp_total[w];
  for (int j = j0; j < j1; ++j) {
    excl += static_cast<double>(dts[j] * A);
    acs[j] = static_cast<float>(excl);
  }
  __syncthreads();
}

// `V` consecutive floats of shared memory (V = 1, 2 or 4; 4V-byte aligned).
template <int V>
__device__ __forceinline__ void lds(float (&out)[V], const float* src) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = *src;
  }
}

// ---------------- Y rows [i0, i0 + rows) of one head ----------------
template <typename T, int P, int N>
__device__ void y_block(const T* __restrict__ xb, const T* __restrict__ Bb,
                        const T* __restrict__ Cb, const Strides& st,
                        const float* acs, const float* dts, float* work,
                        T* __restrict__ y, int64_t bc, int head, int q, int h,
                        int i0) {
  constexpr int LD = N + 4;                  // float4 rows, no bank conflicts
  constexpr int CPL = P / 32;                // Y columns per lane
  constexpr int BPT = kK * N / kThreads;     // staged B values per thread
  constexpr int XPT = kK * P / kThreads;     // staged x * dt per thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(kQ, q - i0);
  float* Cs = work;                          // (kQ, LD)
  float* Bs = Cs + kQ * LD;                  // (kK, LD)
  float* Xs = Bs + kK * LD;                  // (kK, P): x * dt
  float* Wt = Xs + kK * P;                   // (kK, kWld): decayed scores^T
  for (int e = tid; e < kQ * N; e += kThreads) {
    const int r = e / N, k = e % N;
    Cs[r * LD + k] = r < rows
        ? repro::to_float(Cb[(i0 + r) * st.c[2] + k * st.c[3]]) : 0.f;
  }
  float breg[BPT], xreg[XPT];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int u = 0; u < BPT; ++u) {
      const int e = tid + u * kThreads, r = e / N, k = e % N, j = j0 + r;
      breg[u] = j < q ? repro::to_float(Bb[j * st.b[2] + k * st.b[3]]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const int e = tid + u * kThreads, r = e / P, k = e % P, j = j0 + r;
      xreg[u] = j < q
          ? repro::to_float(xb[j * st.x[2] + k * st.x[4]]) * dts[j] : 0.f;
    }
  };
  float acc[4][CPL];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;

  const int i_end = i0 + rows;               // keys [0, i_end) matter
  const int n_ktiles = (i_end + kK - 1) / kK;
  fetch(0);
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int j0 = kt * kK;
    __syncthreads();                         // the last tile is consumed
#pragma unroll
    for (int u = 0; u < BPT; ++u) {
      const int e = tid + u * kThreads;
      Bs[(e / N) * LD + e % N] = breg[u];
    }
#pragma unroll
    for (int u = 0; u < XPT; ++u) Xs[tid + u * kThreads] = xreg[u];
    __syncthreads();
    if (kt + 1 < n_ktiles) fetch(j0 + kK);   // in flight during the math

    // scores of query rows 4 warp + r against key rows lane, lane + 32
    float sc[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) sc[r][0] = sc[r][1] = 0.f;
    const float4* b0 = reinterpret_cast<const float4*>(Bs + lane * LD);
    const float4* b1 = reinterpret_cast<const float4*>(Bs + (lane + 32) * LD);
#pragma unroll 4
    for (int k4 = 0; k4 < N / 4; ++k4) {
      const float4 u0 = b0[k4], u1 = b1[k4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 cv =
            reinterpret_cast<const float4*>(Cs + (4 * warp + r) * LD)[k4];
        sc[r][0] = fmaf(cv.x, u0.x, sc[r][0]);
        sc[r][0] = fmaf(cv.y, u0.y, sc[r][0]);
        sc[r][0] = fmaf(cv.z, u0.z, sc[r][0]);
        sc[r][0] = fmaf(cv.w, u0.w, sc[r][0]);
        sc[r][1] = fmaf(cv.x, u1.x, sc[r][1]);
        sc[r][1] = fmaf(cv.y, u1.y, sc[r][1]);
        sc[r][1] = fmaf(cv.z, u1.z, sc[r][1]);
        sc[r][1] = fmaf(cv.w, u1.w, sc[r][1]);
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int jj = lane + 32 * c, j = j0 + jj;
      float w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ii = 4 * warp + r, i = i0 + ii;
        w[r] = 0.f;                          // select, never multiply
        if (ii < rows && j < q && i >= j) w[r] = sc[r][c] * expf(acs[i] - acs[j]);
      }
      *reinterpret_cast<float4*>(Wt + jj * kWld + 4 * warp) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
    const int jn = min(kK, i_end - j0);      // later keys have zero weight
    for (int jj = 0; jj < jn; ++jj) {
      const float4 w = *reinterpret_cast<const float4*>(Wt + jj * kWld +
                                                        4 * warp);
      float xv[CPL];
      lds<CPL>(xv, Xs + jj * P + lane * CPL);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc[0][c] = fmaf(w.x, xv[c], acc[0][c]);
        acc[1][c] = fmaf(w.y, xv[c], acc[1][c]);
        acc[2][c] = fmaf(w.z, xv[c], acc[2][c]);
        acc[3][c] = fmaf(w.w, xv[c], acc[3][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ii = 4 * warp + r;
    if (ii >= rows) continue;
    T* yr = y + ((bc * q + i0 + ii) * h + head) * P + lane * CPL;
#pragma unroll
    for (int c = 0; c < CPL; ++c) yr[c] = repro::from_float<T>(acc[r][c]);
  }
}

// ---------------- S_c rows [p0, p0 + 32) of (p, n) ----------------
template <typename T, int P, int N>
__device__ void s_block(const T* __restrict__ xb, const T* __restrict__ Bb,
                        const Strides& st, const float* acs, const float* dts,
                        float* work, float* __restrict__ s_out, int64_t bh,
                        int q, int p0) {
  constexpr int NPL = N / 32;                // S_c columns per lane
  constexpr int BPT = kK * N / kThreads;
  constexpr int XPT = kK * kQ / kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float last = acs[q - 1];
  float* Xs = work;                          // (kK, kQ): x dt decay
  float* Bs = Xs + kK * kQ;                  // (kK, N)
  float breg[BPT], xreg[XPT];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int u = 0; u < BPT; ++u) {
      const int e = tid + u * kThreads, r = e / N, k = e % N, j = j0 + r;
      breg[u] = j < q ? repro::to_float(Bb[j * st.b[2] + k * st.b[3]]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const int e = tid + u * kThreads, r = e / kQ, k = e % kQ, j = j0 + r;
      xreg[u] = j < q
          ? repro::to_float(xb[j * st.x[2] + (p0 + k) * st.x[4]]) * dts[j] *
                expf(last - acs[j])
          : 0.f;
    }
  };
  float acc[4][NPL];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NPL; ++c) acc[r][c] = 0.f;
  const int n_ktiles = (q + kK - 1) / kK;
  fetch(0);
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int j0 = kt * kK;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < BPT; ++u) Bs[tid + u * kThreads] = breg[u];
#pragma unroll
    for (int u = 0; u < XPT; ++u) Xs[tid + u * kThreads] = xreg[u];
    __syncthreads();
    if (kt + 1 < n_ktiles) fetch(j0 + kK);
    const int jn = min(kK, q - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float4 xv =
          *reinterpret_cast<const float4*>(Xs + jj * kQ + 4 * warp);
      float bv[NPL];
      lds<NPL>(bv, Bs + jj * N + lane * NPL);
#pragma unroll
      for (int c = 0; c < NPL; ++c) {
        acc[0][c] = fmaf(xv.x, bv[c], acc[0][c]);
        acc[1][c] = fmaf(xv.y, bv[c], acc[1][c]);
        acc[2][c] = fmaf(xv.z, bv[c], acc[2][c]);
        acc[3][c] = fmaf(xv.w, bv[c], acc[3][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float* sr = s_out + (bh * P + p0 + 4 * warp + r) * N + lane * NPL;
#pragma unroll
    for (int c = 0; c < NPL; ++c) sr[c] = acc[r][c];
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y,
                 float* __restrict__ s_out, float* __restrict__ acs_out,
                 Strides st, int nc, int q, int h, int n_qtiles) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int head = blockIdx.y;
  const int64_t bc = blockIdx.z;                 // batch * nc + chunk
  const int64_t bi = bc / nc, ci = bc - bi * nc;
  const T* xb = x + bi * st.x[0] + ci * st.x[1] + head * st.x[3];
  const float* dtb = dt + bi * st.dt[0] + ci * st.dt[1] + head * st.dt[3];
  const T* Bb = Bm + bi * st.b[0] + ci * st.b[1];
  const T* Cb = Cm + bi * st.c[0] + ci * st.c[1];
  const int64_t bh = bc * h + head;

  float* acs = smem;                             // (q,) cumulative dt * A
  float* dts = smem + q;                         // (q,) dt
  float* work = smem + round4(2 * q);            // 16-byte aligned
  for (int j = tid; j < q; j += kThreads) dts[j] = dtb[j * st.dt[2]];
  __syncthreads();
  chunk_cumsum(acs, dts, A[head], q);
  if (blockIdx.x == 0)
    for (int j = tid; j < q; j += kThreads) acs_out[bh * q + j] = acs[j];
  if (static_cast<int>(blockIdx.x) < n_qtiles)
    y_block<T, P, N>(xb, Bb, Cb, st, acs, dts, work, y, bc, head, q, h,
                     blockIdx.x * kQ);
  else
    s_block<T, P, N>(xb, Bb, st, acs, dts, work, s_out, bh, q,
                     (blockIdx.x - n_qtiles) * kQ);
}

// Dynamic shared memory of one block, in bytes: the larger of the query
// blocks' and the state blocks' needs.
size_t smem_bytes(int q, int p, int n) {
  const size_t head = round4(2 * q);
  const size_t y_floats = head + kQ * (n + 4) + kK * (n + 4) + kK * p +
                          kK * kWld;
  const size_t s_floats = head + kK * kQ + kK * n;
  return (y_floats > s_floats ? y_floats : s_floats) * sizeof(float);
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, void* y, float* s, float* acs, const Strides& st,
           int b, int nc, int q, int h, cudaStream_t stream) {
  const int n_qtiles = (q + kQ - 1) / kQ;
  const size_t bytes = smem_bytes(q, P, N);
  auto kernel = ssd_intra_kernel<T, P, N>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_qtiles + P / kQ, h, b * nc);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), s, acs, st, nc, q, h,
      n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_n(const void* x, const float* dt, const float* A, const void* B,
             const void* C, void* y, float* s, float* acs, const Strides& st,
             int b, int nc, int q, int h, int n, cudaStream_t stream) {
  if (n == 32)
    return launch<T, P, 32>(x, dt, A, B, C, y, s, acs, st, b, nc, q, h,
                            stream);
  if (n == 64)
    return launch<T, P, 64>(x, dt, A, B, C, y, s, acs, st, b, nc, q, h,
                            stream);
  if (n == 128)
    return launch<T, P, 128>(x, dt, A, B, C, y, s, acs, st, b, nc, q, h,
                             stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_pn(const void* x, const float* dt, const float* A, const void* B,
              const void* C, void* y, float* s, float* acs, const Strides& st,
              int b, int nc, int q, int h, int p, int n,
              cudaStream_t stream) {
  if (p == 32)
    return launch_n<T, 32>(x, dt, A, B, C, y, s, acs, st, b, nc, q, h, n,
                           stream);
  if (p == 64)
    return launch_n<T, 64>(x, dt, A, B, C, y, s, acs, st, b, nc, q, h, n,
                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// X (b, nc, q, h, p), dt (b, nc, q, h) fp32, A (h,) fp32, B and C (b, nc, q,
// n), read through `strides` (17 element strides: X's 5, dt's 4, B's 4,
// C's 4); p is 32 or 64, n is 32, 64 or 128.  Outputs, contiguous: y (b, nc, q, h,
// p) in X's dtype, s (b, nc, h, p, n) fp32, acs (b, nc, h, q) fp32.  dtype
// (repro::DtypeCode) is X's, B's and C's.  Returns a cudaError_t code (0 on
// success).
extern "C" int ssd_intra_fwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y, void* s,
                             void* acs, const int64_t* strides, int b, int nc,
                             int q, int h, int p, int n, int dtype,
                             void* stream) {
  if (b < 1 || nc < 1 || q < 1 || h < 1 || h > 65535 ||
      static_cast<int64_t>(b) * nc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(q, p, n) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 5; ++i) st.x[i] = strides[i];
  for (int i = 0; i < 4; ++i) {
    st.dt[i] = strides[5 + i];
    st.b[i] = strides[9 + i];
    st.c[i] = strides[13 + i];
  }
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(s);
  float* af = static_cast<float*>(acs);
  if (dtype == repro::kF32)
    return launch_pn<float>(x, dtf, Af, B, C, y, sf, af, st, b, nc, q, h, p,
                            n, sm);
  if (dtype == repro::kBF16)
    return launch_pn<__nv_bfloat16>(x, dtf, Af, B, C, y, sf, af, st, b, nc,
                                    q, h, p, n, sm);
  return static_cast<int>(cudaErrorInvalidValue);
}
