// Mamba2 SSD intra-chunk pass.  For each (batch, chunk, head), over the
// chunk's q rows (ngroups = 1: B and C are shared by every head):
//
//   A_cs[i] = sum_{j <= i} dt[j] * A                                  (q,)
//   Y[i, :] = sum_{j <= i} (C[i] . B[j]) exp(A_cs[i] - A_cs[j]) dt[j] x[j, :]
//   S_c     = sum_j exp(A_cs[q-1] - A_cs[j]) dt[j] x[j, :]^T B[j, :]  (p, n)
//
// from X, B, C in fp32 or bf16 (dt and A fp32); Y is stored in X's dtype,
// S_c and A_cs in fp32.  The inter-chunk recurrence and the off-diagonal
// term stay outside, as in the reference
// (repro_torch/kernels/ops.py::ssd_scan).  Two kernels, chosen by dtype:
// fp32 runs on the CUDA cores (ssd_intra_kernel), bf16 on the tensor cores
// (ssd_intra_mma_kernel).  A call neither takes is refused, never
// rerouted.  Both take p = 32 or 64 and n = 32, 64 or 128 (template
// parameters; the reduced configs use 32 and 32, Zamba2-1.2B 64 and 64,
// Mamba2-370M 64 and 128), any q >= 1 (exact-length admission gives q =
// the prompt length up to the chunk; rows past q are zero-filled, masked
// at every tile edge and never written), and inputs through their element
// strides, so X, B and C may be strided slices of the conv output.  Both
// sum A_cs in fp64, where the sums are exact, and round once, so it equals
// the plain version's bit for bit.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_intra_fwd (Pallas TPU kernel).
//
// ---- fp32: ssd_intra_kernel (PR 15's design, unchanged) ------------------
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
// - every block recomputes A_cs (the scan, cheaper than a second launch);
//   the first writes it out;
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
// The C . B scores are recomputed per head, as the Pallas kernel does.
//
// ---- bf16: ssd_intra_mma_kernel ------------------------------------------
//
// Bound on the H100: bytes.  In bf16 the Mamba2 admission moves ~3.2 MB
// (X and Y 1 MB each, S_c 1 MB in fp32), ~1.0 us at 3.35 TB/s, and its
// tensor-core work, ~0.55 GFLOP counting both halves of every split
// product below, takes ~0.6 us at 989 TFLOP/s.  The SIMT design ran at a
// tenth of the fp32 rate and lost to the plain version's batched products
// at b = 8: every FMA was fed from shared memory and the scores were
// recomputed for every head (half of its work).
//
// Design (mma.sync m16n8k16, bf16 operands, fp32 accumulators; ldmatrix
// and cp.async from csrc/mma.cuh).  One launch of blocks of 8 warps, two
// warp groups, over (blocks, batch * chunk), each block owning a pair of
// heads, one per warp group.  Both kinds of block stream the chunk's
// 64-key tiles through a three-stage cp.async ring (B's rows, both heads'
// X rows and dt; 16-byte copies where the pointers and strides allow it,
// element loads otherwise, so a strided slice at any offset is taken; rows
// past q zero), and compute the keys' A_cs tile by tile: a 64-key fp64 scan
// by shuffles plus a running fp64 carry, rounded once, so the rounding is
// the plain version's and no buffer grows with q.
//
// - A Y block owns a 64-row query tile and walks the key tiles up to the
//   diagonal.  Per tile, its 8 warps compute the scores C . B^T of the
//   tile once (each warp 16 rows x 32 keys; bf16 products are exact, sums
//   fp32) into shared memory, and both warp groups read them: each warp
//   forms, for its 16 rows and its group's head, W = score * exp(A_cs[i] -
//   A_cs[j]) * dt[j] in fp32, selected (never multiplied) below the
//   diagonal, splits W into bf16 hi + lo (~16 bits kept: a single bf16
//   rounding would cost up to ~2e-3 of max |Y|), and adds W_hi X + W_lo X
//   into registers, X through ldmatrix.trans; on the diagonal tile a warp
//   skips the key steps past its rows.  The rows' A_cs come first, from
//   the sum over the keys before them.  Query tiles with the most keys are
//   scheduled first.
// - A state block owns up to 64 of n's columns of both heads' S_c: per
//   tile each warp group forms u = x * dt * exp(A_cs[q-1] - A_cs[j]) (<= 1)
//   for its head in fp32, split into bf16 hi + lo in shared memory, and its
//   warps add u_hi^T B + u_lo^T B, both operands through ldmatrix.trans
//   (S_c is held to 1e-4 of its max, which one bf16 rounding of u misses).
//
// The host (kernels/ssd_scan.py::ssd_plan) lays out the grid: a Y block
// per (query tile, head pair), n / 64 state blocks per pair (96 blocks at
// the Mamba2 admission, 160 at Zamba2's).
#include "common.cuh"
#include "mma.cuh"

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

// ======================= bf16: the tensor-core kernel =====================
namespace mmak {

using bf16 = __nv_bfloat16;
using namespace repro::mma;
constexpr int kT = 64;                   // query rows of a Y block; keys
constexpr int kHeads = 2;                // heads a block: one per warp group
constexpr int kThreadsM = 128 * kHeads;  // 8 warps
constexpr int kStages = 3;               // key tiles in flight

struct Params {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  bf16* y;
  float* s;
  float* acs;
  Strides st;
  int nc, q, h;
  int n_qtiles;  // 64-row tiles of the chunk (query tiles and key tiles)
  int n_pairs;   // head pairs, ceil(h / 2): a Y or state block owns one
  int n_slices;  // state blocks per pair (state_width(n) columns each)
  int vec16;     // X, B and C rows are copied by 16-byte cp.async
};

__host__ __device__ constexpr int state_width(int n) {
  return n < 64 ? n : 64;
}

// Shared memory of a block, in bytes: a ring of kStages key tiles (B's
// rows, each head's X rows and dt), then the Y block's C tile and scores
// tile or the state block's u = x dt decay (bf16 hi and lo, per head), then
// the scans' scratch.
template <int P, int N>
struct Layout {
  static constexpr int RSB = N + 8, RSX = P + 8;  // bf16 row strides
  static constexpr int B_TILE = kT * RSB * 2;
  static constexpr int X_TILE = kT * RSX * 2;
  static constexpr int DT_TILE = kHeads * kT * 4;
  static constexpr int STAGE = B_TILE + kHeads * X_TILE + DT_TILE;
  static constexpr int Y_AREA = kT * RSB * 2 + kT * kT * 4;
  static constexpr int S_AREA = kHeads * 2 * X_TILE;
  static constexpr int AREA = Y_AREA > S_AREA ? Y_AREA : S_AREA;
  // acs of the tile and of the Y block's rows (floats), then 16 doubles
  static constexpr int SCAN = 2 * kHeads * kT * 4 + 16 * 8;
  static constexpr int BYTES = kStages * STAGE + AREA + SCAN;
};

// The scans' scratch: A_cs of the current key tile and of the Y block's
// rows, the running fp64 carry (double-buffered by tile parity), the
// 32-key halves' totals, and per-warp partial sums.
struct Scan {
  float* acs_t;    // [kHeads][kT]
  float* rows;     // [kHeads][kT]: a state block's key factors instead
  double* carry;   // [2][kHeads]
  double* half;    // [kHeads][2]
  double* part;    // [8]: a warp's sum
};

// Rows [row0, row0 + kT) of a strided (rows, COLS) bf16 matrix into a
// shared tile of row stride COLS + 8 (a 16-byte shift a row keeps every
// ldmatrix phase on distinct banks); rows at or past `limit` are zero.  By
// 16-byte cp.async when `vec16` (unit column stride, 16-byte aligned rows),
// else element by element: a narrower load, never a refusal.
template <int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t rs, int64_t cs, int row0,
                                          int limit, bool vec16) {
  constexpr int RS = COLS + 8;
  if (vec16) {
    constexpr int CH = COLS / 8;  // 16-byte chunks a row
#pragma unroll
    for (int i = 0; i < kT * CH / kThreadsM; ++i) {
      const int idx = i * kThreadsM + static_cast<int>(threadIdx.x);
      const int r = idx / CH, c = idx % CH;
      const bool in = row0 + r < limit;
      cp_async_16(smem_addr(dst + r * RS + c * 8),
                  src + (in ? static_cast<int64_t>(row0 + r) * rs : 0) + c * 8,
                  in);
    }
  } else {
    for (int idx = threadIdx.x; idx < kT * COLS; idx += kThreadsM) {
      const int r = idx / COLS, c = idx % COLS;
      dst[r * RS + c] = row0 + r < limit
                            ? src[static_cast<int64_t>(row0 + r) * rs + c * cs]
                            : __float2bfloat16(0.f);
    }
  }
}

// Key tile kt into a ring stage: B's rows (all n columns), the X rows of
// heads [head0, head0 + nh), their dt (zero past q or past the heads).
template <int P, int N>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const Params& pr, int64_t bi,
                                           int64_t ci, int head0, int nh,
                                           int kt) {
  using L = Layout<P, N>;
  const Strides& st = pr.st;
  const int row0 = kt * kT;
  load_tile<N>(reinterpret_cast<bf16*>(stage),
               pr.B + bi * st.b[0] + ci * st.b[1], st.b[2], st.b[3], row0,
               pr.q, pr.vec16);
  for (int g = 0; g < nh; ++g)
    load_tile<P>(reinterpret_cast<bf16*>(stage + L::B_TILE + g * L::X_TILE),
                 pr.x + bi * st.x[0] + ci * st.x[1] + (head0 + g) * st.x[3],
                 st.x[2], st.x[4], row0, pr.q, pr.vec16);
  if (threadIdx.x < kHeads * kT) {
    const int g = threadIdx.x / kT, j = row0 + threadIdx.x % kT;
    const bool in = g < nh && j < pr.q;
    const float* src = pr.dt + bi * st.dt[0] + ci * st.dt[1] +
                       (in ? (head0 + g) * st.dt[3] + j * st.dt[2] : 0);
    cp_async_4(smem_addr(stage + L::B_TILE + kHeads * L::X_TILE +
                         threadIdx.x * 4),
               src, in);
  }
}

// sum_{j < limit} dt[j] * A in fp64, per head of the block, into out[g]
// (every thread calls it; two __syncthreads inside)
__device__ void head_sums(const Params& pr, int64_t bi, int64_t ci,
                          int head0, int nh, int limit, const Scan& sc,
                          double* out) {
  const int g = threadIdx.x / 128, t = threadIdx.x % 128;
  double v = 0.0;
  if (g < nh) {
    const float* dtb = pr.dt + bi * pr.st.dt[0] + ci * pr.st.dt[1] +
                       (head0 + g) * pr.st.dt[3];
    const float a = pr.A[head0 + g];
    for (int j0 = t; j0 < limit; j0 += 4 * 128) {  // 4 loads in flight
      float d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * 128;
        d[u] = j < limit ? dtb[j * pr.st.dt[2]] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) v += static_cast<double>(d[u] * a);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sc.part[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x < kHeads)
    out[threadIdx.x] = sc.part[4 * threadIdx.x] +
                       sc.part[4 * threadIdx.x + 1] +
                       sc.part[4 * threadIdx.x + 2] +
                       sc.part[4 * threadIdx.x + 3];
  __syncthreads();
}

// The A_cs of 64 keys of each head (thread t < 128: head t / 64, key t %
// 64), in two parts around a __syncthreads.  Part 1: dt * A (the fp32
// product) in fp64, scanned over each 32-key half by shuffles; the halves'
// totals posted.  Part 2: plus the carry (the sum over the keys before)
// and the first half's total, rounded once to fp32.  The sums are exact in
// fp64, so this is the correctly rounded cumsum, as chunk_cumsum's and
// the plain version's: bit for bit the same.
__device__ __forceinline__ double scan_part1(float dtv, float a,
                                             const Scan& sc) {
  double incl = 0.0;
  if (threadIdx.x < kHeads * kT) {  // warps 0-3, whole
    const int lane = threadIdx.x & 31;
    incl = static_cast<double>(dtv * a);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sc.half[threadIdx.x / 32] = incl;
  }
  return incl;
}

__device__ __forceinline__ void scan_part2(double incl, const double* carry,
                                           float* acs, double* carry_out,
                                           const Scan& sc) {
  if (threadIdx.x < kHeads * kT) {
    const int g = threadIdx.x / kT, jj = threadIdx.x % kT;
    const double v = carry[g] + incl + (jj >= 32 ? sc.half[2 * g] : 0.0);
    acs[threadIdx.x] = static_cast<float>(v);
    if (carry_out != nullptr && jj == kT - 1) carry_out[g] = v;
  }
}

// a state block's factor of key j: dt[j] exp(A_cs[q-1] - A_cs[j]) (<= 1:
// no overflow), 0 past q; after scan_part2, by the same threads
__device__ __forceinline__ void decay_factor(float dtv, float last,
                                            const Scan& sc, float* fac,
                                            int j, int q) {
  if (threadIdx.x < kHeads * kT)
    fac[threadIdx.x] = j < q ? dtv * expf(last - sc.acs_t[threadIdx.x]) : 0.f;
}

// a and b as two bf16 pairs, hi + lo: hi rounds them, lo rounds what hi
// left, so hi + lo keeps ~16 significant bits (`a` in the low halves)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h2);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

__device__ __forceinline__ Scan scan_scratch(unsigned char* p) {
  Scan sc;
  sc.acs_t = reinterpret_cast<float*>(p);
  sc.rows = sc.acs_t + kHeads * kT;
  sc.carry = reinterpret_cast<double*>(sc.rows + kHeads * kT);
  sc.half = sc.carry + 2 * kHeads;
  sc.part = sc.half + 2 * kHeads;
  return sc;
}

// ---- Y rows [q0, q0 + 64) of heads head0, head0 + 1 ----
template <int P, int N>
__device__ void y_block(const Params& pr, unsigned char* smem, int qt,
                        int head0, int64_t bc, int64_t bi, int64_t ci) {
  using L = Layout<P, N>;
  constexpr int KD = N / 16;  // k-steps of C . B^T
  constexpr int NO = P / 8;   // n-tiles of Y
  const int q = pr.q, h = pr.h, nh = min(kHeads, h - head0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int strip = warp & 3;  // this warp's 16 rows
  const int g = warp >> 2;     // its head, and its half of a tile's keys
  unsigned char* ring = smem;
  bf16* cs = reinterpret_cast<bf16*>(smem + kStages * L::STAGE);
  float4* sct = reinterpret_cast<float4*>(smem + kStages * L::STAGE +
                                          kT * L::RSB * 2);
  const Scan sc = scan_scratch(smem + kStages * L::STAGE + L::AREA);
  const int q0 = qt * kT, nkt = qt + 1;
  const Strides& st = pr.st;

  load_tile<N>(cs, pr.C + bi * st.c[0] + ci * st.c[1], st.c[2], st.c[3], q0,
               q, pr.vec16);
  load_stage<P, N>(ring, pr, bi, ci, head0, nh, 0);
  cp_async_commit();
  if (nkt > 1) load_stage<P, N>(ring + L::STAGE, pr, bi, ci, head0, nh, 1);
  cp_async_commit();

  // A_cs of the rows, from the sum over the keys before them (the rows'
  // dt in flight with the sum's)
  {
    float dtv = 0.f, a = 0.f;
    if (threadIdx.x < kHeads * kT) {
      const int gg = threadIdx.x / kT, i = q0 + threadIdx.x % kT;
      if (gg < nh) {
        a = pr.A[head0 + gg];
        if (i < q)
          dtv = pr.dt[bi * st.dt[0] + ci * st.dt[1] +
                      (head0 + gg) * st.dt[3] + i * st.dt[2]];
      }
    }
    head_sums(pr, bi, ci, head0, nh, q0, sc, sc.carry + kHeads);
    const double incl = scan_part1(dtv, a, sc);
    __syncthreads();
    scan_part2(incl, sc.carry + kHeads, sc.rows, nullptr, sc);
    if (threadIdx.x < kHeads) sc.carry[threadIdx.x] = 0.0;  // key tile 0
    __syncthreads();
    if (threadIdx.x < kHeads * kT) {
      const int gg = threadIdx.x / kT, i = q0 + threadIdx.x % kT;
      if (gg < nh && i < q)
        pr.acs[(bc * h + head0 + gg) * q + i] = sc.rows[threadIdx.x];
    }
  }
  const int i0 = q0 + strip * 16 + gid, i1 = i0 + 8;  // this thread's rows
  const float a_0 = sc.rows[g * kT + strip * 16 + gid];
  const float a_1 = sc.rows[g * kT + strip * 16 + gid + 8];
  const float a_mine =
      threadIdx.x < kHeads * kT && static_cast<int>(threadIdx.x) / kT < nh
          ? pr.A[head0 + threadIdx.x / kT] : 0.f;

  uint32_t cf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1 is consumed
    if (kt + kStages - 1 < nkt)
      load_stage<P, N>(ring + ((kt + kStages - 1) % kStages) * L::STAGE, pr,
                       bi, ci, head0, nh, kt + kStages - 1);
    cp_async_commit();
    const unsigned char* stg = ring + (kt % kStages) * L::STAGE;
    const bf16* bs = reinterpret_cast<const bf16*>(stg);
    const bf16* xs = reinterpret_cast<const bf16*>(stg + L::B_TILE +
                                                   g * L::X_TILE);
    const float* dts = reinterpret_cast<const float*>(
        stg + L::B_TILE + kHeads * L::X_TILE);
    if (kt == 0) {  // this warp's 16 rows of C, as A fragments over n
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(cf[kk], smem_addr(cs + (strip * 16 + (lane & 15)) *
                                               L::RSB +
                                      kk * 16 + (lane >> 4) * 8));
    }
    const double incl = scan_part1(
        threadIdx.x < kHeads * kT ? dts[threadIdx.x] : 0.f, a_mine, sc);

    // the scores C . B^T of this key tile, once for both heads: this
    // warp's 16 rows x keys [32 g, 32 g + 32), to shared memory in
    // fragment order
    float sv[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        const int np = 2 * g + n2;
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(bs + (np * 16 + (lane & 7) +
                                         ((lane >> 4) << 3)) * L::RSB +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(sv[2 * n2], cf[kk], bk[0], bk[1]);
        mma_bf16(sv[2 * n2 + 1], cf[kk], bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
      sct[(strip * 8 + 4 * g + n) * 32 + lane] =
          make_float4(sv[n][0], sv[n][1], sv[n][2], sv[n][3]);
    __syncthreads();
    scan_part2(incl, sc.carry + (kt & 1) * kHeads, sc.acs_t,
               sc.carry + ((kt + 1) & 1) * kHeads, sc);
    __syncthreads();  // the scores and the keys' A_cs are complete

    // W = scores * exp(A_cs[i] - A_cs[j]) * dt[j] below the diagonal
    // (selected, never multiplied: exp overflows above it), split into
    // bf16 hi + lo, then Y += W_hi X + W_lo X for this warp's head
    if (g >= nh) continue;
    const float* acs_g = sc.acs_t + g * kT;
    const float* dt_g = dts + g * kT;
    const int kk_end = kt == qt ? strip + 1 : 4;  // keys past the rows: 0
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= kk_end) break;
      float w[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int nt = 2 * kk + hf, jj = nt * 8 + 2 * tig, j = kt * kT + jj;
        const float4 s4 = sct[(strip * 8 + nt) * 32 + lane];
        const float2 aj = *reinterpret_cast<const float2*>(acs_g + jj);
        const float2 dj = *reinterpret_cast<const float2*>(dt_g + jj);
        w[hf][0] = i0 >= j && i0 < q ? s4.x * expf(a_0 - aj.x) * dj.x : 0.f;
        w[hf][1] = i0 > j && i0 < q ? s4.y * expf(a_0 - aj.y) * dj.y : 0.f;
        w[hf][2] = i1 >= j && i1 < q ? s4.z * expf(a_1 - aj.x) * dj.x : 0.f;
        w[hf][3] = i1 > j && i1 < q ? s4.w * expf(a_1 - aj.y) * dj.y : 0.f;
      }
      uint32_t ah[4], al[4];  // A fragments: rows x keys 16kk..16kk+15
      split2(w[0][0], w[0][1], ah[0], al[0]);
      split2(w[0][2], w[0][3], ah[1], al[1]);
      split2(w[1][0], w[1][1], ah[2], al[2]);
      split2(w[1][2], w[1][3], ah[3], al[3]);
#pragma unroll
      for (int dp = 0; dp < P / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(xs + (kk * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) *
                                                 L::RSX +
                                        dp * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * dp], ah, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], ah, bv[2], bv[3]);
        mma_bf16(acc[2 * dp], al, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], al, bv[2], bv[3]);
      }
    }
  }
  if (g >= nh) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r ? i1 : i0;
    if (i >= q) continue;
    bf16* yr = pr.y + ((bc * q + i) * h + head0 + g) * P + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(yr + n * 8) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---- S_c of heads head0, head0 + 1, columns [slice SW, slice SW + SW) ----
template <int P, int N>
__device__ void s_block(const Params& pr, unsigned char* smem, int head0,
                        int slice, int64_t bc, int64_t bi, int64_t ci) {
  using L = Layout<P, N>;
  constexpr int SW = state_width(N);
  constexpr int SPW = P / 16;  // 16-row strips of p
  constexpr int CG = 4 / SPW;  // column groups of a strip
  constexpr int CW = SW / CG;  // columns a warp
  constexpr int NT = CW / 8;   // n-tiles a warp
  const int q = pr.q, nkt = pr.n_qtiles, nh = min(kHeads, pr.h - head0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = warp >> 2, wl = warp & 3;  // this warp group's head
  const int strip = wl % SPW, cg = wl / SPW;
  unsigned char* ring = smem;
  bf16* uh = reinterpret_cast<bf16*>(smem + kStages * L::STAGE +
                                     g * 2 * L::X_TILE);  // [kT][RSX]
  bf16* ul = uh + kT * L::RSX;
  const Scan sc = scan_scratch(smem + kStages * L::STAGE + L::AREA);

  load_stage<P, N>(ring, pr, bi, ci, head0, nh, 0);
  cp_async_commit();
  if (nkt > 1) load_stage<P, N>(ring + L::STAGE, pr, bi, ci, head0, nh, 1);
  cp_async_commit();
  // A_cs[q - 1]: the rounded sum over every key
  head_sums(pr, bi, ci, head0, nh, q, sc, sc.carry + kHeads);
  // the factor's A_cs[q - 1], for the head of threads < 128 (keys)
  const float last = static_cast<float>(
      sc.carry[kHeads + (threadIdx.x < kHeads * kT &&
                         static_cast<int>(threadIdx.x) / kT < nh
                             ? threadIdx.x / kT : 0)]);
  const float a_mine =
      threadIdx.x < kHeads * kT && static_cast<int>(threadIdx.x) / kT < nh
          ? pr.A[head0 + threadIdx.x / kT] : 0.f;
  if (threadIdx.x < kHeads) sc.carry[threadIdx.x] = 0.0;  // key tile 0

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nkt)
      load_stage<P, N>(ring + ((kt + kStages - 1) % kStages) * L::STAGE, pr,
                       bi, ci, head0, nh, kt + kStages - 1);
    cp_async_commit();
    const unsigned char* stg = ring + (kt % kStages) * L::STAGE;
    const bf16* bs = reinterpret_cast<const bf16*>(stg);
    const bf16* xs = reinterpret_cast<const bf16*>(stg + L::B_TILE +
                                                   g * L::X_TILE);
    const float* dts = reinterpret_cast<const float*>(
        stg + L::B_TILE + kHeads * L::X_TILE);
    const float dtv = threadIdx.x < kHeads * kT ? dts[threadIdx.x] : 0.f;
    const double incl = scan_part1(dtv, a_mine, sc);
    __syncthreads();
    scan_part2(incl, sc.carry + (kt & 1) * kHeads, sc.acs_t,
               sc.carry + ((kt + 1) & 1) * kHeads, sc);
    decay_factor(dtv, last, sc, sc.rows, kt * kT + threadIdx.x % kT, q);
    __syncthreads();
    // u = x * factor, split hi + lo, by this head's warp group, 8 values
    // (16 bytes) a step
    if (g < nh) {
      const float* fac = sc.rows + g * kT;
      for (int e = threadIdx.x % 128; e < kT * P / 8; e += 128) {
        const int r = e / (P / 8), c = (e % (P / 8)) * 8;
        const uint4 xv = *reinterpret_cast<const uint4*>(xs + r * L::RSX + c);
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
        const float f = fac[r];
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)  // a bf16 pair: the low half first
          split2(__uint_as_float(xw[k] << 16) * f,
                 __uint_as_float(xw[k] & 0xffff0000u) * f, hi[k], lo[k]);
        *reinterpret_cast<uint4*>(uh + r * L::RSX + c) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(ul + r * L::RSX + c) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    __syncthreads();
    if (g >= nh) continue;
    // S_c += u^T B: u^T (p x keys) through ldmatrix.trans of u (keys x p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      const int arow = kk * 16 + ((lane >> 4) << 3) + (lane & 7);
      const int acol = strip * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(ah, smem_addr(uh + arow * L::RSX + acol));
      ldmatrix_x4_trans(al, smem_addr(ul + arow * L::RSX + acol));
#pragma unroll
      for (int np = 0; np < CW / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(bs + (kk * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) *
                                                 L::RSB +
                                        slice * SW + cg * CW + np * 16 +
                                        (lane >> 4) * 8));
        mma_bf16(acc[2 * np], ah, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], ah, bv[2], bv[3]);
        mma_bf16(acc[2 * np], al, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], al, bv[2], bv[3]);
      }
    }
  }
  if (g >= nh) return;
  const int64_t bh = bc * pr.h + head0 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* sr = pr.s + (bh * P + strip * 16 + gid + 8 * r) * N + slice * SW +
                cg * CW + 2 * tig;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(sr + n * 8) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreadsM, 1)
ssd_intra_mma_kernel(const Params pr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t bc = blockIdx.y;  // batch * nc + chunk
  const int64_t bi = bc / pr.nc, ci = bc - bi * pr.nc;
  const int bx = blockIdx.x, n_y = pr.n_qtiles * pr.n_pairs;
  if (bx < n_y)  // the last query tiles have the most keys: they go first
    y_block<P, N>(pr, smem_raw, pr.n_qtiles - 1 - bx / pr.n_pairs,
                  (bx % pr.n_pairs) * kHeads, bc, bi, ci);
  else
    s_block<P, N>(pr, smem_raw, (bx - n_y) / pr.n_slices * kHeads,
                  (bx - n_y) % pr.n_slices, bc, bi, ci);
}

template <int P, int N>
int launch(const Params& pr, int b_nc, cudaStream_t stream) {
  constexpr int bytes = Layout<P, N>::BYTES;
  if (pr.n_slices * state_width(N) != N)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_intra_mma_kernel<P, N>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(pr.n_qtiles * pr.n_pairs + pr.n_pairs * pr.n_slices, b_nc);
  kernel<<<grid, kThreadsM, bytes, stream>>>(pr);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_n(const Params& pr, int n, int b_nc, cudaStream_t stream) {
  if (n == 32) return launch<P, 32>(pr, b_nc, stream);
  if (n == 64) return launch<P, 64>(pr, b_nc, stream);
  if (n == 128) return launch<P, 128>(pr, b_nc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// what 16-byte cp.async needs: aligned rows, unit column stride
bool aligned16(const Params& pr) {
  auto al = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const Strides& st = pr.st;
  bool ok = al(pr.x) && al(pr.B) && al(pr.C) && st.x[4] == 1 &&
            st.b[3] == 1 && st.c[3] == 1;
  for (int i = 0; i < 4; ++i) ok = ok && st.x[i] % 8 == 0;
  for (int i = 0; i < 3; ++i) ok = ok && st.b[i] % 8 == 0 && st.c[i] % 8 == 0;
  return ok;
}

}  // namespace mmak

}  // namespace

// X (b, nc, q, h, p), dt (b, nc, q, h) fp32, A (h,) fp32, B and C (b, nc, q,
// n), read through `strides` (17 element strides: X's 5, dt's 4, B's 4,
// C's 4; 0 for a dimension of size 1); p is 32 or 64, n is 32, 64 or 128.
// Outputs, contiguous: y (b, nc, q, h, p) in X's dtype, s (b, nc, h, p, n)
// fp32, acs (b, nc, h, q) fp32.  dtype (repro::DtypeCode) is X's, B's and
// C's: fp32 runs ssd_intra_kernel, bf16 ssd_intra_mma_kernel with the
// host's plan (kernels/ssd_scan.py::ssd_plan): `n_slices` state blocks a
// head pair, `vec16` 16-byte copies (checked here too).  Returns a
// cudaError_t code (0 on success).
extern "C" int ssd_intra_fwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y, void* s,
                             void* acs, const int64_t* strides, int b, int nc,
                             int q, int h, int p, int n, int dtype,
                             int n_slices, int vec16, void* stream) {
  if (b < 1 || nc < 1 || q < 1 || h < 1 || h > 65535 ||
      static_cast<int64_t>(b) * nc > 65535)
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
  if (dtype == repro::kF32) {
    if (smem_bytes(q, p, n) > 227 * 1024)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_pn<float>(x, dtf, Af, B, C, y, sf, af, st, b, nc, q, h, p,
                            n, sm);
  }
  if (dtype != repro::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  using mmak::bf16;
  mmak::Params pr{static_cast<const bf16*>(x), dtf, Af,
                  static_cast<const bf16*>(B), static_cast<const bf16*>(C),
                  static_cast<bf16*>(y), sf, af, st, nc, q, h};
  pr.n_qtiles = (q + mmak::kT - 1) / mmak::kT;
  pr.n_pairs = (h + mmak::kHeads - 1) / mmak::kHeads;
  pr.n_slices = n_slices;
  pr.vec16 = vec16;
  if (n_slices < 1 ||
      static_cast<int64_t>(pr.n_qtiles + n_slices) * pr.n_pairs > 0x7fffffff ||
      (vec16 && !mmak::aligned16(pr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p == 32) return mmak::launch_n<32>(pr, n, b * nc, sm);
  if (p == 64) return mmak::launch_n<64>(pr, n, b * nc, sm);
  return static_cast<int>(cudaErrorInvalidValue);
}
