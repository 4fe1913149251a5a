// Flash attention backward (FlashAttention-2): dQ, dK, dV of causal /
// sliding-window GQA attention from the forward's saved log-sum-exp and
// delta = rowsum(dO * O), queries aligned to the END of the keys
// (qpos = q_offset + i with q_offset = Lk - Lq).
//
// Replaces: src/repro/kernels/flash_attention_bwd.py::flash_attention_bwd
// (Pallas TPU kernels _dkv_kernel and _dq_kernel).
//
// Layout: q, dO, dQ (B, KV, G, Lq, D); k, v, dK, dV (B, KV, Lk, D), each
// through its strides with a unit stride along D (the adapter in
// kernels/ops.py passes permuted views of the model's (B, L, H, D)
// activations and gradients); lse and delta (B, KV, G, Lq) fp32,
// contiguous.  Outputs are written in their inputs' dtype; every sum is
// fp32.  Masking follows the reference: p is exactly 0 where the causal /
// window mask, the ragged edge of either axis, or a row past Lq removes
// the pair, and a row whose lse is the finite mask value (-1e30) takes
// lse = 0.  Key tiles that every row of a dQ block masks, and query tiles
// that attend no key of a dK/dV block, are skipped, so no block size has
// to divide Lq or Lk.
//
// Two kernels per call, two launches, and no atomics: dK/dV per key tile,
// dQ per query tile, so GQA's sum over the group stays inside one block
// and every result is bitwise repeatable, whatever the scheduling.  The dQ
// kernel recomputes S and dP (about 1.4x the FLOP of one kernel with
// atomic dQ).  Chosen by dtype, both pairs hand-written: bf16 runs on the
// tensor cores (flash_bwd_dkv_mma_kernel, flash_bwd_dq_mma_kernel), fp32
// on the CUDA cores (flash_bwd_dkv_kernel, flash_bwd_dq_kernel, whose note
// is below).  A call neither takes is refused, never rerouted.
//
// ---- bf16: flash_bwd_dkv_mma_kernel, flash_bwd_dq_mma_kernel -------------
//
// Bound on the H100: at the OPT-1.3B training shape (B = 8, H = KV = 32,
// L = 512, D = 64, causal) the function moves 118 MB (q, dO, dQ, k, v, dK,
// dV once each, plus lse and delta) and needs 10 D FLOP for each of the
// 34 M unmasked (query, key) pairs, 21.5 GFLOP: 35 us of bytes at 3.35 TB/s
// against 22 us of bf16 tensor-core work, so the bytes bound it.  No
// (Lq, Lk) tile ever reaches device memory: the probabilities are
// recomputed from lse, p = exp(s - lse), in registers.
//
// Design, mma.sync m16n8k16 (bf16 operands, fp32 accumulators), 4 warps,
// rows padded by 8 bf16 so that ldmatrix is free of bank conflicts, tiles
// streamed by 16-byte cp.async in a two-stage ring:
//
// * dK/dV: one block per (b, kv_head, 64-key tile), each warp owning 16
//   keys.  K and V are staged once; the block walks the G heads and the
//   query tiles (64 queries, 32 at D = 128) that attend its keys, with Q,
//   dO, lse and delta streamed.  Per tile it computes S^T = K Q^T and
//   dP^T = V dO^T (K, V as A operands, Q, dO as B), forms
//   P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale in fp32
//   (lse and delta per column, from shared memory), rounds both to bf16 in
//   registers as A fragments, and accumulates dV += P^T dO and dK += dS^T Q
//   with dO and Q through ldmatrix.trans.
// * dQ: one block per (b, kv_head, g, 64-query tile), each warp owning 16
//   query rows, whose Q and dO fragments stay in registers.  K and V
//   stream in 64-key tiles (32 at D = 128); S, dP and dS are formed in
//   registers and dQ += dS K takes K through ldmatrix.trans.
//
// Element masks run only on tiles that touch the diagonal, the window
// edge, or the ragged edge of either axis.
//
// Head dim 192 (MLA): dK and dV for 16 keys a warp would be 2 x 96 fp32
// registers a thread, and the dQ kernel's Q and dO fragments 96 more
// beside dQ's 96.  So at D = 192 the dK/dV entry point launches two
// kernels over the same grid, one accumulating dV (it needs S and P only)
// and one dK (S, P, dP and dS): S is computed twice, dP once.  The dQ
// kernel reloads the Q and dO fragments from its staged tiles at every
// key tile.  Non-causal calls may have Lq > Lk (encoder keys).
//
// Every operand must be 16-byte aligned with row, head and batch strides
// that are multiples of 8 elements (the wrapper checks and raises).
//
// ---- fp32: flash_bwd_dkv_kernel, flash_bwd_dq_kernel ---------------------
//
// At the training shape these kernels need the same 21.5 GFLOP at the fp32
// rate (67 TFLOP/s), which bounds them at 0.32 ms.  They do their products
// on the CUDA cores in fp32, so the fp32 gates (1e-4) hold.
//
// * dK/dV: one block per (b, kv_head, BK-key tile).  K and V of the tile
//   are staged in shared memory once; the block then walks all G query
//   heads of the group and every BQ-query tile that attends at least one
//   of its keys.
// * dQ: one block per (b, kv_head, g, BQ-query tile), walking the key
//   tiles its rows attend.
//
// Each tile step: stage the operand tiles as fp32 in shared memory (rows
// padded by 4 floats, which keeps 16-byte alignment for float4 reads and
// spreads a quarter-warp's rows over all 32 banks); each thread computes an
// 8-row slice of S = Q K^T and dP = dO V^T; p and ds = p (dp - delta) scale
// go to shared memory; then dV += P^T dO, dK += dS^T Q (or dQ += dS K) with
// each thread owning a register block of the output.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTY = 8;   // thread grid over a tile: 8 rows of threads ...
constexpr int kTX = 16;  // ... by 16 columns

template <int D>
struct BwdTile {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  static constexpr int BQ = 64;                   // query rows per tile
  static constexpr int BK = D >= 128 ? 32 : 64;   // keys per tile
  static constexpr int DS = D + 4;                // padded q/dO/k/v row
  static constexpr int PS = BK + 4;               // padded p/ds row
  static constexpr int RA = BQ / kTY;             // S/dP rows per thread
  static constexpr int KA = BK / kTX;             // S/dP keys per thread
  static constexpr int KB = BK / kTY;             // dK/dV keys per thread
  static constexpr int DB = D / kTX;              // output dims per thread
  static constexpr int RQ = BQ / kTY;             // dQ rows per thread
  static_assert(KB % 4 == 0, "float4 reads of p/ds rows");
  static constexpr int dkv_smem = static_cast<int>(sizeof(float)) *
      (2 * BQ * DS + 2 * BK * DS + 2 * BQ * PS + 2 * BQ);
  static constexpr int dq_smem = static_cast<int>(sizeof(float)) *
      (2 * BQ * DS + 2 * BK * DS + BQ * PS + 2 * BQ);
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_sk, q_sg, q_sl;
  int64_t k_sb, k_sk, k_sl;
  int64_t v_sb, v_sk, v_sl;
  int64_t do_sb, do_sk, do_sg, do_sl;
  int64_t dq_sb, dq_sk, dq_sg, dq_sl;
  int64_t dk_sb, dk_sk, dk_sl;
  int64_t dv_sb, dv_sk, dv_sl;
  int B, KV, G, Lq, Lk;
  int causal;
  int window;  // < 0: no window
  float scale;
};

// rows [row0, row0 + rows) of a strided (L, D) matrix into shared memory
// as fp32 with row stride D + 4; rows at or past `limit` are zero
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int64_t stride, int row0,
                                           int rows, int limit) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 4) + d] =
        row0 + r < limit
            ? repro::to_float(src[static_cast<int64_t>(row0 + r) * stride + d])
            : 0.f;
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// p and ds of the (BQ x BK) tile of query rows q0.. and keys k0.., from
// the staged q/dO (BQ rows), k/v (BK rows) and the rows' lse / delta.
// Writes ds (and p when p_s is not null) with row stride PS.
template <int D>
__device__ __forceinline__ void tile_p_ds(const Params& p, const float* q_s,
                                          const float* do_s, const float* k_s,
                                          const float* v_s, const float* lse_s,
                                          const float* delta_s, float* p_s,
                                          float* ds_s, int q0, int k0) {
  using TL = BwdTile<D>;
  constexpr int RA = TL::RA, KA = TL::KA, DS = TL::DS, PS = TL::PS;
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  float s[RA][KA], dp[RA][KA];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int t = 0; t < KA; ++t) s[r][t] = dp[r][t] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 kv[KA], vv[KA];
#pragma unroll
    for (int t = 0; t < KA; ++t) {
      kv[t] = ld4(&k_s[(tx + t * kTX) * DS + d]);
      vv[t] = ld4(&v_s[(tx + t * kTX) * DS + d]);
    }
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const float4 qv = ld4(&q_s[(ty * RA + r) * DS + d]);
      const float4 gv = ld4(&do_s[(ty * RA + r) * DS + d]);
#pragma unroll
      for (int t = 0; t < KA; ++t) {
        s[r][t] = dot4(qv, kv[t], s[r][t]);
        dp[r][t] = dot4(gv, vv[t], dp[r][t]);
      }
    }
  }
  const int q_offset = p.Lk - p.Lq;
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int i = ty * RA + r;
    const int qi = q0 + i;
    const int qpos = q_offset + qi;
    const float lse = lse_s[i];
    const float lse_safe = lse <= REPRO_NEG_INF / 2 ? 0.f : lse;
    const float dl = delta_s[i];
#pragma unroll
    for (int t = 0; t < KA; ++t) {
      const int j = tx + t * kTX;
      const int kpos = k0 + j;
      const bool ok = qi < p.Lq && kpos < p.Lk &&
                      (!p.causal || qpos >= kpos) &&
                      (p.window < 0 || qpos - kpos < p.window);
      const float pv = ok ? expf(s[r][t] * p.scale - lse_safe) : 0.f;
      if (p_s != nullptr) p_s[i * PS + j] = pv;
      ds_s[i * PS + j] = pv * (dp[r][t] - dl) * p.scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const Params p) {
  using TL = BwdTile<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, DS = TL::DS, PS = TL::PS;
  constexpr int KB = TL::KB, DB = TL::DB;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BQ][DS]
  float* do_s = q_s + BQ * DS;                   // [BQ][DS]
  float* k_s = do_s + BQ * DS;                   // [BK][DS]
  float* v_s = k_s + BK * DS;                    // [BK][DS]
  float* p_s = v_s + BK * DS;                    // [BQ][PS]
  float* ds_s = p_s + BQ * PS;                   // [BQ][PS]
  float* lse_s = ds_s + BQ * PS;                 // [BQ]
  float* delta_s = lse_s + BQ;                   // [BQ]

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int q_offset = p.Lk - p.Lq;
  const int jy = threadIdx.x / kTX, dx = threadIdx.x % kTX;

  stage_rows<T, D>(k_s, static_cast<const T*>(p.k) + b * p.k_sb +
                            kvh * p.k_sk, p.k_sl, k0, BK, p.Lk);
  stage_rows<T, D>(v_s, static_cast<const T*>(p.v) + b * p.v_sb +
                            kvh * p.v_sk, p.v_sl, k0, BK, p.Lk);

  // query rows that attend at least one key of this tile
  int q_lo = 0, q_hi = p.Lq;
  if (p.causal) q_lo = max(0, k0 - q_offset);
  if (p.window >= 0) q_hi = min(q_hi, k0 + BK - 1 + p.window - q_offset);
  q_lo = (q_lo / BQ) * BQ;

  float dk[KB][DB], dv[KB][DB];
#pragma unroll
  for (int r = 0; r < KB; ++r)
#pragma unroll
    for (int c = 0; c < DB; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int g = 0; g < p.G; ++g) {
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kvh * p.q_sk +
                  g * p.q_sg;
    const T* gb = static_cast<const T*>(p.dout) + b * p.do_sb +
                  kvh * p.do_sk + g * p.do_sg;
    const int64_t row = (static_cast<int64_t>(b) * p.KV + kvh) * p.G + g;
    const float* lse_b = p.lse + row * p.Lq;
    const float* delta_b = p.delta + row * p.Lq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // the previous tile is consumed
      stage_rows<T, D>(q_s, qb, p.q_sl, q0, BQ, p.Lq);
      stage_rows<T, D>(do_s, gb, p.do_sl, q0, BQ, p.Lq);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        lse_s[i] = q0 + i < p.Lq ? lse_b[q0 + i] : 0.f;
        delta_s[i] = q0 + i < p.Lq ? delta_b[q0 + i] : 0.f;
      }
      __syncthreads();
      tile_p_ds<D>(p, q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, q0,
                   k0);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: thread owns keys jy*KB.. and dims
      // dx + 16c
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pv[KB], dsv[KB], gv[DB], qv[DB];
#pragma unroll
        for (int r = 0; r < KB; r += 4) {
          const float4 a = ld4(&p_s[i * PS + jy * KB + r]);
          const float4 c = ld4(&ds_s[i * PS + jy * KB + r]);
          pv[r] = a.x, pv[r + 1] = a.y, pv[r + 2] = a.z, pv[r + 3] = a.w;
          dsv[r] = c.x, dsv[r + 1] = c.y, dsv[r + 2] = c.z, dsv[r + 3] = c.w;
        }
#pragma unroll
        for (int c = 0; c < DB; ++c) {
          gv[c] = do_s[i * DS + dx + c * kTX];
          qv[c] = q_s[i * DS + dx + c * kTX];
        }
#pragma unroll
        for (int r = 0; r < KB; ++r)
#pragma unroll
          for (int c = 0; c < DB; ++c) {
            dv[r][c] = fmaf(pv[r], gv[c], dv[r][c]);
            dk[r][c] = fmaf(dsv[r], qv[c], dk[r][c]);
          }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sk;
  T* dvb = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sk;
#pragma unroll
  for (int r = 0; r < KB; ++r) {
    const int j = k0 + jy * KB + r;
    if (j < p.Lk) {
#pragma unroll
      for (int c = 0; c < DB; ++c) {
        const int d = dx + c * kTX;
        dkb[static_cast<int64_t>(j) * p.dk_sl + d] =
            repro::from_float<T>(dk[r][c]);
        dvb[static_cast<int64_t>(j) * p.dv_sl + d] =
            repro::from_float<T>(dv[r][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const Params p) {
  using TL = BwdTile<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, DS = TL::DS, PS = TL::PS;
  constexpr int RQ = TL::RQ, DB = TL::DB;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BQ][DS]
  float* do_s = q_s + BQ * DS;                   // [BQ][DS]
  float* k_s = do_s + BQ * DS;                   // [BK][DS]
  float* v_s = k_s + BK * DS;                    // [BK][DS]
  float* ds_s = v_s + BK * DS;                   // [BQ][PS]
  float* lse_s = ds_s + BQ * PS;                 // [BQ]
  float* delta_s = lse_s + BQ;                   // [BQ]

  const int q0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y / p.G, g = blockIdx.y % p.G;
  const int b = blockIdx.z;
  const int q_offset = p.Lk - p.Lq;
  const int ty = threadIdx.x / kTX, dx = threadIdx.x % kTX;

  stage_rows<T, D>(q_s, static_cast<const T*>(p.q) + b * p.q_sb +
                            kvh * p.q_sk + g * p.q_sg, p.q_sl, q0, BQ, p.Lq);
  stage_rows<T, D>(do_s, static_cast<const T*>(p.dout) + b * p.do_sb +
                             kvh * p.do_sk + g * p.do_sg, p.do_sl, q0, BQ,
                   p.Lq);
  const int64_t row = (static_cast<int64_t>(b) * p.KV + kvh) * p.G + g;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    lse_s[i] = q0 + i < p.Lq ? p.lse[row * p.Lq + q0 + i] : 0.f;
    delta_s[i] = q0 + i < p.Lq ? p.delta[row * p.Lq + q0 + i] : 0.f;
  }
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sk;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sk;

  // key range that at least one query row of this block attends
  const int q_end = min(q0 + BQ, p.Lq);
  int k_hi = p.Lk;
  if (p.causal) k_hi = min(k_hi, q_offset + q_end);
  int k_lo = 0;
  if (p.window >= 0) k_lo = max(0, q_offset + q0 - p.window + 1);
  k_lo = (k_lo / BK) * BK;

  float dq[RQ][DB];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < DB; ++c) dq[r][c] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; q tile staged
    stage_rows<T, D>(k_s, kb, p.k_sl, k0, BK, p.Lk);
    stage_rows<T, D>(v_s, vb, p.v_sl, k0, BK, p.Lk);
    __syncthreads();
    tile_p_ds<D>(p, q_s, do_s, k_s, v_s, lse_s, delta_s, nullptr, ds_s, q0,
                 k0);
    __syncthreads();
    // dQ += dS K: thread owns rows ty*RQ.. and dims dx + 16c
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 dsv[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) dsv[r] = ld4(&ds_s[(ty * RQ + r) * PS + j]);
#pragma unroll
      for (int c = 0; c < DB; ++c) {
        const float k_0 = k_s[(j + 0) * DS + dx + c * kTX];
        const float k_1 = k_s[(j + 1) * DS + dx + c * kTX];
        const float k_2 = k_s[(j + 2) * DS + dx + c * kTX];
        const float k_3 = k_s[(j + 3) * DS + dx + c * kTX];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          float a = dq[r][c];
          a = fmaf(dsv[r].x, k_0, a);
          a = fmaf(dsv[r].y, k_1, a);
          a = fmaf(dsv[r].z, k_2, a);
          dq[r][c] = fmaf(dsv[r].w, k_3, a);
        }
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq) + b * p.dq_sb + kvh * p.dq_sk + g * p.dq_sg;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = q0 + ty * RQ + r;
    if (i < p.Lq) {
#pragma unroll
      for (int c = 0; c < DB; ++c)
        dqb[static_cast<int64_t>(i) * p.dq_sl + dx + c * kTX] =
            repro::from_float<T>(dq[r][c]);
    }
  }
}

template <typename T, int D>
int launch_dkv(const Params& p, cudaStream_t stream) {
  using TL = BwdTile<D>;
  static bool configured = false;  // dynamic shared memory above 48 KB
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TL::dkv_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((p.Lk + TL::BK - 1) / TL::BK, p.KV, p.B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, TL::dkv_smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const Params& p, cudaStream_t stream) {
  using TL = BwdTile<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TL::dq_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((p.Lq + TL::BQ - 1) / TL::BQ, p.KV * p.G, p.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, TL::dq_smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 on the tensor cores (see the note at the top) ----

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct MmaBwd {
  static constexpr int RS = D + 8;                // padded shared row (bf16)
  // dK/dV: 64 keys per block (4 warps x 16), query tiles of QT streamed
  static constexpr int KT = 64;
  static constexpr int QT = D >= 128 ? 32 : 64;
  static constexpr int dkv_smem =
      static_cast<int>(sizeof(bf16)) * (2 * KT * RS + 4 * QT * RS) +
      static_cast<int>(sizeof(float)) * 4 * QT;
  // dQ: 64 query rows per block (4 warps x 16), key tiles of KB streamed
  static constexpr int QB = 64;
  static constexpr int KB = D >= 128 ? 32 : 64;
  // dQ keeps its Q and dO fragments in registers up to D = 128; at D = 192
  // they would add 96 registers a thread to dQ's 96, so each key tile
  // reloads them from the staged tiles
  static constexpr bool kQRegs = D <= 128;
  // dK and dV together are 2 x 96 registers a thread at D = 192: there
  // two kernels split them (one writes dV, the other dK)
  static constexpr bool kSplitDkv = D > 128;
  static constexpr int dq_smem =
      static_cast<int>(sizeof(bf16)) * (2 * QB * RS + 4 * KB * RS) +
      static_cast<int>(sizeof(float)) * 2 * QB;
};

__device__ __forceinline__ float lse_log2(float lse) {
  return (lse <= REPRO_NEG_INF / 2 ? 0.f : lse) * kLog2e;
}

// does the (query tile q0.., key tile k0..) pair hold a masked element?
__device__ __forceinline__ bool edge_tile(const Params& p, int q0, int qn,
                                          int k0, int kn) {
  const int q_offset = p.Lk - p.Lq;
  return q0 + qn > p.Lq || k0 + kn > p.Lk ||
         (p.causal && k0 + kn - 1 > q_offset + q0) ||
         (p.window >= 0 && q_offset + q0 + qn - 1 - k0 >= p.window);
}

__device__ __forceinline__ bool attends(const Params& p, int qi, int kpos) {
  const int qpos = p.Lk - p.Lq + qi;
  return qi < p.Lq && kpos < p.Lk && (!p.causal || qpos >= kpos) &&
         (p.window < 0 || qpos - kpos < p.window);
}

// ROLE: kBoth writes dK and dV; kOnlyDv / kOnlyDk one of them (D = 192)
enum DkvRole { kBoth = 0, kOnlyDv = 1, kOnlyDk = 2 };

template <int D, int ROLE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_mma_kernel(
    const Params p) {
  using namespace repro::mma;
  using TL = MmaBwd<D>;
  constexpr int RS = TL::RS, KT = TL::KT, QT = TL::QT;
  constexpr int KD = D / 16;   // k-steps over D
  constexpr int NS = QT / 8;   // query n-tiles of S^T
  constexpr int NO = D / 8;    // dim n-tiles of dK, dV
  constexpr bool kDv = ROLE != kOnlyDk, kDk = ROLE != kOnlyDv;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [KT][RS]
  bf16* v_s = k_s + KT * RS;                       // [KT][RS]
  bf16* q_s = v_s + KT * RS;                       // [2][QT][RS]
  bf16* do_s = q_s + 2 * QT * RS;                  // [2][QT][RS]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * QT * RS);  // [2][QT]
  float* delta_s = lse_s + 2 * QT;                               // [2][QT]

  const int k0 = blockIdx.x * KT;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int q_offset = p.Lk - p.Lq;
  const float scale_log2 = p.scale * kLog2e;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + kvh * p.q_sk;
  const bf16* gb =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + kvh * p.do_sk;
  const int64_t row0 = (static_cast<int64_t>(b) * p.KV + kvh) * p.G * p.Lq;

  load_rows<KT, D, RS, kThreads>(
      k_s, static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sk, p.k_sl,
      k0, p.Lk);
  load_rows<KT, D, RS, kThreads>(
      v_s, static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sk, p.v_sl,
      k0, p.Lk);

  // query rows that attend at least one key of this tile
  int q_lo = 0, q_hi = p.Lq;
  if (p.causal) q_lo = max(0, k0 - q_offset);
  if (p.window >= 0) q_hi = min(q_hi, k0 + KT - 1 + p.window - q_offset);
  q_lo = (q_lo / QT) * QT;
  const int nq = q_hi > q_lo ? (q_hi - q_lo + QT - 1) / QT : 0;
  const int total = p.G * nq;  // (head, query tile) steps

  // Q, dO, lse and delta of step `it` into stage `st`
  auto issue = [&](int it, int st) {
    const int g = it / nq, q0 = q_lo + (it % nq) * QT;
    load_rows<QT, D, RS, kThreads>(q_s + st * QT * RS, qb + g * p.q_sg,
                                   p.q_sl, q0, p.Lq);
    load_rows<QT, D, RS, kThreads>(do_s + st * QT * RS, gb + g * p.do_sg,
                                   p.do_sl, q0, p.Lq);
    for (int i = threadIdx.x; i < QT; i += kThreads) {
      const bool in = q0 + i < p.Lq;
      const int64_t at = row0 + static_cast<int64_t>(g) * p.Lq +
                         (in ? q0 + i : 0);
      cp_async_4(smem_addr(lse_s + st * QT + i), p.lse + at, in);
      cp_async_4(smem_addr(delta_s + st * QT + i), p.delta + at, in);
    }
  };
  if (total > 0) issue(0, 0);
  cp_async_commit();

  float dk[kDk ? NO : 1][4], dv[kDv ? NO : 1][4];
#pragma unroll
  for (int n = 0; n < (kDk ? NO : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < (kDv ? NO : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;
  const int key_row = k0 + warp * 16 + gid;  // and key_row + 8

  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    const int q0 = q_lo + (it % nq) * QT;
    if (it + 1 < total) issue(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // step `it` (and, first, K and V) landed
    __syncthreads();
    const bf16* qs = q_s + st * QT * RS;
    const bf16* dos = do_s + st * QT * RS;
    const float* lses = lse_s + st * QT;
    const float* deltas = delta_s + st * QT;

    // S^T = K Q^T: 16 keys x QT queries per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4];
      ldmatrix_x4(ka, smem_addr(k_s + (warp * 16 + (lane & 15)) * RS +
                                kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bq[4];
        ldmatrix_x4(bq, smem_addr(qs + (np * 16 + (lane & 7) +
                                        ((lane >> 4) << 3)) * RS +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
      }
    }

    // P^T = exp(S^T scale - lse), 0 where masked
    const bool edge = edge_tile(p, q0, QT, k0, KT);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tig + (e & 1);
        float pv = exp2_approx(fmaf(s[n][e], scale_log2,
                                    -lse_log2(lses[col])));
        if (edge && !attends(p, q0 + col, key_row + (e >> 1) * 8)) pv = 0.f;
        s[n][e] = pv;
      }
    }

    // dV += P^T dO, dO through ldmatrix.trans
    if constexpr (kDv) {
#pragma unroll
      for (int j = 0; j < QT / 16; ++j) {
        uint32_t pa[4];
        pack_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bo[4];
          ldmatrix_x4_trans(bo, smem_addr(dos + (j * 16 + (lane & 7) +
                                                 ((lane >> 3) & 1) * 8) * RS +
                                          dp * 16 + (lane >> 4) * 8));
          mma_bf16(dv[2 * dp], pa, bo[0], bo[1]);
          mma_bf16(dv[2 * dp + 1], pa, bo[2], bo[3]);
        }
      }
    }
    if constexpr (kDk) {
      // dP^T = V dO^T
      float dpt[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t va[4];
        ldmatrix_x4(va, smem_addr(v_s + (warp * 16 + (lane & 15)) * RS +
                                  kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bo[4];
          ldmatrix_x4(bo, smem_addr(dos + (np * 16 + (lane & 7) +
                                           ((lane >> 4) << 3)) * RS +
                                    kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(dpt[2 * np], va, bo[0], bo[1]);
          mma_bf16(dpt[2 * np + 1], va, bo[2], bo[3]);
        }
      }

      // dS^T = P^T (dP^T - delta) scale
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[n][e] = s[n][e] *
                      (dpt[n][e] - deltas[n * 8 + 2 * tig + (e & 1)]) *
                      p.scale;

      // dK += dS^T Q, Q through ldmatrix.trans
#pragma unroll
      for (int j = 0; j < QT / 16; ++j) {
        uint32_t da[4];
        pack_a(da, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, smem_addr(qs + (j * 16 + (lane & 7) +
                                                ((lane >> 3) & 1) * 8) * RS +
                                          dp * 16 + (lane >> 4) * 8));
          mma_bf16(dk[2 * dp], da, bq[0], bq[1]);
          mma_bf16(dk[2 * dp + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (total = 0: K and V)

  bf16* dkb = static_cast<bf16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sk;
  bf16* dvb = static_cast<bf16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key_row + r * 8;
    if (j < p.Lk) {
      bf16* dkr = dkb + static_cast<int64_t>(j) * p.dk_sl + 2 * tig;
      bf16* dvr = dvb + static_cast<int64_t>(j) * p.dv_sl + 2 * tig;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if constexpr (kDk)
          *reinterpret_cast<uint32_t*>(dkr + n * 8) =
              pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
        if constexpr (kDv)
          *reinterpret_cast<uint32_t*>(dvr + n * 8) =
              pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma_kernel(
    const Params p) {
  using namespace repro::mma;
  using TL = MmaBwd<D>;
  constexpr int RS = TL::RS, QB = TL::QB, KB = TL::KB;
  constexpr int KD = D / 16;   // k-steps over D
  constexpr int NS = KB / 8;   // key n-tiles of S
  constexpr int NO = D / 8;    // dim n-tiles of dQ
  constexpr bool kQRegs = TL::kQRegs;
  constexpr int KDR = kQRegs ? KD : 1;  // Q / dO fragments in registers
  constexpr int KV_TILE = KB * RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [QB][RS]
  bf16* do_s = q_s + QB * RS;                      // [QB][RS]
  bf16* k_s = do_s + QB * RS;                      // [2][KB][RS]
  bf16* v_s = k_s + 2 * KV_TILE;                   // [2][KB][RS]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * KV_TILE);  // [QB]
  float* delta_s = lse_s + QB;                                  // [QB]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * QB;  // longest rows first
  const int kvh = blockIdx.y / p.G, g = blockIdx.y % p.G;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int q_offset = p.Lk - p.Lq;
  const float scale_log2 = p.scale * kLog2e;

  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sk;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sk;
  load_rows<QB, D, RS, kThreads>(
      q_s, static_cast<const bf16*>(p.q) + b * p.q_sb + kvh * p.q_sk +
               g * p.q_sg, p.q_sl, q0, p.Lq);
  load_rows<QB, D, RS, kThreads>(
      do_s, static_cast<const bf16*>(p.dout) + b * p.do_sb + kvh * p.do_sk +
                g * p.do_sg, p.do_sl, q0, p.Lq);
  const int64_t row0 =
      ((static_cast<int64_t>(b) * p.KV + kvh) * p.G + g) * p.Lq;
  for (int i = threadIdx.x; i < QB; i += kThreads) {
    const bool in = q0 + i < p.Lq;
    const int64_t at = row0 + (in ? q0 + i : 0);
    cp_async_4(smem_addr(lse_s + i), p.lse + at, in);
    cp_async_4(smem_addr(delta_s + i), p.delta + at, in);
  }

  // key range that at least one query row of this block attends
  const int q_end = min(q0 + QB, p.Lq);
  int k_hi = p.Lk;
  if (p.causal) k_hi = min(k_hi, q_offset + q_end);
  int k_lo = 0;
  if (p.window >= 0) k_lo = max(0, q_offset + q0 - p.window + 1);
  k_lo = (k_lo / KB) * KB;
  const int n_tiles = (k_hi - k_lo + KB - 1) / KB;
  load_rows<KB, D, RS, kThreads>(k_s, kb, p.k_sl, k_lo, p.Lk);
  load_rows<KB, D, RS, kThreads>(v_s, vb, p.v_sl, k_lo, p.Lk);
  cp_async_commit();

  const int row_q = q0 + warp * 16 + gid;  // and row_q + 8
  uint32_t qf[KDR][4], gf[KDR][4];
  float lse2[2], dl[2];
  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * KB;
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_rows<KB, D, RS, kThreads>(k_s + (st ^ 1) * KV_TILE, kb, p.k_sl,
                                     k0 + KB, p.Lk);
      load_rows<KB, D, RS, kThreads>(v_s + (st ^ 1) * KV_TILE, vb, p.v_sl,
                                     k0 + KB, p.Lk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, first, Q, dO, lse, delta) landed
    __syncthreads();
    if (t == 0) {
      if constexpr (kQRegs) {
#pragma unroll
        for (int kk = 0; kk < KDR; ++kk) {
          const int off = (warp * 16 + (lane & 15)) * RS + kk * 16 +
                          (lane >> 4) * 8;
          ldmatrix_x4(qf[kk], smem_addr(q_s + off));
          ldmatrix_x4(gf[kk], smem_addr(do_s + off));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = lse_log2(lse_s[warp * 16 + gid + r * 8]);
        dl[r] = delta_s[warp * 16 + gid + r * 8];
      }
    }
    const bf16* ks = k_s + st * KV_TILE;
    const bf16* vs = v_s + st * KV_TILE;

    // S = Q K^T and dP = dO V^T: 16 rows x KB keys per warp
    float s[NS][4], dpv[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dpv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], ga[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e], ga[e] = gf[kk][e];
      } else {
        const int off = (warp * 16 + (lane & 15)) * RS + kk * 16 +
                        (lane >> 4) * 8;
        ldmatrix_x4(qa, smem_addr(q_s + off));
        ldmatrix_x4(ga, smem_addr(do_s + off));
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, smem_addr(ks + off));
        ldmatrix_x4(bv, smem_addr(vs + off));
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        mma_bf16(dpv[2 * np], ga, bv[0], bv[1]);
        mma_bf16(dpv[2 * np + 1], ga, bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta) scale with P = exp(S scale - lse), 0 where masked
    const bool edge = edge_tile(p, q0, QB, k0, KB);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pv = exp2_approx(fmaf(s[n][e], scale_log2, -lse2[r]));
        if (edge && !attends(p, row_q + r * 8, k0 + n * 8 + 2 * tig + (e & 1)))
          pv = 0.f;
        dpv[n][e] = pv * (dpv[n][e] - dl[r]) * p.scale;
      }
    }

    // dQ += dS K, K through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < KB / 16; ++j) {
      uint32_t da[4];
      pack_a(da, dpv[2 * j], dpv[2 * j + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, smem_addr(ks + (j * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) * RS +
                                        dp * 16 + (lane >> 4) * 8));
        mma_bf16(dq[2 * dp], da, bk[0], bk[1]);
        mma_bf16(dq[2 * dp + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  bf16* dqb = static_cast<bf16*>(p.dq) + b * p.dq_sb + kvh * p.dq_sk +
              g * p.dq_sg;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_q + r * 8;
    if (i < p.Lq) {
      bf16* dqr = dqb + static_cast<int64_t>(i) * p.dq_sl + 2 * tig;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(dqr + n * 8) =
            pack_bf16(dq[n][2 * r], dq[n][2 * r + 1]);
    }
  }
}

template <int D>
int launch_mma(const Params& p, bool dkv, cudaStream_t stream) {
  using TL = MmaBwd<D>;
  static bool configured = false;  // dynamic shared memory above 48 KB
  if (!configured) {
    cudaError_t e = cudaSuccess;
    auto attr = [&](const void* fn, int bytes) {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    };
    if constexpr (TL::kSplitDkv) {
      attr(reinterpret_cast<const void*>(flash_bwd_dkv_mma_kernel<D, kOnlyDv>),
           TL::dkv_smem);
      attr(reinterpret_cast<const void*>(flash_bwd_dkv_mma_kernel<D, kOnlyDk>),
           TL::dkv_smem);
    } else {
      attr(reinterpret_cast<const void*>(flash_bwd_dkv_mma_kernel<D, kBoth>),
           TL::dkv_smem);
    }
    attr(reinterpret_cast<const void*>(flash_bwd_dq_mma_kernel<D>),
         TL::dq_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  if (dkv) {
    const dim3 grid((p.Lk + TL::KT - 1) / TL::KT, p.KV, p.B);
    if constexpr (TL::kSplitDkv) {  // two kernels: dV, then dK
      flash_bwd_dkv_mma_kernel<D, kOnlyDv>
          <<<grid, kThreads, TL::dkv_smem, stream>>>(p);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      flash_bwd_dkv_mma_kernel<D, kOnlyDk>
          <<<grid, kThreads, TL::dkv_smem, stream>>>(p);
    } else {
      flash_bwd_dkv_mma_kernel<D, kBoth>
          <<<grid, kThreads, TL::dkv_smem, stream>>>(p);
    }
  } else {
    const dim3 grid((p.Lq + TL::QB - 1) / TL::QB, p.KV * p.G, p.B);
    flash_bwd_dq_mma_kernel<D><<<grid, kThreads, TL::dq_smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int D, bool dkv, bool mma, cudaStream_t s) {
  switch (D) {
    case 32:
      return mma ? launch_mma<32>(p, dkv, s)
                 : (dkv ? launch_dkv<float, 32>(p, s)
                        : launch_dq<float, 32>(p, s));
    case 64:
      return mma ? launch_mma<64>(p, dkv, s)
                 : (dkv ? launch_dkv<float, 64>(p, s)
                        : launch_dq<float, 64>(p, s));
    case 128:
      return mma ? launch_mma<128>(p, dkv, s)
                 : (dkv ? launch_dkv<float, 128>(p, s)
                        : launch_dq<float, 128>(p, s));
    case 192:
      return mma ? launch_mma<192>(p, dkv, s)
                 : (dkv ? launch_dkv<float, 192>(p, s)
                        : launch_dq<float, 192>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cp.async moves 16-byte chunks: every bf16 base pointer 16-byte aligned
// and every stride but D's a multiple of 8 elements
bool aligned(const Params& p) {
  const int64_t st[] = {p.q_sb,  p.q_sk,  p.q_sg,  p.q_sl,  p.k_sb,  p.k_sk,
                        p.k_sl,  p.v_sb,  p.v_sk,  p.v_sl,  p.do_sb, p.do_sk,
                        p.do_sg, p.do_sl, p.dq_sb, p.dq_sk, p.dq_sg, p.dq_sl,
                        p.dk_sb, p.dk_sk, p.dk_sl, p.dv_sb, p.dv_sk, p.dv_sl};
  for (const int64_t s : st)
    if (s % 8 != 0) return false;
  const void* ptrs[] = {p.q, p.k, p.v, p.dout, p.dq, p.dk, p.dv};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  return true;
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* delta, void* dq,
        void* dk, void* dv, const int64_t* st, int B, int KV, int G, int Lq,
        int Lk, int D, int causal, int window, float scale, int dtype,
        void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_sb = st[0], p.q_sk = st[1], p.q_sg = st[2], p.q_sl = st[3];
  p.k_sb = st[4], p.k_sk = st[5], p.k_sl = st[6];
  p.v_sb = st[7], p.v_sk = st[8], p.v_sl = st[9];
  p.do_sb = st[10], p.do_sk = st[11], p.do_sg = st[12], p.do_sl = st[13];
  p.dq_sb = st[14], p.dq_sk = st[15], p.dq_sg = st[16], p.dq_sl = st[17];
  p.dk_sb = st[18], p.dk_sk = st[19], p.dk_sl = st[20];
  p.dv_sb = st[21], p.dv_sk = st[22], p.dv_sl = st[23];
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return dispatch(p, D, dkv, false, s);
  if (dtype == repro::kBF16) {
    if (!aligned(p)) return static_cast<int>(cudaErrorMisalignedAddress);
    return dispatch(p, D, dkv, true, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides (elements), 24 values: q (b, kv, g, l), k (b, kv, l),
// v (b, kv, l), dO (b, kv, g, l), dQ (b, kv, g, l), dK (b, kv, l),
// dV (b, kv, l); the D axis has unit stride everywhere.  window < 0 means
// no sliding window.  Each entry point launches one kernel and returns a
// cudaError_t code.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    const int64_t* strides, int B, int KV, int G, int Lq, int Lk, int D,
    int causal, int window, float scale, int dtype, void* stream) {
  return run(true, q, k, v, dout, lse, delta, dq, dk, dv, strides, B, KV, G,
             Lq, Lk, D, causal, window, scale, dtype, stream);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    const int64_t* strides, int B, int KV, int G, int Lq, int Lk, int D,
    int causal, int window, float scale, int dtype, void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, dk, dv, strides, B, KV, G,
             Lq, Lk, D, causal, window, scale, dtype, stream);
}
