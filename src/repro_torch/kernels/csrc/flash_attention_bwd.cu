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
// fp32.
//
// Bound on the H100: at the OPT-1.3B training shape (B = 8, H = KV = 32,
// L = 512, D = 64, causal) the function moves ~118 MB in bf16 (q, dO, dQ,
// k, v, dK, dV once each, plus lse and delta) and needs ~10 D FLOP for each
// of the ~34 M unmasked (query, key) pairs: ~21 GFLOP, ~21 us on the
// tensor cores, so the bytes bound it at ~35 us.  This first kernel does
// its products on the CUDA cores in fp32 (no mma.sync / wgmma, no TMA):
// right first, fast later.
// What it keeps out of device memory is every (Lq, Lk) tile: the
// probabilities are recomputed from lse, p = exp(s - lse), and live in
// shared memory only for the tile at hand.
//
// Design, two kernels in this source, two launches per call:
//
// * dK/dV: one block per (b, kv_head, BK-key tile).  K and V of the tile
//   are staged in shared memory once; the block then walks all G query
//   heads of the group and every BQ-query tile that attends at least one
//   of its keys, so GQA's sum over the group stays inside the block: no
//   atomics, and the result does not depend on scheduling.
// * dQ: one block per (b, kv_head, g, BQ-query tile), walking the key
//   tiles its rows attend.
//
// Each tile step: stage the operand tiles as fp32 in shared memory (rows
// padded by 4 floats, which keeps 16-byte alignment for float4 reads and
// spreads a quarter-warp's rows over all 32 banks); each thread computes an
// 8-row slice of S = Q K^T and dP = dO V^T; p and ds = p (dp - delta) scale
// go to shared memory; then dV += P^T dO, dK += dS^T Q (or dQ += dS K) with
// each thread owning a register block of the output.  Masking follows the
// reference: p is exactly 0 where the causal / window mask, the ragged
// edge of either axis, or a row past Lq removes the pair, and a row whose
// lse is the finite mask value (-1e30) takes lse = 0.  Key tiles that
// every row of a dQ block masks, and query tiles that attend no key of a
// dK/dV block, are skipped, so no block size has to divide Lq or Lk.
#include "common.cuh"

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

template <typename T>
int dispatch(const Params& p, int D, bool dkv, cudaStream_t s) {
  switch (D) {
    case 32: return dkv ? launch_dkv<T, 32>(p, s) : launch_dq<T, 32>(p, s);
    case 64: return dkv ? launch_dkv<T, 64>(p, s) : launch_dq<T, 64>(p, s);
    case 128: return dkv ? launch_dkv<T, 128>(p, s) : launch_dq<T, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (dtype == repro::kF32) return dispatch<float>(p, D, dkv, s);
  if (dtype == repro::kBF16) return dispatch<__nv_bfloat16>(p, D, dkv, s);
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
