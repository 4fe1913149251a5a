// Flash attention forward (prefill and training): causal / sliding-window
// GQA attention with an online softmax, queries aligned to the END of the
// keys (qpos = q_offset + i with q_offset = Lk - Lq).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
// (Pallas TPU kernel).
//
// Layout: q (B, KV, G, Lq, D), k/v (B, KV, Lk, D), out like q, each taken
// through its strides with a unit stride along D.  The model's
// (B, L, H, D) activations are passed as permuted views, so no layout copy
// is made (see kernels/ops.py).  Given a non-null `lse`, each row's
// log-sum-exp m + log(max(l, 1e-20)) also goes into a contiguous
// (B, KV, G, Lq) fp32 tensor, straight from the registers that hold the
// running max and sum; the backward kernels (flash_attention_bwd.cu)
// recompute the probabilities from it.  The output does not depend on
// whether the LSE is asked for.
//
// Two kernels, chosen by dtype, both hand-written: bf16 runs on the tensor
// cores (flash_fwd_mma_kernel), fp32 on the CUDA cores (flash_fwd_kernel,
// whose note is below).  A call neither takes is refused, never rerouted.
//
// ---- bf16: flash_fwd_mma_kernel ------------------------------------------
//
// Bound on the H100: at the OPT-1.3B training shape (B = 8, H = KV = 32,
// L = 512, D = 64, causal) the function moves 67 MB (q, k, v, out once
// each) and needs 4 D FLOP for each of the 34 M unmasked (query, key)
// pairs, 8.6 GFLOP: 20 us of bytes at 3.35 TB/s against 8.7 us of bf16
// tensor-core work, so the bytes bound it.  The (Lq, Lk) score matrix never
// leaves the registers.
//
// Design (FlashAttention-2 on mma.sync): one block of 4 warps per
// (b, kv_head, g, 64-query tile); each warp owns 16 query rows, whose Q
// fragments it loads once (ldmatrix) and keeps in registers.  K and V
// stream through shared memory in 64-key tiles by 16-byte cp.async in a
// two-stage ring, so the next tile's copy overlaps this tile's math.  Rows
// are padded by 8 bf16 (a 16-byte shift per row), which keeps every
// ldmatrix phase on 32 distinct banks.  S = Q K^T is mma.sync m16n8k16
// (bf16 operands, fp32 accumulators) with K as the B operand; the online
// softmax runs on the accumulator fragments (base 2, scale folded into one
// multiply), each row's max reduced over the 4 lanes that hold it; P is
// rounded to bf16 and reused in registers as the A operand of P V (the
// accumulator layout of two n-tiles is the A layout of one k-step), with V
// through ldmatrix.trans.  Masks follow the reference: -1e30 for causal /
// window, -inf past Lk; element masks run only on tiles that touch the
// diagonal, the window edge or the ragged edge, and tiles that no row of
// the block attends are skipped.  Rows past Lq are zero-filled, computed
// and not stored, so no block size has to divide Lq or Lk.  Every operand
// must be 16-byte aligned with row, head and batch strides that are
// multiples of 8 elements (the wrapper checks and raises).
//
// Head dim 192 (MLA's 128 + 64 query/key dims, V zero-padded to 192 by the
// caller): a warp's O accumulator is 16 x 192 fp32, 96 registers a thread
// against 64 at D = 128.  So at D = 192 the kernel streams 32-key tiles (S
// is 16 registers, not 32) and reloads the Q fragments from the staged Q
// tile at each key tile instead of holding 48 more registers for the whole
// walk; shared memory is 2 (64 + 4 x 32) x 200 bf16 = 76.8 KB, two blocks
// an SM.  Non-causal calls may have Lq > Lk (cross-attention over encoder
// keys: the query offset is then negative, and nothing reads it).
//
// ---- fp32: flash_fwd_kernel ----------------------------------------------
//
// At the admission shape (B = 1, H = KV = 32, D = 64, Lq = Lk = 256,
// causal) the function moves ~8 MB in fp32 and needs ~0.27 GFLOP, which
// the fp32 rate (67 TFLOP/s) bounds.  The kernel does its products on the
// CUDA cores in fp32 (the fp32 gates hold the port to 1e-4, which bf16
// operands would not meet).
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
#include "common.cuh"
#include "mma.cuh"

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

// ---- bf16 on the tensor cores (see the note at the top) ----

using bf16 = __nv_bfloat16;
constexpr int kMmaBQ = 64;   // query rows per block: 4 warps x 16
constexpr int kMmaBK = 64;   // keys per streamed tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct MmaTile {
  // keys per streamed tile: 32 at D = 192, where a warp's O accumulator
  // alone is 96 registers a thread and the S tile must stay small
  static constexpr int BK = D > 128 ? 32 : kMmaBK;
  // Q fragments held in registers for the whole key walk up to D = 128; at
  // D = 192 they would add 48 registers a thread to O's 96, so each tile
  // reloads them from the staged Q tile (ldmatrix, no global traffic)
  static constexpr bool kQRegs = D <= 128;
  static constexpr int RS = D + 8;           // padded shared row (bf16)
  static constexpr int KV_TILE = BK * RS;    // one K or V stage
  static constexpr int smem_bytes =
      static_cast<int>(sizeof(bf16)) * (kMmaBQ * RS + 4 * KV_TILE);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma_kernel(
    const Params p) {
  using namespace repro::mma;
  constexpr int RS = MmaTile<D>::RS, KV_TILE = MmaTile<D>::KV_TILE;
  constexpr int BK = MmaTile<D>::BK;
  constexpr bool kQRegs = MmaTile<D>::kQRegs;
  constexpr int KD = D / 16;       // k-steps over D
  constexpr int NS = BK / 8;       // key n-tiles of S
  constexpr int NO = D / 8;        // dim n-tiles of O
  constexpr int KDR = kQRegs ? KD : 1;  // Q fragments kept in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kMmaBQ][RS]
  bf16* k_s = q_s + kMmaBQ * RS;                   // [2][BK][RS]
  bf16* v_s = k_s + 2 * KV_TILE;                   // [2][BK][RS]

  // the last query tiles attend the most keys under a causal mask: they
  // are scheduled first, so the short ones fill the tail of the grid
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;
  const int kvh = blockIdx.y / p.G, g = blockIdx.y % p.G;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int q_offset = p.Lk - p.Lq;
  const float scale_log2 = p.scale * kLog2e;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb +
                   kvh * p.q_sk + g * p.q_sg;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sk;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sk;
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + kvh * p.o_sk +
             g * p.o_sg;

  // key range that at least one query row of this block attends
  const int q_end = min(q0 + kMmaBQ, p.Lq);
  int k_hi = p.Lk;
  if (p.causal) k_hi = min(k_hi, q_offset + q_end);
  int k_lo = 0;
  if (p.window >= 0) k_lo = max(0, q_offset + q0 - p.window + 1);
  k_lo = (k_lo / BK) * BK;
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  load_rows<kMmaBQ, D, RS, kThreads>(q_s, qb, p.q_sl, q0, p.Lq);
  load_rows<BK, D, RS, kThreads>(k_s, kb, p.k_sl, k_lo, p.Lk);
  load_rows<BK, D, RS, kThreads>(v_s, vb, p.v_sl, k_lo, p.Lk);
  cp_async_commit();

  // this thread's two rows: r = 0 -> gid, r = 1 -> gid + 8 of the warp's 16
  const int row_q = q0 + warp * 16 + gid;
  uint32_t qf[KDR][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * BK;
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_rows<BK, D, RS, kThreads>(k_s + (st ^ 1) * KV_TILE, kb,
                                         p.k_sl, k0 + BK, p.Lk);
      load_rows<BK, D, RS, kThreads>(v_s + (st ^ 1) * KV_TILE, vb,
                                         p.v_sl, k0 + BK, p.Lk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, at t = 0, the Q tile) landed
    __syncthreads();
    if (kQRegs && t == 0) {
#pragma unroll
      for (int kk = 0; kk < KDR; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(q_s + (warp * 16 + (lane & 15)) * RS +
                                      kk * 16 + (lane >> 4) * 8));
    }

    // S = Q K^T: 16 rows x 64 keys per warp
    const bf16* ks = k_s + st * KV_TILE;
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, smem_addr(q_s + (warp * 16 + (lane & 15)) * RS +
                                  kk * 16 + (lane >> 4) * 8));
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(ks + (np * 16 + (lane & 7) +
                                        ((lane >> 4) << 3)) * RS +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
      }
    }

    // mask (only where the tile touches an edge) and online softmax, base 2
    const bool edge =
        k0 + BK > p.Lk ||
        (p.causal && k0 + BK - 1 > q_offset + q0) ||
        (p.window >= 0 && q_offset + q0 + kMmaBQ - 1 - k0 >= p.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[n][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * tig + (e & 1);
          const int qpos = q_offset + row_q + (e >> 1) * 8;
          if (kpos >= p.Lk) {
            v = -INFINITY;  // ragged edge: not a key at all
          } else if ((p.causal && qpos < kpos) ||
                     (p.window >= 0 && qpos - kpos >= p.window)) {
            v = REPRO_NEG_INF;
          }
        }
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];  // per-lane partial sums; the quad's sum at the end
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P from the S fragments, V through ldmatrix.trans
    const bf16* vs = v_s + st * KV_TILE;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pa[4];
      pack_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(vs + (j * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) * RS +
                                        dp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lsum = fmaxf(l[r], 1e-20f);
    const float inv = 1.f / lsum;
    const int row = row_q + r * 8;
    if (row < p.Lq) {
      bf16* orow = ob + static_cast<int64_t>(row) * p.o_sl + 2 * tig;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      if (p.lse != nullptr && tig == 0)
        p.lse[(static_cast<int64_t>(b * p.KV + kvh) * p.G + g) * p.Lq + row] =
            m[r] * kLn2 + logf(lsum);
    }
  }
}

template <int D>
int launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int smem = MmaTile<D>::smem_bytes;
  static bool configured = false;  // dynamic shared memory above 48 KB
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((p.Lq + kMmaBQ - 1) / kMmaBQ, p.KV * p.G, p.B);
  flash_fwd_mma_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32 on the CUDA cores ----

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

int dispatch_d(const Params& p, int D, bool mma, cudaStream_t stream) {
  switch (D) {
    case 32: return mma ? launch_mma<32>(p, stream) : launch<float, 32>(p, stream);
    case 64: return mma ? launch_mma<64>(p, stream) : launch<float, 64>(p, stream);
    case 128:
      return mma ? launch_mma<128>(p, stream) : launch<float, 128>(p, stream);
    case 192:
      return mma ? launch_mma<192>(p, stream) : launch<float, 192>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cp.async moves 16-byte chunks: every bf16 base pointer 16-byte aligned
// and every stride but D's a multiple of 8 elements
bool aligned(const Params& p) {
  const int64_t st[] = {p.q_sb, p.q_sk, p.q_sg, p.q_sl, p.k_sb, p.k_sk,
                        p.k_sl, p.v_sb, p.v_sk, p.v_sl, p.o_sb, p.o_sk,
                        p.o_sg, p.o_sl};
  for (const int64_t s : st)
    if (s % 8 != 0) return false;
  const void* ptrs[] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  return true;
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
  if (dtype == repro::kF32) return dispatch_d(p, D, false, s);
  if (dtype == repro::kBF16) {
    if (!aligned(p)) return static_cast<int>(cudaErrorMisalignedAddress);
    return dispatch_d(p, D, true, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
