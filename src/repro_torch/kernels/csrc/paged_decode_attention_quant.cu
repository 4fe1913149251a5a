// Int8 paged decode attention forward: one query token per sequence attends
// to the first lens[b] rows of its int8 KV, which live in a shared pool of
// fixed-size blocks reached through the sequence's block table, with the
// per-row fp32 scales fused into the online softmax.
//
// Replaces:
// src/repro/kernels/paged_attention.py::paged_decode_attention_quant_fwd
// (Pallas TPU kernel).
//
// What it computes (the reference's algebra, never an fp copy of K/V):
//   s[g, r] = (q[g] . k_i8[r]) / sqrt(D) * k_scale[r]
//   p       = online softmax of s over the lens[b] valid rows, in fp32
//   acc[g] += (p[g, r] * v_scale[r]) * v_i8[r]
// where row r of sequence b, and its two scales, live at
// [table[b, r / bs], r % bs] of the pools and scale planes.
//
// Layout: q (B, KV, G, D) bf16 or fp32; k/v pool (nblocks, bs, KV, D) int8
// and k_scale/v_scale (nblocks, bs, KV) fp32, all taken through strides, so
// per-layer views of the model's pool and its scale planes are read in
// place; block_tables (B, nb) and lens (B,) contiguous int32; out like q.
//
// Bound on the H100: bytes.  Each valid row of one KV head moves 2 * D int8
// bytes and two fp32 scales, 2 * D + 8 bytes, for 4 * G * D flops.  At the
// PPO generation shape (B = 8, KV = 32, G = 1, D = 64, 257..512 valid rows)
// that is at most 8 * 32 * 512 * 136 B = 17.8 MB, ~5.3 us at 3.35 TB/s.
//
// Design: csrc/paged_decode_attention.cu's (table entries in shared memory,
// only the lens[b] valid rows ever read, one block of 4 warps per
// (b, kv_head), 32-row chunks, per-warp online softmax merged in shared
// memory), with csrc/decode_attention_quant.cu's int8 row work: a lane
// reads its key row as D / 16 16-byte loads plus its two scales, and folds
// its row's v_scale into its probabilities before they reach the lanes that
// own the output dimensions by warp shuffles.  lens[b] == 0 gives 0 (the
// Pallas kernel's answer; ROADMAP R8); a table entry outside [0, nblocks)
// is never dereferenced and gives a NaN output instead.  A simple kernel:
// no split-KV, no tensor cores.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;          // query heads per KV head
constexpr int kMaxBlocks = 2048;  // table entries a sequence may use

struct Params {
  const void* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const int32_t* tables;
  const int32_t* lens;
  void* o;
  int64_t q_sb, q_sk, q_sg;
  int64_t k_sn, k_so, k_sk;
  int64_t v_sn, v_so, v_sk;
  int64_t ks_sn, ks_so, ks_sk;
  int64_t vs_sn, vs_so, vs_sk;
  int64_t o_sb, o_sk, o_sg;
  int B, KV, G, nb, bs, nblocks;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_quant_kernel(const Params p) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int DPL = D / 32;  // output dims per lane
  constexpr int VEC = 16;      // int8 values per 16-byte load
  __shared__ float q_s[kMaxG][D];
  __shared__ float m_w[kWarps][kMaxG];
  __shared__ float l_w[kWarps][kMaxG];
  __shared__ float acc_w[kWarps][kMaxG][D];
  __shared__ int tbl_s[kMaxBlocks];
  __shared__ int bad;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = p.G, bs = p.bs;
  const int n_valid = max(0, min(p.lens[b], p.nb * bs));
  const int n_blk = (n_valid + bs - 1) / bs;

  if (threadIdx.x == 0) bad = 0;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kvh * p.q_sk;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads)
    q_s[idx / D][idx % D] = repro::to_float(qb[(idx / D) * p.q_sg + idx % D]);
  __syncthreads();
  const int32_t* tb = p.tables + static_cast<int64_t>(b) * p.nb;
  for (int i = threadIdx.x; i < n_blk; i += kThreads) {
    int e = tb[i];
    if (e < 0 || e >= p.nblocks) {
      bad = 1;
      e = 0;
    }
    tbl_s[i] = e;
  }
  __syncthreads();

  T* ob = static_cast<T*>(p.o) + b * p.o_sb + kvh * p.o_sk;
  if (bad) {  // uniform across the block: read after the barrier
    const float nan = __int_as_float(0x7fc00000);
    for (int idx = threadIdx.x; idx < G * D; idx += kThreads)
      ob[(idx / D) * p.o_sg + idx % D] = repro::from_float<T>(nan);
    return;
  }

  const int8_t* kb = p.k + kvh * p.k_sk;
  const int8_t* vb = p.v + kvh * p.v_sk;
  const float* ksb = p.ks + kvh * p.ks_sk;
  const float* vsb = p.vs + kvh * p.vs_sk;

  float m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = REPRO_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int u = 0; u < DPL; ++u) acc[g][u] = 0.f;
  }

  const int nchunks = (n_valid + 31) / 32;
  for (int c = warp; c < nchunks; c += kWarps) {
    const int srow = c * 32 + lane;
    const bool in = srow < n_valid;
    float dot[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
    float k_sc = 0.f, v_sc = 0.f;
    if (in) {
      const int blk = tbl_s[srow / bs], off = srow % bs;
      const int8_t* kr = kb + blk * p.k_sn + off * p.k_so;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VEC) {
        const int4 raw = *reinterpret_cast<const int4*>(kr + d0);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float kv = static_cast<float>(e[j]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) dot[g] += q_s[g][d0 + j] * kv;
        }
      }
      k_sc = ksb[blk * p.ks_sn + off * p.ks_so];
      v_sc = vsb[blk * p.vs_sn + off * p.vs_so];
    }

    float pv[kMaxG];  // probability times the row's v_scale
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      pv[g] = 0.f;
      if (g < G) {
        const float sv = in ? dot[g] * p.scale * k_sc : -INFINITY;
        const float m_new = fmaxf(m[g], repro::warp_max(sv));
        const float alpha = expf(m[g] - m_new);
        const float pr = expf(sv - m_new);
        l[g] = l[g] * alpha + pr;  // per-lane partial; summed at the end
#pragma unroll
        for (int u = 0; u < DPL; ++u) acc[g][u] *= alpha;
        m[g] = m_new;
        pv[g] = pr * v_sc;
      }
    }

    const int n_in = min(32, n_valid - c * 32);  // only valid rows of V
    for (int jj = 0; jj < n_in; ++jj) {
      const int row = c * 32 + jj;
      const int8_t* vr = vb + tbl_s[row / bs] * p.v_sn + (row % bs) * p.v_so;
      float vv[DPL];
#pragma unroll
      for (int u = 0; u < DPL; ++u)
        vv[u] = static_cast<float>(vr[u * 32 + lane]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(0xffffffffu, pv[g], jj);
#pragma unroll
          for (int u = 0; u < DPL; ++u) acc[g][u] += pj * vv[u];
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const float lt = repro::warp_sum(l[g]);
      if (lane == 0) {
        m_w[warp][g] = m[g];
        l_w[warp][g] = lt;
      }
#pragma unroll
      for (int u = 0; u < DPL; ++u) acc_w[warp][g][u * 32 + lane] = acc[g][u];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float M = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_w[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_w[w][g] - M);
      L += l_w[w][g] * f;
      A += acc_w[w][g][d] * f;
    }
    ob[g * p.o_sg + d] = repro::from_float<T>(A / fmaxf(L, 1e-20f));
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.KV, p.B);
  paged_decode_quant_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
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

// strides (elements): q (b, kv, g), k pool (block, offset, kv), v pool
// (block, offset, kv), k_scale (block, offset, kv), v_scale (block,
// offset, kv), o (b, kv, g) — 18 values; the D axis has unit stride and
// K/V rows start on 16-byte boundaries (checked by the wrapper).
// block_tables (B, nb) and lens (B,) are contiguous int32.  Returns a
// cudaError_t code.
extern "C" int paged_decode_attention_quant_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lens, void* o, const int64_t* strides, int B, int KV, int G,
    int nb, int bs, int nblocks, int D, float scale, int dtype,
    void* stream) {
  if (G < 1 || G > kMaxG || nb < 1 || nb > kMaxBlocks || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = static_cast<const int8_t*>(k_pool);
  p.v = static_cast<const int8_t*>(v_pool);
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int32_t*>(block_tables);
  p.lens = static_cast<const int32_t*>(lens);
  p.o = o;
  p.q_sb = strides[0];
  p.q_sk = strides[1];
  p.q_sg = strides[2];
  p.k_sn = strides[3];
  p.k_so = strides[4];
  p.k_sk = strides[5];
  p.v_sn = strides[6];
  p.v_so = strides[7];
  p.v_sk = strides[8];
  p.ks_sn = strides[9];
  p.ks_so = strides[10];
  p.ks_sk = strides[11];
  p.vs_sn = strides[12];
  p.vs_so = strides[13];
  p.vs_sk = strides[14];
  p.o_sb = strides[15];
  p.o_sk = strides[16];
  p.o_sg = strides[17];
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.nb = nb;
  p.bs = bs;
  p.nblocks = nblocks;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return dispatch_d<float>(p, D, s);
  if (dtype == repro::kBF16) return dispatch_d<__nv_bfloat16>(p, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
