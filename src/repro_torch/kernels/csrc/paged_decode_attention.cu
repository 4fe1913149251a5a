// Paged decode attention forward: one query token per sequence attends to
// the first lens[b] rows of its KV, which live in a shared pool of
// fixed-size blocks reached through the sequence's block table.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_decode_attention_fwd
// (Pallas TPU kernel; the block table and lens arrive there by scalar
// prefetch and the block axis is the sequential grid dimension).
//
// Layout: q (B, KV, G, D) bf16 or fp32; k/v pool (nblocks, bs, KV, D) taken
// through strides, so a per-layer view of the model's (n_units, nblocks,
// bs, KV, D) pool is read in place; block_tables (B, nb) int32, contiguous,
// entries past a sequence's allocated prefix pointing at the trash block 0;
// lens (B,) int32, the valid rows of each sequence (the engine gives
// min(pos + 1, nb * bs) >= 1); out like q.  Virtual row r of sequence b
// lives at pool[table[b, r / bs], r % bs].
//
// Bound on the H100: bytes.  Each valid row of one KV head moves 2 * D
// elements of K and V for 4 * G * D flops, far below the card's ~295
// flops/byte balance.  At the OPT-1.3B serve shape (B = 16, KV = 32, G = 1,
// D = 64, bf16, up to 512 rows a sequence) the full tables are 67 MB,
// ~20 us at 3.35 TB/s; only the valid rows count.  A layer's bf16 pool at
// 513 blocks is 67 MB, more than the 50 MB L2, so a real decode step finds
// most of it cold.
//
// Design: the dense decode kernel's (csrc/decode_attention.cu), with the
// arena row replaced by a table lookup.  One block of 4 warps per
// (b, kv_head), so all G query heads of a GQA group share every K/V row the
// block loads.  The block first copies the sequence's first
// ceil(lens / bs) table entries into shared memory; blocks past lens are
// never read, nor are rows past lens in the last block (the reference
// masks those with -1e30, which gives them weight exactly 0 once a real
// row is seen; here they never enter the softmax).  So a stale or trash row
// never meets a probability, not even a zero one.  The warps split the
// lens[b] valid rows into interleaved 32-row chunks; a lane owns one key
// row, reads it with 16-byte loads (every row starts on a 16-byte boundary:
// the row stride is KV * D elements) and forms its G scores against the
// query heads in shared memory; the probabilities reach the lanes that own
// the output dimensions by warp shuffles while the V rows are read
// coalesced.  Each warp keeps its own online-softmax state (m, l, acc) in
// fp32 registers and the 4 partial states are merged in shared memory.
// With lens[b] == 0 no row is read and the output is 0, as the Pallas
// kernel gives (its oracle gives the mean of V instead; ROADMAP R8).  A
// table entry outside [0, nblocks) is never dereferenced: the sequence's
// output is NaN instead (the engine checks its host table before upload).
// A simple kernel: no split-KV, no tensor cores.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;          // query heads per KV head
constexpr int kMaxBlocks = 2048;  // table entries a sequence may use

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* tables;
  const int32_t* lens;
  void* o;
  int64_t q_sb, q_sk, q_sg;
  int64_t k_sn, k_so, k_sk;
  int64_t v_sn, v_so, v_sk;
  int64_t o_sb, o_sk, o_sg;
  int B, KV, G, nb, bs, nblocks;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const Params p) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int DPL = D / 32;                            // dims per lane
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per 16 B load
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

  const T* kb = static_cast<const T*>(p.k) + kvh * p.k_sk;
  const T* vb = static_cast<const T*>(p.v) + kvh * p.v_sk;

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
    if (in) {
      const T* kr = kb + tbl_s[srow / bs] * p.k_sn + (srow % bs) * p.k_so;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + d0);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float kv = repro::to_float(e[j]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) dot[g] += q_s[g][d0 + j] * kv;
        }
      }
    }

    float pr[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      pr[g] = 0.f;
      if (g < G) {
        const float sv = in ? dot[g] * p.scale : -INFINITY;
        const float m_new = fmaxf(m[g], repro::warp_max(sv));
        const float alpha = expf(m[g] - m_new);
        pr[g] = expf(sv - m_new);
        l[g] = l[g] * alpha + pr[g];  // per-lane partial; summed at the end
#pragma unroll
        for (int u = 0; u < DPL; ++u) acc[g][u] *= alpha;
        m[g] = m_new;
      }
    }

    const int n_in = min(32, n_valid - c * 32);  // only valid rows of V
    for (int jj = 0; jj < n_in; ++jj) {
      const int row = c * 32 + jj;
      const T* vr = vb + tbl_s[row / bs] * p.v_sn + (row % bs) * p.v_so;
      float vv[DPL];
#pragma unroll
      for (int u = 0; u < DPL; ++u) vv[u] = repro::to_float(vr[u * 32 + lane]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(0xffffffffu, pr[g], jj);
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
  paged_decode_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
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
// (block, offset, kv), o (b, kv, g) — 12 values; the D axis has unit
// stride and K/V rows start on 16-byte boundaries (checked by the
// wrapper).  block_tables (B, nb) and lens (B,) are contiguous int32.
// Returns a cudaError_t code.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lens, void* o,
    const int64_t* strides, int B, int KV, int G, int nb, int bs,
    int nblocks, int D, float scale, int dtype, void* stream) {
  if (G < 1 || G > kMaxG || nb < 1 || nb > kMaxBlocks || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k_pool;
  p.v = v_pool;
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
  p.o_sb = strides[9];
  p.o_sk = strides[10];
  p.o_sg = strides[11];
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
