// Int8-KV decode attention forward: one query token per sequence attends to
// the S rows of its dense int8 KV arena row under a (B, S) validity mask,
// with the per-row fp32 scales fused into the online softmax.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_quant_fwd
// (Pallas TPU kernel).
//
// What it computes (the reference's algebra, never an fp copy of K/V):
//   s[g, t] = (q[g] . k_i8[t]) / sqrt(D) * k_scale[t]   (-1e30 where masked)
//   p       = online softmax of s in fp32
//   acc[g] += (p[g, t] * v_scale[t]) * v_i8[t]
// and writes acc / l in q's dtype.
//
// Layout: q (B, KV, G, D) bf16 or fp32; k/v (B, KV, S, D) int8 and
// k_scale/v_scale (B, KV, S) fp32, all taken through strides, so the
// model's (B, S, KV, D) int8 arena and its (B, S, KV) scale planes are read
// in place; valid (B, S) bool; out like q.
//
// Bound on the H100: bytes.  Each valid row of one KV head moves 2*D int8
// bytes and two fp32 scales, 2*D + 8 bytes, for 4*G*D flops: far below the
// card's ~295 flops/byte balance.  At the PPO generation shape (B = 8,
// KV = 32, G = 1, S = 512, D = 64) the full arena, every row valid, is
// 8 * 32 * 512 * 136 B = 17.8 MB, ~5.3 us at 3.35 TB/s; half the bytes of
// the bf16 arena, which is the point of int8 KV.  Mid-generation only the
// 256 prompt rows and the tokens so far are valid, and only they count.
//
// Design: the dense decode kernel's (csrc/decode_attention.cu), widened for
// int8.  One block of 4 warps per (b, kv_head), so all G query heads of a
// GQA group share every K/V row the block loads.  The warps split the S axis
// into interleaved 32-row chunks; in a chunk a lane owns one key row, reads
// its D int8 values as D/16 16-byte loads (four for D = 64) plus its two
// scales, and forms its G scores against the query heads held in fp32 in
// shared memory.  Each lane folds its row's v_scale into its probabilities;
// they reach the lanes that own the output dimensions by warp shuffles
// while the int8 V rows are read coalesced (32 bytes per warp load).  Each
// warp keeps its own online-softmax state (m, l, acc) in fp32 registers and
// the 4 partial states are merged in shared memory at the end.  Masked rows
// get the reference's finite -1e30 (an all-masked row yields the mean of
// the dequantized V, not NaN); rows past S in the last chunk get -inf and
// never count.  A simple kernel: no split-KV, no tensor cores (int8 dot
// products would need the q row quantized too, which the reference does
// not do).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;  // query heads per KV head

struct Params {
  const void* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const uint8_t* valid;
  void* o;
  int64_t q_sb, q_sk, q_sg;
  int64_t k_sb, k_sk, k_ss;
  int64_t v_sb, v_sk, v_ss;
  int64_t ks_sb, ks_sk, ks_ss;
  int64_t vs_sb, vs_sk, vs_ss;
  int64_t m_sb, m_ss;
  int64_t o_sb, o_sk, o_sg;
  int B, KV, G, S;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_quant_kernel(const Params p) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int DPL = D / 32;  // output dims per lane
  constexpr int VEC = 16;      // int8 values per 16-byte load
  __shared__ float q_s[kMaxG][D];
  __shared__ float m_w[kWarps][kMaxG];
  __shared__ float l_w[kWarps][kMaxG];
  __shared__ float acc_w[kWarps][kMaxG][D];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = p.G;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kvh * p.q_sk;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads)
    q_s[idx / D][idx % D] = repro::to_float(qb[(idx / D) * p.q_sg + idx % D]);
  __syncthreads();

  const int8_t* kb = p.k + b * p.k_sb + kvh * p.k_sk;
  const int8_t* vb = p.v + b * p.v_sb + kvh * p.v_sk;
  const float* ksb = p.ks + b * p.ks_sb + kvh * p.ks_sk;
  const float* vsb = p.vs + b * p.vs_sb + kvh * p.vs_sk;
  const uint8_t* mb = p.valid + b * p.m_sb;

  float m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = REPRO_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int u = 0; u < DPL; ++u) acc[g][u] = 0.f;
  }

  const int nchunks = (p.S + 31) / 32;
  for (int c = warp; c < nchunks; c += kWarps) {
    const int srow = c * 32 + lane;
    const bool in = srow < p.S;
    float dot[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
    float k_sc = 0.f, v_sc = 0.f;
    if (in) {
      const int8_t* kr = kb + static_cast<int64_t>(srow) * p.k_ss;
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
      k_sc = ksb[static_cast<int64_t>(srow) * p.ks_ss];
      v_sc = vsb[static_cast<int64_t>(srow) * p.vs_ss];
    }
    const bool ok = in && mb[static_cast<int64_t>(srow) * p.m_ss] != 0;

    float pv[kMaxG];  // probability times the row's v_scale
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      pv[g] = 0.f;
      if (g < G) {
        const float sv = !in ? -INFINITY
                             : (ok ? dot[g] * p.scale * k_sc : REPRO_NEG_INF);
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

    const int n_in = min(32, p.S - c * 32);
    for (int jj = 0; jj < n_in; ++jj) {
      const int8_t* vr = vb + static_cast<int64_t>(c * 32 + jj) * p.v_ss;
      float vv[DPL];
#pragma unroll
      for (int u = 0; u < DPL; ++u) vv[u] = static_cast<float>(vr[u * 32 + lane]);
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

  T* ob = static_cast<T*>(p.o) + b * p.o_sb + kvh * p.o_sk;
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
  decode_quant_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
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

// strides (elements): q (b, kv, g), k (b, kv, s), v (b, kv, s),
// k_scale (b, kv, s), v_scale (b, kv, s), valid (b, s), o (b, kv, g) —
// 20 values; the D axis has unit stride.  K/V rows must start on 16-byte
// boundaries (checked by the wrapper).  Returns a cudaError_t code.
extern "C" int decode_attention_quant_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* valid, void* o, const int64_t* strides,
    int B, int KV, int G, int S, int D, float scale, int dtype,
    void* stream) {
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.valid = static_cast<const uint8_t*>(valid);
  p.o = o;
  p.q_sb = strides[0];
  p.q_sk = strides[1];
  p.q_sg = strides[2];
  p.k_sb = strides[3];
  p.k_sk = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sk = strides[7];
  p.v_ss = strides[8];
  p.ks_sb = strides[9];
  p.ks_sk = strides[10];
  p.ks_ss = strides[11];
  p.vs_sb = strides[12];
  p.vs_sk = strides[13];
  p.vs_ss = strides[14];
  p.m_sb = strides[15];
  p.m_ss = strides[16];
  p.o_sb = strides[17];
  p.o_sk = strides[18];
  p.o_sg = strides[19];
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.S = S;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return dispatch_d<float>(p, D, s);
  if (dtype == repro::kBF16) return dispatch_d<__nv_bfloat16>(p, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
