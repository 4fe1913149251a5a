// The decode core shared by the dense and the paged decode kernels, fp and
// int8 (decode_attention.cu, paged_decode_attention.cu,
// decode_attention_quant.cu, paged_decode_attention_quant.cu): one query
// token per sequence attends to its valid K/V rows, which a *row locator*
// (decode_rows.cuh) finds.
//
// Bound on the H100: bytes.  A K/V row of one KV head is used for 2 * G
// flops per byte (G query heads, G <= 8; int8: 4 * G), against the card's
// ~295 flops per byte, so neither tensor cores (nothing to gain below that
// balance) nor TMA (paged rows are gathered rows; dense rows strided by
// KV * D) are used.  The least time is the valid rows' bytes over
// 3.35 TB/s, so the design is about reading those bytes, and only those, at
// the memory rate:
//
// * Split-KV.  Grid (splits, KV, B): block (s, h, b) takes rows
//   [s * chunk, (s + 1) * chunk) of one (b, kv head), chunk a multiple of 64
//   (and of the block size, paged).  The wrapper picks splits on the host so
//   that small batches still fill the card; with splits == 1 the block writes
//   the output, else an fp32 partial (m, l, acc) that combine_kernel merges.
// * Coalesced loads of K and V alike.  A row is read by LPR = D / VEC lanes of
//   a warp, each holding VEC elements of D: 16 bytes of fp32 or bf16 (VEC = 4
//   or 8; bf16 at D = 64: 8 lanes, one warp instruction reads 4 whole 128-byte
//   rows), or of int8 (VEC = 16: at D = 64 one warp instruction reads 8 whole
//   64-byte rows) where the GM <= 2 heads' q and acc registers allow it, else
//   8 bytes (VEC = 8, the lane geometry and registers of bf16).  Each lane
//   group takes kRB = 4 rows per batch, K and V, and the batches go through a
//   kStages = 3 ring of per-thread cp.async slots in shared memory: two
//   batches (16 KB a warp at D = 64 bf16) are in flight while a third is
//   consumed, without holding registers, so a few resident blocks per SM cover
//   the ~25 KB that Little's law asks of 3.35 TB/s at ~1 us latency.  A
//   register double buffer in the ring's place was measured once on the H100:
//   it held over twice the registers and was no faster at any timed shape.
// * Scores: the lane's D-slice of q for the G heads is held in registers,
//   pre-scaled by scale * log2(e); the partial dot products are reduced over
//   the lane group with __shfl_xor_sync; the online softmax runs in base 2
//   (ex2.approx).  Each lane group keeps its own (m, l, acc) in fp32; the
//   groups of a warp merge by shuffles, the 4 warps in shared memory.
// * Int8 rows (a locator with kScaled) carry two fp32 scales each, fetched
//   under the same valid-row rule by 4-byte cp.async into the warp's scale
//   slots of the ring stage, one lane a row of the warp's batch.  The
//   reference's algebra, never an fp copy of K/V: the reduced score is
//   multiplied by k_scale once per row, the probability by v_scale before it
//   meets the int8 V row, and l sums the probability alone.  Int8 becomes
//   fp32 by a byte permute into the mantissa of 2^23 and one subtraction
//   (VecI8), not by I2F.
// * Only rows that count are read.  The locator says which rows of the
//   split are valid; an invalid row is never loaded (its slots are
//   zero-filled without a read, its probability is 0).  The reference
//   masks with the finite
//   -1e30, so once one row of a sequence is valid a masked row's weight is
//   exactly 0 in fp32 and skipping it is exact.
//
// The edge rules, kept by both the one-split path and the combine:
// * an empty split (no valid row) contributes nothing: its partial is
//   marked empty and never enters a max or an exp;
// * a sequence with no valid row at all gets the locator's answer: the mean
//   of V (int8: of the dequantized V) over all rows (dense, the reference's
//   answer under its finite mask; the only case that reads masked rows) or
//   0 (paged lens = 0, the Pallas kernel's answer);
// * a locator that finds a bad row reference (paged: a table entry outside
//   the pool) marks the split bad, and the whole output of that (b, kv
//   head) is NaN, carried as an explicit state (fmaxf would drop a NaN);
// * no atomics: every sum runs in a fixed order, so two calls agree bit for
//   bit; and every rounding is spelled out (fmaf, __fmul_rn, __fadd_rn), so
//   the compiler cannot contract a product and a sum into an FMA in one
//   kernel and not in the other: the dense and the paged kernel give the
//   same bits for the same rows and split plan (greedy streams over the
//   arena and over the pool stay identical).
#pragma once

#include <climits>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;   // split ranges are multiples of this many rows
constexpr int kMaxG = 8;    // query heads per KV head
constexpr int kMaxSplits = 64;
constexpr int kRB = 4;      // rows per lane group per batch
constexpr int kStages = 3;  // cp.async ring depth

// partial record states (last float of a record)
constexpr float kEmpty = 0.f, kFull = 1.f, kBad = 2.f;

// floats of one split's partial record: acc[G][D], m[G], l[G], state;
// rounded up to 4 so every record starts on 16 bytes
__host__ __device__ inline int record_floats(int G, int D) {
  return (G * D + 2 * G + 1 + 3) / 4 * 4;
}

// What a lane loads of one row (Raw, VEC = N elements), as floats.
template <typename KT>
struct Vec;
template <>
struct Vec<float> {
  using Raw = uint4;
  static constexpr int N = 4;
  __device__ __forceinline__ static void cvt(const uint4& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int N = 8;
  __device__ __forceinline__ static void cvt(const uint4& r, float (&f)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is exact: the high half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
// N = 8 or 16 int8 values (8 or 16 bytes) as floats, exact, without I2F
// (16 a clock per SM: at D = 64 a second bound as long as the bytes').
// Byte b with its sign bit flipped is b + 128 in 0..255; permuted into the
// low mantissa byte of 2^23 (0x4B000000) it reads as 2^23 + b + 128, and
// one subtraction of 2^23 + 128 leaves b.  One LOP3 per 4 values, one PRMT
// and one FADD each.
template <int N_>
struct VecI8 {
  using Raw = typename std::conditional<N_ == 16, uint4, uint2>::type;
  static constexpr int N = N_;
  __device__ __forceinline__ static void cvt(const Raw& r, float (&f)[N]) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = __fsub_rn(
            __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650u | j)),
            8388736.f);
    }
  }
};

// A lane's share of a row: 16 bytes of fp32 or bf16; 16 int8 values where
// the G heads' q and acc registers allow it (GM <= 2, D >= 64: 4 lanes a
// row at D = 64, so a warp instruction reads 8 rows), else 8 (the lane
// geometry and registers of bf16)
template <typename KT, int D, int GM>
struct LaneVec {
  using type = Vec<KT>;
};
template <int D, int GM>
struct LaneVec<int8_t, D, GM> {
  using type = VecI8<(GM <= 2 && D >= 64) ? 16 : 8>;
};

// one lane's Raw of a row, global -> its ring slot (zero-filled, and
// nothing read, when `ok` is false)
template <typename Raw>
__device__ __forceinline__ void cp_async_raw(uint32_t dst, const void* src,
                                             bool ok) {
  if constexpr (sizeof(Raw) == 16) mma::cp_async_16(dst, src, ok);
  else mma::cp_async_8(dst, src, ok);
}

// where the cp.async ring starts in dynamic shared memory, after the
// locator's data, and the bytes of both: the K/V slots, then (kScaled)
// each warp's scale slots, 2 x 32 floats a stage
template <class Loc>
__host__ __device__ inline size_t ring_offset(int chunk, const Loc& loc) {
  return (Loc::smem_bytes(chunk, loc) + 15) / 16 * 16;
}
template <int D, int GM, class Loc>
inline size_t dyn_smem_bytes(int chunk, const Loc& loc) {
  using Raw = typename LaneVec<typename Loc::Elem, D, GM>::type::Raw;
  return ring_offset(chunk, loc) +
         static_cast<size_t>(kStages) * 2 * kRB * kThreads * sizeof(Raw) +
         (Loc::kScaled ? static_cast<size_t>(kStages) * kWarps * 2 * 32 *
                             sizeof(float)
                       : 0);
}

// A row locator (decode_rows.cuh: DenseRows, PagedRows; their int8
// extensions in the quant kernels' sources) gives the kernels:
//   Elem                the K/V element type (float, bf16, int8)
//   kScaled             int8 rows with two fp32 scales each
//   kMeanIfEmpty        true: a sequence with no valid row gets the mean
//                       of V, through v_any(b, kvh, r) (and vs_any, the
//                       row's v_scale, when kScaled); false: zeros
//   smem_bytes(chunk)   the dynamic shared memory its prologue fills
//   prologue(...)       run by the whole block: fills that memory, sets
//                       [lo, hi), a range of the split's rows that holds
//                       all its valid rows (lo == hi: none), and returns a
//                       View, uniform across the block after a barrier
//   View::bad           a row reference is invalid: the output is NaN
//   View::ok(r)         row r in [lo, hi) is valid
//   View::k(r), v(r)    its K and V rows, aligned to a lane's load
//   View::ks(r), vs(r)  (kScaled) its k_scale and v_scale
//
// What both locators share: q, out, the scratch and the launch geometry.
struct Common {
  const void* q;
  void* o;
  float* part;  // (B, KV, splits) records; null when splits == 1
  int64_t q_sb, q_sk, q_sg;
  int64_t o_sb, o_sk, o_sg;
  int KV, G, splits, chunk, n_rows;
  float scale2;  // softmax scale * log2(e)
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Mean of V (int8: of v_scale * V) over rows [0, n) of one (b, kv head),
// written to all G heads: the reference's answer for a sequence whose rows
// are all masked.  Every thread of the block calls it; `red` holds
// kThreads floats.
template <typename T, int D, class Loc>
__device__ void mean_v(const Loc& loc, int b, int kvh, int n, int G, T* ob,
                       int64_t o_sg, float* red) {
  constexpr int P = kThreads / D;  // rows summed in parallel
  const int d = threadIdx.x % D, p = threadIdx.x / D;
  float s = 0.f;
  for (int r = p; r < n; r += P) {
    if constexpr (Loc::kScaled)
      s = __fadd_rn(s, __fmul_rn(static_cast<float>(loc.v_any(b, kvh, r)[d]),
                                 loc.vs_any(b, kvh, r)));
    else
      s = __fadd_rn(s, to_float(loc.v_any(b, kvh, r)[d]));
  }
  __syncthreads();
  red[threadIdx.x] = s;
  __syncthreads();
  if (p == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) t = __fadd_rn(t, red[i * D + d]);
    const T y = from_float<T>(n > 0 ? t / static_cast<float>(n) : 0.f);
    for (int g = 0; g < G; ++g) ob[g * o_sg + d] = y;
  }
}

// One block: one split of one (b, kv head).  T is q's and the output's
// type, Loc::Elem the rows'.  GM is G rounded up to a power of two
// (registers for GM heads; the loops stop at the runtime G).
template <typename T, int D, int GM, class Loc>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const Common c, const Loc loc) {
  using V = typename LaneVec<typename Loc::Elem, D, GM>::type;
  using Raw = typename V::Raw;
  constexpr bool kScaled = Loc::kScaled;
  constexpr int VEC = V::N;        // elements per lane per row
  constexpr int LPR = D / VEC;     // lanes per row
  constexpr int RPW = 32 / LPR;    // rows per warp instruction
  constexpr int RB = kRB;
  constexpr int BR = RPW * RB;     // rows per warp batch
  static_assert(LPR >= 1 && LPR <= 32 && kTile % BR == 0, "row geometry");
  static_assert(!kScaled || BR <= 32, "a warp's scale slots: a row a lane");

  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float m_w[kWarps][GM], l_w[kWarps][GM];
  __shared__ float acc_w[kWarps][GM][D];
  __shared__ int lohi[2][kWarps];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / LPR, sl = lane % LPR;  // row group, D-slice
  const int G = c.G;
  const int r0 = split * c.chunk;
  const int r1 = min(r0 + c.chunk, c.n_rows);

  // this lane's D-slice of q, pre-scaled into the base-2 domain (loaded
  // first, so its latency overlaps the locator's prologue)
  float q[GM][VEC];
  const T* qb = static_cast<const T*>(c.q) + b * c.q_sb + kvh * c.q_sk;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      q[g][j] = g < G ? __fmul_rn(to_float(qb[g * c.q_sg + sl * VEC + j]),
                                  c.scale2)
                      : 0.f;

  // the locator's prologue: its shared data, the rows [lo, hi) that hold
  // every valid row of the split, and whether a row reference is bad
  int lo, hi;
  const typename Loc::View view =
      loc.prologue(b, kvh, r0, r1, dyn, &lohi[0][0], &lo, &hi);
  const bool bad = view.bad;  // uniform: decided after a barrier
  const bool empty = lo >= hi;

  T* ob = static_cast<T*>(c.o) + b * c.o_sb + kvh * c.o_sk;
  float* rec = c.part == nullptr
                   ? nullptr
                   : c.part + ((static_cast<int64_t>(b) * c.KV + kvh) *
                                   c.splits + split) *
                                  record_floats(G, D);
  if (bad || empty) {
    if (rec != nullptr) {  // partial: only the state (and m, l) count
      if (threadIdx.x == 0) rec[G * D + 2 * G] = bad ? kBad : kEmpty;
    } else if (bad) {
      for (int i = threadIdx.x; i < G * D; i += kThreads)
        ob[(i / D) * c.o_sg + i % D] = from_float<T>(nan_f());
    } else if constexpr (Loc::kMeanIfEmpty) {
      mean_v<T, D>(loc, b, kvh, c.n_rows, G, ob, c.o_sg, &acc_w[0][0][0]);
    } else {
      for (int i = threadIdx.x; i < G * D; i += kThreads)
        ob[(i / D) * c.o_sg + i % D] = from_float<T>(0.f);
    }
    return;
  }

  float m[GM], l[GM], acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
  }

  // warp batches of BR rows from lo (rounded down to BR; r0 is a multiple
  // of kTile, so the batch never starts before the split); batch n goes to
  // warp n % kWarps
  const int base = lo - (lo - r0) % BR;
  const int nbatch = (hi - base + BR - 1) / BR;
  auto row_of = [&](int n, int i) { return base + n * BR + i * RPW + rg; };

  // ksc / vsc: the rows' scales (kScaled), else unused
  auto consume = [&](int n, const Raw (&kr)[RB], const Raw (&vr)[RB],
                     const float (&ksc)[RB], const float (&vsc)[RB]) {
    float s[RB][GM];
    bool ok[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int r = row_of(n, i);
      ok[i] = r < hi && view.ok(r);
      float kf[VEC];
      V::cvt(kr[i], kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) a = fmaf(q[g][j], kf[j], a);
        s[i][g] = a;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], off);
    if constexpr (kScaled) {  // k_scale on the reduced score, once a row
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int g = 0; g < GM; ++g) s[i][g] = __fmul_rn(s[i][g], ksc[i]);
    }
    float vf[RB][VEC];
#pragma unroll
    for (int i = 0; i < RB; ++i) V::cvt(vr[i], vf[i]);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) continue;
      float smax = -INFINITY;
#pragma unroll
      for (int i = 0; i < RB; ++i)
        if (ok[i]) smax = fmaxf(smax, s[i][g]);
      const float mn = fmaxf(m[g], smax);
      if (mn == -INFINITY) continue;  // nothing valid yet in this group
      const float alpha = mma::exp2_approx(m[g] - mn);  // 2^-inf = 0
      l[g] = __fmul_rn(l[g], alpha);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] = __fmul_rn(acc[g][j], alpha);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float p = ok[i] ? mma::exp2_approx(s[i][g] - mn) : 0.f;
        l[g] = __fadd_rn(l[g], p);
        float pv = p;  // v_scale on the probability, not in l
        if constexpr (kScaled) pv = __fmul_rn(p, vsc[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[g][j] = fmaf(pv, vf[i][j], acc[g][j]);
      }
      m[g] = mn;
    }
  };

  // a kStages-deep ring of per-thread cp.async slots after the locator's
  // shared data: [stage][2 * RB][kThreads] x sizeof(Raw), so a warp's
  // accesses hit consecutive addresses; each thread reads back only its
  // own slots, so no barrier is needed.  Then (kScaled) each warp's scale
  // slots, [stage][warp][k_scale, v_scale][32] floats: lane j fetches both
  // scales of the batch's row j (one cp.async each for the batch's BR
  // rows, not one per lane and row), and every lane reads its rows' after
  // a __syncwarp.  An invalid row is zero-filled without a read (source
  // size 0).
  Raw* ring = reinterpret_cast<Raw*>(dyn + ring_offset(c.chunk, loc));
  float* sring = reinterpret_cast<float*>(ring + kStages * 2 * RB * kThreads);
  auto slot = [&](int st, int i) {
    return ring + (st * 2 * RB + i) * kThreads + threadIdx.x;
  };
  auto sslot = [&](int st, int which, int j) {
    return sring + ((st * kWarps + warp) * 2 + which) * 32 + j;
  };
  auto issue = [&](int n, int st) {
    if (n < nbatch) {
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = row_of(n, i);
        const bool ok = r < hi && view.ok(r);
        cp_async_raw<Raw>(mma::smem_addr(slot(st, i)),
                          ok ? view.k(r) + sl * VEC : view.k(lo), ok);
        cp_async_raw<Raw>(mma::smem_addr(slot(st, RB + i)),
                          ok ? view.v(r) + sl * VEC : view.v(lo), ok);
      }
      if constexpr (kScaled) {
        if (lane < BR) {
          const int r = base + n * BR + lane;
          const bool ok = r < hi && view.ok(r);
          mma::cp_async_4(mma::smem_addr(sslot(st, 0, lane)),
                          ok ? view.ks(r) : view.ks(lo), ok);
          mma::cp_async_4(mma::smem_addr(sslot(st, 1, lane)),
                          ok ? view.vs(r) : view.vs(lo), ok);
        }
      }
    }
    mma::cp_async_commit();  // an empty group past the end keeps counts
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(warp + st * kWarps, st);
  for (int n = warp, st = 0; n < nbatch; n += kWarps) {
    issue(n + (kStages - 1) * kWarps, (st + kStages - 1) % kStages);
    mma::cp_async_wait<kStages - 1>();
    Raw kr[RB], vr[RB];
    float ksc[RB], vsc[RB];
    if constexpr (kScaled) __syncwarp();  // the other lanes' scale copies
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      kr[i] = *slot(st, i);
      vr[i] = *slot(st, RB + i);
      if constexpr (kScaled) {
        ksc[i] = *sslot(st, 0, i * RPW + rg);
        vsc[i] = *sslot(st, 1, i * RPW + rg);
      }
    }
    if constexpr (kScaled) __syncwarp();  // read before the next issue
    consume(n, kr, vr, ksc, vsc);
    st = st + 1 == kStages ? 0 : st + 1;
  }
  mma::cp_async_wait<0>();

  // merge the lane groups of each warp (shuffles), then the warps (shared)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float fa = mn == -INFINITY ? 0.f : mma::exp2_approx(m[g] - mn);
      const float fb = mn == -INFINITY ? 0.f : mma::exp2_approx(mo - mn);
      l[g] = fmaf(l[g], fa, __fmul_rn(lo_, fb));
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        acc[g][j] = fmaf(acc[g][j], fa, __fmul_rn(ao, fb));
      }
      m[g] = mn;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (sl == 0) {
        m_w[warp][g] = m[g];
        l_w[warp][g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc_w[warp][g][sl * VEC + j] = acc[g][j];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_w[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (m_w[w][g] == -INFINITY) continue;  // a warp that saw no valid row
      const float f = mma::exp2_approx(m_w[w][g] - M);
      L = fmaf(l_w[w][g], f, L);
      A = fmaf(acc_w[w][g][d], f, A);
    }
    if (rec == nullptr) {
      ob[g * c.o_sg + d] = from_float<T>(A / fmaxf(L, 1e-20f));
    } else {
      rec[i] = A;
      if (d == 0) {
        rec[G * D + g] = M;
        rec[G * D + G + g] = L;
      }
    }
  }
  if (rec != nullptr && threadIdx.x == 0) rec[G * D + 2 * G] = kFull;
}

// Merge the splits' partials of one (b, kv head) in split order.  The
// splits' states, m and l are staged in shared memory by all threads at
// once, each head's weights 2^(m_s - M) and 1 / L computed once, and the
// acc loads of the splits are independent of each other.
template <typename T, int D, class Loc>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const Common c, const Loc loc) {
  __shared__ float red[kThreads];
  __shared__ float st_s[kMaxSplits];
  __shared__ float w_s[kMaxSplits][kMaxG];  // m, then the weight
  __shared__ float l_s[kMaxSplits][kMaxG];
  __shared__ float inv_l[kMaxG];
  __shared__ int state;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = c.G, R = record_floats(G, D), S = c.splits;
  const float* recs =
      c.part + (static_cast<int64_t>(b) * c.KV + kvh) * S * R;
  T* ob = static_cast<T*>(c.o) + b * c.o_sb + kvh * c.o_sk;
  for (int i = threadIdx.x; i < S * (2 * G + 1); i += kThreads) {
    const int s = i / (2 * G + 1), j = i % (2 * G + 1);
    const float x = recs[s * R + G * D + j];
    if (j < G) w_s[s][j] = x;
    else if (j < 2 * G) l_s[s][j - G] = x;
    else st_s[s] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // 0: every split empty, 1: some full, 2: bad
    int st = 0;
    for (int s = 0; s < S; ++s) {
      if (st_s[s] == kBad) st = 2;
      else if (st_s[s] == kFull && st == 0) st = 1;
    }
    state = st;
  }
  __syncthreads();
  if (state != 1) {
    if constexpr (Loc::kMeanIfEmpty) {
      if (state == 0) {
        mean_v<T, D>(loc, b, kvh, c.n_rows, G, ob, c.o_sg, red);
        return;
      }
    }
    const float y = state == 2 ? nan_f() : 0.f;
    for (int i = threadIdx.x; i < G * D; i += kThreads)
      ob[(i / D) * c.o_sg + i % D] = from_float<T>(y);
    return;
  }
  if (threadIdx.x < G) {
    // only a full split's m and l were written: an empty split's weight is
    // 0 and its l is never read (0 * an unwritten NaN would be NaN, which
    // the fmaxf below would turn into 1e-20)
    const int g = threadIdx.x;
    float M = -INFINITY;
    for (int s = 0; s < S; ++s)
      if (st_s[s] == kFull) M = fmaxf(M, w_s[s][g]);
    float L = 0.f;
    for (int s = 0; s < S; ++s) {
      float w = 0.f;
      if (st_s[s] == kFull) {
        w = mma::exp2_approx(w_s[s][g] - M);
        L = fmaf(l_s[s][g], w, L);
      }
      w_s[s][g] = w;
    }
    inv_l[g] = 1.f / fmaxf(L, 1e-20f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float A = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {  // an empty split's acc was never written
      const bool full = st_s[s] == kFull;
      A = fmaf(full ? w_s[s][g] : 0.f, full ? recs[s * R + i] : 0.f, A);
    }
    ob[g * c.o_sg + d] = from_float<T>(__fmul_rn(A, inv_l[g]));
  }
}

template <typename T, int D, int GM, class Loc>
int launch_gm(const Common& c, const Loc& loc, int B, cudaStream_t stream) {
  const size_t smem = dyn_smem_bytes<D, GM>(c.chunk, loc);
  static bool attr = false;  // above 48 KB only after opting in
  if (!attr) {
    cudaFuncSetAttribute(split_kernel<T, D, GM, Loc>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         100 * 1024);
    attr = true;
  }
  split_kernel<T, D, GM, Loc>
      <<<dim3(c.splits, c.KV, B), kThreads, smem, stream>>>(c, loc);
  if (c.splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    combine_kernel<T, D, Loc><<<dim3(c.KV, B), kThreads, 0, stream>>>(c, loc);
  }
  return static_cast<int>(cudaGetLastError());
}

// dispatch on D and G (GM = G rounded up to a power of two)
template <typename T, int D, class Loc>
int launch_d(const Common& c, const Loc& loc, int B, cudaStream_t s) {
  if (c.G == 1) return launch_gm<T, D, 1>(c, loc, B, s);
  if (c.G == 2) return launch_gm<T, D, 2>(c, loc, B, s);
  if (c.G <= 4) return launch_gm<T, D, 4>(c, loc, B, s);
  return launch_gm<T, D, 8>(c, loc, B, s);
}

template <class LocF, class LocB>
int launch(const Common& c, const LocF& lf, const LocB& lb, int B, int D,
           int dtype, cudaStream_t s) {
  if (c.G < 1 || c.G > kMaxG || c.splits < 1 || c.splits > kMaxSplits ||
      c.chunk % kTile ||
      (c.splits > 1 && c.part == nullptr) ||
      static_cast<int64_t>(c.splits - 1) * c.chunk >= max(c.n_rows, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32) {
    switch (D) {
      case 32: return launch_d<float, 32>(c, lf, B, s);
      case 64: return launch_d<float, 64>(c, lf, B, s);
      case 128: return launch_d<float, 128>(c, lf, B, s);
    }
  } else if (dtype == kBF16) {
    switch (D) {
      case 32: return launch_d<__nv_bfloat16, 32>(c, lb, B, s);
      case 64: return launch_d<__nv_bfloat16, 64>(c, lb, B, s);
      case 128: return launch_d<__nv_bfloat16, 128>(c, lb, B, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode
}  // namespace repro
