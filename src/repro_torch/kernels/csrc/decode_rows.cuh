// The row locators of the decode core (decode_core.cuh), over fp rows of
// element type KT: DenseRows (a (B, KV, S, D) arena under a (B, S) mask)
// and PagedRows (a (nblocks, bs, KV, D) pool through block tables and
// lens).  The int8 kernels extend them with the rows' fp32 scales
// (decode_attention_quant.cu, paged_decode_attention_quant.cu).
#pragma once

#include "decode_core.cuh"

namespace repro {
namespace decode {

// A split first copies its rows' mask bytes into shared memory and narrows
// its range to [first valid, last valid]; inside it a row whose mask is 0
// is never loaded.  A sequence with no valid row gets the mean of V over
// all S rows, the reference's answer.
template <typename KT>
struct DenseRows {
  using Elem = KT;
  static constexpr bool kScaled = false;
  static constexpr bool kMeanIfEmpty = true;
  const KT* k;
  const KT* v;
  const uint8_t* valid;
  int64_t k_sb, k_sk, k_ss, v_sb, v_sk, v_ss, m_sb, m_ss;

  // one mask byte per row of a split
  __host__ __device__ static size_t smem_bytes(int chunk, const DenseRows&) {
    return static_cast<size_t>(chunk);
  }

  struct View {
    const KT* kb;
    const KT* vb;
    int64_t k_ss, v_ss;
    const uint8_t* msk;
    int r0;
    bool bad;
    __device__ bool ok(int r) const { return msk[r - r0] != 0; }
    __device__ const KT* k(int r) const { return kb + r * k_ss; }
    __device__ const KT* v(int r) const { return vb + r * v_ss; }
  };

  __device__ const KT* v_any(int b, int kvh, int r) const {
    return v + b * v_sb + kvh * v_sk + r * v_ss;
  }

  // The split's mask bytes into shared memory, and [lo, hi) = its first
  // and one past its last valid row (lo == hi when none is valid).
  __device__ View prologue(int b, int kvh, int r0, int r1,
                           unsigned char* smem, int* red, int* lo,
                           int* hi) const {
    const uint8_t* mb = valid + b * m_sb;
    int first = INT_MAX, last = -1;
    for (int i = threadIdx.x; i < r1 - r0; i += kThreads) {
      const uint8_t x = mb[(r0 + i) * m_ss];
      smem[i] = x;
      if (x) {
        first = min(first, i);
        last = i;
      }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    if (threadIdx.x % 32 == 0) {
      red[threadIdx.x / 32] = first;
      red[kWarps + threadIdx.x / 32] = last;
    }
    __syncthreads();
    first = INT_MAX;
    last = -1;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      first = min(first, red[w]);
      last = max(last, red[kWarps + w]);
    }
    *lo = last < 0 ? r0 : r0 + first;
    *hi = last < 0 ? r0 : r0 + last + 1;
    return View{k + b * k_sb + kvh * k_sk, v + b * v_sb + kvh * v_sk, k_ss,
                v_ss, smem, r0, false};
  }
};

// A split (its rows a multiple of 64 and of bs) copies only its slice of
// the table, the entries that hold valid rows, into shared memory, and
// finds a row as (entry, offset) by shift and mask for a power-of-two bs (a
// division otherwise).  Rows at or past lens are never read, nor are table
// entries past them.  lens == 0 gives 0; a table entry outside
// [0, nblocks) is never dereferenced: the split is bad.
template <typename KT>
struct PagedRows {
  using Elem = KT;
  static constexpr bool kScaled = false;
  static constexpr bool kMeanIfEmpty = false;
  const KT* k;
  const KT* v;
  const int32_t* tables;
  const int32_t* lens;
  int64_t k_sn, k_so, k_sk, v_sn, v_so, v_sk;
  int nb, bs, lbs, nblocks;  // lbs = log2(bs), or -1 if bs is no power of 2

  // the split's table entries
  __host__ __device__ static size_t smem_bytes(int chunk, const PagedRows& p) {
    return static_cast<size_t>(chunk / p.bs) * sizeof(int);
  }

  struct View {
    const KT* kb;
    const KT* vb;
    int64_t k_sn, k_so, v_sn, v_so;
    const int* tbl;  // the split's entries, from entry e0
    int e0, bs, lbs;
    bool bad;
    __device__ bool ok(int) const { return true; }  // every row < hi is valid
    __device__ void locate(int r, int* blk, int* off) const {
      const int e = lbs >= 0 ? r >> lbs : r / bs;
      *off = lbs >= 0 ? r & (bs - 1) : r - e * bs;
      *blk = tbl[e - e0];
    }
    __device__ const KT* k(int r) const {
      int blk, off;
      locate(r, &blk, &off);
      return kb + blk * k_sn + off * k_so;
    }
    __device__ const KT* v(int r) const {
      int blk, off;
      locate(r, &blk, &off);
      return vb + blk * v_sn + off * v_so;
    }
  };

  // [lo, hi) = the split's rows below lens; its table entries that hold
  // them into shared memory, each checked against the pool.
  __device__ View prologue(int b, int kvh, int r0, int r1,
                           unsigned char* smem, int*, int* lo,
                           int* hi) const {
    const int n_valid = max(0, min(lens[b], nb * bs));
    *lo = r0;
    *hi = max(r0, min(r1, n_valid));
    const int e0 = r0 / bs, e1 = (*hi + bs - 1) / bs;
    int* tbl = reinterpret_cast<int*>(smem);
    const int32_t* tb = tables + static_cast<int64_t>(b) * nb;
    int bad = 0;
    for (int e = e0 + static_cast<int>(threadIdx.x); e < e1; e += kThreads) {
      int x = tb[e];
      if (x < 0 || x >= nblocks) {
        bad = 1;
        x = 0;
      }
      tbl[e - e0] = x;
    }
    bad = __syncthreads_or(bad);  // also the barrier for the table
    return View{k + kvh * k_sk, v + kvh * v_sk, k_sn, k_so, v_sn, v_so, tbl,
                e0, bs, lbs, bad != 0};
  }
};

// log2(bs) for a power of two, else -1
inline int log2_or_neg(int bs) {
  if (bs & (bs - 1)) return -1;
  int l = 0;
  while ((1 << l) < bs) ++l;
  return l;
}

}  // namespace decode
}  // namespace repro
