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
// The first SIMT kernel ran B * KV blocks, each copying its whole table,
// one lane per key row and V one row at a time.
//
// Design: the shared decode core (decode_core.cuh: split-KV over (splits,
// KV, B) blocks with a combine pass, coalesced 16-byte int8 row loads by
// lane groups (8-byte at G > 2 or D = 32), each row's two scales fetched
// once into the warp's slots of the cp.async ring, int8 -> fp32 by byte
// permute, base-2 online softmax) over the PagedRows locator of the fp
// kernel (decode_rows.cuh) with the scale planes added, found through the
// same (entry, offset): a split copies only its slice of the table, rows at
// or past lens (their K/V and their scales) are never read, lens[b] == 0
// gives 0 (the Pallas kernel's answer; ROADMAP R8), and a table entry
// outside [0, nblocks) is never dereferenced: the sequence's whole output is
// NaN.  Over the same rows and split plan it gives the dense int8 kernel's
// bits.
#include "decode_rows.cuh"

namespace {

using repro::decode::PagedRows;

struct PagedRowsQ {
  using Elem = int8_t;
  static constexpr bool kScaled = true;
  static constexpr bool kMeanIfEmpty = false;
  PagedRows<int8_t> rows;
  const float* ks;
  const float* vs;
  int64_t ks_sn, ks_so, ks_sk, vs_sn, vs_so, vs_sk;

  __host__ __device__ static size_t smem_bytes(int chunk,
                                               const PagedRowsQ& p) {
    return PagedRows<int8_t>::smem_bytes(chunk, p.rows);
  }

  struct View : PagedRows<int8_t>::View {
    const float* ksb;
    const float* vsb;
    int64_t ks_sn, ks_so, vs_sn, vs_so;
    __device__ const float* ks(int r) const {
      int blk, off;
      locate(r, &blk, &off);
      return ksb + blk * ks_sn + off * ks_so;
    }
    __device__ const float* vs(int r) const {
      int blk, off;
      locate(r, &blk, &off);
      return vsb + blk * vs_sn + off * vs_so;
    }
  };

  __device__ View prologue(int b, int kvh, int r0, int r1,
                           unsigned char* smem, int* red, int* lo,
                           int* hi) const {
    return View{rows.prologue(b, kvh, r0, r1, smem, red, lo, hi),
                ks + kvh * ks_sk, vs + kvh * vs_sk, ks_sn, ks_so, vs_sn,
                vs_so};
  }
};

}  // namespace

// strides (elements): q (b, kv, g), k pool (block, offset, kv), v pool
// (block, offset, kv), k_scale (block, offset, kv), v_scale (block,
// offset, kv), o (b, kv, g) — 18 values; the D axis has unit stride and
// K/V rows start on 16-byte boundaries (checked by the wrapper).
// block_tables (B, nb) and lens (B,) are contiguous int32.  The nb * bs
// virtual rows are split into `splits` ranges of `chunk` rows (a multiple
// of 64 and of bs); with splits > 1, `scratch` holds B * KV * splits
// partial records of record_floats(G, D) fp32 each, and a combine kernel
// follows on the same stream.  Returns a cudaError_t code.
extern "C" int paged_decode_attention_quant_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lens, void* o, void* scratch, const int64_t* strides, int B,
    int KV, int G, int nb, int bs, int nblocks, int D, int splits, int chunk,
    float scale, int dtype, void* stream) {
  if (nb < 1 || bs < 1 || chunk % bs)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::decode::Common c;
  c.q = q;
  c.o = o;
  c.part = static_cast<float*>(scratch);
  c.q_sb = strides[0];
  c.q_sk = strides[1];
  c.q_sg = strides[2];
  c.o_sb = strides[15];
  c.o_sk = strides[16];
  c.o_sg = strides[17];
  c.KV = KV;
  c.G = G;
  c.splits = splits;
  c.chunk = chunk;
  c.n_rows = nb * bs;
  c.scale2 = scale * 1.4426950408889634f;
  const PagedRowsQ loc{
      PagedRows<int8_t>{static_cast<const int8_t*>(k_pool),
                        static_cast<const int8_t*>(v_pool),
                        static_cast<const int32_t*>(block_tables),
                        static_cast<const int32_t*>(lens), strides[3],
                        strides[4], strides[5], strides[6], strides[7],
                        strides[8], nb, bs, repro::decode::log2_or_neg(bs),
                        nblocks},
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      strides[9], strides[10], strides[11], strides[12], strides[13],
      strides[14]};
  return repro::decode::launch(c, loc, loc, B, D, dtype,
                               static_cast<cudaStream_t>(stream));
}
