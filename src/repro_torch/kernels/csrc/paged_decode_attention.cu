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
// Bound on the H100: bytes of the valid rows, 2 * D elements of K and V per
// row and KV head.  At the OPT-1.3B serve shape (B = 16, KV = 32, G = 1,
// D = 64, bf16, up to 512 rows a sequence) the full tables are 67 MB and
// the valid rows about half; a layer's pool at 513 blocks is more than the
// 50 MB L2, so a real decode step finds most of it cold.  The first SIMT
// kernel ran B * KV blocks, each first copying its table serially into a
// static 2,048-entry array, then one lane per key row with a division per
// row and V one row at a time.
//
// Design: the shared decode core (decode_core.cuh: split-KV over
// (splits, KV, B) blocks with a combine pass, coalesced 16-byte row loads
// by lane groups, base-2 online softmax) over the PagedRows locator
// (decode_rows.cuh): a split
// (its rows a multiple of 64 and of bs) copies only its slice of the table,
// the entries that hold valid rows, into shared memory, and finds a row as
// (entry, offset) by shift and mask for a power-of-two bs (a division
// otherwise).  Rows at or past lens are never read, nor are table entries
// past them, so a stale or trash row never meets a probability, not even a
// zero one.  lens[b] == 0 gives 0, as the Pallas kernel does (its oracle
// gives the mean of V; ROADMAP R8).  A table entry outside [0, nblocks) in
// any split is never dereferenced: the sequence's whole output is NaN (the
// engine checks its host table before upload).
#include "decode_rows.cuh"

namespace {

using repro::decode::PagedRows;

template <typename T>
PagedRows<T> rows(const void* k, const void* v, const void* tables,
                  const void* lens, const int64_t* s, int nb, int bs,
                  int nblocks) {
  return PagedRows<T>{static_cast<const T*>(k),
                      static_cast<const T*>(v),
                      static_cast<const int32_t*>(tables),
                      static_cast<const int32_t*>(lens),
                      s[3], s[4], s[5], s[6], s[7], s[8],
                      nb, bs, repro::decode::log2_or_neg(bs), nblocks};
}

}  // namespace

// strides (elements): q (b, kv, g), k pool (block, offset, kv), v pool
// (block, offset, kv), o (b, kv, g) — 12 values; the D axis has unit
// stride and K/V rows start on 16-byte boundaries (checked by the
// wrapper).  block_tables (B, nb) and lens (B,) are contiguous int32.
// The nb * bs virtual rows are split into `splits` ranges of `chunk` rows
// (a multiple of 64 and of bs); with splits > 1, `scratch` holds B * KV *
// splits partial records of record_floats(G, D) fp32 each, and a combine
// kernel follows on the same stream.  Returns a cudaError_t code.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lens, void* o, void* scratch,
    const int64_t* strides, int B, int KV, int G, int nb, int bs,
    int nblocks, int D, int splits, int chunk, float scale, int dtype,
    void* stream) {
  if (nb < 1 || bs < 1 || chunk % bs)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::decode::Common c;
  c.q = q;
  c.o = o;
  c.part = static_cast<float*>(scratch);
  c.q_sb = strides[0];
  c.q_sk = strides[1];
  c.q_sg = strides[2];
  c.o_sb = strides[9];
  c.o_sk = strides[10];
  c.o_sg = strides[11];
  c.KV = KV;
  c.G = G;
  c.splits = splits;
  c.chunk = chunk;
  c.n_rows = nb * bs;
  c.scale2 = scale * 1.4426950408889634f;
  return repro::decode::launch(
      c, rows<float>(k_pool, v_pool, block_tables, lens, strides, nb, bs,
                     nblocks),
      rows<__nv_bfloat16>(k_pool, v_pool, block_tables, lens, strides, nb, bs,
                          nblocks),
      B, D, dtype, static_cast<cudaStream_t>(stream));
}
