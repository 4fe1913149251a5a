// Decode attention forward: one query token per sequence attends to the S
// rows of its dense KV arena row under a (B, S) validity mask.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_fwd
// (Pallas TPU kernel).
//
// Layout: q (B, KV, G, D); k/v (B, KV, S, D) taken through strides, so the
// model's (B, S, KV, D) arena is read in place (the reference's adapter
// transposes the whole cache on every call; this kernel never copies it);
// valid (B, S) bool; out like q, any strides with unit stride along D.
//
// Bound on the H100: bytes, and only the valid rows' bytes count.  At
// OPT-1.3B with 16 slots (B = 16, H = KV = 32, S = 512, D = 64, bf16) the
// arena is 67 MB; the engine's mask is a prefix (rows < min(pos + 1, S)),
// so a step with ragged positions needs about half of it, ~8 us at
// 3.35 TB/s.  The first SIMT kernel streamed every row, masked or not,
// with one lane per key row, V one row at a time and B * KV blocks.
//
// Design: the shared decode core (decode_core.cuh: split-KV over
// (splits, KV, B) blocks with a combine pass, coalesced 16-byte row loads
// by lane groups, base-2 online softmax) over the DenseRows locator
// (decode_rows.cuh): a split
// first copies its rows' mask bytes into shared memory and narrows its
// range to [first valid, last valid]; inside it a row whose mask is 0 is
// never loaded.  Skipping masked rows is exact (the reference's -1e30
// gives them weight 0 once a row is valid); a sequence with no valid row
// gets the mean of V over all S rows, the reference's answer, the only
// case that reads masked rows.
#include "decode_rows.cuh"

namespace {

using repro::decode::DenseRows;

template <typename T>
DenseRows<T> rows(const void* k, const void* v, const void* valid,
                  const int64_t* s) {
  return DenseRows<T>{static_cast<const T*>(k),
                      static_cast<const T*>(v),
                      static_cast<const uint8_t*>(valid),
                      s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10]};
}

}  // namespace

// strides (elements): q (b, kv, g), k (b, kv, s), v (b, kv, s),
// valid (b, s), o (b, kv, g) — 14 values; the D axis has unit stride and
// K/V rows start on 16-byte boundaries (checked by the wrapper).  Rows are
// split into `splits` ranges of `chunk` rows (a multiple of 64); with
// splits > 1, `scratch` holds B * KV * splits partial records of
// record_floats(G, D) fp32 each, and a combine kernel follows on the same
// stream.  Returns a cudaError_t code.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* valid,
                                    void* o, void* scratch,
                                    const int64_t* strides, int B, int KV,
                                    int G, int S, int D, int splits,
                                    int chunk, float scale, int dtype,
                                    void* stream) {
  repro::decode::Common c;
  c.q = q;
  c.o = o;
  c.part = static_cast<float*>(scratch);
  c.q_sb = strides[0];
  c.q_sk = strides[1];
  c.q_sg = strides[2];
  c.o_sb = strides[11];
  c.o_sk = strides[12];
  c.o_sg = strides[13];
  c.KV = KV;
  c.G = G;
  c.splits = splits;
  c.chunk = chunk;
  c.n_rows = S;
  c.scale2 = scale * 1.4426950408889634f;
  return repro::decode::launch(c, rows<float>(k, v, valid, strides),
                               rows<__nv_bfloat16>(k, v, valid, strides), B,
                               D, dtype, static_cast<cudaStream_t>(stream));
}
