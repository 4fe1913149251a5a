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
// The first SIMT kernel ran B * KV blocks, one lane per key row (its D
// bytes as uncoalesced 16-byte loads), V one row at a time per warp, and
// loaded the mask, K and the scales of every row, masked or not.
//
// Design: the shared decode core (decode_core.cuh: split-KV over (splits,
// KV, B) blocks with a combine pass, coalesced 16-byte int8 row loads by
// lane groups (8-byte at G > 2 or D = 32), each row's two scales fetched
// once into the warp's slots of the cp.async ring, int8 -> fp32 by byte
// permute, base-2 online softmax) over the DenseRows locator of the fp
// kernel (decode_rows.cuh) with the scale planes added: a split copies its
// mask bytes into shared memory and narrows its range to [first valid, last
// valid]; a masked row, its K/V and its scales are never loaded.  A sequence
// with no valid row gets the mean of the dequantized V over all S rows,
// sum(v_scale * v_i8) / S: the Pallas kernel's answer under its finite
// -1e30.  Over the same rows and split plan it gives the paged int8 kernel's
// bits.
#include "decode_rows.cuh"

namespace {

using repro::decode::DenseRows;

struct DenseRowsQ {
  using Elem = int8_t;
  static constexpr bool kScaled = true;
  static constexpr bool kMeanIfEmpty = true;
  DenseRows<int8_t> rows;
  const float* ks;
  const float* vs;
  int64_t ks_sb, ks_sk, ks_ss, vs_sb, vs_sk, vs_ss;

  __host__ __device__ static size_t smem_bytes(int chunk,
                                               const DenseRowsQ& p) {
    return DenseRows<int8_t>::smem_bytes(chunk, p.rows);
  }

  struct View : DenseRows<int8_t>::View {
    const float* ksb;
    const float* vsb;
    int64_t ks_ss, vs_ss;
    __device__ const float* ks(int r) const { return ksb + r * ks_ss; }
    __device__ const float* vs(int r) const { return vsb + r * vs_ss; }
  };

  __device__ const int8_t* v_any(int b, int kvh, int r) const {
    return rows.v_any(b, kvh, r);
  }
  __device__ float vs_any(int b, int kvh, int r) const {
    return vs[b * vs_sb + kvh * vs_sk + r * vs_ss];
  }

  __device__ View prologue(int b, int kvh, int r0, int r1,
                           unsigned char* smem, int* red, int* lo,
                           int* hi) const {
    return View{rows.prologue(b, kvh, r0, r1, smem, red, lo, hi),
                ks + b * ks_sb + kvh * ks_sk, vs + b * vs_sb + kvh * vs_sk,
                ks_ss, vs_ss};
  }
};

// Int8 -> fp32 of the decode core (VecI8<8> and VecI8<16>) against
// static_cast<float>, 16 values a thread: out[i] and out[n + i] the
// core's, out[2 * n + i] the cast's.
__global__ void int8_to_float_kernel(const int8_t* x, float* out, int n) {
  using repro::decode::VecI8;
  const int i = 16 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i + 16 > n) return;
  float f8[16], f16[16];
  VecI8<8>::cvt(*reinterpret_cast<const uint2*>(x + i),
                *reinterpret_cast<float(*)[8]>(f8));
  VecI8<8>::cvt(*reinterpret_cast<const uint2*>(x + i + 8),
                *reinterpret_cast<float(*)[8]>(f8 + 8));
  VecI8<16>::cvt(*reinterpret_cast<const uint4*>(x + i), f16);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    out[i + j] = f8[j];
    out[n + i + j] = f16[j];
    out[2 * n + i + j] = static_cast<float>(x[i + j]);
  }
}

}  // namespace

// strides (elements): q (b, kv, g), k (b, kv, s), v (b, kv, s),
// k_scale (b, kv, s), v_scale (b, kv, s), valid (b, s), o (b, kv, g) —
// 20 values; the D axis has unit stride.  K/V rows must start on 16-byte
// boundaries (checked by the wrapper).  Rows are split into `splits`
// ranges of `chunk` rows (a multiple of 64); with splits > 1, `scratch`
// holds B * KV * splits partial records of record_floats(G, D) fp32 each,
// and a combine kernel follows on the same stream.  Returns a cudaError_t
// code.
extern "C" int decode_attention_quant_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* valid, void* o, void* scratch,
    const int64_t* strides, int B, int KV, int G, int S, int D, int splits,
    int chunk, float scale, int dtype, void* stream) {
  repro::decode::Common c;
  c.q = q;
  c.o = o;
  c.part = static_cast<float*>(scratch);
  c.q_sb = strides[0];
  c.q_sk = strides[1];
  c.q_sg = strides[2];
  c.o_sb = strides[17];
  c.o_sk = strides[18];
  c.o_sg = strides[19];
  c.KV = KV;
  c.G = G;
  c.splits = splits;
  c.chunk = chunk;
  c.n_rows = S;
  c.scale2 = scale * 1.4426950408889634f;
  const DenseRowsQ loc{
      DenseRows<int8_t>{static_cast<const int8_t*>(k),
                        static_cast<const int8_t*>(v),
                        static_cast<const uint8_t*>(valid), strides[3],
                        strides[4], strides[5], strides[6], strides[7],
                        strides[8], strides[15], strides[16]},
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      strides[9], strides[10], strides[11], strides[12], strides[13],
      strides[14]};
  return repro::decode::launch(c, loc, loc, B, D, dtype,
                               static_cast<cudaStream_t>(stream));
}

// n int8 values (n a multiple of 16, x 16-byte aligned) -> out (3 * n
// fp32): the decode core's conversion 8 and 16 values at a time, then
// static_cast<float>.  For the card test of that conversion; returns a
// cudaError_t code.
extern "C" int decode_int8_to_float(const void* x, void* out, int n,
                                    void* stream) {
  if (n <= 0 || n % 16) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = n / 16;
  int8_to_float_kernel<<<(threads + 127) / 128, 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
