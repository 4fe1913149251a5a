// Tensor-core building blocks shared by the bf16 flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): warp-level mma.sync on
// bf16 operands with fp32 accumulation, ldmatrix from shared memory, and
// cp.async copies from global to shared memory.  Inline PTX only, no CUTLASS.
//
// Fragment layouts of mma.sync.aligned.m16n8k16 (lane = 4 * gid + tig):
//   A (16 x 16, row-major), 4 registers of 2 bf16:
//     a0 (row gid, k 2tig..+1)  a1 (row gid+8, k 2tig..)
//     a2 (row gid, k 8+2tig..)  a3 (row gid+8, k 8+2tig..)
//   B (16 x 8, k x n), 2 registers: b0 (k 2tig..+1, n gid), b1 (k 8+2tig..)
//   C (16 x 8 fp32), 4 registers: c0, c1 (row gid, n 2tig, 2tig+1),
//     c2, c3 (row gid+8, n 2tig, 2tig+1)
// So the C fragments of two neighbouring n-tiles, rounded to bf16 in pairs,
// are the A fragment of the next product over those 16 columns (pack_a).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i gets matrix i's (row lane/4, cols 2(lane%4), +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed: register i gets (rows 2(lane%4), +1;
// col lane/4) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b on one 16x8x16 tile
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest-even bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment over 16 columns from the C fragments of the n-tiles that
// hold columns 0-7 (c_lo) and 8-15 (c_hi).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c_lo)[4],
                                       const float (&c_hi)[4]) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

// 16 bytes global -> shared; with `valid` false nothing is read and the 16
// bytes are zero-filled.  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// 8 bytes global -> shared, zero-filled when `valid` is false; both
// addresses 8-byte aligned
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// 4 bytes global -> shared, zero-filled when `valid` is false
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `N` of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x (MUFU.EX2, flushing denormals): 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of a strided (L, D) bf16 matrix into a shared
// tile with row stride RS elements, by 16-byte cp.async from all `threads`
// threads of the block; rows at or past `limit` are zero-filled.
template <int ROWS, int D, int RS, int threads>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int row0,
                                          int limit) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * CH) % threads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / threads; ++i) {
    const int idx = i * threads + static_cast<int>(threadIdx.x);
    const int r = idx / CH, c = idx % CH;
    const bool in = row0 + r < limit;
    const __nv_bfloat16* s =
        src + (in ? static_cast<int64_t>(row0 + r) * stride : 0) + c * 8;
    cp_async_16(smem_addr(dst + r * RS + c * 8), s, in);
  }
}

}  // namespace mma
}  // namespace repro
