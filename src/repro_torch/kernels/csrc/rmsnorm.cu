// RMSNorm forward: out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w,
// computed in fp32, stored in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm_fwd (Pallas TPU kernel).
//
// Bound on the H100: bytes.  One read of x, one read of w, one write of out,
// about 4 operations per element: at D = 2048 that is far below the card's
// operations-per-byte balance.  At the decode shape (R = 16 slots, D = 2048,
// ~135 KB) the kernel is over in well under the launch latency, so launch
// overhead, not the bound, sets its time.
//
// Design: one block of 256 threads per row.  Each thread accumulates the sum
// of squares of its strided elements in fp32, a warp-shuffle reduction and a
// shared-memory pass over the 8 warps give the row's sum, and a second
// strided pass writes the scaled row (the re-read of x hits L1/L2: a row is
// at most a few KB).  Any R and any D are taken: the strided loops mask the
// ragged edge themselves, unlike the Pallas kernel, which needs a row block
// that divides R.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ out, int D, int64_t x_row_stride,
               int64_t out_row_stride, float eps) {
  __shared__ float partial[kThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * x_row_stride;
  T* orow = out + row * out_row_stride;

  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = repro::to_float(xr[d]);
    ss += v * v;
  }
  ss = repro::warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.f;
    t = repro::warp_sum(t);
    if (lane == 0) partial[0] = t;
  }
  __syncthreads();
  const float rstd = rsqrtf(partial[0] / static_cast<float>(D) + eps);

  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float y = repro::to_float(xr[d]) * rstd;
    orow[d] = repro::from_float<T>(y * repro::to_float(w[d]));
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int R, int D,
           int64_t x_row_stride, int64_t out_row_stride, float eps,
           cudaStream_t stream) {
  rmsnorm_kernel<T, W><<<R, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), D, x_row_stride, out_row_stride, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (R, D) with unit stride along D; w: (D,).  x_dtype/w_dtype are
// repro::DtypeCode values.  Returns a cudaError_t code (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int R,
                           int D, int64_t x_row_stride,
                           int64_t out_row_stride, float eps, int x_dtype,
                           int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == repro::kF32 && w_dtype == repro::kF32)
    return launch<float, float>(x, w, out, R, D, x_row_stride,
                                out_row_stride, eps, s);
  if (x_dtype == repro::kBF16 && w_dtype == repro::kBF16)
    return launch<bf16, bf16>(x, w, out, R, D, x_row_stride, out_row_stride,
                              eps, s);
  if (x_dtype == repro::kBF16 && w_dtype == repro::kF32)
    return launch<bf16, float>(x, w, out, R, D, x_row_stride,
                               out_row_stride, eps, s);
  if (x_dtype == repro::kF32 && w_dtype == repro::kBF16)
    return launch<float, bf16>(x, w, out, R, D, x_row_stride,
                               out_row_stride, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
