// Dense NHWC x HWIO convolution with a fused epilogue, fp32, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py::_conv_kernel
// (pallas_call at conv2d.py:195), which sums kh*kw shifted GEMM taps into an
// fp32 accumulator.  Here the whole conv is one implicit GEMM (igemm.cuh):
// grid (pixel tile, Cout tile), K = kh*kw*Cin walked in steps of 16, the
// weight slab of the Cout tile staged in shared memory step by step, and
// every input read masked against the bounds, so the per-dim (low, high)
// pads of SAME (asymmetric for even k), VALID and int padding cost nothing
// and need no padded copy or halo.  The high pads only set the output
// extent, which the caller passes.  Stride is any positive integer;
// rectangular kernels (5x1 / 1x5) are native.
//
// Bound on the H100: fp32 CUDA-core FMAs for the 3x3 layers (Cin 16..128),
// device-memory bytes for the 1x1 projections; see PERF.md for the measured
// time beside the bound.

#include <cuda_runtime.h>

#include "igemm.cuh"

namespace repro {

struct ConvGeo {
  int64_t M;  // n * oh * ow
  int K;      // kh * kw * cin
  int h, w, cin, cout;
  int oh, ow, kw, stride, pad_top, pad_left;

  __device__ __forceinline__ Pix a_pixel(int64_t m) const {
    if (m >= M) return {0, kNoPixel, kNoPixel};
    const int64_t hw = static_cast<int64_t>(oh) * ow;
    const int64_t n = m / hw;
    const int rem = static_cast<int>(m - n * hw);
    const int oy = rem / ow, ox = rem % ow;
    return {n * h * w * cin, oy * stride - pad_top, ox * stride - pad_left};
  }

  __device__ __forceinline__ bool out_offset(int64_t m, int64_t* off) const {
    *off = m * cout;
    return m < M;
  }

  __device__ __forceinline__ Tap tap(int k) const {
    const int ci = k % cin;
    const int tp = k / cin;
    // HWIO flattens (dy, dx, ci) in exactly this order: the row is k
    return {tp / kw, tp % kw, ci, k};
  }
};

template <class T>
__global__ void __launch_bounds__(kThreads)
    conv2d_kernel(ConvGeo g, const float* __restrict__ x,
                  const float* __restrict__ w, float* __restrict__ out,
                  Epilogue ep) {
  igemm_tile<T>(g, x, w, out, ep);
}

}  // namespace repro

extern "C" int conv2d_fwd(const float* x, const float* w, float* out,
                          const float* scale, const float* shift,
                          const float* alpha, const float* residual, int n,
                          int h, int w_in, int cin, int oh, int ow, int cout,
                          int kh, int kw, int stride, int pad_top,
                          int pad_left, int bn, int prelu, int residual_mode,
                          void* stream) {
  using namespace repro;
  ConvGeo g;
  g.M = static_cast<int64_t>(n) * oh * ow;
  g.K = kh * kw * cin;
  g.h = h;
  g.w = w_in;
  g.cin = cin;
  g.cout = cout;
  g.oh = oh;
  g.ow = ow;
  g.kw = kw;
  g.stride = stride;
  g.pad_top = pad_top;
  g.pad_left = pad_left;
  const Epilogue ep = {scale, shift, alpha, residual, bn, prelu,
                       residual_mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dispatch_tile(cout, [&](auto tile) {
    using T = decltype(tile);
    dim3 grid(static_cast<unsigned>((g.M + T::BM - 1) / T::BM),
              static_cast<unsigned>((cout + T::BN - 1) / T::BN), 1);
    conv2d_kernel<T><<<grid, kThreads, 0, st>>>(g, x, w, out, ep);
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
