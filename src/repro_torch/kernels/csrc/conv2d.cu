// Dense NHWC x HWIO convolution with a fused epilogue, fp32 or bf16, for
// sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py::_conv_kernel
// (pallas_call at conv2d.py:195), which sums kh*kw shifted GEMM taps into an
// fp32 accumulator.  Here the whole conv is one implicit GEMM (igemm.cuh):
// grid (pixel tile, Cout tile), K = kh*kw*Cin walked tap-major through a
// 4-stage ring of asynchronous copies, the weight slab of the Cout tile
// resident in shared memory, every input read masked against the bounds
// (the copy zero-fills), so the per-dim (low, high) pads of SAME
// (asymmetric for even k), VALID and int padding cost nothing and need no
// padded copy or halo.  The high pads only set the output extent, which
// the caller passes.  Stride is any positive integer; rectangular kernels
// (5x1 / 1x5) are native.  As the Pallas kernel does, it takes fp32 or bf16
// x and w (and a residual of their type), accumulates in fp32 and returns
// their type: bf16 is staged as bf16 in shared memory, widened as the FMAs
// read it, and rounded once after the epilogue.
//
// Bound on the H100 (igemm.cuh): device-memory bytes for ENet's 1x1
// projections, k2 s2 downsamples, stem and decoder 3x3 4->4; FMAs for its
// 3x3 (dense and dilated), 5x1 and 1x5 layers at Cin 16-32; bf16 halves
// the bytes of the first group and leaves the FMAs of the second on the
// CUDA cores (a tensor-core form is a ROADMAP.md lever).  The plan
// (kernels/conv2d.py::conv_plan) picks the copy width (the widest of 16, 8
// bytes whose channel run divides Cin, else one element), the Cout tile and
// resident or streamed weights; PERF.md has each layer's time beside its
// bound.

#include <cuda_runtime.h>

#include "igemm.cuh"

namespace repro {

template <class T, class E, int VEC, bool RESIDENT>
__global__ void __launch_bounds__(T::THREADS)
    conv2d_kernel(ConvGeo g, const E* __restrict__ x,
                  const E* __restrict__ w, E* __restrict__ out,
                  Epilogue<E> ep) {
  igemm_conv<T, E, VEC, RESIDENT>(g, x, w, out, ep);
}

template <class T, class E, int V, bool RESIDENT>
cudaError_t launch_conv2d(const ConvGeo& g, const E* x, const E* w, E* out,
                          const Epilogue<E>& ep, cudaStream_t st) {
  const int bytes =
      ConvSmem::of<T, E>(g.K, RESIDENT, ep.residual_mode != kResidualNone)
          .total;
  static unsigned smem_set = 0;
  cudaError_t err = allow_big_smem(
      reinterpret_cast<const void*>(conv2d_kernel<T, E, V, RESIDENT>), bytes,
      &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>((g.M + T::BM - 1) / T::BM),
            static_cast<unsigned>((g.cout + T::BN - 1) / T::BN), 1);
  conv2d_kernel<T, E, V, RESIDENT><<<grid, T::THREADS, bytes, st>>>(
      g, x, w, out, ep);
  return cudaGetLastError();
}

}  // namespace repro

// x, w, out and residual are of dtype code `dtype` (kF32 or kBF16); scale,
// shift and alpha are fp32.  vec: elements per copy of x, 4 or 1 for fp32
// (16 or 4 bytes), 8, 4 or 1 for bf16 (16, 8 or 2 bytes); Cin must be a
// multiple of it and x aligned to its bytes.  tile: an id of dispatch_tile
// but the one-group 32-wide tile; resident: keep the weight slab in shared
// memory.
// Returns cudaErrorInvalidValue for a dtype or plan the kernel cannot run.
extern "C" int conv2d_fwd(const void* x, const void* w, void* out,
                          const float* scale, const float* shift,
                          const float* alpha, const void* residual, int n,
                          int h, int w_in, int cin, int oh, int ow, int cout,
                          int kh, int kw, int stride, int pad_top,
                          int pad_left, int bn, int prelu, int residual_mode,
                          int dtype, int vec, int tile, int resident,
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_dtype(dtype, [&](auto e) {
    using E = decltype(e);
    const int run = vec * static_cast<int>(sizeof(E));
    if (vec < 1 || cin % vec != 0 ||
        reinterpret_cast<uintptr_t>(x) % run != 0)
      return;
    const Epilogue<E> ep = {scale, shift, alpha,
                            static_cast<const E*>(residual), bn, prelu,
                            residual_mode};
    const E* xe = static_cast<const E*>(x);
    const E* we = static_cast<const E*>(w);
    E* oe = static_cast<E*>(out);
    dispatch_tile(tile, [&](auto t) {
      using T = decltype(t);
      // conv_plan takes the split-K tile for a 32-wide Cout tile, so the
      // one-group 32-wide tile (the transposed conv's) is not built here
      if constexpr (!(T::BN == 32 && T::KS == 1)) {
        dispatch_vec<E>(vec, [&](auto v) {
          constexpr int V = decltype(v)::value;
          err = resident
                    ? launch_conv2d<T, E, V, true>(g, xe, we, oe, ep, st)
                    : launch_conv2d<T, E, V, false>(g, xe, we, oe, ep, st);
        });
      }
    });
  });
  return static_cast<int>(err);
}

extern "C" const char* conv2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory (bytes) that conv2d_fwd asks for with the plan
// (tile, resident) on K = kh * kw * Cin rows, with or without a residual in
// the epilogue, or -1 for a dtype or tile the kernel does not build.
// kernels/tiling_policy.py is held to it.
extern "C" int conv2d_smem_bytes(int k_rows, int dtype, int tile,
                                 int resident, int residual) {
  using namespace repro;
  int bytes = -1;
  dispatch_dtype(dtype, [&](auto e) {
    using E = decltype(e);
    dispatch_tile(tile, [&](auto t) {
      using T = decltype(t);
      if constexpr (!(T::BN == 32 && T::KS == 1))
        bytes = ConvSmem::of<T, E>(k_rows, resident != 0, residual != 0)
                    .total;
    });
  });
  return bytes;
}
