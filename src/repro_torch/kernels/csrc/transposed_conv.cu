// Decomposed transposed convolution with a fused epilogue, fp32, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/transposed_conv.py::_tconv_kernel
// (pallas_call at transposed_conv.py:235).  A stride-s transposed conv splits
// into s*s parity sub-convolutions (paper §II-C): output y = s*b + r reads
// only kernel taps t with (t - p_lo + r) % s == 0, from input row b + off,
// off = (r + t - p_lo) / s.  The wrapper passes those per-parity lists
// (parity_schedule) as small int arrays.  Grid z is the parity plane, so
// every thread of a block walks the same live taps: K = live taps x Cin,
// and no zero-inserted input or dead tap is ever touched (MACs issued =
// nonzero MACs).  A plane with no live tap (k < s) keeps acc = 0 and still
// gets the epilogue (BN shift and residual are not zero).  Each result is
// stored at its interleaved NHWC position, and the residual is read there
// too, so there is no plane buffer and no de-interleave pass.
//
// Bound on the H100: device-memory bytes for ENet's thin decoder layers
// (Cin 4..16), fp32 CUDA-core FMAs otherwise; see PERF.md.

#include <cuda_runtime.h>

#include "igemm.cuh"

namespace repro {

constexpr int kMaxStride = 8;
constexpr int kMaxTaps = 8;  // live taps per parity: ceil(k / s)

struct Schedule {
  int count[kMaxStride];
  int tap[kMaxStride][kMaxTaps];
  int off[kMaxStride][kMaxTaps];
};

struct TconvGeo {
  int64_t M;  // n * hb * wb: every parity plane is indexed on the same grid
  int h, w, cin, cout;
  int oh, ow, k, s, hb, wb;
  Schedule sched;
};

// the geometry of one parity plane (ry, rx), as igemm_tile sees it; it
// refers to the kernel's __grid_constant__ parameter, so the schedule is
// read from parameter space and never copied per thread
struct PlaneGeo {
  const TconvGeo& g;
  int ry, rx, ntx;
  int64_t M;
  int K, h, w, cin, cout;

  __device__ __forceinline__ PlaneGeo(const TconvGeo& geo, int plane)
      : g(geo),
        ry(plane / geo.s),
        rx(plane % geo.s),
        ntx(geo.sched.count[plane % geo.s]),
        M(geo.M),
        K(geo.sched.count[plane / geo.s] * geo.sched.count[plane % geo.s] *
          geo.cin),
        h(geo.h),
        w(geo.w),
        cin(geo.cin),
        cout(geo.cout) {}

  // plane pixel m = (image, block row b, block col c) -> output
  // (s*b + ry, s*c + rx); blocks past the output edge are masked
  __device__ __forceinline__ bool out_pos(int64_t m, int64_t* img, int* b,
                                          int* c) const {
    const int64_t hw = static_cast<int64_t>(g.hb) * g.wb;
    *img = m / hw;
    const int rem = static_cast<int>(m - *img * hw);
    *b = rem / g.wb;
    *c = rem % g.wb;
    return m < M && g.s * *b + ry < g.oh && g.s * *c + rx < g.ow;
  }

  __device__ __forceinline__ Pix a_pixel(int64_t m) const {
    int64_t n;
    int b, c;
    if (!out_pos(m, &n, &b, &c)) return {0, kNoPixel, kNoPixel};
    return {n * h * w * cin, b, c};
  }

  __device__ __forceinline__ bool out_offset(int64_t m, int64_t* off) const {
    int64_t n;
    int b, c;
    const bool ok = out_pos(m, &n, &b, &c);
    *off = ((n * g.oh + g.s * b + ry) * g.ow + g.s * c + rx) * cout;
    return ok;
  }

  __device__ __forceinline__ Tap tap(int kidx) const {
    const int ci = kidx % cin;
    const int j = kidx / cin;
    const int jy = j / ntx, jx = j % ntx;
    const int ty = g.sched.tap[ry][jy], tx = g.sched.tap[rx][jx];
    return {g.sched.off[ry][jy], g.sched.off[rx][jx], ci,
            static_cast<int64_t>(ty * g.k + tx) * cin + ci};
  }
};

template <class T>
__global__ void __launch_bounds__(kThreads)
    tconv_kernel(const __grid_constant__ TconvGeo g,
                 const float* __restrict__ x,
                 const float* __restrict__ w, float* __restrict__ out,
                 Epilogue ep) {
  const PlaneGeo pg(g, blockIdx.z);
  igemm_tile<T>(pg, x, w, out, ep);
}

}  // namespace repro

// sched: for each parity r < s, kMaxTaps (tap, offset) pairs after a count,
// i.e. s rows of 1 + 2 * kMaxTaps ints.  Returns cudaErrorInvalidValue when
// the schedule does not fit the kernel's fixed arrays.
extern "C" int tconv_fwd(const float* x, const float* w, float* out,
                         const float* scale, const float* shift,
                         const float* alpha, const float* residual, int n,
                         int h, int w_in, int cin, int oh, int ow, int cout,
                         int k, int s, const int* sched, int bn, int prelu,
                         int residual_mode, void* stream) {
  using namespace repro;
  if (s < 1 || s > kMaxStride) return static_cast<int>(cudaErrorInvalidValue);
  TconvGeo g;
  g.h = h;
  g.w = w_in;
  g.cin = cin;
  g.cout = cout;
  g.oh = oh;
  g.ow = ow;
  g.k = k;
  g.s = s;
  g.hb = (oh + s - 1) / s;
  g.wb = (ow + s - 1) / s;
  g.M = static_cast<int64_t>(n) * g.hb * g.wb;
  for (int r = 0; r < kMaxStride; ++r) {
    g.sched.count[r] = 0;
    for (int j = 0; j < kMaxTaps; ++j) {
      g.sched.tap[r][j] = 0;
      g.sched.off[r][j] = 0;
    }
  }
  for (int r = 0; r < s; ++r) {
    const int* row = sched + r * (1 + 2 * kMaxTaps);
    if (row[0] < 0 || row[0] > kMaxTaps)
      return static_cast<int>(cudaErrorInvalidValue);
    g.sched.count[r] = row[0];
    for (int j = 0; j < row[0]; ++j) {
      g.sched.tap[r][j] = row[1 + 2 * j];
      g.sched.off[r][j] = row[2 + 2 * j];
    }
  }
  const Epilogue ep = {scale, shift, alpha, residual, bn, prelu,
                       residual_mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dispatch_tile(cout, [&](auto tile) {
    using T = decltype(tile);
    dim3 grid(static_cast<unsigned>((g.M + T::BM - 1) / T::BM),
              static_cast<unsigned>((cout + T::BN - 1) / T::BN),
              static_cast<unsigned>(s * s));
    tconv_kernel<T><<<grid, kThreads, 0, st>>>(g, x, w, out, ep);
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
