// Implicit-GEMM tile loop shared by the dense and the transposed conv kernels.
//
// A conv is a GEMM with M = output pixels, N = Cout and K = live taps x Cin,
// whose A operand (the im2col matrix) is never materialised: each K step
// reads the input at (pixel, tap) with bounds masks, so zero padding costs
// no memory.  A block owns a BM x BN output tile.  Per K step of BK it
// stages a BM x BK slice of A and the BK x BN slice of the weight slab in
// shared memory, then each of the 256 threads accumulates a TM x TN register
// tile in fp32 on the CUDA cores (no TF32: the port holds fp32 to the
// reference's 1e-5).  The epilogue runs on the registers and the result is
// stored straight to NHWC.
//
// What differs between the kernels is only the geometry, a small struct the
// kernel passes in (see conv2d.cu, transposed_conv.cu):
//   int64_t M; int K, h, w, cin, cout;
//   Pix  a_pixel(int64_t m)            input origin of output pixel m
//   bool out_offset(int64_t m, int64_t* off)   NHWC offset of pixel m
//   Tap  tap(int k)                    (dy, dx, ci, weight row) of GEMM row k
//
// Bound: fp32 CUDA-core FMAs for the wide layers, device-memory bytes for
// the thin ones (Cin or Cout of 4..16).  This first version keeps every
// operand fp32 and issues scalar shared-memory reads; wgmma/TMA pipelines
// are later work (ROADMAP.md).
#pragma once

#include <climits>
#include <cstdint>

#include "epilogue.cuh"

namespace repro {

constexpr int kThreads = 256;
constexpr int kBK = 16;
// an invalid pixel's input origin: every tap then fails the bounds check
constexpr int kNoPixel = INT_MIN / 2;

struct Pix {
  int64_t base;  // offset of the image in the NHWC input
  int iy0, ix0;  // input row/col that tap offset (0, 0) reads
};

struct Tap {
  int dy, dx, ci;
  int64_t wrow;  // row of the (K, Cout) weight matrix
};

template <int BM_, int BN_, int TM_, int TN_>
struct TileShape {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int TX = BN / TN;  // threads along Cout
  static constexpr int TY = BM / TM;  // threads along pixels
  static constexpr int A_ROWS = BM * kBK / kThreads;  // A pixels per thread
  static_assert(TX * TY == kThreads, "a tile uses 256 threads");
  static_assert(BM % (kThreads / kBK) == 0, "A slice splits evenly");
};

template <class T, class Geo>
__device__ __forceinline__ void igemm_tile(const Geo& g,
                                           const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           float* __restrict__ out,
                                           const Epilogue& ep) {
  // A is stored k-major (+4 pad keeps rows 16-byte aligned, fewer conflicts)
  __shared__ float As[kBK][T::BM + 4];
  __shared__ float Bs[kBK][T::BN];

  const int t = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * T::BM;
  const int n0 = blockIdx.y * T::BN;

  // each thread loads A column ka for pixels pa_row + i * (256 / BK)
  const int ka = t % kBK;
  const int pa_row = t / kBK;
  Pix pa[T::A_ROWS];
#pragma unroll
  for (int i = 0; i < T::A_ROWS; ++i)
    pa[i] = g.a_pixel(m0 + pa_row + i * (kThreads / kBK));

  const int tx = t % T::TX;
  const int ty = t / T::TX;
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    {  // stage A: masked gather of the implicit im2col slice
      const int k = k0 + ka;
      const bool kval = k < g.K;
      Tap tp = {0, 0, 0, 0};
      if (kval) tp = g.tap(k);
#pragma unroll
      for (int i = 0; i < T::A_ROWS; ++i) {
        const int iy = pa[i].iy0 + tp.dy;
        const int ix = pa[i].ix0 + tp.dx;
        float v = 0.0f;
        if (kval && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w)
          v = x[pa[i].base + (static_cast<int64_t>(iy) * g.w + ix) * g.cin +
                tp.ci];
        As[ka][pa_row + i * (kThreads / kBK)] = v;
      }
    }
    // stage B: the weight slab rows of this K step for the Cout tile
    for (int e = t; e < kBK * T::BN; e += kThreads) {
      const int kb = e / T::BN;
      const int nn = e % T::BN;
      const int k = k0 + kb;
      float v = 0.0f;
      if (k < g.K && n0 + nn < g.cout)
        v = w[g.tap(k).wrow * g.cout + n0 + nn];
      Bs[kb][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[T::TM], b[T::TN];
#pragma unroll
      for (int i = 0; i < T::TM; ++i) a[i] = As[kk][ty * T::TM + i];
#pragma unroll
      for (int j = 0; j < T::TN; ++j) b[j] = Bs[kk][tx * T::TN + j];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    int64_t off;
    if (!g.out_offset(m0 + ty * T::TM + i, &off)) continue;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int co = n0 + tx * T::TN + j;
      if (co < g.cout) out[off + co] = apply_epilogue(acc[i][j], ep, co,
                                                      off + co);
    }
  }
}

// Run `launch(TileShape)` with the tile whose Cout width fits `cout` best:
// thin layers waste fewer lanes on a narrow tile with more pixels.
template <class Launch>
inline void dispatch_tile(int cout, Launch&& launch) {
  if (cout <= 8)
    launch(TileShape<128, 8, 4, 1>{});
  else if (cout <= 16)
    launch(TileShape<128, 16, 4, 2>{});
  else if (cout <= 32)
    launch(TileShape<64, 32, 4, 2>{});
  else
    launch(TileShape<64, 64, 4, 4>{});
}

}  // namespace repro
