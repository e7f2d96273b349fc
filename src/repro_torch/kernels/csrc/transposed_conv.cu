// Decomposed transposed convolution with a fused epilogue, fp32, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/transposed_conv.py::_tconv_kernel
// (pallas_call at transposed_conv.py:235).  A stride-s transposed conv splits
// into s*s parity sub-convolutions (paper §II-C): output y = s*b + r reads
// only kernel taps t with (t - p_lo + r) % s == 0, from input row b + off,
// off = (r + t - p_lo) / s.  The wrapper passes those per-parity lists
// (parity_schedule) as small int arrays.
//
// As the TPU kernel does, one block computes all s*s parity planes of one
// input tile: TBH x TBW plane pixels (block rows and cols b, c), a Cout
// tile of BN.  Per chunk of 16 input channels it stages the input tile
// with its halo (rows b + off for every live offset) in shared memory with
// asynchronous copies (16-byte when Cin % 4 == 0), once for all planes.
// The chunk's k*k x BN weights are staged with it when they fit
// kResidentBytes (every ENet layer: 12 KB at most); a larger k streams them
// per plane, a group of whole rows of the plane's live taps at a time, so
// any k the schedule takes runs.  Each plane then walks only its own live
// taps over the tile, so MACs issued = nonzero MACs, and adds its register
// tile into the interleaved s*TBH x s*TBW output tile in shared memory.  A
// plane with no live tap (k < s) adds nothing and still gets the epilogue
// (BN shift and residual are not zero).  The finished tile leaves as
// contiguous NHWC rows, the residual read and the result written with
// 16-byte accesses (igemm.cuh::store_tile): no stride-s scatter, no plane
// buffer and no de-interleave pass.
//
// Bound on the H100: device-memory bytes for ENet's decoder (Cin 4..16);
// its 19-class head moves 97 MB, mostly its fp32 output, and does 1.4
// GFLOP, so its FMAs alone take nearly three quarters of its byte time and
// the Cout tile is 20 wide for 19 (5% idle lanes).  PERF.md has the times.

#include <algorithm>

#include <cuda_runtime.h>

#include "igemm.cuh"

namespace repro {

constexpr int kMaxStride = 8;
constexpr int kMaxTaps = 8;   // live taps per parity: ceil(k / s)
// input channels staged at a time (fewer are zero-padded to it, so the
// channel loop is unrolled at compile time), and the floats of a staged
// pixel: 5 quads, odd, so lanes on neighbouring pixels hit distinct banks
constexpr int kChunk = 16;
constexpr int kChunkStride = kChunk + 4;

struct Schedule {
  int count[kMaxStride];
  int tap[kMaxStride][kMaxTaps];
  int off[kMaxStride][kMaxTaps];
};

struct TconvGeo {
  int h, w, cin, cout;
  int oh, ow, k, s;
  int tbh, tbw, tiles_h, tiles_w;  // plane pixels per block, tiles
  int offmin, span;                // smallest live offset, largest - smallest
  int resident;  // all k*k taps' weights staged per chunk, else per plane
  int wtaps;     // taps the weight buffer holds (k*k when resident)
  Schedule sched;
};

// Shared memory of the kernel, in floats: the input tile (pixels of
// kChunkStride floats), the weights of wtaps taps, the interleaved output
// tile, the epilogue's channel operands.
struct TconvSmem {
  int xs, ws, ot, ev, total;
  template <class T>
  __host__ __device__ static TconvSmem of(const TconvGeo& g) {
    TconvSmem m;
    m.xs = 0;
    m.ws = (g.tbh + g.span) * (g.tbw + g.span) * kChunkStride;
    m.ot = m.ws + g.wtaps * kChunk * T::BN;
    m.ev = m.ot + g.s * g.tbh * g.s * g.tbw * T::CS;
    m.total = m.ev + 3 * T::BN;
    return m;
  }
};

template <class T, int VEC>
__global__ void __launch_bounds__(T::THREADS)
    tconv_kernel(const __grid_constant__ TconvGeo g,
                 const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, Epilogue ep) {
  extern __shared__ __align__(16) float smem[];
  const TconvSmem L = TconvSmem::of<T>(g);
  float* xs = smem + L.xs;
  float* ws = smem + L.ws;
  float* ot = smem + L.ot;
  float* ev = smem + L.ev;

  const int t = threadIdx.x;
  int bid = blockIdx.x;
  const int tw = bid % g.tiles_w;
  bid /= g.tiles_w;
  const int th = bid % g.tiles_h;
  const int img = bid / g.tiles_h;
  const int b0 = th * g.tbh, c0 = tw * g.tbw;
  const int n0 = blockIdx.y * T::BN;
  const int xw = g.tbw + g.span;
  const int npix = (g.tbh + g.span) * xw;
  const int otw = g.s * g.tbw;  // output tile width, pixels
  const int ot_floats = g.s * g.tbh * otw * T::CS;
  const bool wide_w = g.cout % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  stage_epilogue<T>(ev, ep, n0, g.cout);
  for (int e = t * 4; e < ot_floats; e += T::THREADS * 4)
    *reinterpret_cast<float4*>(ot + e) = make_float4(0.f, 0.f, 0.f, 0.f);

  // this thread's plane pixels p = ty + i * TY: their input tile offsets
  const int tx = t % T::TX, ty = t / T::TX;
  const int plane_px = g.tbh * g.tbw;
  int xoff[T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int p = min(ty + i * T::TY, plane_px - 1);
    xoff[i] = ((p / g.tbw) * xw + p % g.tbw) * kChunkStride;
  }

  for (int cbase = 0; cbase < g.cin; cbase += kChunk) {
    // the input tile of this chunk, halo included, zero outside the image
    constexpr int groups = kChunk / VEC;
    for (int e = t; e < npix * groups; e += T::THREADS) {
      const int q = e / groups, gi = e - q * groups;
      const int yy = q / xw, xx = q - (q / xw) * xw;
      const int iy = b0 + g.offmin + yy, ix = c0 + g.offmin + xx;
      const int ci = cbase + gi * VEC;
      const bool v = static_cast<unsigned>(iy) < static_cast<unsigned>(g.h) &&
                     static_cast<unsigned>(ix) < static_cast<unsigned>(g.w) &&
                     ci < g.cin;
      const float* src =
          v ? x + ((static_cast<int64_t>(img) * g.h + iy) * g.w + ix) * g.cin +
                  ci
            : x;
      copy_async<VEC>(xs + q * kChunkStride + gi * VEC, src, v);
    }
    // weights of kernel tap `tap` into slot `slot`: rows (channel) of BN
    // couts, zero past Cin
    const int rows = min(kChunk, g.cin - cbase);
    auto stage_tap = [&](int slot, int tap) {
      copy_weights<T>(ws + slot * kChunk * T::BN, w, tap * g.cin + cbase,
                      rows, tap * g.cin + cbase + rows, g.cout, n0, wide_w);
      if (rows < kChunk)
        for (int e = t; e < (kChunk - rows) * T::BN; e += T::THREADS)
          ws[(slot * kChunk + rows) * T::BN + e] = 0.0f;
    };
    if (g.resident)
      for (int tap = 0; tap < g.k * g.k; ++tap) stage_tap(tap, tap);
    copy_commit();
    copy_wait<0>();
    __syncthreads();

    for (int plane = 0; plane < g.s * g.s; ++plane) {
      const int ry = plane / g.s, rx = plane - (plane / g.s) * g.s;
      const int ny = g.sched.count[ry], nx = g.sched.count[rx];
      if (ny == 0 || nx == 0) continue;
      float acc[T::TM][4];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      // rows jy0 .. jy1 - 1 of the plane's live taps; streamed weights
      // take as many whole rows a group as the buffer holds
      const int gy = g.resident ? ny : max(1, g.wtaps / nx);
      for (int jy0 = 0; jy0 < ny; jy0 += gy) {
        const int jy1 = min(ny, jy0 + gy);
        if (!g.resident) {
          __syncthreads();  // the previous group's weights are consumed
          for (int jy = jy0; jy < jy1; ++jy)
            for (int jx = 0; jx < nx; ++jx)
              stage_tap((jy - jy0) * nx + jx,
                        g.sched.tap[ry][jy] * g.k + g.sched.tap[rx][jx]);
          copy_commit();
          copy_wait<0>();
          __syncthreads();
        }
        for (int jy = jy0; jy < jy1; ++jy) {
          const int oy = g.sched.off[ry][jy] - g.offmin;
          const int ky = g.sched.tap[ry][jy];
          for (int jx = 0; jx < nx; ++jx) {
            const int shift =
                (oy * xw + g.sched.off[rx][jx] - g.offmin) * kChunkStride;
            const int slot = g.resident ? ky * g.k + g.sched.tap[rx][jx]
                                        : (jy - jy0) * nx + jx;
            const float* wt = ws + slot * kChunk * T::BN + tx * 4;
#pragma unroll
            for (int cq = 0; cq < kChunk; cq += 4) {
              float4 a[T::TM], b[4][1];
#pragma unroll
              for (int i = 0; i < T::TM; ++i)
                a[i] = *reinterpret_cast<const float4*>(xs + xoff[i] + shift +
                                                        cq);
#pragma unroll
              for (int q = 0; q < 4; ++q)
                b[q][0] =
                    *reinterpret_cast<const float4*>(wt + (cq + q) * T::BN);
              fma_slice(acc, a, b);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
        const int p = ty + i * T::TY;
        if (p >= plane_px) continue;
        const int bb = p / g.tbw, cc = p - (p / g.tbw) * g.tbw;
        float4* o = reinterpret_cast<float4*>(
            ot + ((g.s * bb + ry) * otw + g.s * cc + rx) * T::CS + tx * 4);
        const float4 v = *o;
        *o = make_float4(v.x + acc[i][0], v.y + acc[i][1], v.z + acc[i][2],
                         v.w + acc[i][3]);
      }
    }
    __syncthreads();  // the chunk is consumed; the tile is complete
  }

  // output row y0 + r, cols x0 .. x0 + otw - 1 (clipped to the output)
  const int y0 = g.s * b0, x0 = g.s * c0;
  store_tile<T>(
      ot, nullptr, ev, g.s * g.tbh, otw,
      [&](int r, int64_t* p0, int* np) {
        const int y = y0 + r;
        *p0 = (static_cast<int64_t>(img) * g.oh + y) * g.ow + x0;
        *np = y < g.oh ? min(otw, g.ow - x0) : 0;
      },
      n0, g.cout, out, ep);
}

template <class T, int V>
cudaError_t launch_tconv(const TconvGeo& g, int n, const float* x,
                         const float* w, float* out, const Epilogue& ep,
                         cudaStream_t st) {
  const int bytes =
      static_cast<int>(TconvSmem::of<T>(g).total * sizeof(float));
  static unsigned smem_set = 0;
  cudaError_t err = allow_big_smem(
      reinterpret_cast<const void*>(tconv_kernel<T, V>), bytes, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(n * g.tiles_h * g.tiles_w),
            static_cast<unsigned>((g.cout + T::BN - 1) / T::BN), 1);
  tconv_kernel<T, V><<<grid, T::THREADS, bytes, st>>>(g, x, w, out, ep);
  return cudaGetLastError();
}

}  // namespace repro

// sched: for each parity r < s, kMaxTaps (tap, offset) pairs after a count,
// i.e. s rows of 1 + 2 * kMaxTaps ints.  vec: 4 (16-byte copies of x; needs
// Cin % 4 == 0 and a 16-byte aligned x) or 1; tile: a tile id of 4-wide
// register tiles and one K group, at most 32 couts wide; resident: stage
// all k*k taps' weights of a chunk at once (they must fit kResidentBytes),
// else stream them per plane.
// Returns cudaErrorInvalidValue for a schedule or plan the kernel cannot
// take.
extern "C" int tconv_fwd(const float* x, const float* w, float* out,
                         const float* scale, const float* shift,
                         const float* alpha, const float* residual, int n,
                         int h, int w_in, int cin, int oh, int ow, int cout,
                         int k, int s, const int* sched, int bn, int prelu,
                         int residual_mode, int vec, int tile, int resident,
                         void* stream) {
  using namespace repro;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (s < 2 || s > kMaxStride) return bad;
  if (vec == 4 && (cin % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return bad;
  TconvGeo g;
  g.h = h;
  g.w = w_in;
  g.cin = cin;
  g.cout = cout;
  g.oh = oh;
  g.ow = ow;
  g.k = k;
  g.s = s;
  int offmin = INT_MAX, offmax = INT_MIN;
  for (int r = 0; r < kMaxStride; ++r) {
    g.sched.count[r] = 0;
    for (int j = 0; j < kMaxTaps; ++j) {
      g.sched.tap[r][j] = 0;
      g.sched.off[r][j] = 0;
    }
  }
  for (int r = 0; r < s; ++r) {
    const int* row = sched + r * (1 + 2 * kMaxTaps);
    if (row[0] < 0 || row[0] > kMaxTaps) return bad;
    g.sched.count[r] = row[0];
    for (int j = 0; j < row[0]; ++j) {
      g.sched.tap[r][j] = row[1 + 2 * j];
      g.sched.off[r][j] = row[2 + 2 * j];
      offmin = offmin < row[2 + 2 * j] ? offmin : row[2 + 2 * j];
      offmax = offmax > row[2 + 2 * j] ? offmax : row[2 + 2 * j];
    }
  }
  if (offmin > offmax) offmin = offmax = 0;  // no live tap at all
  g.offmin = offmin;
  g.span = offmax - offmin;
  const Epilogue ep = {scale, shift, alpha, residual, bn, prelu,
                       residual_mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_tile(tile, [&](auto t) {
    using T = decltype(t);
    // one K group and 4-wide register tiles, up to 32 couts a block
    if constexpr (T::TN == 4 && T::KS == 1 && T::BN <= 32) {
      constexpr int tap_floats = kChunk * T::BN;
      static_assert(kResidentBytes / (tap_floats * 4) >= kMaxTaps,
                    "a row of live taps fits the streamed weight buffer");
      const int slab = k * k * tap_floats * static_cast<int>(sizeof(float));
      if (resident && slab > kResidentBytes) return;
      g.resident = resident;
      g.wtaps = resident ? k * k
                         : std::min(k * k, kResidentBytes / (tap_floats * 4));
      // plane pixels per block: up to BM, and an output tile of at most
      // 4 BM pixels (s = 2 fills both)
      const int hb = (oh + s - 1) / s, wb = (ow + s - 1) / s;
      const int cap = std::max(1, 4 * T::BM / (s * s));
      g.tbw = std::min({16, wb, cap});
      g.tbh = std::max(1, std::min(hb, std::min(T::BM, cap) / g.tbw));
      g.tiles_h = (hb + g.tbh - 1) / g.tbh;
      g.tiles_w = (wb + g.tbw - 1) / g.tbw;
      dispatch_vec(vec, [&](auto v) {
        err = launch_tconv<T, decltype(v)::value>(g, n, x, w, out, ep, st);
      });
    }
  });
  return static_cast<int>(err);
}

extern "C" const char* tconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
