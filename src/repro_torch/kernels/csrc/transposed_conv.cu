// Decomposed transposed convolution with a fused epilogue, fp32 or bf16, for
// sm_90a.
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
// asynchronous copies (16-byte when a 16-byte channel run divides Cin; bf16
// Cin 4 takes 8-byte ones, odd Cin plain loads), once for all planes.
// The chunk's k*k x BN weights are staged with it when they fit
// kResidentBytes (every ENet layer: 12 KB at most); a larger k streams them
// per plane, a group of whole rows of the plane's live taps at a time, so
// any k the schedule takes runs.  Each plane then walks only its own live
// taps over the tile, so MACs issued = nonzero MACs, and adds its register
// tile into the interleaved s*TBH x s*TBW output tile in shared memory.  A
// plane with no live tap (k < s) adds nothing and still gets the epilogue
// (BN shift and residual are not zero).  The finished tile leaves as
// contiguous NHWC rows, the residual read and the result written with
// 16-byte (bf16: 8-byte) accesses (igemm.cuh::store_tile): no stride-s
// scatter, no plane buffer and no de-interleave pass.  As the Pallas
// kernel does, x, w, residual and output are fp32 or bf16 (E); the input
// tile and weights are staged in E and widened as the FMAs read them, the
// output tile is fp32, and a bf16 result is rounded once, at the store.
//
// Bound on the H100: device-memory bytes for ENet's decoder (Cin 4..16);
// its 19-class head moves 97 MB, mostly its fp32 output, and does 1.4
// GFLOP, so its FMAs alone take nearly three quarters of its byte time and
// the Cout tile is 20 wide for 19 (5% idle lanes); bf16 halves those
// bytes.  PERF.md has the times.

#include <algorithm>

#include <cuda_runtime.h>

#include "igemm.cuh"

namespace repro {

constexpr int kMaxStride = 8;
constexpr int kMaxTaps = 8;   // live taps per parity: ceil(k / s)
// input channels staged at a time (fewer are zero-padded to it, so the
// channel loop is unrolled at compile time), and the elements of a staged
// pixel: whole 16-byte quads, an odd number (fp32 5, bf16 3), so lanes on
// neighbouring pixels hit distinct banks
constexpr int kChunk = 16;
template <class E>
constexpr int kChunkStride = sizeof(E) == 4 ? kChunk + 4 : kChunk + 8;

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

// Shared memory of the kernel, as 16-byte aligned byte offsets: the input
// tile (pixels of kChunkStride elements of E), the weights (E) of wtaps
// taps, the interleaved fp32 output tile, the epilogue's fp32 channel
// operands.  For fp32 these are the float offsets of the fp32-only kernel
// times 4.
struct TconvSmem {
  int xs, ws, ot, ev, total;
  template <class T, class E>
  __host__ __device__ static TconvSmem of(const TconvGeo& g) {
    constexpr int es = static_cast<int>(sizeof(E));
    TconvSmem m;
    m.xs = 0;
    m.ws = align16((g.tbh + g.span) * (g.tbw + g.span) * kChunkStride<E> *
                   es);
    m.ot = m.ws + align16(g.wtaps * kChunk * T::BN * es);
    m.ev = m.ot + g.s * g.tbh * g.s * g.tbw * T::CS * 4;
    m.total = m.ev + 3 * T::BN * 4;
    return m;
  }
};

template <class T, class E, int VEC>
__global__ void __launch_bounds__(T::THREADS)
    tconv_kernel(const __grid_constant__ TconvGeo g,
                 const E* __restrict__ x, const E* __restrict__ w,
                 E* __restrict__ out, Epilogue<E> ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CST = kChunkStride<E>;
  const TconvSmem L = TconvSmem::of<T, E>(g);
  E* xs = reinterpret_cast<E*>(smem + L.xs);
  E* ws = reinterpret_cast<E*>(smem + L.ws);
  float* ot = reinterpret_cast<float*>(smem + L.ot);
  float* ev = reinterpret_cast<float*>(smem + L.ev);

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
  const bool wide_w = g.cout % 4 == 0 && quad_aligned(w);

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
    xoff[i] = ((p / g.tbw) * xw + p % g.tbw) * CST;
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
      const E* src =
          v ? x + ((static_cast<int64_t>(img) * g.h + iy) * g.w + ix) * g.cin +
                  ci
            : x;
      copy_elems<E, VEC>(xs + q * CST + gi * VEC, src, v);
    }
    // weights of kernel tap `tap` into slot `slot`: rows (channel) of BN
    // couts, zero past Cin
    const int rows = min(kChunk, g.cin - cbase);
    auto stage_tap = [&](int slot, int tap) {
      copy_weights<T>(ws + slot * kChunk * T::BN, w, tap * g.cin + cbase,
                      rows, tap * g.cin + cbase + rows, g.cout, n0, wide_w);
      if (rows < kChunk)
        for (int e = t; e < (kChunk - rows) * T::BN; e += T::THREADS)
          ws[(slot * kChunk + rows) * T::BN + e] = from_f32<E>(0.0f);
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
                (oy * xw + g.sched.off[rx][jx] - g.offmin) * CST;
            const int slot = g.resident ? ky * g.k + g.sched.tap[rx][jx]
                                        : (jy - jy0) * nx + jx;
            const E* wt = ws + slot * kChunk * T::BN + tx * 4;
#pragma unroll
            for (int cq = 0; cq < kChunk; cq += 4) {
              float4 a[T::TM], b[4][1];
#pragma unroll
              for (int i = 0; i < T::TM; ++i)
                a[i] = load4(xs + xoff[i] + shift + cq);
#pragma unroll
              for (int q = 0; q < 4; ++q) b[q][0] = load4(wt + (cq + q) * T::BN);
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
      ot, static_cast<const E*>(nullptr), ev, g.s * g.tbh, otw,
      [&](int r, int64_t* p0, int* np) {
        const int y = y0 + r;
        *p0 = (static_cast<int64_t>(img) * g.oh + y) * g.ow + x0;
        *np = y < g.oh ? min(otw, g.ow - x0) : 0;
      },
      n0, g.cout, out, ep);
}

template <class T, class E, int V>
cudaError_t launch_tconv(const TconvGeo& g, int n, const E* x, const E* w,
                         E* out, const Epilogue<E>& ep, cudaStream_t st) {
  const int bytes = TconvSmem::of<T, E>(g).total;
  static unsigned smem_set = 0;
  cudaError_t err = allow_big_smem(
      reinterpret_cast<const void*>(tconv_kernel<T, E, V>), bytes, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(n * g.tiles_h * g.tiles_w),
            static_cast<unsigned>((g.cout + T::BN - 1) / T::BN), 1);
  tconv_kernel<T, E, V><<<grid, T::THREADS, bytes, st>>>(g, x, w, out, ep);
  return cudaGetLastError();
}

// Fill in a plan's block shape and weight buffer for tile T, on a geometry
// whose schedule is set: the plane tile of a block (up to BM plane pixels,
// and an output tile of at most 4 BM pixels; s = 2 fills both), the taps
// the weight buffer holds and the grid's tiles.  False for a resident plan
// whose k*k taps of a chunk do not fit kResidentBytes.
template <class T, class E>
bool plan_tconv_geo(TconvGeo& g, int resident) {
  constexpr int tap_bytes = kChunk * T::BN * static_cast<int>(sizeof(E));
  static_assert(kResidentBytes / tap_bytes >= kMaxTaps,
                "a row of live taps fits the streamed weight buffer");
  const int k = g.k, s = g.s;
  if (resident && k * k * tap_bytes > kResidentBytes) return false;
  g.resident = resident;
  g.wtaps = resident ? k * k : std::min(k * k, kResidentBytes / tap_bytes);
  const int hb = (g.oh + s - 1) / s, wb = (g.ow + s - 1) / s;
  const int cap = std::max(1, 4 * T::BM / (s * s));
  g.tbw = std::min({16, wb, cap});
  g.tbh = std::max(1, std::min(hb, std::min(T::BM, cap) / g.tbw));
  g.tiles_h = (hb + g.tbh - 1) / g.tbh;
  g.tiles_w = (wb + g.tbw - 1) / g.tbw;
  return true;
}

// Run `f(T{})` for a tile id the transposed kernel builds: one K group and
// 4-wide register tiles, up to 32 couts a block.
template <class F>
void dispatch_tconv_tile(int tile, F&& f) {
  dispatch_tile(tile, [&](auto t) {
    using T = decltype(t);
    if constexpr (T::TN == 4 && T::KS == 1 && T::BN <= 32) f(t);
  });
}

// Launch the plan (vec, tile, resident) of a geometry whose schedule is set:
// pick the block's plane tile and the weight buffer, then the kernel
// instance.  cudaErrorInvalidValue for a plan the kernel cannot take.
template <class E>
cudaError_t launch_tconv_plan(TconvGeo g, int n, const E* x, const E* w,
                              E* out, const Epilogue<E>& ep, int vec,
                              int tile, int resident, cudaStream_t st) {
  if (vec < 1 || g.cin % vec != 0 ||
      reinterpret_cast<uintptr_t>(x) % (vec * sizeof(E)) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_tconv_tile(tile, [&](auto t) {
    using T = decltype(t);
    if (!plan_tconv_geo<T, E>(g, resident)) return;
    dispatch_vec<E>(vec, [&](auto v) {
      err = launch_tconv<T, E, decltype(v)::value>(g, n, x, w, out, ep, st);
    });
  });
  return err;
}

// Read the wrapper's schedule (s rows of a count and kMaxTaps (tap, offset)
// pairs) into g, with the smallest live offset and the offsets' span.
// False for a stride or count the kernel cannot take.
inline bool read_schedule(TconvGeo& g, const int* sched, int s) {
  if (s < 2 || s > kMaxStride) return false;
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
    if (row[0] < 0 || row[0] > kMaxTaps) return false;
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
  return true;
}

}  // namespace repro

// x, w, out and residual are of dtype code `dtype` (kF32 or kBF16); scale,
// shift and alpha are fp32.  sched: for each parity r < s, kMaxTaps (tap,
// offset) pairs after a count, i.e. s rows of 1 + 2 * kMaxTaps ints.  vec:
// elements per copy of x, as for conv2d_fwd (4 or 1 fp32; 8, 4 or 1 bf16;
// Cin a multiple of it, x aligned to its bytes); tile: a tile id of 4-wide
// register tiles and one K group, at most 32 couts wide; resident: stage
// all k*k taps' weights of a chunk at once (they must fit kResidentBytes),
// else stream them per plane.
// Returns cudaErrorInvalidValue for a dtype, schedule or plan the kernel
// cannot take.
extern "C" int tconv_fwd(const void* x, const void* w, void* out,
                         const float* scale, const float* shift,
                         const float* alpha, const void* residual, int n,
                         int h, int w_in, int cin, int oh, int ow, int cout,
                         int k, int s, const int* sched, int bn, int prelu,
                         int residual_mode, int dtype, int vec, int tile,
                         int resident, void* stream) {
  using namespace repro;
  TconvGeo g;
  g.h = h;
  g.w = w_in;
  g.cin = cin;
  g.cout = cout;
  g.oh = oh;
  g.ow = ow;
  g.k = k;
  g.s = s;
  if (!read_schedule(g, sched, s))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_dtype(dtype, [&](auto e) {
    using E = decltype(e);
    const Epilogue<E> ep = {scale, shift, alpha,
                            static_cast<const E*>(residual), bn, prelu,
                            residual_mode};
    err = launch_tconv_plan(g, n, static_cast<const E*>(x),
                            static_cast<const E*>(w), static_cast<E*>(out),
                            ep, vec, tile, resident, st);
  });
  return static_cast<int>(err);
}

extern "C" const char* tconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory (bytes) that tconv_fwd asks for with the plan
// (tile, resident) on an (oh, ow) output of a k x k, stride-s kernel with
// schedule `sched` (as for tconv_fwd), or -1 for a dtype, schedule or plan
// the kernel does not take.  kernels/tiling_policy.py is held to it.
extern "C" int tconv_smem_bytes(int oh, int ow, int k, int s,
                                const int* sched, int dtype, int tile,
                                int resident) {
  using namespace repro;
  TconvGeo g;
  g.oh = oh;
  g.ow = ow;
  g.k = k;
  g.s = s;
  if (!read_schedule(g, sched, s)) return -1;
  int bytes = -1;
  dispatch_dtype(dtype, [&](auto e) {
    using E = decltype(e);
    dispatch_tconv_tile(tile, [&](auto t) {
      using T = decltype(t);
      if (plan_tconv_geo<T, E>(g, resident))
        bytes = TconvSmem::of<T, E>(g).total;
    });
  });
  return bytes;
}
