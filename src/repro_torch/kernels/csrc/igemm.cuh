// Implicit-GEMM building blocks of the dense and the transposed conv
// kernels, on the CUDA cores, for sm_90a.  Operands (x, w, residual, out)
// are stored as E = float or __nv_bfloat16 (element.cuh picks it from the
// wrapper's dtype code); the accumulators, the staged output tile, the
// epilogue's channel operands and all arithmetic are fp32, and a bf16
// output is rounded once (to nearest even) after the epilogue, as the
// Pallas kernels cast once at their store.
//
// A conv is a GEMM with M = output pixels, N = Cout and K = taps x Cin whose
// A operand (the im2col matrix) is never materialised.  ENet's convs are
// thin (Cin and Cout 3..128): the ENet-512 batch-4 forward's dense convs do
// 14.5 GFLOP (0.217 ms at the 67 TFLOP/s of the CUDA cores) against 0.447
// ms for their bytes at 3.35 TB/s.  Layer by layer on the H100, the 1x1
// projections (the 128->64 one as much by its FMAs), the k2 s2
// downsamples, the stem, the decoder's 3x3 4->4 and the transposed convs
// are bound by device-memory bytes; the 3x3 (dense and dilated), 5x1 and
// 1x5 layers at Cin 16-32 by their FMAs (PERF.md §6).  So the design keeps
// loads in flight and stores wide, feeds the FMAs from float4 shared reads,
// and uses no tensor cores: TF32 would break the port's 1e-4 fp32 bar, and
// 3xTF32 on mma.sync is the lever left for the FMA-bound layers
// (ROADMAP.md).
//
//   * Tap-major K.  K runs over (tap, Cin) in HWIO order, so a group of 4
//     consecutive K rows is 4 channels of one tap: the tap is decoded once
//     per group and per pipeline stage, and the A gather of one pixel at one
//     tap is a contiguous channel run.
//   * Async copies.  A is gathered with 16-byte `cp.async` when a 16-byte
//     run of channels divides Cin (Cin % 4 == 0 in fp32, % 8 in bf16),
//     else with the widest copy that does (8 bytes for bf16 Cin 4, 4 bytes
//     for fp32 Cin 3), through L1 (`.ca`), so the taps of a 3x3 find their
//     neighbours' lines there; the 16-byte copies of weights and residual
//     bypass L1 (`.cg`).  A tap outside the image, a pixel past M or a K
//     row past K copies with src-size 0, which zero-fills: padding stays
//     free and needs no branch around the copy.  cp.async has no 2-byte
//     form, so bf16 runs of odd length (the stem's Cin 3, a Cin-19
//     cotangent, Cout 13 and 19) take plain loads and stores instead.
//   * bf16 staging.  bf16 operands stay bf16 in shared memory (half the
//     bytes of a stage and of a weight slab) and are widened to fp32 pairs
//     (`__bfloat1622float2`) as the FMA loop reads them.
//   * Pipeline.  A ring of kStages stages of kBK = 16 K rows, with
//     commit_group / wait_group, keeps the next three stages' loads in
//     flight while the FMAs of the current one run.
//   * Resident weights.  The block's K x BN weight slab is copied into
//     shared memory once, with the first stage, when it fits kResidentBytes
//     (every ENet conv: 36 KB at most).  A larger slab streams through the
//     ring beside A.  A residual operand rides the fourth stage into shared
//     memory, so the epilogue never waits on it.
//   * Register tiles.  A thread owns TM pixels (strided by TY, so lanes on
//     consecutive pixels read distinct bank groups) by TN couts; a 4-deep K
//     slice is TM + TN float4 shared reads for 4 TM TN FMAs.  Cout tiles of
//     4, 8, 16, 20, 32 and 64 fit ENet's 4, 13, 16, 19, 32, 64 and 128.
//     The 32-wide tile takes 8 x 8 register tiles and splits each stage's
//     K over 4 thread groups, whose partial sums meet in shared memory:
//     fewer shared reads per FMA, and as many threads as a 4 x 4 tile.
//   * Epilogue.  The accumulators go to shared memory; the block then walks
//     its output rows in NHWC order and writes the result with 16-byte
//     accesses (the fused epilogue of epilogue.cuh in between, with scale,
//     shift and alpha staged once per block).
//
// The TMA's im2col mode was the other way to feed A.  cp.async was chosen:
// a tensor map would be encoded on the host at every call of a host-bound
// forward, and a 16-byte channel run per pixel and tap (Cin 4 and 16) is
// the TMA's smallest box anyway.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "element.cuh"
#include "epilogue.cuh"

namespace repro {

constexpr int kBK = 16;      // K rows per pipeline stage
constexpr int kStages = 4;   // depth of the ring
// elements per staged pixel of a stage: whole 16-byte quads, an odd number
// of them (fp32 5, bf16 3), so lanes on neighbouring pixels hit distinct
// banks
template <class E>
constexpr int kAStride = sizeof(E) == 4 ? kBK + 4 : kBK + 8;
// weight slabs up to this size stay in shared memory (conv2d.py mirrors it)
constexpr int kResidentBytes = 48 * 1024;
// an invalid pixel's input origin: every tap then fails the bounds check
constexpr int kNoPixel = INT_MIN / 2;

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// --------------------------------------------------------------- cp.async
// Copy BYTES (4, 8 or 16) from global `src` to shared `dst`, or zero-fill
// them when `valid` is false (src-size 0: nothing is read, but `src` must
// still be a mapped address).  L1: keep the line in L1 too (`.ca`), for the
// input gather, whose taps read neighbouring pixels again; else L2 only
// (`.cg`, which takes 16-byte copies only).
template <int BYTES, bool L1 = false>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16 && L1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  } else {
    static_assert(BYTES == 4, "4-, 8- or 16-byte copies");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

// Copy VEC elements of type E (zero when !valid): a cp.async of their
// bytes, or, for one 2-byte bf16 element, a plain load and store (visible
// to the block after its next __syncthreads, like a landed copy).
template <class E, int VEC, bool L1 = false>
__device__ __forceinline__ void copy_elems(E* dst, const E* src, bool valid) {
  constexpr int BYTES = VEC * static_cast<int>(sizeof(E));
  if constexpr (BYTES >= 4) {
    copy_async<BYTES, L1>(dst, src, valid);
  } else {
    static_assert(BYTES == 2, "a single bf16 element");
    *dst = valid ? *src : from_f32<E>(0.0f);
  }
}

// 4 consecutive elements (8- or 16-byte aligned) widened to fp32, and 4
// fp32 values rounded to E and stored (RNE for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ----------------------------------------------------------------- tiles
// A block computes BM = TY * TM pixels by BN couts.  Its threads form KS
// groups of TX * TY (TX = BN / TN); a thread owns pixels ty + i * TY
// (i < TM) and couts TN tx .. TN tx + TN - 1, and its group takes every
// KS-th 4-deep K slice of each stage (split K inside the block: more
// threads for a large register tile, whose partial sums meet in shared
// memory before the store).
template <int BN_, int TN_, int TY_, int TM_, int KS_>
struct Tile {
  static constexpr int BN = BN_, TN = TN_, TY = TY_, TM = TM_, KS = KS_;
  static constexpr int TX = BN / TN;
  static constexpr int GROUP = TX * TY;
  static constexpr int THREADS = GROUP * KS;
  static constexpr int BM = TY * TM;
  // row stride (floats) of a staged output tile: whole 16-byte quads, an
  // odd number of them, so lanes on consecutive rows hit distinct banks
  static constexpr int CS = (BN / 4) % 2 ? BN : BN + 4;
  static_assert(BN % TN == 0 && TN % 4 == 0 && THREADS <= 256 &&
                    (kBK / 4) % KS == 0,
                "tile shape");
};

// Run `f(Tile{})` for tile id `id` (conv2d.py: TILES, in this order);
// false for an unknown id.
template <class F>
inline bool dispatch_tile(int id, F&& f) {
  switch (id) {
    case 0: f(Tile<4, 4, 128, 2, 1>{}); return true;
    case 1: f(Tile<8, 4, 64, 4, 1>{}); return true;
    case 2: f(Tile<16, 4, 64, 2, 1>{}); return true;
    case 3: f(Tile<20, 4, 32, 4, 1>{}); return true;
    case 4: f(Tile<32, 4, 32, 4, 1>{}); return true;
    case 5: f(Tile<64, 4, 16, 8, 1>{}); return true;
    case 6: f(Tile<32, 8, 16, 8, 4>{}); return true;
    default: return false;
  }
}

// Call `f(Vec<V>{})` for a copy width of V elements of E: 4 or 1 floats
// (16 or 4 bytes), 8, 4 or 1 bf16 (16, 8 or 2 bytes); false for another.
template <int V>
struct Vec {
  static constexpr int value = V;
};
template <class E, class F>
inline bool dispatch_vec(int vec, F&& f) {
  if (vec == 16 / static_cast<int>(sizeof(E))) {
    f(Vec<16 / static_cast<int>(sizeof(E))>{});
    return true;
  }
  if constexpr (sizeof(E) == 2) {
    if (vec == 4) { f(Vec<4>{}); return true; }
  }
  if (vec == 1) { f(Vec<1>{}); return true; }
  return false;
}

// Let `kernel` take up to the card's opt-in shared memory, once a device:
// `done` (one bit per device) is the caller's static flag for this kernel.
inline cudaError_t allow_big_smem(const void* kernel, int bytes,
                                  unsigned* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (*done >> dev) & 1u) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess && dev < 32) *done |= 1u << dev;
  return err;
}

// ------------------------------------------------------------ register tile
__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// acc[i][j] += sum_q a[i][q] * b[q][j]: one 4-deep K slice of the tile;
// b[q][jn] holds couts 4 jn .. 4 jn + 3 of K row q
template <int TM, int TN>
__device__ __forceinline__ void fma_slice(float (&acc)[TM][TN],
                                          const float4 (&a)[TM],
                                          const float4 (&b)[4][TN / 4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float av = lane(a[i], q);
#pragma unroll
      for (int jn = 0; jn < TN / 4; ++jn) {
        acc[i][4 * jn] = fmaf(av, b[q][jn].x, acc[i][4 * jn]);
        acc[i][4 * jn + 1] = fmaf(av, b[q][jn].y, acc[i][4 * jn + 1]);
        acc[i][4 * jn + 2] = fmaf(av, b[q][jn].z, acc[i][4 * jn + 2]);
        acc[i][4 * jn + 3] = fmaf(av, b[q][jn].w, acc[i][4 * jn + 3]);
      }
    }
}

// ------------------------------------------------------ weight slab copies
// Copy K rows k0 .. k0 + rows - 1 of the (K, Cout) weight matrix, columns
// n0 .. n0 + BN - 1, into dst (rows of BN elements); rows past K and
// columns past Cout are zero-filled.  Runs of 4 elements (16 bytes fp32, 8
// bf16) when Cout % 4 == 0 and the weights are aligned to such a run, else
// one element at a time.
template <class T, class E>
__device__ __forceinline__ void copy_weights(E* dst, const E* w, int k0,
                                             int rows, int K, int cout,
                                             int n0, bool wide) {
  if (wide) {
    constexpr int Q = T::BN / 4;
    for (int e = threadIdx.x; e < rows * Q; e += T::THREADS) {
      const int r = e / Q, c = (e - r * Q) * 4;
      const bool v = k0 + r < K && n0 + c < cout;
      copy_elems<E, 4>(dst + r * T::BN + c,
                       v ? w + static_cast<int64_t>(k0 + r) * cout + n0 + c
                         : w,
                       v);
    }
  } else {
    for (int e = threadIdx.x; e < rows * T::BN; e += T::THREADS) {
      const int r = e / T::BN, c = e - r * T::BN;
      const bool v = k0 + r < K && n0 + c < cout;
      copy_elems<E, 1>(dst + r * T::BN + c,
                       v ? w + static_cast<int64_t>(k0 + r) * cout + n0 + c
                         : w,
                       v);
    }
  }
}

// whether runs of 4 elements of `p` (16 bytes fp32, 8 bf16) are aligned
template <class E>
__device__ __forceinline__ bool quad_aligned(const E* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(E) - 1)) == 0;
}

// ---------------------------------------------------------------- epilogue
// scale, shift and alpha of the block's BN couts, staged once (ev: 3 * BN)
template <class T, class E>
__device__ __forceinline__ void stage_epilogue(float* ev,
                                               const Epilogue<E>& ep, int n0,
                                               int cout) {
  for (int c = threadIdx.x; c < T::BN; c += T::THREADS) {
    const int co = n0 + c;
    const bool v = co < cout;
    ev[c] = ep.bn && v ? ep.scale[co] : 1.0f;
    ev[T::BN + c] = ep.bn && v ? ep.shift[co] : 0.0f;
    ev[2 * T::BN + c] = ep.prelu && v ? ep.alpha[co] : 0.0f;
  }
}

// Write a staged fp32 output tile `cs` (pixels of T::CS floats) to NHWC
// `out` with the fused epilogue, rounding once to E.  The tile is `nruns`
// runs of consecutive output pixels: run r's pixel i is staged at
// cs[(r * run_stride + i) * CS] and is output pixel pix0 + i, where run(r,
// &pix0, &npix) gives the run.  The threads walk each run's (pixel,
// channel) elements 4 at a time.  A quad is one float4 shared read when the
// block's width nb is a multiple of 4 (it then lies in one pixel), and one
// 4-element residual read and store (16 bytes fp32, 8 bf16) when its 4
// elements are adjacent and aligned in `out` (Cout % 4 == 0, or the block
// covers all of Cout and the run is aligned).  `rs`, when not null, is the
// residual already staged like `cs` (in E); else the residual is read from
// global memory.
template <class T, class E, class Run>
__device__ __forceinline__ void store_tile(const float* cs, const E* rs,
                                           const float* ev, int nruns,
                                           int run_stride, Run run, int n0,
                                           int cout, E* __restrict__ out,
                                           const Epilogue<E>& ep) {
  const int nb = min(T::BN, cout - n0);
  const bool has_res = ep.residual_mode != kResidualNone;
  const bool res_ok = rs != nullptr || !has_res || quad_aligned(ep.residual);
  const bool in_pixel = nb % 4 == 0;
  for (int r = 0; r < nruns; ++r) {
    int64_t pix0;
    int npix;
    run(r, &pix0, &npix);
    const int len = npix * nb;
    const int64_t base = pix0 * cout + n0;
    const bool wide =
        res_ok && ((cout % 4 == 0) ||
                   (nb == cout && base % 4 == 0 && len % 4 == 0));
    const float* stage = cs + r * run_stride * T::CS;
    const E* rstage = rs ? rs + r * run_stride * T::CS : nullptr;
    for (int e = threadIdx.x * 4; e < len; e += T::THREADS * 4) {
      const int n = min(4, len - e);
      int p = e / nb, c = e - p * nb;
      float4 y, sc, sh, al, res = make_float4(0.f, 0.f, 0.f, 0.f);
      int64_t off[4];
      if (in_pixel) {
        const int st = p * T::CS + c;
        y = *reinterpret_cast<const float4*>(stage + st);
        sc = *reinterpret_cast<const float4*>(ev + c);
        sh = *reinterpret_cast<const float4*>(ev + T::BN + c);
        al = *reinterpret_cast<const float4*>(ev + 2 * T::BN + c);
        if (has_res && rs != nullptr) res = load4(rstage + st);
        const int64_t o = base + static_cast<int64_t>(p) * cout + c;
        off[0] = o, off[1] = o + 1, off[2] = o + 2, off[3] = o + 3;
      } else {
        float yv[4], scv[4], shv[4], alv[4], rv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c == nb) {
            c = 0;
            ++p;
          }
          const int st = p * T::CS + c;
          const bool in = j < n;
          yv[j] = in ? stage[st] : 0.0f;
          rv[j] = in && has_res && rs != nullptr ? to_f32(rstage[st]) : 0.0f;
          scv[j] = ev[c];
          shv[j] = ev[T::BN + c];
          alv[j] = ev[2 * T::BN + c];
          off[j] = base + static_cast<int64_t>(p) * cout + c;
          ++c;
        }
        y = make_float4(yv[0], yv[1], yv[2], yv[3]);
        sc = make_float4(scv[0], scv[1], scv[2], scv[3]);
        sh = make_float4(shv[0], shv[1], shv[2], shv[3]);
        al = make_float4(alv[0], alv[1], alv[2], alv[3]);
        res = make_float4(rv[0], rv[1], rv[2], rv[3]);
      }
      if (has_res && rs == nullptr) {
        if (wide) {
          res = load4(ep.residual + off[0]);
        } else {
          res.x = to_f32(ep.residual[off[0]]);
          if (n > 1) res.y = to_f32(ep.residual[off[1]]);
          if (n > 2) res.z = to_f32(ep.residual[off[2]]);
          if (n > 3) res.w = to_f32(ep.residual[off[3]]);
        }
      }
      const float4 v = apply_epilogue4(y, sc, sh, al, res, ep);
      if (wide) {
        store4(out + off[0], v);
      } else {
        out[off[0]] = from_f32<E>(v.x);
        if (n > 1) out[off[1]] = from_f32<E>(v.y);
        if (n > 2) out[off[2]] = from_f32<E>(v.z);
        if (n > 3) out[off[3]] = from_f32<E>(v.w);
      }
    }
  }
}

// ------------------------------------------------------ dense conv igemm
// NHWC x HWIO conv geometry (conv2d.cu fills it)
struct ConvGeo {
  int64_t M;  // n * oh * ow
  int K;      // kh * kw * cin
  int h, w, cin, cout;
  int oh, ow, kw, stride, pad_top, pad_left;

  // (image, input row and col of tap (0, 0)) of output pixel m
  __device__ __forceinline__ int4 pixel(int64_t m) const {
    if (m >= M) return make_int4(0, kNoPixel, kNoPixel, 0);
    const int64_t hw = static_cast<int64_t>(oh) * ow;
    const int n = static_cast<int>(m / hw);
    const int rem = static_cast<int>(m - n * hw);
    const int oy = rem / ow, ox = rem - (rem / ow) * ow;
    return make_int4(n, oy * stride - pad_top, ox * stride - pad_left, 0);
  }
};

// Shared memory of igemm_conv, as 16-byte aligned byte offsets: the A ring
// of E (reused by the fp32 staged output tile), the weight slab or its ring
// of E, the staged residual of E (when the epilogue adds one), the pixel
// table, the epilogue's fp32 channel operands.  For fp32 these are the
// float offsets of the fp32-only kernel times 4.
struct ConvSmem {
  int nk, a, b, r, pix, ev, total;
  template <class T, class E>
  __host__ __device__ static ConvSmem of(int K, bool resident,
                                         bool residual) {
    constexpr int es = static_cast<int>(sizeof(E));
    ConvSmem s;
    s.nk = (K + kBK - 1) / kBK;
    const int slots = s.nk < kStages ? s.nk : kStages;
    const int ring = slots * T::BM * kAStride<E> * es;
    const int stage = T::BM * T::CS * 4;
    s.a = 0;
    s.b = align16(ring > stage ? ring : stage);
    s.r = s.b + align16((resident ? s.nk : slots) * kBK * T::BN * es);
    s.pix = s.r + (residual ? align16(T::BM * T::CS * es) : 0);
    s.ev = s.pix + 16 * T::BM;
    s.total = s.ev + 3 * T::BN * 4;
    return s;
  }
};

// Copy the block's residual tile (npix pixels from m0, couts n0 .. n0 +
// nb - 1) into rs, laid out like the staged output tile.
template <class T, class E>
__device__ __forceinline__ void copy_residual(E* rs, const E* res, int64_t m0,
                                              int npix, int n0, int cout) {
  const int nb = min(T::BN, cout - n0);
  if (cout % 4 == 0 && quad_aligned(res)) {
    constexpr int Q = T::BN / 4;
    for (int e = threadIdx.x; e < T::BM * Q; e += T::THREADS) {
      const int p = e / Q, c = (e - p * Q) * 4;
      if (p < npix && c < nb)
        copy_elems<E, 4>(rs + p * T::CS + c, res + (m0 + p) * cout + n0 + c,
                         true);
    }
  } else {
    for (int e = threadIdx.x; e < T::BM * T::BN; e += T::THREADS) {
      const int p = e / T::BN, c = e - p * T::BN;
      if (p < npix && c < nb)
        copy_elems<E, 1>(rs + p * T::CS + c, res + (m0 + p) * cout + n0 + c,
                         true);
    }
  }
}

template <class T, class E, int VEC, bool RESIDENT>
__device__ __forceinline__ void igemm_conv(const ConvGeo& g,
                                           const E* __restrict__ x,
                                           const E* __restrict__ w,
                                           E* __restrict__ out,
                                           const Epilogue<E>& ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int AS = kAStride<E>;
  const bool has_res = ep.residual_mode != kResidualNone;
  const ConvSmem L = ConvSmem::of<T, E>(g.K, RESIDENT, has_res);
  E* As = reinterpret_cast<E*>(smem + L.a);
  E* Bs = reinterpret_cast<E*>(smem + L.b);
  E* Rs = reinterpret_cast<E*>(smem + L.r);
  int4* pix = reinterpret_cast<int4*>(smem + L.pix);
  float* ev = reinterpret_cast<float*>(smem + L.ev);

  const int t = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int64_t rest = g.M - m0;
  const int npix = static_cast<int>(rest < T::BM ? rest : T::BM);
  const bool wide_w = g.cout % 4 == 0 && quad_aligned(w);

  for (int p = t; p < T::BM; p += T::THREADS) pix[p] = g.pixel(m0 + p);
  stage_epilogue<T>(ev, ep, n0, g.cout);
  __syncthreads();

  // thread t copies K group gc (VEC rows) of pixels pr, pr + RPP, ...
  constexpr int GC = kBK / VEC;
  constexpr int RPP = T::THREADS / GC;
  static_assert(T::THREADS % GC == 0, "copy mapping");
  const int gc = t % GC, pr = t / GC;

  auto load_a = [&](int kt) {
    const int k = kt * kBK + gc * VEC;
    const bool kval = k < g.K;
    const int tap = k / g.cin;
    const int ci = k - tap * g.cin;
    const int dy = tap / g.kw, dx = tap - (tap / g.kw) * g.kw;
    E* dst = As + (kt % kStages) * T::BM * AS + gc * VEC;
    for (int p = pr; p < T::BM; p += RPP) {
      const int4 q = pix[p];
      const int iy = q.y + dy, ix = q.z + dx;
      const bool v = kval &&
                     static_cast<unsigned>(iy) < static_cast<unsigned>(g.h) &&
                     static_cast<unsigned>(ix) < static_cast<unsigned>(g.w);
      const E* src =
          v ? x + ((static_cast<int64_t>(q.x) * g.h + iy) * g.w + ix) * g.cin +
                  ci
            : x;
      copy_elems<E, VEC, true>(dst + p * AS, src, v);
    }
  };
  auto load_b = [&](int kt) {
    copy_weights<T>(Bs + (kt % kStages) * kBK * T::BN, w, kt * kBK, kBK,
                    g.K, g.cout, n0, wide_w);
  };

  if constexpr (RESIDENT)
    copy_weights<T>(Bs, w, 0, L.nk * kBK, g.K, g.cout, n0, wide_w);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < L.nk) {
      load_a(s);
      if constexpr (!RESIDENT) load_b(s);
    }
    copy_commit();
  }

  const int kg = t / T::GROUP, tr = t - kg * T::GROUP;
  const int tx = tr % T::TX, ty = tr / T::TX;
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < L.nk; ++kt) {
    copy_wait<kStages - 2>();  // stage kt (and a resident slab) landed
    __syncthreads();           // ... for all threads; slot kt-1 is free
    const int nxt = kt + kStages - 1;
    if (nxt < L.nk) {
      load_a(nxt);
      if constexpr (!RESIDENT) load_b(nxt);
    }
    // the residual tile rides with the fourth stage, far ahead of its use
    if (kt == 0 && has_res) copy_residual<T>(Rs, ep.residual, m0, npix, n0,
                                             g.cout);
    copy_commit();
    const E* a_s = As + (kt % kStages) * T::BM * AS;
    const E* b_s =
        Bs + (RESIDENT ? kt : kt % kStages) * kBK * T::BN + tx * T::TN;
#pragma unroll
    for (int u = 0; u < kBK / 4 / T::KS; ++u) {
      const int kk = 4 * (kg + u * T::KS);
      float4 a[T::TM], b[4][T::TN / 4];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
        a[i] = load4(a_s + (ty + i * T::TY) * AS + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int jn = 0; jn < T::TN / 4; ++jn)
          b[q][jn] = load4(b_s + (kk + q) * T::BN + 4 * jn);
      fma_slice(acc, a, b);
    }
  }
  copy_wait<0>();
  __syncthreads();  // the ring is read out: stage the tile over it

  // the K groups' partial tiles meet in shared memory, one group at a time
  float* cs = reinterpret_cast<float*>(smem + L.a);
#pragma unroll
  for (int gi = 0; gi < T::KS; ++gi) {
    if (kg == gi) {
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int jn = 0; jn < T::TN / 4; ++jn) {
          float4* o = reinterpret_cast<float4*>(
              cs + (ty + i * T::TY) * T::CS + tx * T::TN + 4 * jn);
          float4 v = make_float4(acc[i][4 * jn], acc[i][4 * jn + 1],
                                 acc[i][4 * jn + 2], acc[i][4 * jn + 3]);
          if (gi > 0) {
            const float4 u = *o;
            v = make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
          }
          *o = v;
        }
    }
    __syncthreads();
  }
  store_tile<T>(
      cs, has_res ? Rs : static_cast<const E*>(nullptr), ev, 1, 0,
      [&](int, int64_t* p0, int* np) {
        *p0 = m0;
        *np = npix;
      },
      n0, g.cout, out, ep);
}

}  // namespace repro
