// Forward flash attention (online softmax), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:82).  That grid walks kv tiles
// innermost on one core, keeping the running max, the denominator and the
// output accumulator in VMEM scratch across grid steps, and its wrapper pads
// q, k and v to whole tiles in device memory.  Hopper blocks run in
// parallel and in no order, so here one block owns one (batch*head, q tile)
// and loops over the kv tiles itself, with the running state in registers.
// Both variants keep the reference kernel's semantics to the letter: scores
// are fp32 q.k scaled by dh^-1/2 (the caller passes the fp32 scale), the
// causal mask is top-left (q_pos >= k_pos) and keys >= Sk are masked, with
// the finite -1e30, the denominator l is summed from the fp32
// probabilities, and the output is acc / max(l, 1e-30) cast to q's type.
// A causal call may also take a window w > 0 (the sliding-window layers of
// the reference model, whose _chunked_causal masks k_pos <= q_pos - w too):
// then a key is masked when k_pos > q_pos or q_pos - k_pos >= w, a band of
// w keys a row.  With the causal mask, kv tiles wholly above the diagonal
// are skipped, and under a band the tiles wholly below the first row's
// window as well (both would add exactly 0): a block walks only the tiles
// from the one holding q0 - w + 1 to the one holding its last row.  The
// q tiles that see the most keys are scheduled first.  A row whose first
// tiles hold none of its keys is exact in both variants: the running max
// starts at the finite -1e30, so simt takes p = exp(0) on those masked
// keys and wgmma p = 2^-inf = 0 (it masks the raw score with -inf), and
// the first tile holding a key of the row rescales what came before by
// alpha = exp(-1e30 - m) = 0.  The Python wrapper picks the variant and
// passes its code (kSimt, kWgmma):
//
// * wgmma (q, k and v bf16, dh 64 or 128, 16-byte aligned bases): the
//   tensor cores.  A block of three warpgroups owns 128 query rows: one
//   producer thread loads the q tile once and streams 128-key K and V
//   tiles by TMA through a ring of 2 stages (separate full barriers for K
//   and V, so QK^T starts while V lands); each of two consumer warpgroups
//   owns 64 rows.  The tensor maps are 3-D, (dh, S, B*H), so rows past Sq
//   or Sk of one head read as zeros, never as the next head's rows.
//   S = QK^T is wgmma.m64n128k16 from shared memory (Q and K both K-major),
//   dh / 16 deep.  The online softmax runs on the S accumulator in
//   registers: a row's 128 scores sit in the 4 threads of a quad, so its
//   max and sum are two shuffles; the scale folds into one FFMA before
//   each ex2, and only tiles on the diagonal, past Sk or across a band's
//   lower edge are masked.
//   O += P V takes P from the accumulator registers as the A fragment
//   (whose layout is the accumulator's) and V (keys x dh, MN-major) by the
//   transposed-B form.  P is split in two bf16 terms, P_hi = bf16(P) and
//   P_lo = bf16(P - P_hi), and both products go into O: the reference
//   multiplies the fp32 P, and P rounded once to bf16 misses the bf16 bar
//   of chip_smoke.py on the causal StableLM call (cancellation in the
//   early rows, where few terms carry the sum; tests/test_torch_wgmma.py
//   shows both).  The split costs 1.5x the tensor-core work of one bf16
//   PV.  Bound on the H100: the softmax's exps, bf16 splits and their
//   dependent chains, which one warp a scheduler runs at a few cycles an
//   instruction, beside the 989 TFLOP/s tensor cores; PERF.md has the
//   cycle counts.
// * simt (fp32, mixed types, other head dims up to 256): fp32 FMAs on the
//   CUDA cores.  Each of the 16 x 16 threads owns 4 query rows (ty + 16 i)
//   and 4 keys (tx + 16 j) of a 64 x 64 score tile and the same 4 rows and
//   head-dim columns tx + 16 c of the output; a row's 16 threads share one
//   half of a warp, so the row max and sum are shuffles.  The q tile and
//   each kv tile are staged in shared memory as fp32 (each element
//   converted as it is loaded, rows past Sq or Sk read as 0) at a row
//   stride of dh + 1, so the 16 keys a half-warp reads fall in 16 banks.
//   Shared memory grows with dh (212 KB at dh = 256) and is dynamic, raised
//   past 48 KB with cudaFuncSetAttribute.  Bound: the two products' FMAs
//   at the 67 TFLOP/s of the CUDA cores (shared-memory reads hold it at
//   about a quarter of that).
//
// PERF.md has the measured times beside the bounds.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "element.cuh"
#include "sm90.cuh"

namespace repro {

enum AttentionVariant { kSimt = 0, kWgmma = 1 };

// ------------------------------------------------------------------ simt

constexpr int kFaThreads = 256;
constexpr int kFaBQ = 64;   // query rows per block
constexpr int kFaBK = 64;   // keys per kv tile
constexpr int kFaRows = kFaBQ / 16;  // query rows per thread
constexpr int kFaKeys = kFaBK / 16;  // keys per thread
constexpr int kFaMaxDh = 256;
constexpr float kFaNegInf = -1e30f;

inline size_t fa_smem_bytes(int dh) {
  return sizeof(float) *
         (static_cast<size_t>(kFaBQ) * (dh + 1) +   // q tile
          static_cast<size_t>(kFaBK) * (dh + 1) +   // k tile
          static_cast<size_t>(kFaBK) * dh +         // v tile
          static_cast<size_t>(kFaBQ) * (kFaBK + 1));  // probabilities
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows [row0, row0 + rows) of a (seq, dh) slab as fp32 at the given
// row stride; rows at or past `seq` read as 0.
template <class T>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const T* __restrict__ src,
                                           int64_t row0, int rows,
                                           int64_t seq, int dh, int stride) {
  for (int e = threadIdx.x; e < rows * dh; e += kFaThreads) {
    const int r = e / dh;
    const int d = e - r * dh;
    const int64_t row = row0 + r;
    dst[r * stride + d] = row < seq ? to_f32(src[row * dh + d]) : 0.0f;
  }
}

// NC: head-dim columns per thread, ceil(dh / 16) rounded up to a power of 2.
template <class T, int NC>
__global__ void __launch_bounds__(kFaThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int64_t sq, int64_t sk, int dh, int n_qtiles,
                           float scale, int causal, int64_t window) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kFaBQ * (dh + 1);
  float* Vs = Ks + kFaBK * (dh + 1);
  float* Ps = Vs + kFaBK * dh;

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int64_t bh = blockIdx.x / n_qtiles;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x % n_qtiles);
  const int64_t q0 = static_cast<int64_t>(qt) * kFaBQ;
  const T* qb = q + bh * sq * dh;
  const T* kb = k + bh * sk * dh;
  const T* vb = v + bh * sk * dh;
  T* ob = out + bh * sq * dh;

  stage_rows(Qs, qb, q0, kFaBQ, sq, dh, dh + 1);

  float m[kFaRows], l[kFaRows], acc[kFaRows][NC];
#pragma unroll
  for (int i = 0; i < kFaRows; ++i) {
    m[i] = kFaNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // keys any row of this tile can see: all of them, or under the causal
  // mask those up to the tile's last real row, and under a band those from
  // the first row's first key, rounded down to a whole kv tile
  int64_t kv_begin = 0, kv_end = sk;
  if (causal) {
    const int64_t last_row = (q0 + kFaBQ < sq ? q0 + kFaBQ : sq) - 1;
    if (last_row + 1 < kv_end) kv_end = last_row + 1;
    if (window > 0 && q0 - window + 1 > 0)
      kv_begin = (q0 - window + 1) / kFaBK * kFaBK;
  }

  for (int64_t k0 = kv_begin; k0 < kv_end; k0 += kFaBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage_rows(Ks, kb, k0, kFaBK, sk, dh, dh + 1);
    stage_rows(Vs, vb, k0, kFaBK, sk, dh, dh);
    __syncthreads();

    float s[kFaRows][kFaKeys];
#pragma unroll
    for (int i = 0; i < kFaRows; ++i)
#pragma unroll
      for (int j = 0; j < kFaKeys; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < dh; ++d) {
      float qv[kFaRows], kv[kFaKeys];
#pragma unroll
      for (int i = 0; i < kFaRows; ++i)
        qv[i] = Qs[(ty + 16 * i) * (dh + 1) + d];
#pragma unroll
      for (int j = 0; j < kFaKeys; ++j)
        kv[j] = Ks[(tx + 16 * j) * (dh + 1) + d];
#pragma unroll
      for (int i = 0; i < kFaRows; ++i)
#pragma unroll
        for (int j = 0; j < kFaKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kFaRows; ++i) {
      const int64_t q_pos = q0 + ty + 16 * i;
      float mx = kFaNegInf;
#pragma unroll
      for (int j = 0; j < kFaKeys; ++j) {
        const int64_t k_pos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && (q_pos < k_pos || (window > 0 && q_pos - k_pos >= window)))
          x = kFaNegInf;
        if (k_pos >= sk) x = kFaNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kFaKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * (kFaBK + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kFaBK; ++j) {
      float pv[kFaRows], vv[NC];
#pragma unroll
      for (int i = 0; i < kFaRows; ++i)
        pv[i] = Ps[(ty + 16 * i) * (kFaBK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < dh ? Vs[j * dh + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kFaRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kFaRows; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) ob[row * dh + d] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <class T, int NC>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 long long bh, long long sq, long long sk, int dh, float scale,
                 int causal, long long window, cudaStream_t st) {
  const long long n_qtiles = (sq + kFaBQ - 1) / kFaBQ;
  const long long blocks = bh * n_qtiles;
  if (n_qtiles > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fa_smem_bytes(dh);
  auto kernel = flash_attention_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kFaThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, dh,
      static_cast<int>(n_qtiles), scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}


// ----------------------------------------------------------------- wgmma

constexpr int kTcBQ = 128;       // query rows per block, 64 per consumer
constexpr int kTcBK = 128;       // keys per kv tile
constexpr int kTcThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr uint32_t kTcBox = 128 * 128;  // 128 rows x 64 bf16 (one TMA box)

// shared memory: the q tile, 2 K and 2 V stages, 1024 bytes of alignment
// slack and 7 mbarriers
template <int DH>
constexpr size_t fa_tc_smem() {
  return 5 * (DH / 64) * static_cast<size_t>(kTcBox) + 1024 + 8 * 8;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x, to the MUFU's approximation (relative error about 2^-22; results
// under 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// O (64 x DH) += A (64 x 16, registers) x 16 rows of V at desc_v.
template <int DH>
__device__ __forceinline__ void pv_wgmma(float (&o)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (DH == 64)
    sm90::wgmma_m64n64k16_rs<1>(o, a, desc_v, 1);
  else
    sm90::wgmma_m64n128k16_rs<1>(o, a, desc_v, 1);
}

template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 __nv_bfloat16* __restrict__ out, int n_bh,
                                 int sq, int sk, float scale, int causal,
                                 int window) {
  using namespace sm90;
  constexpr int kChunks = DH / 64;  // 64-wide head-dim boxes per tile
  constexpr uint32_t kTile = kChunks * kTcBox;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t qs = (smem_addr(tc_smem) + 1023) & ~1023u;
  auto ks = [&](int s) { return qs + (1 + s) * kTile; };
  auto vs = [&](int s) { return qs + (3 + s) * kTile; };
  const uint32_t bars = qs + 5 * kTile;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (3 + s); };
  auto empty = [&](int s) { return bars + 8 * (5 + s); };

  // q tiles from the last (the most keys under the causal mask) to the
  // first, every head's before the next shorter tile
  const int qt = static_cast<int>(gridDim.x / n_bh) - 1 -
                 static_cast<int>(blockIdx.x / n_bh);
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int q0 = qt * kTcBQ;
  // the kv tiles from the one holding the first row's first key (under a
  // band) to the one holding the last row's last (under the causal mask)
  int kv_begin = 0, kv_end = sk;
  if (causal) {
    kv_end = min(sk, min(q0 + kTcBQ, sq));
    if (window > 0 && q0 - window + 1 > 0)
      kv_begin = (q0 - window + 1) / kTcBK * kTcBK;
  }
  const int n_kv = (kv_end + kTcBK - 1) / kTcBK - kv_begin / kTcBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 2);  // one arrive per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full_q, kTile);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_load_3d(qs + c * kTcBox, &tm_q, full_q, 64 * c, q0, bh);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it & 1;
        if (it >= 2) mbar_wait(empty(s), ((it >> 1) - 1) & 1);
        mbar_arrive_expect_tx(full_k(s), kTile);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(ks(s) + c * kTcBox, &tm_k, full_k(s), 64 * c,
                      kv_begin + it * kTcBK, bh);
        mbar_arrive_expect_tx(full_v(s), kTile);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(vs(s) + c * kTcBox, &tm_v, full_v(s), 64 * c,
                      kv_begin + it * kTcBK, bh);
      }
    }
  } else {  // consumers: rows 64 (wg - 1) .. of the q tile
    regs_alloc<232>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    // this thread's two rows (r0 and r0 + 8) and its first column in each
    // group of 8 columns of an accumulator (see sm90.cuh)
    const int r0 = q0 + cw * 64 + 16 * (t / 32) + (t % 32) / 4;
    const int c0 = 2 * (t % 4);
    float o[DH / 2], sc[kTcBK / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kTcBK / 2; ++i) sc[i] = 0.0f;
    float m[2] = {kFaNegInf, kFaNegInf}, l[2] = {0.0f, 0.0f};
    mbar_wait(full_q, 0);

    for (int it = 0; it < n_kv; ++it) {
      const int s = it & 1;
      const uint32_t phase = (it >> 1) & 1;
      const int k0 = kv_begin + it * kTcBK;

      // S = Q K^T, fp32 (each bf16 x bf16 product is exact in fp32)
      mbar_wait(full_k(s), phase);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk / 4) * kTcBox + (kk % 4) * 32;
        wgmma_m64n128k16_ss<0>(
            sc, wgmma_desc(qs + off + cw * 64 * 128, 16, 1024),
            wgmma_desc(ks(s) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Mask the raw scores, on tiles that reach past the diagonal or Sk,
      // or below the window of this warpgroup's last row, only.  A masked
      // score is -inf here where the reference has -1e30: both give p = 0
      // exactly and the same running max once a row has seen one of its
      // keys.  A row none of whose keys is in the tiles so far (a band
      // starting mid-tile, or past it) keeps m at its finite start -1e30:
      // its p = 2^(-inf) = 0 and alpha = 2^0 = 1 there, never -inf - -inf;
      // its first key then sets m and alpha = 2^(-1e30 log2 e) = 0.
      const int row_lo = q0 + cw * 64;
      const bool mask = (causal && k0 + kTcBK - 1 > row_lo) ||
                        k0 + kTcBK > sk ||
                        (window > 0 && k0 <= row_lo + 63 - window);
      if (mask) {
#pragma unroll
        for (int i = 0; i < kTcBK / 2; ++i) {
          const int k_pos = k0 + 8 * (i >> 2) + c0 + (i & 1);
          const int row = r0 + 8 * ((i >> 1) & 1);
          if (k_pos >= sk ||
              (causal && (row < k_pos ||
                          (window > 0 && row - k_pos >= window))))
            sc[i] = -INFINITY;
        }
      }
      // Row max over the quad, from four partial maxima a row (short
      // dependent chains); max(S * scale) = max(S) * scale, since rounding a
      // product is monotonic, so m is the reference's.
      float mx[2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) mx[i / 4][i % 4] = -INFINITY;
#pragma unroll
      for (int i = 0; i < kTcBK / 2; ++i) {
        float& x = mx[(i >> 1) & 1][(i >> 2) & 3];
        x = fmaxf(x, sc[i]);
      }
      float alpha[2], neg_m[2];
      const float c_log2 = scale * kLog2e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float m_new = fmaxf(m[h], v * scale);
        alpha[h] = ex2((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        neg_m[h] = -m_new * kLog2e;
      }
      // P = exp(S scale - m) = 2^(S scale log2(e) - m log2(e)) in fp32, in
      // place of S, all exps issued back to back, summed into l
      float ps[2][4] = {};
#pragma unroll
      for (int i = 0; i < kTcBK / 2; ++i) {
        const int h = (i >> 1) & 1;
        sc[i] = ex2(fmaf(sc[i], c_log2, neg_m[h]));
        ps[h][(i >> 2) & 3] += sc[i];
      }
      const float rs[2] = {(ps[0][0] + ps[0][1]) + (ps[0][2] + ps[0][3]),
                           (ps[1][0] + ps[1][1]) + (ps[1][2] + ps[1][3])};
      // P_hi = bf16(P) and P_lo = bf16(P - P_hi) as A fragments: keys
      // 16 j .. 16 j + 15 are registers 4 j .. 4 j + 3, the accumulator's
      // 8 j .. 8 j + 7 in pairs
      uint32_t p_hi[kTcBK / 4], p_lo[kTcBK / 4];
#pragma unroll
      for (int i = 0; i < kTcBK / 2; i += 2) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[i], sc[i + 1]);
        p_hi[i / 2] = bits(hi);
        p_lo[i / 2] = bits(__floats2bfloat162_rn(
            sc[i] - __low2float(hi), sc[i + 1] - __high2float(hi)));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P_hi V + P_lo V
      mbar_wait(full_v(s), phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTcBK / 16; ++j) {
        const uint32_t a[4] = {p_hi[4 * j], p_hi[4 * j + 1], p_hi[4 * j + 2],
                               p_hi[4 * j + 3]};
        pv_wgmma<DH>(o, a, wgmma_desc(vs(s) + 2048 * j, kTcBox, 1024));
      }
#pragma unroll
      for (int j = 0; j < kTcBK / 16; ++j) {
        const uint32_t a[4] = {p_lo[4 * j], p_lo[4 * j + 1], p_lo[4 * j + 2],
                               p_lo[4 * j + 3]};
        pv_wgmma<DH>(o, a, wgmma_desc(vs(s) + 2048 * j, kTcBox, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      if (t == 0) mbar_arrive(empty(s));
    }

    // out = O / max(l, 1e-30), l summed over the quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const float denom = fmaxf(l[h], 1e-30f);
      const int row = r0 + 8 * h;
      if (row >= sq) continue;
      __nv_bfloat16* orow = out + (static_cast<int64_t>(bh) * sq + row) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] / denom,
                                  o[4 * j + 2 * h + 1] / denom);
    }
  }
}

template <int DH>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* out,
                       long long bh, long long sq, long long sk, float scale,
                       int causal, long long window, cudaStream_t st) {
  const long long n_qtiles = (sq + kTcBQ - 1) / kTcBQ;
  const long long blocks = bh * n_qtiles;
  if (bh > 0x7fffffffLL || sq > 0x7fffffffLL || sk > 0x7fffffffLL ||
      blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const long long lens[3] = {sq, sk, sk};
  for (int i = 0; i < 3; ++i) {  // (B*H, S, dh) as dims {dh, S, B*H}
    const uint64_t dims[3] = {static_cast<uint64_t>(DH),
                              static_cast<uint64_t>(lens[i]),
                              static_cast<uint64_t>(bh)};
    const uint64_t strides[2] = {static_cast<uint64_t>(DH) * 2,
                                 static_cast<uint64_t>(lens[i]) * DH * 2};
    const uint32_t box[3] = {64, static_cast<uint32_t>(i == 0 ? kTcBQ : kTcBK),
                             1};
    cudaError_t err = make_tensor_map_bf16(&maps[i], bases[i], 3, dims,
                                           strides, box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = flash_attention_wgmma_kernel<DH>;
  constexpr size_t smem = fa_tc_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, smem, st>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out),
      static_cast<int>(bh), static_cast<int>(sq), static_cast<int>(sk),
      scale, causal, static_cast<int>(window < sq ? window : sq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// q: (bh, sq, dh), k and v: (bh, sk, dh), out: (bh, sq, dh), all of dtype
// code `dtype`, contiguous.  bh, sq and sk must be positive, 1 <= dh <= 256.
// `window` is 0 (no band) or, with `causal` and sq <= sk (so that every row
// keeps its own key), the band's width.  `variant` is kSimt or kWgmma;
// kWgmma takes bf16 with dh 64 or 128 and 16-byte aligned bases, and
// returns cudaErrorInvalidValue otherwise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, long long bh,
                                   long long sq, long long sk, int dh,
                                   float scale, int causal, long long window,
                                   int dtype, int variant, void* stream) {
  using namespace repro;
  if (bh <= 0 || sq <= 0 || sk <= 0 || dh < 1 || dh > kFaMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  if (window < 0 || (window > 0 && (!causal || sq > sk)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma) {
    if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
    if (dh == 64)
      return launch_flash_wgmma<64>(q, k, v, out, bh, sq, sk, scale, causal,
                                    window, st);
    if (dh == 128)
      return launch_flash_wgmma<128>(q, k, v, out, bh, sq, sk, scale, causal,
                                     window, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != kSimt) return static_cast<int>(cudaErrorInvalidValue);
  int code = static_cast<int>(cudaErrorInvalidValue);
  dispatch_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    auto launch = [&](auto nc) {
      return launch_flash<T, decltype(nc)::value>(q, k, v, out, bh, sq, sk,
                                                  dh, scale, causal, window,
                                                  st);
    };
    if (dh <= 16)
      code = launch(std::integral_constant<int, 1>{});
    else if (dh <= 32)
      code = launch(std::integral_constant<int, 2>{});
    else if (dh <= 64)
      code = launch(std::integral_constant<int, 4>{});
    else if (dh <= 128)
      code = launch(std::integral_constant<int, 8>{});
    else
      code = launch(std::integral_constant<int, 16>{});
  });
  return code;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
