// Forward flash attention (online softmax), fp32 arithmetic, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:82).  That grid walks kv tiles
// innermost on one core, keeping the running max, the denominator and the
// output accumulator in VMEM scratch across grid steps, and its wrapper pads
// q, k and v to whole tiles in device memory.  Hopper blocks run in
// parallel and in no order, so here one block owns one (batch*head, q tile)
// and loops over the kv tiles itself, with the running state in registers:
//
//   * the q tile and each kv tile are staged in shared memory as fp32 (each
//     element converted as it is loaded, rows past Sq or Sk read as 0), so
//     no padded copy of q, k or v is made;
//   * each of the 16 x 16 threads owns 4 query rows (ty + 16 i) and 4 keys
//     (tx + 16 j) of the score tile, and the same 4 rows and head-dim
//     columns tx + 16 c of the output; a row's 16 threads share one half of
//     a warp, so the row max and row sum are shuffles;
//   * the semantics are the reference kernel's, to the letter: scores are
//     fp32 q.k scaled by dh^-1/2 (the caller passes the fp32 scale), the
//     causal mask is top-left (q_pos >= k_pos) and keys >= Sk are masked,
//     both with the finite -1e30 (so a masked entry's exp is exactly 0 once
//     a row has seen key 0, which every row does in kv tile 0), and the
//     output is acc / max(l, 1e-30) cast to q's type;
//   * with the causal mask, kv tiles wholly above the diagonal are skipped:
//     they would contribute exactly 0 to acc and l and leave m unchanged;
//   * q tiles are scheduled from the last (longest under the causal mask)
//     to the first, so the long blocks start first.
//
// The row stride of the staged q and k tiles is dh + 1, so the 16 keys a
// half-warp reads fall in 16 banks.  Shared memory grows with dh (212 KB at
// dh = 256) and is dynamic, raised past 48 KB with cudaFuncSetAttribute.
//
// Bound on the H100: the two products' FMAs (4 * unmasked pairs * dh flops),
// at 67 TFLOP/s on the CUDA cores for fp32; for bf16 the card could do them
// on its tensor cores at 989 TFLOP/s, which this kernel does not use.
// wgmma, TMA loads and bf16 tensor-core tiles are later work (ROADMAP.md);
// PERF.md has the measured time beside the bound.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "element.cuh"

namespace repro {

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
                           float scale, int causal) {
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
  // mask those up to the tile's last real row
  int64_t kv_end = sk;
  if (causal) {
    const int64_t last_row = (q0 + kFaBQ < sq ? q0 + kFaBQ : sq) - 1;
    if (last_row + 1 < kv_end) kv_end = last_row + 1;
  }

  for (int64_t k0 = 0; k0 < kv_end; k0 += kFaBK) {
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
        if (causal && q_pos < k_pos) x = kFaNegInf;
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
                 int causal, cudaStream_t st) {
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
      static_cast<int>(n_qtiles), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// q: (bh, sq, dh), k and v: (bh, sk, dh), out: (bh, sq, dh), all of dtype
// code `dtype`, contiguous.  bh, sq and sk must be positive, 1 <= dh <= 256.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, long long bh,
                                   long long sq, long long sk, int dh,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  using namespace repro;
  if (bh <= 0 || sq <= 0 || sk <= 0 || dh < 1 || dh > kFaMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int code = static_cast<int>(cudaErrorInvalidValue);
  dispatch_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    auto launch = [&](auto nc) {
      return launch_flash<T, decltype(nc)::value>(q, k, v, out, bh, sq, sk,
                                                  dh, scale, causal, st);
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
