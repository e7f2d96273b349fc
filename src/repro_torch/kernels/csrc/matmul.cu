// Dense (M, K) @ (K, N) -> (M, N) with fp32 accumulation, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py::_mm_kernel
// (pallas_call at matmul.py:51), whose grid walks K innermost into an fp32
// VMEM scratch and casts on the last K step; its wrapper pads A and B in
// device memory to whole 128^3 tiles and slices the output.  Here blocks
// run in parallel and in no order, so each block owns one BM x BN output
// tile and walks all of K itself: per step of BK it stages a BM x BK slice
// of A and a BK x BN slice of B in shared memory, converting each element to
// fp32 as it is loaded, and each of the 256 threads accumulates an 8 x 8
// register tile with fp32 FMAs on the CUDA cores (no TF32, which would break
// the 1e-4 fp32 bar).  Every load and store is masked against M, N and K,
// so nothing is padded, and offsets are 64-bit.  A, B and C share one
// element type (fp32 or bf16); the wrapper upcasts mixed operands to
// fp32 first, as the reference's dot_general(preferred_element_type=f32)
// computes them.
//
// Bound on the H100: FMAs.  The fp32 bound is the 67 TFLOP/s of the CUDA
// cores; for bf16 operands the card could do the same work on its tensor
// cores at 989 TFLOP/s, which this kernel does not use.  wgmma, TMA loads
// and bf16 tensor-core tiles are later work (ROADMAP.md); see PERF.md for
// the measured time beside the bound.

#include <cuda_runtime.h>

#include <cstdint>

#include "element.cuh"

namespace repro {

constexpr int kMmThreads = 256;
constexpr int kMmBM = 128, kMmBN = 128, kMmBK = 16;
constexpr int kMmTM = 8, kMmTN = 8;  // register tile of one thread
// the A slice is stored k-major; +4 keeps float4 rows 16-byte aligned
constexpr int kMmAStride = kMmBM + 4;

static_assert((kMmBM / kMmTM) * (kMmBN / kMmTN) == kMmThreads,
              "one 8 x 8 register tile per thread");

template <class T>
__global__ void __launch_bounds__(kMmThreads)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ c, int64_t M, int64_t N, int64_t K) {
  __shared__ __align__(16) float As[kMmBK][kMmAStride];
  __shared__ __align__(16) float Bs[kMmBK][kMmBN];

  const int t = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kMmBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kMmBN;

  // staging: A element (row ar + 16 i, col ak); B element (row bk + 2 i,
  // col bn).  Neighbouring threads read neighbouring addresses of a row.
  const int ak = t % kMmBK;
  const int ar = t / kMmBK;
  const int bn = t % kMmBN;
  const int bk = t / kMmBN;
  constexpr int kARows = kMmThreads / kMmBK;  // 16
  constexpr int kBRows = kMmThreads / kMmBN;  // 2

  // compute: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise
  // with tx, so each shared-memory read is one float4
  const int tx = t % (kMmBN / kMmTN);
  const int ty = t / (kMmBN / kMmTN);

  float acc[kMmTM][kMmTN];
#pragma unroll
  for (int i = 0; i < kMmTM; ++i)
#pragma unroll
    for (int j = 0; j < kMmTN; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < K; k0 += kMmBK) {
    {
      const int64_t k = k0 + ak;
#pragma unroll
      for (int i = 0; i < kMmBM / kARows; ++i) {
        const int r = ar + i * kARows;
        const int64_t m = m0 + r;
        As[ak][r] = (m < M && k < K) ? to_f32(a[m * K + k]) : 0.0f;
      }
      const int64_t n = n0 + bn;
#pragma unroll
      for (int i = 0; i < kMmBK / kBRows; ++i) {
        const int r = bk + i * kBRows;
        const int64_t kb = k0 + r;
        Bs[r][bn] = (kb < K && n < N) ? to_f32(b[kb * N + n]) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmBK; ++kk) {
      float av[kMmTM], bv[kMmTN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][kMmBM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][kMmBN / 2 + tx * 4]);
      av[0] = a0.x, av[1] = a0.y, av[2] = a0.z, av[3] = a0.w;
      av[4] = a1.x, av[5] = a1.y, av[6] = a1.z, av[7] = a1.w;
      bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
      bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kMmTM; ++i)
#pragma unroll
        for (int j = 0; j < kMmTN; ++j) acc[i][j] = fmaf(av[i], bv[j],
                                                         acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMmTM; ++i) {
    const int64_t m = m0 + (i / 4) * (kMmBM / 2) + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kMmTN; ++j) {
      const int64_t n = n0 + (j / 4) * (kMmBN / 2) + tx * 4 + j % 4;
      if (n < N) c[m * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace repro

// a: (M, K), b: (K, N), c: (M, N), all of dtype code `dtype`, row-major
// and contiguous.  M and N must be positive.
extern "C" int matmul_fwd(const void* a, const void* b, void* c,
                          long long M, long long N, long long K, int dtype,
                          void* stream) {
  using namespace repro;
  const long long n_tiles = (N + kMmBN - 1) / kMmBN;
  if (M <= 0 || N <= 0 || K < 0 || n_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((M + kMmBM - 1) / kMmBM),
                  static_cast<unsigned>(n_tiles), 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = dispatch_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    matmul_kernel<T><<<grid, kMmThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(c), M, N, K);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
