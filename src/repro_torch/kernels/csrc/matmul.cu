// Dense (M, K) @ (K, N) -> (M, N) with fp32 accumulation, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py::_mm_kernel
// (pallas_call at matmul.py:51), whose grid walks K innermost into an fp32
// VMEM scratch and casts on the last K step; its wrapper pads A and B in
// device memory to whole 128^3 tiles and slices the output.  Here blocks
// run in parallel and in no order, so each block owns one output tile and
// walks all of K itself.  Nothing is padded in device memory.  Two
// variants; the Python wrapper picks one by dtype, shape and alignment and
// passes its code (kSimt, kWgmma) to matmul_fwd:
//
// * wgmma (bf16 A and B, K and N multiples of 8, 16-byte aligned bases):
//   the tensor cores.  A block owns a 128 x 256 tile: one producer thread
//   keeps TMA loads of 128 x 64 A and 64 x 256 B slices in flight through
//   a ring of 4 stages (48 KB each, a full and an empty mbarrier per
//   stage), and two consumer warpgroups, 64 rows each, issue
//   wgmma.m64n256k16 from shared memory into 128 fp32 accumulators a
//   thread.  A (M, K) is K-major; B (K, N) row-major is MN-major and is
//   read with wgmma's transposed-B form, in four 64-column TMA boxes (the
//   128-byte swizzle caps a box row at 64 bf16).  TMA fills reads past M,
//   N or K with zeros, so ragged shapes need no masking.  The epilogue
//   rounds the accumulators to bf16 into the drained ring with stmatrix
//   (128-byte-swizzled 64 x 64 boxes) and writes C with TMA stores, which
//   clip at M and N; scattered 4-byte stores from the registers took a
//   quarter of a tile's time.  Bound on the H100: the 989 TFLOP/s of the
//   bf16 tensor cores at StableLM-2's shapes.
// * simt (everything else: fp32, K or N not a multiple of 8, unaligned
//   views): fp32 FMAs on the CUDA cores (no TF32, which would break the
//   1e-4 fp32 bar).  128 x 128 tiles, K in steps of 16 staged in shared
//   memory as fp32 (each element converted as it is loaded), an 8 x 8
//   register tile per thread, every load and store masked against M, N
//   and K.  Bound: the 67 TFLOP/s of the CUDA cores.
//
// A, B and C share one element type; the wrapper upcasts mixed operands to
// fp32 first, as the reference's dot_general(preferred_element_type=f32)
// computes them.  PERF.md has the measured times beside the bounds.
//
// The batched form (matmul_batched_fwd) computes c[e] = a[e] @ b[e] for
// contiguous (E, M, K), (E, K, N) and (E, M, N): the expert products of
// the MoE FFN (models/moe.py), which the reference writes as einsums over a
// stacked weight (src/repro/models/moe.py:86-90) and XLA computes outside
// any Pallas kernel.  Both variants put the expert on blockIdx.z, so one
// launch covers every expert.  simt offsets its three pointers by the
// expert's batch strides; wgmma reads rank-3 tensor maps (K, M, E) and so
// on, so a tile's rows past M come back from TMA as zeros and its TMA
// stores clip at M: no tile reads or writes the next expert's rows, which
// an (E * M, K) view through the 2-D form would do for M not a multiple of
// 128 (M = 320 at a prefill's capacity buffers, 1 at decode).  Bound: the
// bf16 tensor cores at a prefill's M = 320; the bytes of every expert's
// weights at decode, where M = 1 and the 128-row tile is mostly zeros.

#include <cuda_runtime.h>

#include <cstdint>

#include "element.cuh"
#include "sm90.cuh"

namespace repro {

enum MatmulVariant { kSimt = 0, kWgmma = 1 };

// ------------------------------------------------------------------ simt

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
  // the batched form's expert; 0 in the 2-D form (gridDim.z = 1)
  const int64_t e = blockIdx.z;
  a += e * M * K;
  b += e * K * N;
  c += e * M * N;
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


// ----------------------------------------------------------------- wgmma

constexpr int kTcBM = 128, kTcBN = 256, kTcBK = 64, kTcStages = 4;
constexpr int kTcThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr uint32_t kTcABytes = kTcBM * kTcBK * 2;   // 128 rows x 128 B
constexpr uint32_t kTcBBox = kTcBK * 64 * 2;        // 64 K rows x 128 B
constexpr uint32_t kTcStageBytes = kTcABytes + (kTcBN / 64) * kTcBBox;
// the ring, 1024 bytes of alignment slack, and 2 mbarriers per stage
constexpr size_t kTcSmem = kTcStages * kTcStageBytes + 1024 + 16 * kTcStages;

// kBatched: the tensor maps are rank 3, the expert blockIdx.z their
// outermost coordinate.
template <bool kBatched>
__global__ void __launch_bounds__(kTcThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                        const __grid_constant__ CUtensorMap tm_b,
                        const __grid_constant__ CUtensorMap tm_c, int K) {
  using namespace sm90;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t ring = (smem_addr(tc_smem) + 1023) & ~1023u;
  const uint32_t bars = ring + kTcStages * kTcStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kTcStages + s); };
  const int wg = threadIdx.x / 128;
  const int nk = (K + kTcBK - 1) / kTcBK;
  const int m0 = blockIdx.y * kTcBM;
  const int n0 = blockIdx.x * kTcBN;
  const int e = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full(s), 1);   // the producer's arrive + the TMA bytes
      mbar_init(empty(s), 2);  // one arrive per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kTcStages;
        if (kt >= kTcStages) mbar_wait(empty(s), (kt / kTcStages - 1) & 1);
        const uint32_t a_s = ring + s * kTcStageBytes;
        mbar_arrive_expect_tx(full(s), kTcStageBytes);
        if constexpr (kBatched)
          tma_load_3d(a_s, &tm_a, full(s), kt * kTcBK, m0, e);
        else
          tma_load_2d(a_s, &tm_a, full(s), kt * kTcBK, m0);
#pragma unroll
        for (int j = 0; j < kTcBN / 64; ++j) {
          const uint32_t b_s = a_s + kTcABytes + j * kTcBBox;
          if constexpr (kBatched)
            tma_load_3d(b_s, &tm_b, full(s), n0 + 64 * j, kt * kTcBK, e);
          else
            tma_load_2d(b_s, &tm_b, full(s), n0 + 64 * j, kt * kTcBK);
        }
      }
    }
  } else {  // consumers: rows 64 (wg - 1) .. of the tile
    const int cw = wg - 1;
    float acc[kTcBN / 2];
#pragma unroll
    for (int i = 0; i < kTcBN / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kTcStages;
      mbar_wait(full(s), (kt / kTcStages) & 1);
      const uint32_t a_s = ring + s * kTcStageBytes + cw * 64 * 128;
      const uint32_t b_s = ring + s * kTcStageBytes + kTcABytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTcBK / 16; ++k)
        wgmma_m64n256k16_ss<1>(acc, wgmma_desc(a_s + 32 * k, 16, 1024),
                               wgmma_desc(b_s + 2048 * k, kTcBBox, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty(s));
    }
    // C: both consumers are done with the ring, so each rounds its 64 x 256
    // rows to bf16 into its own 32 KB of it, as four 64 x 64 boxes with the
    // 128-byte swizzle.  Accumulator registers 8 j .. 8 j + 7 hold columns
    // 16 j .. 16 j + 15 of this thread's two rows, four 8 x 8 matrices;
    // lane l stores row 8 ((l / 8) % 2) + l % 8 of matrix l / 8.
    named_barrier_sync(1, 256);
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int mi = lane / 8;
    const uint32_t c_s = ring + cw * 4 * kTcBBox;
    const uint32_t row = (16 * (t / 32) + 8 * (mi & 1) + lane % 8) * 128;
#pragma unroll
    for (int j = 0; j < kTcBN / 16; ++j) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 p =
            __floats2bfloat162_rn(acc[8 * j + 2 * q], acc[8 * j + 2 * q + 1]);
        v[q] = *reinterpret_cast<const uint32_t*>(&p);
      }
      const uint32_t unit = 2 * (j % 4) + (mi >> 1);
      stmatrix_x4(c_s + (j / 4) * kTcBBox + row + ((unit ^ (lane % 8)) << 4),
                  v[0], v[1], v[2], v[3]);
    }
    fence_proxy_async();
    named_barrier_sync(2 + cw, 128);
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < kTcBN / 64; ++j) {
        if constexpr (kBatched)
          tma_store_3d(&tm_c, c_s + j * kTcBBox, n0 + 64 * j, m0 + 64 * cw,
                       e);
        else
          tma_store_2d(&tm_c, c_s + j * kTcBBox, n0 + 64 * j, m0 + 64 * cw);
      }
      tma_store_commit_and_wait();
    }
  }
}

// E experts of (M, K) @ (K, N); `batched` takes rank-3 tensor maps (the
// batched form, any E >= 1), else rank 2 (the 2-D form, E = 1).
int launch_matmul_wgmma(const void* a, const void* b, void* c, long long E,
                        long long M, long long N, long long K, bool batched,
                        cudaStream_t st) {
  const long long m_tiles = (M + kTcBM - 1) / kTcBM;
  const long long n_tiles = (N + kTcBN - 1) / kTcBN;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || M > 0x7fffffffLL ||
      N > 0x7fffffffLL || K > 0x7fffffffLL || m_tiles > 65535 ||
      E > 65535 || (!batched && E != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rank = batched ? 3 : 2;
  const uint64_t e = static_cast<uint64_t>(E), m = static_cast<uint64_t>(M),
                 n = static_cast<uint64_t>(N), k = static_cast<uint64_t>(K);
  CUtensorMap tm_a, tm_b, tm_c;
  {  // A (E, M, K): dims {K, M, E}, box 64 x 128 x 1
    const uint64_t dims[3] = {k, m, e};
    const uint64_t strides[2] = {k * 2, m * k * 2};
    const uint32_t box[3] = {kTcBK, kTcBM, 1};
    cudaError_t err = make_tensor_map_bf16(&tm_a, a, rank, dims, strides, box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {  // B (E, K, N): dims {N, K, E}, box 64 x 64 x 1
    const uint64_t dims[3] = {n, k, e};
    const uint64_t strides[2] = {n * 2, k * n * 2};
    const uint32_t box[3] = {64, kTcBK, 1};
    cudaError_t err = make_tensor_map_bf16(&tm_b, b, rank, dims, strides, box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {  // C (E, M, N): dims {N, M, E}, box 64 x 64 x 1
    const uint64_t dims[3] = {n, m, e};
    const uint64_t strides[2] = {n * 2, m * n * 2};
    const uint32_t box[3] = {64, 64, 1};
    cudaError_t err = make_tensor_map_bf16(&tm_c, c, rank, dims, strides, box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = batched ? matmul_wgmma_kernel<true>
                        : matmul_wgmma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTcSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(m_tiles), static_cast<unsigned>(E));
  kernel<<<grid, kTcThreads, kTcSmem, st>>>(tm_a, tm_b, tm_c,
                                            static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}

// The simt form over E experts (E = 1: the 2-D form).
int launch_matmul_simt(const void* a, const void* b, void* c, long long E,
                       long long M, long long N, long long K, int dtype,
                       cudaStream_t st) {
  const long long n_tiles = (N + kMmBN - 1) / kMmBN;
  if (n_tiles > 65535 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((M + kMmBM - 1) / kMmBM),
                  static_cast<unsigned>(n_tiles), static_cast<unsigned>(E));
  const bool known = dispatch_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    matmul_kernel<T><<<grid, kMmThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(c), M, N, K);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// a: (M, K), b: (K, N), c: (M, N), all of dtype code `dtype`, row-major
// and contiguous.  M and N must be positive.  `variant` is kSimt or kWgmma;
// kWgmma takes bf16 only, K and N multiples of 8 and 16-byte aligned
// bases, and returns cudaErrorInvalidValue otherwise.
extern "C" int matmul_fwd(const void* a, const void* b, void* c,
                          long long M, long long N, long long K, int dtype,
                          int variant, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == kWgmma) {
    if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
    return launch_matmul_wgmma(a, b, c, 1, M, N, K, false, st);
  }
  if (variant != kSimt) return static_cast<int>(cudaErrorInvalidValue);
  return launch_matmul_simt(a, b, c, 1, M, N, K, dtype, st);
}

// The batched form: a (E, M, K), b (E, K, N), c (E, M, N), row-major and
// contiguous, c[e] = a[e] @ b[e].  E, M and N must be positive and E at
// most 65535 (the grid's z).  `variant` as for matmul_fwd; kWgmma takes
// the same operands it takes there (bf16, K and N multiples of 8, 16-byte
// aligned bases, which keeps every expert's slice aligned too).
extern "C" int matmul_batched_fwd(const void* a, const void* b, void* c,
                                  long long E, long long M, long long N,
                                  long long K, int dtype, int variant,
                                  void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || M <= 0 || N <= 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == kWgmma) {
    if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
    return launch_matmul_wgmma(a, b, c, E, M, N, K, true, st);
  }
  if (variant != kSimt) return static_cast<int>(cudaErrorInvalidValue);
  return launch_matmul_simt(a, b, c, E, M, N, K, dtype, st);
}

extern "C" const char* matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
