// Hopper (sm_90a) building blocks shared by the bf16 tensor-core variants of
// matmul.cu and flash_attention.cu: PTX wrappers for mbarriers, TMA tile
// loads and stores, wgmma shared-memory descriptors and issues, stmatrix,
// the async-proxy fence and named barriers, and the host-side tensor-map
// encoder.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle (or by
// stmatrix in the same layout): 64 bf16 values (128 bytes) a row, rows 128
// bytes apart, the eight 16-byte chunks of row r permuted by r % 8, every
// tile 1024-byte aligned.  The same bytes serve as a wgmma operand in either
// of its two layouts:
//
//   * K-major (A of both products, K of QK^T): rows are M (or N), the
//     128-byte row runs along K.  Eight rows form a 1024-byte atom; SBO =
//     1024 steps between atoms, LBO is unused, and a k16 step inside the
//     64-wide row advances the start address by 32 bytes.
//   * MN-major (B of matmul, V of PV; the "transposed B" form): rows are K,
//     the 128-byte row runs along N.  SBO = 1024 steps between groups of
//     eight K rows, LBO steps between 64-wide N chunks (each chunk is its
//     own TMA box), and a k16 step advances the start address by 16 rows,
//     2048 bytes.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and to
// the other threads; every thread calls __syncthreads() after this.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts any legitimate one (2^33 cycles, seconds) traps, so a pipeline
// fault shows as a launch error, not as a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 33)) __trap();
  }
}

// ------------------------------------------------------------------- TMA

// Tile load global -> shared, completing `bytes` on barrier `bar`.
// Coordinates are in elements, innermost first; rows and columns outside
// the tensor are filled with zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Tile store shared -> global of the box at `src`; elements outside the
// tensor are not written.  Completes as a bulk group of this thread: commit,
// then wait until the shared memory has been read before it is reused or
// the block exits.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled tile at shared
// address `addr` (1024-byte aligned up to the k16 offsets described
// above); `lbo` and `sbo` in bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);  // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes (its accumulators and register A
// fragments) across the wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Hand registers between the warpgroups of a warp-specialised block: the
// producer gives up what it does not need, the consumers take it.
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// Store four 8 x 8 bf16 matrices to shared memory, one warp: lane l gives
// the address of row l % 8 of matrix l / 8, and register j of every lane
// holds two neighbouring values of matrix j in the accumulator layout
// (row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
          addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// Make this thread's shared-memory stores visible to the async proxy,
// through which wgmma and TMA stores read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barriers 1..15 (0 is __syncthreads): wait until `count` threads
// of the block, this one included, have reached barrier `id`.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// D (64 x N, fp32, in registers) += A (64 x 16 bf16) * B (16 x N bf16), on
// one warpgroup, B from shared memory; scale_d == 0 overwrites D.  "ss": A
// from shared memory, K-major; "rs": A from registers, four bf16 pairs a
// thread in the layout of the accumulator's first 16 columns (see
// flash_attention.cu).  TransB = 1 takes B MN-major.  Thread t of the
// warpgroup holds accumulator d[i] at row 16 (t / 32) + (t % 32) / 4 +
// 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2.
#define R8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int TransB>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n"
      "    {%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "     %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "     %16, %17, %18, %19, %20, %21, %22, %23,\n"
      "     %24, %25, %26, %27, %28, %29, %30, %31,\n"
      "     %32, %33, %34, %35, %36, %37, %38, %39,\n"
      "     %40, %41, %42, %43, %44, %45, %46, %47,\n"
      "     %48, %49, %50, %51, %52, %53, %54, %55,\n"
      "     %56, %57, %58, %59, %60, %61, %62, %63,\n"
      "     %64, %65, %66, %67, %68, %69, %70, %71,\n"
      "     %72, %73, %74, %75, %76, %77, %78, %79,\n"
      "     %80, %81, %82, %83, %84, %85, %86, %87,\n"
      "     %88, %89, %90, %91, %92, %93, %94, %95,\n"
      "     %96, %97, %98, %99, %100, %101, %102, %103,\n"
      "     %104, %105, %106, %107, %108, %109, %110, %111,\n"
      "     %112, %113, %114, %115, %116, %117, %118, %119,\n"
      "     %120, %121, %122, %123, %124, %125, %126, %127},\n"
      "    %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : R8(0), R8(8), R8(16), R8(24),
        R8(32), R8(40), R8(48), R8(56),
        R8(64), R8(72), R8(80), R8(88),
        R8(96), R8(104), R8(112), R8(120)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "    {%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "     %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "     %16, %17, %18, %19, %20, %21, %22, %23,\n"
      "     %24, %25, %26, %27, %28, %29, %30, %31,\n"
      "     %32, %33, %34, %35, %36, %37, %38, %39,\n"
      "     %40, %41, %42, %43, %44, %45, %46, %47,\n"
      "     %48, %49, %50, %51, %52, %53, %54, %55,\n"
      "     %56, %57, %58, %59, %60, %61, %62, %63},\n"
      "    %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : R8(0), R8(8), R8(16), R8(24),
        R8(32), R8(40), R8(48), R8(56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "    {%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "     %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "     %16, %17, %18, %19, %20, %21, %22, %23,\n"
      "     %24, %25, %26, %27, %28, %29, %30, %31,\n"
      "     %32, %33, %34, %35, %36, %37, %38, %39,\n"
      "     %40, %41, %42, %43, %44, %45, %46, %47,\n"
      "     %48, %49, %50, %51, %52, %53, %54, %55,\n"
      "     %56, %57, %58, %59, %60, %61, %62, %63},\n"
      "    {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : R8(0), R8(8), R8(16), R8(24),
        R8(32), R8(40), R8(48), R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "    {%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "     %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "     %16, %17, %18, %19, %20, %21, %22, %23,\n"
      "     %24, %25, %26, %27, %28, %29, %30, %31},\n"
      "    {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(TransB));
}


#undef R8

}  // namespace sm90

// ---------------------------------------------------------- tensor maps

// cuTensorMapEncodeTiled, taken from the driver at run time so that the
// libraries need no -lcuda.
using TensorMapEncodeFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline TensorMapEncodeFn tensor_map_encoder() {
  static TensorMapEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<TensorMapEncodeFn>(p);
  }();
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle and zero fill out of
// bounds.  dims and box innermost first; strides in bytes of dims 1..rank-1.
// Returns cudaErrorInvalidValue where TMA cannot take the tensor: a base
// not 16-byte aligned or a stride not a multiple of 16 bytes.
inline cudaError_t make_tensor_map_bf16(CUtensorMap* map, const void* base,
                                        int rank, const uint64_t* dims,
                                        const uint64_t* strides,
                                        const uint32_t* box) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return cudaErrorInvalidValue;
  for (int i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16 != 0) return cudaErrorInvalidValue;
  TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), d, s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace repro
