// Element types of the matmul and attention kernels: fp32 and bf16
// operands, each converted to fp32 as it is loaded (all arithmetic is fp32)
// and rounded to nearest even as it is stored.
//
// A dtype crosses the C interface as an int code (kF32, kBF16; the
// Python wrappers map torch dtypes to it), and dispatch_dtype() turns the
// code into a C++ type for a template.
#pragma once

#include <cuda_bf16.h>

namespace repro {

enum DtypeCode { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Call `f(T{})` with the element type of `code`; false for an unknown code.
template <class F>
inline bool dispatch_dtype(int code, F&& f) {
  switch (code) {
    case kF32:
      f(float{});
      return true;
    case kBF16:
      f(__nv_bfloat16{});
      return true;
    default:
      return false;
  }
}

}  // namespace repro
