// Fused conv epilogue, shared by the dense and the transposed conv kernels.
//
// Replaces the in-kernel body src/repro/kernels/epilogue.py::apply_tile.
// It runs on each fp32 accumulator before the store, in the reference's
// order: folded BN (y*scale + shift) -> pre_act residual -> PReLU ->
// post_act residual.  Without PReLU the two residual placements are the
// same single add.  Channel operands are fp32 (cout,) vectors (the wrapper
// broadcasts a scalar slope), which the kernels stage per block; the
// residual is NHWC like the output, in the output's element type E (fp32
// or bf16, widened to fp32 as it is read), and is read at the output
// element's own offset.  All of it is fp32 arithmetic: a bf16 output is
// rounded once, after the epilogue.  apply_epilogue4 is the same on 4
// elements, for the kernels' 16-byte (fp32) and 8-byte (bf16) stores.
#pragma once

#include <cstdint>

namespace repro {

enum ResidualMode : int { kResidualNone = 0, kResidualPreAct = 1,
                          kResidualPostAct = 2 };

template <class E>
struct Epilogue {
  const float* scale;     // (cout,) or null
  const float* shift;     // (cout,) or null
  const float* alpha;     // (cout,) or null
  const E* residual;      // output-shaped, or null
  int bn;                 // apply y * scale + shift
  int prelu;              // apply PReLU with slope alpha
  int residual_mode;      // ResidualMode
};

// one element: its channel's scale, shift and alpha, and its residual
// (ignored where the epilogue does not apply them)
template <class E>
__device__ __forceinline__ float apply_epilogue(float y, float scale,
                                                float shift, float alpha,
                                                float res,
                                                const Epilogue<E>& ep) {
  if (ep.bn) y = y * scale + shift;
  if (ep.residual_mode == kResidualPreAct) y += res;
  if (ep.prelu) y = y >= 0.0f ? y : alpha * y;
  if (ep.residual_mode == kResidualPostAct) y += res;
  return y;
}

template <class E>
__device__ __forceinline__ float4 apply_epilogue4(float4 y, float4 scale,
                                                  float4 shift, float4 alpha,
                                                  float4 res,
                                                  const Epilogue<E>& ep) {
  y.x = apply_epilogue(y.x, scale.x, shift.x, alpha.x, res.x, ep);
  y.y = apply_epilogue(y.y, scale.y, shift.y, alpha.y, res.y, ep);
  y.z = apply_epilogue(y.z, scale.z, shift.z, alpha.z, res.z, ep);
  y.w = apply_epilogue(y.w, scale.w, shift.w, alpha.w, res.w, ep);
  return y;
}

}  // namespace repro
