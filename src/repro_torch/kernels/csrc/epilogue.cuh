// Fused conv epilogue, shared by the dense and the transposed conv kernels.
//
// Replaces the in-kernel body src/repro/kernels/epilogue.py::apply_tile.
// It runs on each fp32 accumulator in registers, before the store, in the
// reference's order: folded BN (y*scale + shift) -> pre_act residual ->
// PReLU -> post_act residual.  Without PReLU the two residual placements
// are the same single add.  Channel operands are fp32 (cout,) vectors (the
// wrapper broadcasts a scalar slope); the residual is NHWC like the output
// and is read at the output element's own offset.
#pragma once

#include <cstdint>

namespace repro {

enum ResidualMode : int { kResidualNone = 0, kResidualPreAct = 1,
                          kResidualPostAct = 2 };

struct Epilogue {
  const float* scale;     // (cout,) or null
  const float* shift;     // (cout,) or null
  const float* alpha;     // (cout,) or null
  const float* residual;  // output-shaped, or null
  int bn;                 // apply y * scale + shift
  int prelu;              // apply PReLU with slope alpha
  int residual_mode;      // ResidualMode
};

__device__ __forceinline__ float apply_epilogue(float y, const Epilogue& ep,
                                                int co, int64_t idx) {
  if (ep.bn) y = y * ep.scale[co] + ep.shift[co];
  if (ep.residual_mode == kResidualPreAct) y += ep.residual[idx];
  if (ep.prelu) y = y >= 0.0f ? y : ep.alpha[co] * y;
  if (ep.residual_mode == kResidualPostAct) y += ep.residual[idx];
  return y;
}

}  // namespace repro
