"""Dynamic loss scaling and the branchless step skip.

The port of ``repro.optim.loss_scale`` (DESIGN.md §12).  The loss is
multiplied by ``scale`` before the gradient and the gradients divided by
it after; if any unscaled gradient is non-finite the step is skipped and
the scale halves; after ``growth_interval`` finite steps in a row it
doubles.  Every transition is a ``torch.where`` over 0-d tensors, and
:func:`select_tree` applies a step conditionally leaf by leaf, so a
skipped step leaves parameters and optimizer state bit-identical (no
``0 * NaN`` masks) and costs the same launches as a taken one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    """The current scale (0-d fp32) and the finite-step streak (0-d int32)."""
    scale: torch.Tensor
    good_steps: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """Config and pure transition functions of the dynamic loss scaler."""

    init_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 200      # finite steps between growth probes
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    def init(self, device=None) -> LossScaleState:
        return LossScaleState(
            torch.tensor(self.init_scale, dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))

    def scale(self, state: LossScaleState,
              loss: torch.Tensor) -> torch.Tensor:
        """Amplify the loss (in fp32) before differentiation."""
        return loss.float() * state.scale

    def unscale(self, state: LossScaleState, grads: dict) -> dict:
        """Divide every gradient by the current scale (in fp32)."""
        inv = 1.0 / state.scale
        return {k: g.float() * inv for k, g in grads.items()}

    @staticmethod
    def all_finite(grads: dict) -> torch.Tensor:
        """0-d bool: every element of every leaf is finite."""
        if not grads:
            return torch.tensor(True)
        return torch.stack([torch.isfinite(g).all()
                            for g in grads.values()]).all()

    def update(self, state: LossScaleState,
               finite: torch.Tensor) -> LossScaleState:
        """Branchless post-step transition: back off, hold or grow."""
        grown = state.good_steps + 1 >= self.growth_interval
        next_scale = torch.where(
            finite,
            torch.where(grown, state.scale * self.growth_factor, state.scale),
            state.scale * self.backoff_factor)
        next_scale = torch.clamp(next_scale, self.min_scale, self.max_scale)
        next_good = torch.where(finite & ~grown, state.good_steps + 1,
                                torch.zeros_like(state.good_steps))
        return LossScaleState(next_scale.to(torch.float32),
                              next_good.to(torch.int32))


def select_tree(pred: torch.Tensor, on_true, on_false):
    """``torch.where(pred, a, b)`` over matching trees of dicts, tuples
    (``NamedTuple``s included) and tensors; ``None`` leaves stay ``None``."""
    if isinstance(on_true, dict):
        return {k: select_tree(pred, on_true[k], on_false[k])
                for k in on_true}
    if isinstance(on_true, tuple):
        items = [select_tree(pred, a, b) for a, b in zip(on_true, on_false)]
        return (type(on_true)(*items) if hasattr(on_true, "_fields")
                else tuple(items))
    if on_true is None:
        return None
    return torch.where(pred, on_true, on_false)


__all__ = ["DynamicLossScale", "LossScaleState", "select_tree"]
