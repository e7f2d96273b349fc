"""Shared building blocks of the segmentation models, in PyTorch.

The port of ``repro.models.common`` for the ENet slice.  BN is carried in
folded form (:func:`fold_bn`): one per-channel ``scale``/``shift``
multiply-add, which is what the fused conv epilogues consume.  Batch
statistics (:func:`bn`) stay a reference op.  Initialisers draw on the CPU
from an explicit ``torch.Generator``, so a seed gives the same weights on
every device; the caller moves them.
"""

from __future__ import annotations

import torch


def conv_init(generator: torch.Generator, kh: int, kw: int, cin: int,
              cout: int) -> torch.Tensor:
    """He-normal HWIO kernel init (fp32, on the CPU)."""
    fan_in = kh * kw * cin
    return (torch.randn((kh, kw, cin, cout), generator=generator,
                        dtype=torch.float32) * (2.0 / fan_in) ** 0.5)


def prelu(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, a * x)


def bn_init(c: int) -> dict[str, torch.Tensor]:
    return {"g": torch.ones((c,)), "b": torch.zeros((c,))}


def bn(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Batch norm with batch statistics (training form; reference only)."""
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def fold_bn(p: dict, mu: torch.Tensor | None = None,
            var: torch.Tensor | None = None,
            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold BN params (+ optional fixed statistics) to ``(scale, shift)``.

    With ``mu``/``var`` (running statistics at inference):
    ``scale = g / sqrt(var + eps)``, ``shift = b - mu * scale``.  Without
    them the fold is the learnable affine itself, as the model zoo trains.
    """
    g, b = p["g"], p["b"]
    if mu is None:
        return g, b
    scale = g * torch.rsqrt(var + eps)
    return scale, b - mu * scale


__all__ = ["conv_init", "prelu", "bn_init", "bn", "fold_bn"]
