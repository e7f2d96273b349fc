"""Shared building blocks of the model zoo, in PyTorch.

The port of ``repro.models.common``.  BN is carried in folded form
(:func:`fold_bn`): one per-channel ``scale``/``shift`` multiply-add, which
is what the fused conv epilogues consume.  GroupNorm folds the same way
(:func:`fold_gn`); batch statistics (:func:`bn`) and live GroupNorm
statistics (:func:`group_norm`) stay reference ops.  Initialisers draw on
the CPU from an explicit ``torch.Generator``, so a seed gives the same
weights on every device; the caller moves them.

:class:`SeededModule` holds what the port's ``nn.Module`` models share: the
device rule of their constructors (CUDA by default, ``"cpu"`` on request,
``"meta"`` for a weightless shell) and :meth:`SeededModule.load_jax_params`,
which carries a reference parameter tree across by name.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.util import resolve_device


def conv_init(generator: torch.Generator, kh: int, kw: int, cin: int,
              cout: int) -> torch.Tensor:
    """He-normal HWIO kernel init (fp32, on the CPU)."""
    fan_in = kh * kw * cin
    return (torch.randn((kh, kw, cin, cout), generator=generator,
                        dtype=torch.float32) * (2.0 / fan_in) ** 0.5)


def tconv_init(generator: torch.Generator, kh: int, kw: int, cin: int,
               cout: int, stride: int = 2) -> torch.Tensor:
    """He-normal init of a transposed conv's HWIO kernel (fp32, on the CPU).

    A stride-``s`` transposed conv spreads its ``k*k`` taps over ``s*s``
    output parities, so an output pixel sums ``~k*k/s**2`` taps: that is
    the fan-in, or a chain of upsamplers would shrink its activations by
    ``s`` a stage.
    """
    fan_in = max(kh * kw * cin // (stride * stride), 1)
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


def gn_init(c: int) -> dict[str, torch.Tensor]:
    """GroupNorm parameters: a per-channel affine (U-Net blocks)."""
    return {"g": torch.ones((c,)), "b": torch.zeros((c,))}


def group_norm(p: dict, x: torch.Tensor, groups: int = 8,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with live per-sample statistics (reference only).

    Like batch-statistics BN, the statistics are a function of the very
    output being produced, so they cannot fuse into one conv output pass;
    the models carry GroupNorm folded (:func:`fold_gn`) and this op is the
    oracle the fold is tested against.
    """
    n, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    xg = x.reshape(n, h, w, groups, c // groups)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(n, h, w, c) * p["g"] + p["b"]


def fold_gn(p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold GroupNorm to the ``(scale, shift)`` the fused epilogues take:
    the learnable affine with identity statistics (per-sample statistics
    would need a per-sample scale, which a ``(cout,)`` operand cannot
    carry)."""
    return p["g"], p["b"]


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal diffusion-timestep embedding: ``t`` (B,) -> (B, dim) fp32,
    ``[cos(t * f), sin(t * f)]`` with ``f = max_period ** (-i / (dim/2))``.
    The timestep enters the denoiser as a value, never as a shape."""
    if dim % 2:
        raise ValueError(f"embedding dim must be even, got {dim}")
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """A nested parameter tree (the reference's ``init_params`` layout) as
    one flat dict keyed by dotted names (``b1_0.bn1.g``), the names of a
    model's ``named_parameters()``, so trees compare leaf by leaf."""
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_tree(v, name))
        else:
            flat[name] = v
    return flat


class SeededModule(nn.Module):
    """Base of the port's models: weights drawn from an explicit generator
    on the CPU, then moved to the device.

    ``device``: ``None`` -> CUDA (raises without a card); ``"cpu"`` runs the
    kernels' plain versions; ``"meta"`` builds a shell that holds no
    weights (nothing is drawn), for ``torch.func.functional_call``.
    """

    def _materialise(self, device, build) -> None:
        """Run ``build()`` (which adds the parameters) on ``device``."""
        meta = device == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        with torch.device("meta") if meta else contextlib.nullcontext():
            build()
        self.to(dev)

    @torch.no_grad()
    def load_jax_params(self, tree: dict) -> None:
        """Fill the module from the reference's parameter tree.

        ``tree`` is the reference's ``init_params(...)`` as nested dicts of
        numpy arrays (same keys, HWIO kernels).  Every parameter must be
        present with its exact shape; anything missing, extra or misshapen
        raises before any parameter is written.
        """
        flat = flatten_tree(tree)
        params = dict(self.named_parameters())
        if set(flat) != set(params):
            raise KeyError(f"parameter trees differ: missing "
                           f"{sorted(set(params) - set(flat))}, extra "
                           f"{sorted(set(flat) - set(params))}")
        values = {name: torch.tensor(flat[name], dtype=torch.float32)
                  for name in params}
        for name, p in params.items():
            if tuple(values[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(values[name].shape)} "
                                 f"!= {tuple(p.shape)}")
        for name, p in params.items():
            p.copy_(values[name])


def to_device(tree: dict, device) -> dict:
    """A functional model's parameter tree, nested dicts of tensors or
    arrays (the reference's ``init_params`` output as numpy, say), as the
    same nested dicts of fp32 tensors on ``device`` (``None`` -> CUDA,
    raising without a card).  Arrays are copied."""
    dev = resolve_device(device)
    return {k: to_device(v, dev) if isinstance(v, dict)
            else (v if isinstance(v, torch.Tensor)
                  else torch.tensor(np.asarray(v))).to(dev, torch.float32)
            for k, v in tree.items()}


def unflatten_tree(flat: dict) -> dict:
    """A flat {dotted name: leaf} dict as the nested dict a functional
    model takes (the inverse of :func:`flatten_tree`)."""
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for part in path:
            d = d.setdefault(part, {})
        d[leaf] = v
    return out


__all__ = ["conv_init", "tconv_init", "prelu", "bn_init", "bn", "fold_bn",
           "gn_init", "group_norm", "fold_gn", "timestep_embedding",
           "flatten_tree", "unflatten_tree", "SeededModule", "to_device"]
