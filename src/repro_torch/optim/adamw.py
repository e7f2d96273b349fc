"""AdamW with fp32 master weights, as plain tensor functions.

The port of ``repro.optim.adamw``.  Parameters, gradients and moments are
flat ``{name: tensor}`` dicts (the names of ``ENet.named_parameters()``);
the state mirrors the reference's:

  master  — fp32 copy of the parameters (authoritative)
  mu, nu  — fp32 first/second moments
  step    — 0-d int32 tensor

The arithmetic follows the reference step for step (global-norm clip,
bias correction, decoupled weight decay inside the lr product), over the
leaves in the reference's order (sorted names, as JAX flattens a dict), so
a step compares with it leaf by leaf.  ``torch.optim.AdamW`` orders and
clips differently and is not used.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor
    master: dict | None
    mu: dict
    nu: dict


def adamw_init(params: dict, *, memory_mode: str = "fp32") -> AdamWState:
    """fp32 master copy and zero moments.  ``memory_mode="bf16"`` (bf16
    moments, no master) waits for the bf16 slice of ROADMAP.md."""
    if memory_mode == "bf16":
        raise NotImplementedError(
            "adamw_init: memory_mode='bf16' waits for the bf16 slice of "
            "ROADMAP.md (queue 1 item 4b)")
    if memory_mode != "fp32":
        raise ValueError(f"unknown memory_mode {memory_mode!r}")
    dev = next(iter(params.values())).device if params else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master={k: p.detach().to(torch.float32, copy=True)
                for k, p in params.items()},
        mu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
    )


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, leaves in sorted
    name order."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def adamw_update(grads: dict, state: AdamWState, params: dict, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns ``(new_params, new_state, grad_norm)``.  ``lr`` may be a
    Python float or a 0-d tensor."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    mu, nu, master = {}, {}, {}
    for k in sorted(grads):
        g = grads[k].float() * scale
        mf = b1 * state.mu[k].float() + (1 - b1) * g
        vf = b2 * state.nu[k].float() + (1 - b2) * g * g
        mhat, vhat = mf / c1, vf / c2
        w = state.master[k].float()
        master[k] = w - lr * (mhat / (torch.sqrt(vhat) + eps)
                              + weight_decay * w)
        mu[k], nu[k] = mf, vf
    new_params = {k: master[k].to(params[k].dtype) for k in params}
    return new_params, AdamWState(step, master, mu, nu), gnorm


__all__ = ["AdamWState", "adamw_init", "global_norm", "adamw_update"]
