"""AdamW with fp32 master weights, as plain tensor functions.

The port of ``repro.optim.adamw``.  Parameters, gradients and moments are
flat ``{name: tensor}`` dicts (the names of ``ENet.named_parameters()``);
the state mirrors the reference's:

  master  — fp32 copy of the parameters (authoritative); ``None`` in the
            bf16 memory mode, where the parameters are the master
  mu, nu  — first/second moments: fp32, or bf16 in the bf16 memory mode
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
    """fp32 master copy and zero fp32 moments.  ``memory_mode="bf16"``, as
    in the reference, drops the master and keeps bf16 moments (6 bytes a
    parameter instead of 14): the parameters are then the master, and the
    update math stays fp32."""
    if memory_mode not in ("fp32", "bf16"):
        raise ValueError(f"unknown memory_mode {memory_mode!r}")
    fp32 = memory_mode == "fp32"
    moment = torch.float32 if fp32 else torch.bfloat16
    dev = next(iter(params.values())).device if params else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master=({k: p.detach().to(torch.float32, copy=True)
                 for k, p in params.items()} if fp32 else None),
        mu={k: torch.zeros_like(p, dtype=moment) for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=moment) for k, p in params.items()},
    )


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, leaves in sorted
    name order."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def adamw_update(grads: dict, state: AdamWState, params: dict, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 gnorm: torch.Tensor | None = None):
    """Returns ``(new_params, new_state, grad_norm)``.  ``lr`` may be a
    Python float or a 0-d tensor.  The update is fp32 whatever the state's
    dtypes; the moments and the master (the parameters when there is no
    master) are stored back in their own dtypes.  ``gnorm``: the gradient
    norm where ``grads`` are a rank's blocks of a sharded gradient
    (``ModelParallel.global_norm``); the update is elementwise, so it runs
    on each block as on the whole."""
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    masters = state.master if state.master is not None else params
    mu, nu, master = {}, {}, {}
    for k in sorted(grads):
        g = grads[k].float() * scale
        mf = b1 * state.mu[k].float() + (1 - b1) * g
        vf = b2 * state.nu[k].float() + (1 - b2) * g * g
        mhat, vhat = mf / c1, vf / c2
        w = masters[k].float()
        master[k] = (w - lr * (mhat / (torch.sqrt(vhat) + eps)
                               + weight_decay * w)).to(masters[k].dtype)
        mu[k], nu[k] = mf.to(state.mu[k].dtype), vf.to(state.nu[k].dtype)
    new_params = {k: master[k].to(params[k].dtype) for k in params}
    kept = master if state.master is not None else None
    return new_params, AdamWState(step, kept, mu, nu), gnorm


__all__ = ["AdamWState", "adamw_init", "global_norm", "adamw_update"]
