"""Mixture-of-Experts FFN: top-k routing with grouped capacity dispatch.

The port of ``repro.models.moe``.  Tokens are routed in groups of ``g``
tokens with a per-group expert capacity ``cap = max(1, int(ceil(g * k / E)
* capacity_factor))``; a (token, slot) past its expert's capacity in its
group is dropped and contributes nothing.  Groups form within the sequence
when ``S >= group_size`` and ``S % group_size == 0``, else across the
batch's tokens with ``g = min(group_size, B * S)``
(:func:`group_tokens`).  An optional shared expert (Llama-4) runs densely
beside the routed ones.

What the reference computes, the port computes the same way up to the
dispatch:

* **Routing** (:func:`route`): fp32 logits ``x @ router``, top-k with ties
  to the lower expert index (as ``lax.top_k``; ``torch.topk`` does not
  promise that order, so a stable descending sort picks them), a softmax
  over the k gates, and each (token, slot)'s position in its expert's
  buffer as the running count over the group's (token, slot) order,
  token-major.
* **Dispatch and combine as gathers.**  The reference builds a (B, G, g, E,
  C) one-hot and contracts it twice; each (expert, slot) holds at most one
  token, so the port copies the kept tokens into an (E, R, D) buffer, R =
  groups x cap, rows with no token zero, and gathers each token's kept rows
  back.  The numbers are the same: the one-hot products have one nonzero
  term each.  The combine weights each row by its gate rounded to
  ``x.dtype`` (the reference's ``(gates * keep).astype(x.dtype)``), sums a
  token's rows in fp32 and casts once.
* **The experts**: ``silu(xe @ we_gate) * (xe @ we_up) @ we_down``, three
  launches of kernel 3's batched form (``kernels.matmul.matmul_batched``)
  under ``backend="kernels"``, ``torch.bmm`` under ``"torch"``.  The router
  is a 2-D fp32 product (kernel 3's ``"simt"``; ``torch.matmul``) and the
  shared expert :func:`~repro_torch.models.layers.mlp`.

A MoE layer thus launches 1 + 3 two-dimensional matmuls (router, shared
expert) or 1, and 3 batched ones.  Decode computes every expert's buffer,
as the reference does, empty ones included (launching only the experts
that hold tokens is a lever, ROADMAP.md).

**The backward** (MoE training) is what the reference's ``jax.grad``
takes of the same function.  Under autograd (grad mode on and an operand
that requires grad) the kernels backend runs the experts through
``kernels.matmul.BatchedMatmulFn``, whose dA and dB are kernel 3's
batched form again (two launches a product); the router and the shared
expert go through ``linear`` and so ``MatmulFn``.  The router's gradient
flows through the softmax of the k chosen logits, as the reference's
``lax.top_k`` -> ``softmax``; with top-1 that softmax is the constant 1,
so the router's gradient is exactly zero in both packages.  Dispatch and
combine take autograd's gradients of the gathers, which are those of the
reference's one-hot contractions: a dropped (token, slot) writes the
spare row ``E * R``, which no expert reads, so its token gets no gradient
through the experts; its gate is multiplied by ``keep`` = 0, so the gate
gets none; and its clamped read of row ``E * R - 1`` is weighted by that
0, so it adds exactly zero to the real row it reads.  Under remat the
layer routes again in the recompute; the router's product has no split-K
and the sort is stable, so the routes are the forward's bit for bit.

:func:`aux_load_balance_loss` is the reference's Switch-style auxiliary
loss, a plain function: no reference path calls it, and neither does the
port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import matmul as kmm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (check_backend, dense_init, linear,
                                       mlp, mlp_init, normal_init)


def moe_init(generator, cfg: ModelConfig, dtype=torch.bfloat16,
             device=None) -> dict:
    """The reference's leaves: ``router`` fp32 (D, E); ``we_gate`` and
    ``we_up`` (E, D, F), ``we_down`` (E, F, D) in ``dtype``; ``shared``
    (an ``mlp_init``) when ``shared_expert_ff`` is set."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    p = {
        "router": dense_init(generator, d, e, torch.float32, device=device),
        "we_gate": normal_init(generator, (e, d, f), d ** -0.5, dtype, device),
        "we_up": normal_init(generator, (e, d, f), d ** -0.5, dtype, device),
        "we_down": normal_init(generator, (e, f, d), f ** -0.5, dtype,
                               device),
    }
    if m.shared_expert_ff:
        p["shared"] = mlp_init(generator, d, m.shared_expert_ff, dtype,
                               device)
    return p


def capacity(g: int, cfg: ModelConfig) -> int:
    """Slots of each expert in a group of ``g`` tokens, computed as the
    reference writes it."""
    m = cfg.moe
    return max(1, int(-(-g * m.top_k // m.num_experts) * m.capacity_factor))


def group_tokens(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) as (lead0, lead1, g, D) groups: (B, S / g, g, D) within
    the sequence when ``S >= group_size`` and ``S % group_size == 0``, else
    (1, B * S / g, g, D) across the batch's tokens with ``g =
    min(group_size, B * S)``.  Raises ``ValueError`` where ``g`` does not
    divide the tokens (the reference asserts)."""
    m = cfg.moe
    b, s, d = x.shape
    if s >= m.group_size and s % m.group_size == 0:
        g = m.group_size
        return x.reshape(b, s // g, g, d)
    tokens = b * s
    g = min(m.group_size, tokens)
    if tokens % g:
        raise ValueError(f"{cfg.name}: {tokens} tokens do not split into "
                         f"groups of {g} (moe.group_size {m.group_size})")
    return x.reshape(1, tokens // g, g, d)


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
          backend: str = "kernels", experts: torch.Tensor | None = None):
    """Route the grouped tokens ``xt`` (lead0, lead1, g, D).  Returns
    ``(idx, gates, pos, keep)``, each (lead0, lead1, g, k): the experts
    (int64, ties to the lower index), the softmax over the k gates (fp32),
    each slot's position in its expert's buffer and whether it is within
    the group's capacity.  ``experts`` (int64, (lead0, lead1, g, k)) are
    taken in place of the top-k, their gates the softmax of their own
    logits: a teacher-forced route, with which two computations of the
    same tokens can be held to one another across the top-k's jumps."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    *lead, g, _ = xt.shape
    logits = linear(xt.float(), router, backend)            # (..., g, E)
    if experts is None:
        vals, order = torch.sort(logits, dim=-1, descending=True,
                                 stable=True)
        idx, top = order[..., :k], vals[..., :k]
    else:
        idx, top = experts, logits.gather(-1, experts)
    gates = torch.softmax(top, dim=-1)
    # a slot's position: how many earlier (token, slot)s of its group chose
    # its expert.  A stable sort by expert keeps that order within each
    # expert's run, and a slot's rank in its run is its position.
    flat = idx.reshape(*lead, g * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    run = flat.gather(-1, order)
    rank = (torch.arange(g * k, device=flat.device)
            - torch.searchsorted(run, run))
    pos = torch.empty_like(flat).scatter_(-1, order, rank).reshape(
        *lead, g, k)
    return idx, gates, pos, pos < capacity(g, cfg)


def _experts(p: dict, xe: torch.Tensor, backend: str) -> torch.Tensor:
    """The experts' SwiGLU on their buffers xe (E, R, D) -> (E, R, D):
    kernel 3's batched form (``BatchedMatmulFn`` under autograd) or
    ``torch.bmm``."""
    if backend == "kernels":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (xe, p["we_gate"], p["we_up"],
                                          p["we_down"])):
            bmm = kmm.BatchedMatmulFn.apply
        else:
            bmm = kmm.matmul_batched
    else:
        bmm = torch.bmm
    h = F.silu(bmm(xe, p["we_gate"])) * bmm(xe, p["we_up"])
    return bmm(h, p["we_down"])


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
            backend: str = "kernels") -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), what ``repro.models.moe.moe_ffn``
    computes."""
    check_backend(backend)
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    xt = group_tokens(x, cfg)
    groups, g = xt.shape[0] * xt.shape[1], xt.shape[2]
    cap = capacity(g, cfg)
    idx, gates, pos, keep = (t.reshape(groups * g, k) for t in route(
        p["router"], xt, cfg, backend))
    rows = groups * cap                                      # R
    # each kept (token, slot)'s row of the flat (E * R) buffers; a dropped
    # one writes a spare row past them (no host sync on the mask)
    grp = torch.arange(groups * g, device=x.device) // g
    slot = torch.where(keep, idx * rows + grp[:, None] * cap + pos,
                       e * rows)
    xf = xt.reshape(groups * g, d)
    xe = x.new_zeros((e * rows + 1, d))
    xe[slot] = xf[:, None, :].expand(-1, k, -1)
    ye = _experts(p, xe[:-1].view(e, rows, d), backend).reshape(e * rows, d)
    w = (gates * keep).to(x.dtype).float()
    picked = ye[slot.clamp(max=e * rows - 1)].float()        # (T, k, D)
    out = torch.einsum("tk,tkd->td", w, picked).to(x.dtype)
    if "shared" in p:
        out = out + mlp(p["shared"], xf, backend)
    return out.reshape(b, s, d)


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                          e: int) -> torch.Tensor:
    """The reference's Switch-style load-balancing loss: ``e * sum(f * P)``
    with ``f`` each expert's share of the first-choice routes ``idx[...,
    0]`` and ``P`` its mean router probability, both averaged over the
    leading two axes of ``logits`` (G, g, E)."""
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = F.one_hot(idx[..., 0].long(), e).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return e * torch.sum(frac_tokens * frac_probs)


__all__ = ["moe_init", "moe_ffn", "route", "group_tokens", "capacity",
           "aux_load_balance_loss"]
