"""The few collectives the data axis needs, over a ``torch.distributed``
group: an equal contiguous share of a leading axis, the all-gather of the
shares in rank order (with the backward that takes this rank's share of
the cotangent), and a broadcast from rank 0.

Every rank of a group computes the same program (SPMD), so a cotangent
that reaches a gathered tensor is the same on every rank, and the share
of it that belongs to this rank's slice is the slice's whole cotangent.
The gloo backend carries CUDA tensors for these calls as well as CPU
ones, so N ranks on one card gather on the card.  A ``group`` of ``None``
is the whole world.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def share(n: int, group) -> slice:
    """This rank's contiguous equal share of ``n`` rows."""
    size = group_size(group)
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over {size} ranks")
    per = n // size
    r = group_rank(group)
    return slice(r * per, (r + 1) * per)


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape), concatenated on dim 0 in
    rank order."""
    if group_size(group) == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.rows = group, t.shape[0]
        return all_gather_cat(t, group)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_gather_cat`, differentiable: the gradient of this rank's
    ``t`` is its rows of the (replicated) cotangent."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherRows.apply(t, group)
    return all_gather_cat(t, group)


def split_rows(t: torch.Tensor | None, group):
    """This rank's share of ``t``'s rows (``None`` stays ``None``)."""
    return None if t is None else t[share(t.shape[0], group)]


def pad_rows(t: torch.Tensor | None, multiple: int):
    """``t`` with zero rows appended up to a multiple of ``multiple``
    (``None`` stays ``None``)."""
    pad = 0 if t is None else (-t.shape[0]) % multiple
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def map_rows(fn, *tensors, group):
    """``fn`` on this rank's share of each tensor's rows (``None`` passes
    through), the results gathered in rank order; ``fn(*tensors)`` itself
    when ``group`` is ``None``.  Rows that do not split evenly are
    zero-padded to a multiple of the group's size, and the padded rows'
    results cropped.  ``fn``'s kernel launches of the share's rows take
    the plan of the same launch over all the rows
    (:func:`repro_torch.kernels.autotune.whole_batch_plans`), so each row
    gets the bits ``fn(*tensors)`` gives it."""
    from repro_torch.kernels.autotune import whole_batch_plans

    if group is None:
        return fn(*tensors)
    n, size = tensors[0].shape[0], group_size(group)
    shares = [split_rows(pad_rows(t, size), group) for t in tensors]
    with whole_batch_plans(shares[0].shape[0], n):
        out = gather_rows(fn(*shares), group)
    return out[:n] if out.shape[0] != n else out


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """A copy of global rank ``src``'s ``t`` on every rank of ``group``."""
    out = t.detach().clone().contiguous()
    if group_size(group) > 1:
        dist.broadcast(out, src, group=group)
    return out


__all__ = ["group_size", "group_rank", "share", "all_gather_cat",
           "gather_rows", "split_rows", "pad_rows", "map_rows",
           "broadcast"]
