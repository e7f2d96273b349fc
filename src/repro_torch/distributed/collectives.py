"""The collectives of the data and model axes, over a ``torch.distributed``
group: an equal contiguous share of a leading axis, the all-gather of the
shares in rank order (with the backward that takes this rank's share of
the cotangent), a broadcast from rank 0, the fixed-order sum of every
rank's partial tensor (tensor parallelism's reductions), training's
adjoints of FSDP and tensor parallelism (:func:`fsdp_gather`, whose
backward is a fixed-order reduce-scatter; :func:`sum_partials` and
:func:`copy_in`, Megatron's pair), and the row
halos of an image split into bands over the model axis
(:func:`exchange_halos`, with its adjoint, and :func:`gather_bands`).

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


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape), concatenated on ``dim`` in
    rank order (not differentiable: :func:`fsdp_gather` is)."""
    if group_size(group) == 1:
        return t
    return all_gather_cat(t.movedim(dim, 0), group).movedim(0, dim)


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` in ONE fixed order: the tensors are
    all-gathered in rank order and reduced by one ``torch.sum(dim=0)``, so
    the result is the same on every rank and does not depend on timing
    (a ring all-reduce would regroup it)."""
    if group_size(group) == 1:
        return t
    return torch.sum(all_gather_cat(t[None], group), dim=0)


# ---------------------------------------------------------------------------
# Training's adjoints: FSDP over the data axis, Megatron over the model axis
# ---------------------------------------------------------------------------

def _wants_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.conf = (dim, group, t.shape[dim])
        return gather_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.conf
        r = group_rank(group)
        return sum_over(g, group).narrow(dim, r * n, n), None, None


def fsdp_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """FSDP's gather of a parameter block: :func:`gather_dim`, whose
    backward is the reduce-scatter over ``group``: every rank's cotangent
    of the whole (each from its own rows of the batch) all-gathered in
    rank order, summed by one ``torch.sum(dim=0)`` (:func:`sum_over`) and
    this rank's block sliced out, so its bits do not depend on timing."""
    if group_size(group) == 1:
        return t
    if _wants_grad(t):
        return _FsdpGather.apply(t, dim, group)
    return gather_dim(t, dim, group)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return sum_over(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_partials(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model axis of every rank's partial ``t`` (a
    row-split product's, the vocab-split embedding's): :func:`sum_over`
    forward; backward the identity, since what follows the sum runs the
    same on every rank, so each rank's cotangent of the sum is already
    the whole one."""
    if group_size(group) == 1:
        return t
    if _wants_grad(t):
        return _SumPartials.apply(t, group)
    return sum_over(t, group)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g, ctx.group), None


def copy_in(t: torch.Tensor, group) -> torch.Tensor:
    """The entry of a replicated tensor into a model-split region (the
    input of the column-split products, a replicated parameter used on
    this rank's heads): the identity forward; backward :func:`sum_over`,
    so the tensor's gradient is the sum of every rank's partial."""
    if group_size(group) == 1 or not _wants_grad(t):
        return t
    return _CopyIn.apply(t, group)


# ---------------------------------------------------------------------------
# Row bands and their halos (the model axis of an image)
# ---------------------------------------------------------------------------

#: what the halo exchanges of this process moved (:func:`exchange_halos`
#: and its adjoint add to it; :func:`reset_halo_stats` zeroes it):
#: ``exchanges``, ``rows`` (halo rows this rank received and used) and
#: ``wire_rows`` / ``bytes`` (what the gather of boundary slabs brought
#: this rank from the other ranks)
HALO_STATS = {"exchanges": 0, "rows": 0, "wire_rows": 0, "bytes": 0}


def reset_halo_stats() -> None:
    for k in HALO_STATS:
        HALO_STATS[k] = 0


def _count(rows: int, slab: torch.Tensor, ranks: int) -> None:
    HALO_STATS["exchanges"] += 1
    HALO_STATS["rows"] += rows
    HALO_STATS["wire_rows"] += (ranks - 1) * slab.shape[1]
    HALO_STATS["bytes"] += (ranks - 1) * slab.numel() * slab.element_size()


def halo_extent(r: int, hb: int, ranks: int, h_lo: int,
                h_hi: int) -> tuple[int, int]:
    """The halo rows band ``r`` of ``ranks`` bands of ``hb`` rows receives
    above and below it: ``h_lo`` and ``h_hi``, cut at the image's edges."""
    height = hb * ranks
    return (r * hb - max(0, r * hb - h_lo),
            min(height, (r + 1) * hb + h_hi) - (r + 1) * hb)


def _slabs(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's slab (N, rows, ...) gathered: (ranks, N, rows, ...)."""
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def _halo_forward(x, h_lo, h_hi, group):
    ranks, r, hb = group_size(group), group_rank(group), x.shape[1]
    n_lo, n_hi = halo_extent(r, hb, ranks, h_lo, h_hi)
    top, bot = min(h_hi, hb), min(h_lo, hb)
    # each rank's first rows (a band above needs them) and last rows (a
    # band below needs them): one gather of fixed-size boundary slabs
    slab = torch.cat([x[:, :top], x[:, hb - bot:]], dim=1)
    got = _slabs(slab, group)
    parts = []
    if n_lo:
        above = torch.cat([got[q][:, top:] for q in range(r)], dim=1)
        parts.append(above[:, above.shape[1] - n_lo:])
    parts.append(x)
    if n_hi:
        below = torch.cat([got[q][:, :top] for q in range(r + 1, ranks)],
                          dim=1)
        parts.append(below[:, :n_hi])
    _count(n_lo + n_hi, slab, ranks)
    return torch.cat(parts, dim=1) if len(parts) > 1 else x, n_lo, n_hi


def _halo_adjoint(g, hb, h_lo, h_hi, group):
    """The gradient of this rank's band: its own rows, then the band
    above's halo gradients landing on them, then the band below's, added
    in that order (nearest band first), so the sum's bits are fixed."""
    ranks, r = group_size(group), group_rank(group)
    n_lo, n_hi = halo_extent(r, hb, ranks, h_lo, h_hi)
    own = g[:, n_lo:n_lo + hb].clone()
    # this rank's halo gradients, each aligned to the full halo: slab row
    # i of the top part is image row r*hb - h_lo + i
    lo = g.new_zeros((g.shape[0], h_lo, *g.shape[2:]))
    hi = g.new_zeros((g.shape[0], h_hi, *g.shape[2:]))
    if n_lo:
        lo[:, h_lo - n_lo:] = g[:, :n_lo]
    if n_hi:
        hi[:, :n_hi] = g[:, n_lo + hb:]
    slab = torch.cat([lo, hi], dim=1)
    got = _slabs(slab, group)
    r0, r1 = r * hb, (r + 1) * hb
    for q in range(r - 1, -1, -1):          # bands above: their lower halo
        a, b = max((q + 1) * hb, r0), min((q + 1) * hb + h_hi, r1)
        if a < b:
            own[:, a - r0:b - r0] += got[q][:, h_lo + a - (q + 1) * hb:
                                            h_lo + b - (q + 1) * hb]
    for q in range(r + 1, ranks):           # bands below: their upper halo
        a, b = max(q * hb - h_lo, r0), min(q * hb, r1)
        if a < b:
            own[:, a - r0:b - r0] += got[q][:, a - (q * hb - h_lo):
                                            b - (q * hb - h_lo)]
    _count(n_lo + n_hi, slab, ranks)
    return own


class _Halos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h_lo, h_hi, group):
        ctx.conf = (x.shape[1], h_lo, h_hi, group)
        return _halo_forward(x, h_lo, h_hi, group)[0]

    @staticmethod
    def backward(ctx, g):
        return _halo_adjoint(g, *ctx.conf), None, None, None


def exchange_halos(x: torch.Tensor, h_lo: int, h_hi: int, group):
    """This rank's band ``x`` (N, hb, ...) of an image whose rows split in
    equal bands over ``group`` (rank ``r`` owns rows ``[r*hb, (r+1)*hb)``),
    with the ``h_lo`` image rows above it and the ``h_hi`` below it
    prepended and appended; at the image's top and bottom edges there is
    nothing to receive.  Returns ``(rows, n_lo, n_hi)``: the extended band
    and the halo rows it received above and below.

    Only boundary rows move: each rank puts its first ``min(h_hi, hb)``
    and last ``min(h_lo, hb)`` rows in one slab, and ONE ``all_gather`` of
    the fixed-size slabs gives every rank the rows of the bands it
    borders; a halo longer than a band takes the rows of each band it
    spans.  The gather is the transport (not ``isend``/``irecv``): gloo,
    the backend of ranks sharing one card, takes CUDA tensors in its
    collectives but sends and receives CPU tensors only, and the gather is
    the collective the data axis already runs on the card.

    Under autograd the adjoint sends each halo's gradient rows back to
    their owner (one gather of slabs again), who adds them to its own
    rows in a fixed order: its own rows, the band above's part, the band
    below's.  :data:`HALO_STATS` counts what each exchange moved.
    """
    if group_size(group) == 1 or (h_lo == 0 and h_hi == 0):
        return x, 0, 0
    r, hb = group_rank(group), x.shape[1]
    n_lo, n_hi = halo_extent(r, hb, group_size(group), h_lo, h_hi)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Halos.apply(x, h_lo, h_hi, group), n_lo, n_hi
    return _halo_forward(x, h_lo, h_hi, group)


def gather_bands(t: torch.Tensor, counts: list[int], group,
                 dim: int = 1) -> torch.Tensor:
    """Every rank's band of rows on ``dim`` (rank ``q``'s ``counts[q]``
    rows; this rank's ``t`` holds its own), concatenated in rank order.
    Unequal bands travel padded to the longest.  Differentiable: the
    gradient of this rank's band is its rows of the (replicated)
    cotangent."""
    if group_size(group) == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherBands.apply(t, tuple(counts), group, dim)
    return _gather_bands(t, counts, group, dim)


def _gather_bands(t, counts, group, dim):
    most = max(counts)
    t = t.movedim(dim, 0)
    if t.shape[0] < most:
        t = torch.cat([t, t.new_zeros((most - t.shape[0], *t.shape[1:]))])
    parts = [torch.empty_like(t) for _ in counts]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).movedim(0, dim)


class _GatherBands(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, counts, group, dim):
        ctx.conf = (counts, group, dim)
        return _gather_bands(t, counts, group, dim)

    @staticmethod
    def backward(ctx, g):
        counts, group, dim = ctx.conf
        r = group_rank(group)
        start = sum(counts[:r])
        return g.narrow(dim, start, counts[r]), None, None, None


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """A copy of global rank ``src``'s ``t`` on every rank of ``group``."""
    out = t.detach().clone().contiguous()
    if group_size(group) > 1:
        dist.broadcast(out, src, group=group)
    return out


__all__ = ["group_size", "group_rank", "share", "all_gather_cat",
           "gather_rows", "split_rows", "pad_rows", "map_rows",
           "gather_dim", "sum_over", "fsdp_gather", "sum_partials",
           "copy_in", "HALO_STATS", "reset_halo_stats",
           "halo_extent", "exchange_halos", "gather_bands",
           "broadcast"]
