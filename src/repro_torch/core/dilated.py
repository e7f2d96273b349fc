"""Input decomposition for dilated convolutions (paper §II-B), in PyTorch.

The port of ``repro.core.dilated`` (plain torch ops, so autograd
differentiates it natively).  A dilated convolution with step ``d`` reads, for output ``(y, x)``, only inputs congruent to
``(y, x) mod d``: the input splits into ``d**2`` phase blocks, each
convolved densely with the compact ``k x k`` kernel, and the outputs
interleave back.  Three forms, all NHWC / HWIO:

* :func:`dilated_conv2d_reference` — ``F.conv2d`` with ``dilation=``.
* :func:`dilated_conv2d_naive` — the zero-inserted ``d*(k-1)+1`` kernel run
  densely (the paper's baseline, every zero MAC issued).
* :func:`dilated_conv2d_decomposed` — phase split -> dense conv -> stitch,
  ``ragged`` (one conv per phase block, as the paper schedules it) or
  ``batched`` (phases stacked on the batch axis, one dense conv).

A strided dilated conv uses the output-class schedule
(:func:`stride_class_schedule`, DESIGN.md §2c).

The phase-batched form takes ``group=`` (a ``torch.distributed`` group,
the data axis of DESIGN.md §13; the reference's ``phase_sharding``): the
folded ``(d*d*N, H/d, W/d, C)`` batch (or the stacked class windows) is
independent block by block, so rank r convolves its contiguous share of
it, and the shares are gathered in fold order before the stitch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import nhwc
from repro_torch.distributed.collectives import map_rows


def same_pad(k: int) -> int:
    """Padding for SAME output with an odd kernel of size ``k``."""
    if k % 2 != 1:
        raise ValueError(f"SAME padding defined for odd kernels only, "
                         f"got k={k}")
    return (k - 1) // 2


def effective_kernel_size(k: int, dilation: int) -> int:
    """Zero-inserted footprint ``d*(k-1)+1``."""
    return dilation * (k - 1) + 1


def strided_out_size(h: int, k: int, dilation: int, stride: int) -> int:
    """Output extent of a SAME-padded strided dilated conv: ``ceil(h/s)``."""
    ke = effective_kernel_size(k, dilation)
    return (h + 2 * same_pad(ke) - ke) // stride + 1


def dilated_conv2d_reference(x: torch.Tensor, w: torch.Tensor, dilation: int,
                             stride: int = 1) -> torch.Tensor:
    """Plain oracle: SAME dilated convolution via ``F.conv2d(dilation=)``."""
    pad = same_pad(effective_kernel_size(w.shape[0], dilation))
    return nhwc.conv(x, w, stride, ((pad, pad), (pad, pad)), dilation)


def zero_insert_weight(w: torch.Tensor, dilation: int) -> torch.Tensor:
    """Explicitly materialise the enlarged zero-inserted kernel (Fig. 2)."""
    k, _, cin, cout = w.shape
    ke = effective_kernel_size(k, dilation)
    we = w.new_zeros((ke, ke, cin, cout))
    we[::dilation, ::dilation] = w
    return we


def dilated_conv2d_naive(x: torch.Tensor, w: torch.Tensor, dilation: int,
                         stride: int = 1) -> torch.Tensor:
    """Dense execution of the zero-inserted kernel — the paper's baseline."""
    we = zero_insert_weight(w, dilation)
    pad = same_pad(we.shape[0])
    return nhwc.conv(x, we, stride, ((pad, pad), (pad, pad)))


def phase_split(x: torch.Tensor, d: int) -> list[list[torch.Tensor]]:
    """Split NHWC input into ``d x d`` ragged phase blocks (paper Fig. 4)."""
    return [[x[:, i::d, j::d, :] for j in range(d)] for i in range(d)]


def phase_stitch(blocks: list[list[torch.Tensor]],
                 out_shape: tuple[int, ...]) -> torch.Tensor:
    """Interleave ``d x d`` phase outputs back into a dense NHWC tensor."""
    d = len(blocks)
    out = blocks[0][0].new_zeros(out_shape)
    for i in range(d):
        for j in range(d):
            out[:, i::d, j::d, :] = blocks[i][j]
    return out


def _phase_to_batch(x: torch.Tensor, d: int) -> tuple[torch.Tensor, int, int]:
    """Pad H, W up to multiples of ``d`` and stack phases on the batch axis.

    Returns (stacked ``(d*d*N, H//d, W//d, C)``, padded H, padded W).  The
    zero pad is exact: the SAME conv pads with zeros too, and the excess
    rows are cropped at the stitch.
    """
    n, h, w_, c = x.shape
    hp, wp = math.ceil(h / d) * d, math.ceil(w_ / d) * d
    x = F.pad(x, (0, 0, 0, wp - w_, 0, hp - h))
    x = x.reshape(n, hp // d, d, wp // d, d, c).permute(2, 4, 0, 1, 3, 5)
    return x.reshape(d * d * n, hp // d, wp // d, c), hp, wp


def _batch_to_phase(y: torch.Tensor, d: int, n: int, h: int,
                    w_: int) -> torch.Tensor:
    """Inverse of :func:`_phase_to_batch` (crops the pad-up rows/cols)."""
    _, hb, wb, c = y.shape
    y = y.reshape(d, d, n, hb, wb, c).permute(2, 3, 0, 4, 1, 5)
    y = y.reshape(n, hb * d, wb * d, c)
    return y[:, :h, :w_, :]


def stride_class_schedule(d: int, s: int, p: int, out_len: int
                          ) -> tuple[int, int, list[tuple[int, int, int]]]:
    """Output-class schedule for one spatial dim of a strided dilated conv.

    Output ``y`` reads inputs congruent to ``r(y) = (s*y - p) mod d``, which
    is periodic in ``y`` with period ``q = d // gcd(s, d)``.  Class ``j``
    (outputs ``j + q*u``) reads phase block ``r_j`` at block positions
    ``m0_j + s_blk*u + t`` with ``s_blk = s // gcd(s, d)``.  Returns
    ``(q, s_blk, [(r_j, m0_j, n_out_j)])``; each class is a dense VALID
    correlation at stride ``s_blk``, so MACs issued equal nonzero MACs.
    """
    g = math.gcd(s, d)
    q, s_blk = d // g, s // g
    sched = []
    for j in range(q):
        r = (s * j - p) % d
        m0 = (s * j - p - r) // d
        n_out = len(range(j, out_len, q))
        sched.append((r, m0, n_out))
    return q, s_blk, sched


def _class_window(x: torch.Tensor, d: int, row, col, rows_span: int,
                  cols_span: int) -> torch.Tensor:
    """One (row-class, col-class) phase window, padded to a common span.

    Aligned so that the class's first output reads rows/cols ``[0, k)``;
    the zero pads mirror the oracle's SAME zero pads.
    """
    (ri, m0i, _), (rj, m0j, _) = row, col
    blk = x[:, ri::d, rj::d, :]
    pt, pl_ = max(0, -m0i), max(0, -m0j)
    st, sl = m0i + pt, m0j + pl_
    pb = max(0, st + rows_span - (blk.shape[1] + pt))
    pr = max(0, sl + cols_span - (blk.shape[2] + pl_))
    blk = F.pad(blk, (0, 0, pl_, pr, pt, pb))
    return blk[:, st: st + rows_span, sl: sl + cols_span, :]


def _dilated_strided_decomposed(x: torch.Tensor, w: torch.Tensor, d: int,
                                s: int, strategy: str, conv_fn=None,
                                group=None) -> torch.Tensor:
    """Strided-dilated decomposition: class split -> strided conv -> stitch.

    ``conv_fn(xb, w, sb)`` runs a VALID dense conv at stride ``sb``; it
    defaults to ``F.conv2d`` and the kernel path passes its own, so both
    share one schedule and stitch.  ``group`` splits the batched class
    windows over its ranks.
    """
    if group is not None and strategy != "batched":
        raise ValueError("group= splits the phase-batched layout only")
    if conv_fn is None:
        def conv_fn(xb, wt, sb):
            return nhwc.conv(xb, wt, sb)

    k = w.shape[0]
    p = same_pad(effective_kernel_size(k, d))
    n, h, w_, _ = x.shape
    cout = w.shape[-1]
    oh = strided_out_size(h, k, d, s)
    ow = strided_out_size(w_, k, d, s)
    q, sb, rsched = stride_class_schedule(d, s, p, oh)
    _, _, csched = stride_class_schedule(d, s, p, ow)
    ny_max = max(e[2] for e in rsched)
    nx_max = max(e[2] for e in csched)
    rows_span = sb * (ny_max - 1) + k
    cols_span = sb * (nx_max - 1) + k
    windows = [_class_window(x, d, row, col, rows_span, cols_span)
               for row in rsched for col in csched]
    if strategy == "batched":
        yb = map_rows(lambda xb: conv_fn(xb, w, sb),
                      torch.cat(windows, dim=0), group=group)
        planes = [yb[i * n: (i + 1) * n] for i in range(q * q)]
    else:  # ragged: one conv per class (paper-faithful schedule)
        planes = [conv_fn(win, w, sb) for win in windows]
    out = x.new_zeros((n, oh, ow, cout))
    i = 0
    for ji, (_, _, nyi) in enumerate(rsched):
        for jj, (_, _, nxj) in enumerate(csched):
            out[:, ji::q, jj::q, :] = planes[i][:, :nyi, :nxj, :]
            i += 1
    return out


def dilated_conv2d_decomposed(x: torch.Tensor, w: torch.Tensor, dilation: int,
                              strategy: str = "batched",
                              stride: int = 1, group=None) -> torch.Tensor:
    """The paper's method: phase decomposition -> dense conv -> stitch.

    ``strategy='ragged'`` convolves the ``d**2`` ragged blocks separately;
    ``'batched'`` stacks them on the batch axis into one dense conv.  Both
    are exact.  ``stride > 1`` uses the output-class schedule.  ``group``
    (batched only) splits the folded batch over its ranks.
    """
    d = dilation
    if strategy not in ("ragged", "batched"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if group is not None and (strategy != "batched" or d == 1):
        raise ValueError("group= splits the phase-batched layout only")
    if d == 1:
        return dilated_conv2d_reference(x, w, 1, stride)
    if stride != 1:
        return _dilated_strided_decomposed(x, w, d, stride, strategy,
                                           group=group)
    pad = same_pad(w.shape[0])
    pads = ((pad, pad), (pad, pad))
    n, h, w_, _ = x.shape
    if strategy == "ragged":
        outs = [[nhwc.conv(b, w, 1, pads) for b in row]
                for row in phase_split(x, d)]
        return phase_stitch(outs, (n, h, w_, w.shape[-1]))
    xb, _, _ = _phase_to_batch(x, d)
    yb = map_rows(lambda xs: nhwc.conv(xs, w, 1, pads), xb, group=group)
    return _batch_to_phase(yb, d, n, h, w_)


def band_inputs(r0: int, r1: int, h: int, k: int, d: int
                ) -> tuple[int, int]:
    """The image rows ``[i0, i1)`` that output rows ``[r0, r1)`` of a SAME
    stride-1 dilated conv read: ``d * (k - 1) / 2`` rows on each side,
    cut to the image's ``h`` rows."""
    halo = d * same_pad(k)
    return max(0, r0 - halo), min(h, r1 + halo)


def dilated_band(x: torch.Tensor, w: torch.Tensor, d: int, r0: int,
                 r1: int, i0: int, i1: int, conv_fn) -> torch.Tensor:
    """Output rows ``[r0, r1)`` of a SAME stride-1 dilated conv from the
    input rows ``[i0, i1)`` of :func:`band_inputs` (``x``), by the paper's
    decomposition inside the band: ``r0``, ``i0`` and ``i1 - i0`` are
    multiples of ``d``, so the band folds into its own ``d*d`` phase
    blocks (the whole image's phase of every row), and ONE dense conv runs
    them all (``conv_fn(xb, pads)``, ``pads`` the phase-space pads: the
    SAME pad only where the band meets the image's edge; rows beyond it
    are real rows, read from the halo).  Returns (N, r1 - r0, W, Cout)."""
    p = same_pad(w.shape[0])
    n, _, w_in, _ = x.shape
    xb, _, _ = _phase_to_batch(x, d)
    pads = ((p - (r0 - i0) // d, p - (i1 - r1) // d), (p, p))
    return _batch_to_phase(conv_fn(xb, pads), d, n, r1 - r0, w_in)


__all__ = ["band_inputs", "dilated_band", "same_pad",
           "effective_kernel_size", "strided_out_size",
           "dilated_conv2d_reference", "zero_insert_weight",
           "dilated_conv2d_naive", "phase_split", "phase_stitch",
           "stride_class_schedule", "dilated_conv2d_decomposed"]
