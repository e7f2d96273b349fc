"""Weight decomposition for transposed convolutions (paper §II-C), in PyTorch.

The port of ``repro.core.transposed`` (plain torch ops, so autograd
differentiates it natively).  A stride-``s`` transposed conv zero-inserts
``s - 1`` zeros between input elements and runs a dense ``k x k``
correlation; for output ``(y, x)`` only the taps with
``(t - p_lo + r) % s == 0`` (``r`` the output parity) land on real input, so
the kernel splits exactly into ``s**2`` parity sub-kernels that correlate
directly with the un-upsampled input.

Conventions (NHWC / HWIO, cross-correlation, no kernel flip)::

    U = zero_insert(x, s)                  # (H-1)*s + 1 per spatial dim
    O[y, x] = sum_{ky,kx} W[ky,kx] * U_pad[y + ky, x + kx]
    with U_pad = pad(U, (p_lo, p_hi))      # p_hi = p_lo + output_padding
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import nhwc


def out_size(h: int, s: int, k: int, p_lo: int, p_hi: int) -> int:
    return (h - 1) * s + p_lo + p_hi - k + 2


def zero_insert_input(x: torch.Tensor, s: int) -> torch.Tensor:
    """Explicitly materialise the zero-inserted input (Fig. 5, naive path)."""
    if s == 1:
        return x
    n, h, w_, c = x.shape
    u = x.new_zeros((n, (h - 1) * s + 1, (w_ - 1) * s + 1, c))
    u[:, ::s, ::s, :] = x
    return u


def transposed_conv2d_reference(x: torch.Tensor, w: torch.Tensor, stride: int,
                                padding: int,
                                output_padding: int = 0) -> torch.Tensor:
    """Plain oracle via ``F.conv_transpose2d`` (zero-insertion fused)."""
    return nhwc.conv_transpose(x, w, stride, padding,
                               padding + output_padding)


def transposed_conv2d_naive(x: torch.Tensor, w: torch.Tensor, stride: int,
                            padding: int,
                            output_padding: int = 0) -> torch.Tensor:
    """Dense execution over the explicitly zero-inserted input (naive path)."""
    u = zero_insert_input(x, stride)
    p_lo, p_hi = padding, padding + output_padding
    return nhwc.conv(u, w, 1, ((p_lo, p_hi), (p_lo, p_hi)))


def parity_taps(k: int, s: int, p_lo: int, r: int) -> list[int]:
    """Kernel taps (one spatial dim) that hit real input for parity r."""
    return [t for t in range(k) if (t - p_lo + r) % s == 0]


def decompose_weight(w: torch.Tensor, s: int, p_lo: int):
    """Split an HWIO kernel into the ``s**2`` parity sub-kernels (Fig. 6).

    Returns ``{(ry, rx): (sub_kernel, row_offsets, col_offsets)}``, the
    offsets being the input indices (relative to the output block index)
    each tap reads: ``(r + t - p_lo) // s``.  Parities with no tap (possible
    when ``k < s``) map to ``None``.
    """
    k = w.shape[0]
    out = {}
    for ry in range(s):
        for rx in range(s):
            tr = parity_taps(k, s, p_lo, ry)
            tc = parity_taps(k, s, p_lo, rx)
            if not tr or not tc:
                out[(ry, rx)] = None
                continue
            sub = w[tr][:, tc]
            ro = [(ry + t - p_lo) // s for t in tr]
            co = [(rx + t - p_lo) // s for t in tc]
            out[(ry, rx)] = (sub, ro, co)
    return out


def transposed_conv2d_decomposed(x: torch.Tensor, w: torch.Tensor, stride: int,
                                 padding: int,
                                 output_padding: int = 0) -> torch.Tensor:
    """The paper's method: per-parity sub-kernel correlation, no zero-insert.

    Each parity plane is a dense VALID correlation of the (padded) input
    with its sub-kernel; the ``s**2`` planes interleave into the output, and
    planes with no live tap stay zero.  MACs issued == nonzero MACs.
    """
    s, k = stride, w.shape[0]
    if s == 1:
        return transposed_conv2d_reference(x, w, 1, padding, output_padding)
    n, h, w_in, _ = x.shape
    p_lo = padding
    oh = out_size(h, s, k, p_lo, p_lo + output_padding)
    ow = out_size(w_in, s, k, p_lo, p_lo + output_padding)
    out = x.new_zeros((n, oh, ow, w.shape[-1]))
    for (ry, rx), entry in decompose_weight(w, s, p_lo).items():
        nyr = len(range(ry, oh, s))
        nxr = len(range(rx, ow, s))
        if nyr == 0 or nxr == 0 or entry is None:
            continue
        sub, ro, co = entry
        # plane index b reads input rows b + ro[0] .. b + ro[-1]: pad the
        # top/left by -ro[0] (crop when positive) and the bottom/right by
        # whatever the last plane index needs
        pad_top, pad_left = -ro[0], -co[0]
        need_bot = (nyr - 1) + ro[-1] - (h - 1)
        need_rgt = (nxr - 1) + co[-1] - (w_in - 1)
        xp = F.pad(x, (0, 0, max(pad_left, 0), max(need_rgt, 0),
                       max(pad_top, 0), max(need_bot, 0)))
        xp = xp[:, max(-pad_top, 0):, max(-pad_left, 0):, :]
        plane = nhwc.conv(xp, sub)
        out[:, ry::s, rx::s, :] = plane[:, :nyr, :nxr, :]
    return out


def band_inputs(o0: int, o1: int, h: int, k: int, s: int, p_lo: int,
                p_hi: int) -> tuple[int, int]:
    """The input rows ``[i0, i1)`` that output rows ``[o0, o1)`` of a
    stride-``s`` transposed conv over ``h`` input rows read: output ``y =
    s*b + r`` reads input ``b + off`` for the offsets ``off = (r + t -
    p_lo) // s`` of parity ``r``'s live taps, cut to the image.  ``i1``
    reaches far enough that the same transposed conv (same ``p_lo``,
    ``p_hi``, so the same parity schedule) over rows ``[i0, i1)`` yields
    output rows up to ``o1``: its output row ``j`` is row ``j + s*i0`` of
    the whole image's."""
    offs = [(r + t - p_lo) // s for r in range(s)
            for t in parity_taps(k, s, p_lo, r)]
    i0 = max(0, min(o0 // s + min(offs), o0 // s))
    i1 = min(h, (o1 - 1) // s + max(offs) + 1)
    short = o1 - s * i0 - out_size(i1 - i0, s, k, p_lo, p_hi)
    if short > 0:
        i1 = min(h, i1 + -(-short // s))
    return i0, i1


__all__ = ["band_inputs", "out_size", "zero_insert_input",
           "transposed_conv2d_reference",
           "transposed_conv2d_naive", "parity_taps", "decompose_weight",
           "transposed_conv2d_decomposed"]
