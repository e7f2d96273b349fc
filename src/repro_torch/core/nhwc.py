"""NHWC x HWIO convolutions on top of ``torch.nn.functional``.

The JAX package calls ``lax.conv_general_dilated`` with
``("NHWC", "HWIO", "NHWC")``; torch's convolutions take NCHW x OIHW.  These
helpers keep the port's public layout (NHWC activations, HWIO weights) and
do the permutes at the call, so every plain path of the port compares
directly with the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Pads = tuple[tuple[int, int], tuple[int, int]]


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         pads: Pads = ((0, 0), (0, 0)), dilation: int = 1) -> torch.Tensor:
    """Cross-correlation, NHWC x HWIO -> NHWC, with per-dim (low, high) pads.

    Negative pads crop and an empty window gives an empty output, as with
    ``lax.conv_general_dilated`` (a ragged phase block is empty when the
    dilation exceeds the input extent).
    """
    (pt, pb), (pl, pr) = pads
    n, h, w_in, _ = x.shape
    kh, kw, _, cout = w.shape
    oh = (h + pt + pb - dilation * (kh - 1) - 1) // stride + 1
    ow = (w_in + pl + pr - dilation * (kw - 1) - 1) // stride + 1
    if oh <= 0 or ow <= 0:
        return x.new_zeros((n, max(oh, 0), max(ow, 0), cout))
    xc = x.permute(0, 3, 1, 2)
    if any((pt, pb, pl, pr)):
        xc = F.pad(xc, (pl, pr, pt, pb))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, dilation=dilation)
    return y.permute(0, 2, 3, 1)


def conv_transpose(x: torch.Tensor, w: torch.Tensor, stride: int,
                   p_lo: int, p_hi: int) -> torch.Tensor:
    """lhs-dilated correlation (the reference's transposed-conv convention).

    The input is zero-inserted by ``stride``, padded ``(p_lo, p_hi)`` and
    correlated with ``w`` un-flipped.  That is torch's ``conv_transpose2d``
    with the spatially flipped kernel at padding ``k - 1 - p_lo`` and output
    padding ``p_hi - p_lo``, which torch takes for ``0 <= p_lo <= k - 1`` and
    ``0 <= p_hi - p_lo < stride``.  Stride 1 is a plain padded correlation.
    """
    if stride == 1:
        return conv(x, w, 1, ((p_lo, p_hi), (p_lo, p_hi)))
    k = w.shape[0]
    op = p_hi - p_lo
    if not (0 <= p_lo <= k - 1 and 0 <= op < stride):
        raise ValueError(f"conv_transpose2d cannot express p_lo={p_lo}, "
                         f"p_hi={p_hi} for k={k}, stride={stride}")
    wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1)       # (Cin, Cout, k, k)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=stride,
                           padding=k - 1 - p_lo, output_padding=op)
    return y.permute(0, 2, 3, 1)
