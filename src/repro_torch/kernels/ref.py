"""Plain PyTorch oracles for the port's kernels (used by tests only)."""

from __future__ import annotations

import torch

from repro_torch.core import nhwc
from repro_torch.kernels.conv2d import resolve_pads
from repro_torch.kernels.matmul import matmul_plain


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               padding: str | int = "SAME") -> torch.Tensor:
    """Dense 2-D convolution oracle. NHWC x HWIO -> NHWC; ``padding`` is
    "SAME", "VALID", an int or per-dim pairs, as the kernel wrapper takes."""
    return nhwc.conv(x, w, stride, resolve_pads(padding, w.shape[0],
                                                w.shape[1]))


def dilated_conv2d_ref(x: torch.Tensor, w: torch.Tensor,
                       dilation: int) -> torch.Tensor:
    """SAME dilated convolution oracle (``F.conv2d(dilation=)``)."""
    pad = (dilation * (w.shape[0] - 1)) // 2
    return nhwc.conv(x, w, 1, ((pad, pad), (pad, pad)), dilation)


def transposed_conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 2,
                          padding: int = 1,
                          output_padding: int = 1) -> torch.Tensor:
    """Transposed convolution oracle (``F.conv_transpose2d``)."""
    return nhwc.conv_transpose(x, w, stride, padding,
                               padding + output_padding)


#: matmul oracle: fp32 product, cast to ``a.dtype`` (the kernel's plain
#: version computes exactly that)
matmul_ref = matmul_plain


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """(B, H, S, D) attention oracle with fp32 softmax.

    As the reference's ``ref.attention_ref``: the causal mask is
    bottom-right (``tril(k=Sk-Sq)``) with ``-inf``, so when Sq > Sk the
    first Sq - Sk rows see no key and come out NaN.  The kernel
    (:mod:`repro_torch.kernels.flash_attention`) masks top-left instead;
    the two agree only when Sq == Sk.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
