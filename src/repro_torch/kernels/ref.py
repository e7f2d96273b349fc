"""Plain PyTorch oracles for the port's conv kernels (used by tests only)."""

from __future__ import annotations

import torch

from repro_torch.core import nhwc
from repro_torch.kernels.conv2d import resolve_pads


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
