"""Whisper audio frontend on the port's conv engine (arXiv 2212.04356 §2).

The port of ``repro.models.whisper``: whisper-small's two temporal convs
over a log-mel spectrogram, expressed as ``H = 1`` 2-D convs through
:func:`repro_torch.core.decompose.conv2d`::

    mel (B, T, n_mels)
      -> conv (1, 3) s1 SAME -> gelu        (B, T,        d_model)
      -> conv (1, 3) s2 SAME -> gelu        (B, ceil(T/2), d_model)

SAME pads a 3-wide kernel (1, 1) at either stride, the padding of
Whisper's ``Conv1d(..., padding=1)``.  With ``backend="kernels"`` on a CUDA
device a forward launches the dense conv kernel twice; the time axis is
the kernel's flattened pixel axis.  The GELU is the tanh approximation,
``jax.nn.gelu``'s default, which the reference uses.  fp32 only, as in the
reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.decompose import conv2d
from repro_torch.models.common import to_device

#: whisper-small frontend geometry (mel bins, frames, d_model)
N_MELS, N_FRAMES, D_MODEL = 80, 3000, 768


def init_frontend_params(generator: torch.Generator, n_mels: int = N_MELS,
                         d_model: int = D_MODEL, device=None) -> dict:
    """Fan-in-normal weights of the two temporal convs (no biases), drawn
    on the CPU and moved to ``device`` (``None`` -> CUDA)."""
    g = generator
    return to_device({
        "conv1": torch.randn((1, 3, n_mels, d_model), generator=g)
        * (2.0 / (3 * n_mels)) ** 0.5,
        "conv2": torch.randn((1, 3, d_model, d_model), generator=g)
        * (2.0 / (3 * d_model)) ** 0.5}, device)


def frontend(params: dict, mel: torch.Tensor,
             backend: str = "kernels") -> torch.Tensor:
    """mel (B, T, n_mels) -> frame embeddings (B, ceil(T/2), d_model)."""
    x = mel[:, None]                                  # (B, 1, T, n_mels)
    h = F.gelu(conv2d(x, params["conv1"], backend=backend),
               approximate="tanh")
    h = F.gelu(conv2d(h, params["conv2"], stride=2, backend=backend),
               approximate="tanh")
    return h[:, 0]


__all__ = ["N_MELS", "N_FRAMES", "D_MODEL", "init_frontend_params",
           "frontend"]
