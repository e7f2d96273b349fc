"""DCGAN generator in PyTorch, built on the paper's weight decomposition.

The port of ``repro.models.dcgan`` (Radford et al. 2016): a latent
projection to ``4 x 4 x C`` followed by a chain of ``k=4, s=2, p_lo=2``
transposed convs (PyTorch's exact-2x ``ConvTranspose2d(4, stride=2,
padding=1)``) that double the resolution and halve the channels, closed by
a tanh head.  Every stage runs through the weight decomposition: with
``backend="kernels"`` on a CUDA device the 64x64 generator launches the
transposed-conv kernel 4 times a forward and the 128x128 one 5 times.

BN/ReLU after each stage is a fused epilogue: BN folded to scale/shift,
ReLU as PReLU with a fixed fp32 zero slope, made in the forward and not a
parameter (so ``named_parameters()`` is the reference's tree: ``proj``,
``proj_bn.g``, ``up1``, ``bn1.g``, ..., ``head``).  The latent projection
is a ``torch.matmul``, as the reference computes it outside its kernels,
and its BN/ReLU runs as the epilogue's plain version; the tanh is applied
after the head's kernel.  ``compute_dtype="bf16"`` runs the latents, the
projection and every stage in bf16 off fp32 master parameters
(DESIGN.md §12); the image comes back in bf16.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.decompose import conv2d
from repro_torch.kernels.epilogue import EpilogueSpec, apply_reference
from repro_torch.kernels.util import canon_dtype
from repro_torch.models.common import SeededModule, bn_init, fold_bn, tconv_init

_EP_BN_ACT = EpilogueSpec(bn=True, prelu=True)


def n_stages(size: int) -> int:
    """Number of stride-2 stages (the head included) from 4x4 to ``size``."""
    if size not in (64, 128):
        raise ValueError(f"DCGAN generator sizes are 64/128, got {size}")
    return int(math.log2(size // 4))


class DCGAN(SeededModule):
    """The generator for ``size x size`` images (64 or 128).

    Args:
      size: 64 (512 channels at 4x4 with ``ngf=64``) or 128 (1024).
      nz: latent width.  ngf: width multiplier (the canonical 64).
      out_ch: image channels.
      device: ``None`` -> CUDA (raises without a card); ``"cpu"`` runs the
        kernels' plain versions; ``"meta"`` builds a weightless shell for
        ``torch.func.functional_call``.
      generator: the ``torch.Generator`` the weights are drawn from (on the
        CPU, then moved to ``device``).
    """

    def __init__(self, size: int = 64, nz: int = 100, ngf: int = 64,
                 out_ch: int = 3, device=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_up = n_stages(size)
        self._materialise(device, lambda: self._build(
            generator, ngf * (size // 8), nz, out_ch))

    def _build(self, g: torch.Generator, c: int, nz: int,
               out_ch: int) -> None:
        self.proj = nn.Parameter(
            torch.randn((nz, 4 * 4 * c), generator=g) * (2.0 / nz) ** 0.5)
        self.proj_bn = nn.ParameterDict(bn_init(c))
        for i in range(1, self.n_up):
            self.register_parameter(
                f"up{i}", nn.Parameter(tconv_init(g, 4, 4, c, c // 2)))
            self.add_module(f"bn{i}", nn.ParameterDict(bn_init(c // 2)))
            c //= 2
        self.head = nn.Parameter(tconv_init(g, 4, 4, c, out_ch))

    def forward(self, z: torch.Tensor, decomposed: bool = True,
                backend: str = "kernels",
                compute_dtype=None) -> torch.Tensor:
        """z: (N, nz) latents -> (N, size, size, out_ch) images in (-1, 1).

        Every stage is ``k=4, s=2, p_lo=2, output_padding=0``, its BN/ReLU
        fused into the transposed kernel's output pass.
        ``decomposed=False`` is the naive zero-laden baseline (torch only).
        """
        return self.decode(self.project(z, compute_dtype), decomposed,
                           backend, compute_dtype)

    def project(self, z: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """The latent projection with its BN/ReLU: (N, nz) -> (N, 4, 4,
        C), in ``compute_dtype`` when it is given."""
        cd = canon_dtype(compute_dtype)
        if cd is not None:
            z = z.to(cd)
        relu = torch.zeros((1,), dtype=torch.float32, device=z.device)
        # the projection casts the fp32 master to z's dtype, so bf16 latents
        # are not promoted
        h = torch.matmul(z, self.proj.to(z.dtype)).reshape(z.shape[0], 4, 4,
                                                           -1)
        sc, sh = fold_bn(self.proj_bn)
        return apply_reference(_EP_BN_ACT, h, (sc, sh, relu))

    def decode(self, h: torch.Tensor, decomposed: bool = True,
               backend: str = "kernels", compute_dtype=None) -> torch.Tensor:
        """The transposed-conv stages and the tanh head from
        :meth:`project`'s output."""
        cd = canon_dtype(compute_dtype)
        relu = torch.zeros((1,), dtype=torch.float32, device=h.device)
        kw = dict(stride=2, transposed=True, padding=2, output_padding=0,
                  decomposed=decomposed, backend=backend, compute_dtype=cd)
        for i in range(1, self.n_up):
            sc, sh = fold_bn(getattr(self, f"bn{i}"))
            h = conv2d(h, getattr(self, f"up{i}"), epilogue=_EP_BN_ACT,
                       scale=sc, shift=sh, alpha=relu, **kw)
        return torch.tanh(conv2d(h, self.head, **kw))


__all__ = ["DCGAN", "n_stages"]
