"""ENet segmentation network in PyTorch, built on the paper's decomposition.

The port of ``repro.models.enet``.  Every conv goes through
:func:`repro_torch.core.decompose.conv2d`: dilated convs through the input
decomposition (phase-batched), transposed convs through the weight
decomposition (live parity taps only), and every BN, PReLU and residual add
rides the conv as a fused epilogue.  With ``backend="kernels"`` on a CUDA
device the 86 dense and dilated convs of a forward run on the dense conv
kernel and the 3 transposed convs on the parity-plane kernel.

Parameters keep the reference's HWIO layout and its names
(``initial``, ``b1_0.reduce``, ``b1_0.bn1.g``, ...), activations are NHWC,
so :meth:`ENet.load_jax_params` carries a reference parameter tree across
and the outputs compare directly; :func:`flatten_tree` (of
:mod:`repro_torch.models.common`, re-exported here) gives a reference
tree (of parameters, gradients or optimizer moments) the names of
``named_parameters()``.  ``compute_dtype="bf16"`` runs the activations in
bf16 end to end off fp32 master parameters, as the reference does
(DESIGN.md §12): the input is cast once, every conv casts its weight (the
dispatcher's ``compute_dtype``), the folded BN and PReLU operands stay
fp32, and the logits come back in bf16.  The parameters train: under autograd every conv
differentiates through the kernels' ``torch.autograd.Function`` classes, and
serving runs under ``torch.no_grad()``.  The non-conv ops stay plain torch:
2x2/s2 max-pool (floor), channel concat and zero-pad, nearest 2x repeat.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.decompose import conv2d
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.util import canon_dtype
from repro_torch.models.common import (SeededModule, bn_init, conv_init,
                                       flatten_tree, fold_bn)

# BN+PReLU after the reduce and middle convs; BN + residual add + PReLU
# closing every bottleneck
_EP_BN_ACT = EpilogueSpec(bn=True, prelu=True)
_EP_BN_RES_ACT = EpilogueSpec(bn=True, prelu=True, residual="pre_act")

# stage 2/3 layout: (kind, dilation)
_STAGE2 = [("reg", 1), ("dil", 2), ("asym", 1), ("dil", 4),
           ("reg", 1), ("dil", 8), ("asym", 1), ("dil", 16)]


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool on NHWC, floor semantics (VALID)."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2, :]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class Bottleneck(nn.Module):
    """What every ENet bottleneck shares: a reduce conv with BN1+PReLU, a
    middle stage (the subclass's :meth:`branch`) and the 1x1 expand whose
    epilogue folds BN3, the skip add and PReLU into one pass."""

    def __init__(self, g: torch.Generator, c: int, cin: int,
                 reduce_k: int = 1):
        super().__init__()
        ci = max(c // 4, 1)
        self.ci = ci
        self.a1, self.a2, self.a3 = (nn.Parameter(torch.full((1,), 0.25))
                                     for _ in range(3))
        self.bn1, self.bn2, self.bn3 = (nn.ParameterDict(bn_init(n))
                                        for n in (ci, ci, c))
        # folded BN does not re-normalise per batch, so zero-init the closing
        # scale: each block starts as the identity ("zero-init residual")
        with torch.no_grad():
            self.bn3["g"].zero_()
        self.reduce = nn.Parameter(conv_init(g, reduce_k, reduce_k, cin, ci))
        self.expand = nn.Parameter(conv_init(g, 1, 1, ci, c))

    def ep(self, i: int) -> dict:
        """Fused BN_i + PReLU_i epilogue operands."""
        scale, shift = fold_bn(getattr(self, f"bn{i}"))
        return dict(epilogue=_EP_BN_ACT, scale=scale, shift=shift,
                    alpha=getattr(self, f"a{i}"))

    def branch(self, x, decomposed: bool, strategy: str, backend: str,
               cd: torch.dtype | None):
        """-> (main-branch activations before expand, skip tensor); ``cd``
        is every conv's ``compute_dtype``."""
        raise NotImplementedError

    def forward(self, x: torch.Tensor, decomposed: bool = True,
                strategy: str = "batched", backend: str = "kernels",
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        h, skip = self.branch(x, decomposed, strategy, backend, compute_dtype)
        s3, b3 = fold_bn(self.bn3)
        return conv2d(h, self.expand, backend=backend,
                      epilogue=_EP_BN_RES_ACT, scale=s3, shift=b3,
                      alpha=self.a3, residual=skip,
                      compute_dtype=compute_dtype)


class DilatedBottleneck(Bottleneck):
    """Regular (``dilation=1``) or dilated 3x3 bottleneck."""

    def __init__(self, g: torch.Generator, c: int, dilation: int = 1):
        super().__init__(g, c, c)
        self.dilation = dilation
        self.conv = nn.Parameter(conv_init(g, 3, 3, self.ci, self.ci))

    def branch(self, x, decomposed, strategy, backend, cd):
        h = conv2d(x, self.reduce, backend=backend, compute_dtype=cd,
                   **self.ep(1))
        h = conv2d(h, self.conv, dilation=self.dilation, decomposed=decomposed,
                   strategy=strategy, backend=backend, compute_dtype=cd,
                   **self.ep(2))
        return h, x


class AsymBottleneck(Bottleneck):
    """5x1 then 1x5 rectangular pair; BN2+PReLU fuse into the second."""

    def __init__(self, g: torch.Generator, c: int, asym: int = 5):
        super().__init__(g, c, c)
        ci = self.ci
        std = (2.0 / (asym * ci)) ** 0.5
        self.conv_v = nn.Parameter(
            torch.randn((asym, 1, ci, ci), generator=g) * std)
        self.conv_h = nn.Parameter(
            torch.randn((1, asym, ci, ci), generator=g) * std)

    def branch(self, x, decomposed, strategy, backend, cd):
        h = conv2d(x, self.reduce, backend=backend, compute_dtype=cd,
                   **self.ep(1))
        h = conv2d(h, self.conv_v, backend=backend, compute_dtype=cd)
        h = conv2d(h, self.conv_h, backend=backend, compute_dtype=cd,
                   **self.ep(2))
        return h, x


class DownBottleneck(Bottleneck):
    """2x2/s2 reduce; the skip is a 2x2 max-pool, zero-padded to ``c``."""

    def __init__(self, g: torch.Generator, cin: int, c: int):
        super().__init__(g, c, cin, reduce_k=2)
        self.c = c
        self.conv = nn.Parameter(conv_init(g, 3, 3, self.ci, self.ci))

    def branch(self, x, decomposed, strategy, backend, cd):
        h = conv2d(x, self.reduce, stride=2, padding=0, backend=backend,
                   compute_dtype=cd, **self.ep(1))
        skip = F.pad(_max_pool2(x), (0, self.c - x.shape[-1]))
        h = conv2d(h, self.conv, backend=backend, compute_dtype=cd,
                   **self.ep(2))
        return h, skip


class UpBottleneck(Bottleneck):
    """3x3/s2 transposed conv; the skip is a 1x1 projection, repeated 2x
    (nearest neighbour in place of max-unpool indices)."""

    def __init__(self, g: torch.Generator, cin: int, c: int):
        super().__init__(g, c, cin)
        self.deconv = nn.Parameter(conv_init(g, 3, 3, self.ci, self.ci))
        self.skip = nn.Parameter(conv_init(g, 1, 1, cin, c))

    def branch(self, x, decomposed, strategy, backend, cd):
        h = conv2d(x, self.reduce, backend=backend, compute_dtype=cd,
                   **self.ep(1))
        skip = conv2d(x, self.skip, backend=backend, compute_dtype=cd)
        skip = skip.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        h = conv2d(h, self.deconv, stride=2, transposed=True,
                   output_padding=1, decomposed=decomposed, backend=backend,
                   compute_dtype=cd, **self.ep(2))
        return h, skip


class ENet(SeededModule):
    """ENet (Paszke et al. 2016) at full width, as the reference builds it.

    Args:
      num_classes: output channels of the head (19 for Cityscapes).
      device: ``None`` -> CUDA (raises without a card); ``"cpu"`` runs the
        kernels' plain versions; ``"meta"`` builds a shell that holds no
        weights (nothing is drawn), for ``torch.func.functional_call``.
      generator: the ``torch.Generator`` the weights are drawn from (on the
        CPU, then moved to ``device``).
    """

    def __init__(self, num_classes: int = 19, device=None, *,
                 generator: torch.Generator):
        super().__init__()
        self._materialise(device, lambda: self._build(generator, num_classes))

    def _build(self, g: torch.Generator, num_classes: int) -> None:
        self.initial = nn.Parameter(conv_init(g, 3, 3, 3, 13))
        blocks = [("b1_0", DownBottleneck(g, 16, 64))]
        blocks += [(f"b1_{i}", DilatedBottleneck(g, 64)) for i in range(1, 5)]
        blocks.append(("b2_0", DownBottleneck(g, 64, 128)))
        for stage in (2, 3):
            for i, (kind, d) in enumerate(_STAGE2, start=1):
                blk = (AsymBottleneck(g, 128) if kind == "asym"
                       else DilatedBottleneck(g, 128, d))
                blocks.append((f"b{stage}_{i}", blk))
        blocks.append(("b4_0", UpBottleneck(g, 128, 64)))
        blocks += [(f"b4_{i}", DilatedBottleneck(g, 64)) for i in range(1, 3)]
        blocks.append(("b5_0", UpBottleneck(g, 64, 16)))
        blocks.append(("b5_1", DilatedBottleneck(g, 16)))
        for name, blk in blocks:
            self.add_module(name, blk)
        self.block_names = [name for name, _ in blocks]
        self.fullconv = nn.Parameter(conv_init(g, 3, 3, 16, num_classes))

    def forward(self, x: torch.Tensor, decomposed: bool = True,
                strategy: str = "batched", backend: str = "kernels",
                compute_dtype=None) -> torch.Tensor:
        """x: (N, H, W, 3) fp32 -> logits (N, H, W, num_classes).

        ``backend="kernels"`` runs every conv on the CUDA kernels (their
        plain versions on the CPU); ``"torch"`` composes ``F.conv2d``.
        ``decomposed=False`` is the naive zero-laden baseline (torch only).
        ``compute_dtype`` (``None``, ``"fp32"`` or ``"bf16"``) casts the
        input once and every conv's operands, off the fp32 parameters; the
        logits come back in it.
        """
        cd = canon_dtype(compute_dtype)
        if cd is not None:
            x = x.to(cd)
        h = conv2d(x, self.initial, stride=2, backend=backend,
                   compute_dtype=cd)
        h = torch.cat([h, _max_pool2(x)], dim=-1)          # (N, H/2, W/2, 16)
        for name in self.block_names:
            h = getattr(self, name)(h, decomposed, strategy, backend, cd)
        return conv2d(h, self.fullconv, stride=2, transposed=True,
                      output_padding=1, decomposed=decomposed,
                      backend=backend, compute_dtype=cd)


__all__ = ["ENet", "flatten_tree", "Bottleneck", "DilatedBottleneck",
           "AsymBottleneck", "DownBottleneck", "UpBottleneck"]
