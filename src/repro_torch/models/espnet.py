"""ESPNet segmentation network in PyTorch, built on the paper's decomposition.

The port of ``repro.models.espnet`` (Mehta et al. 2018, the reference's
compact variant: alpha2 = 2, alpha3 = 3, K = 4 pyramid branches, a light
transposed-conv decoder).  The ESP module is a 1x1 reduce followed by ``K``
parallel 3x3 branches at dilation 1, 2, 4 and 8 whose outputs are fused
hierarchically (HFF: cumulative sums, then concatenation).  Every conv goes
through :func:`repro_torch.core.decompose.conv2d`:

* the dilated branches of a regular ESP through the phase-batched input
  decomposition (one dense conv a branch);
* the branches of a downsampling ESP (``down1``, ``down2``) through the
  strided-dilated output-class schedule (DESIGN.md §2c): the class windows
  batched into one strided VALID dense conv, stitched back;
* the decoder's three k3 s2 upsamplers through the weight decomposition,
  the first with the skip-add fused as a ``post_act`` residual.

With ``backend="kernels"`` on a CUDA device a forward launches the dense
conv kernel 38 times and the transposed-conv kernel 3 times.  The stem's
BN/PReLU rides its conv as a fused epilogue; the ESP module's BN/PReLU
follows the HFF concat, not any single conv, so it runs as the epilogue's
plain version in one elementwise pass, as in the reference.  Parameters
keep the reference's names and HWIO layout (``stem``, ``down1.br2``,
``l3_0.bn.g``, ...), so :meth:`ESPNet.load_jax_params` carries a reference
tree across.  ``compute_dtype="bf16"`` runs the activations in bf16 off
fp32 master parameters (DESIGN.md §12).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.decompose import conv2d
from repro_torch.kernels.epilogue import EpilogueSpec, apply_reference
from repro_torch.kernels.util import canon_dtype
from repro_torch.models.common import (SeededModule, bn_init, conv_init,
                                       fold_bn)

ESP_DILATIONS = (1, 2, 4, 8)   # K = 4 pyramid branches (d = 2**k)

_EP_BN_ACT = EpilogueSpec(bn=True, prelu=True)
_EP_RES = EpilogueSpec(residual="post_act")


class ESP(nn.Module):
    """ESP module: 1x1 reduce -> K dilated 3x3 branches -> HFF -> BN/PReLU."""

    def __init__(self, g: torch.Generator, cin: int, cout: int):
        super().__init__()
        k = len(ESP_DILATIONS)
        if cout % k:
            raise ValueError(f"cout={cout} not divisible by K={k}")
        cb = cout // k
        self.reduce = nn.Parameter(conv_init(g, 1, 1, cin, cb))
        self.bn = nn.ParameterDict(bn_init(cout))
        self.a = nn.Parameter(torch.full((1,), 0.25))
        # folded BN does not re-normalise per batch; the HFF sums and the
        # residual grow a module's variance ~(K+1)/2 + 1, so the BN scale
        # starts that much down and the stack at unit activation scale
        with torch.no_grad():
            self.bn["g"].div_(((k + 1) / 2 + 1) ** 0.5)
        for d in ESP_DILATIONS:
            self.register_parameter(f"br{d}",
                                    nn.Parameter(conv_init(g, 3, 3, cb, cb)))

    def forward(self, x: torch.Tensor, stride: int = 1,
                decomposed: bool = True, strategy: str = "batched",
                backend: str = "kernels",
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """``stride=2`` is the downsampling ESP: every branch a strided
        (dilated) conv.  The d=1 branch is a plain dense conv."""
        cd = compute_dtype
        h = conv2d(x, self.reduce, backend=backend, compute_dtype=cd)
        outs = []
        for d in ESP_DILATIONS:
            w = getattr(self, f"br{d}")
            if d == 1:
                outs.append(conv2d(h, w, stride=stride, backend=backend,
                                   compute_dtype=cd))
            else:
                outs.append(conv2d(h, w, dilation=d, stride=stride,
                                   decomposed=decomposed, strategy=strategy,
                                   backend=backend, compute_dtype=cd))
        acc, fused = outs[0], [outs[0]]
        for o in outs[1:]:          # HFF: cumulative sums de-grid the pyramid
            acc = acc + o
            fused.append(acc)
        y = torch.cat(fused, dim=-1)
        if stride == 1 and x.shape[-1] == y.shape[-1]:
            y = y + x               # residual (regular ESP only)
        sc, sh = fold_bn(self.bn)
        return apply_reference(_EP_BN_ACT, y, (sc, sh, self.a))


class ESPNet(SeededModule):
    """ESPNet at the reference's widths: stem 16, ESP stages 64 and 128.

    Args:
      num_classes: output channels (19 for Cityscapes).
      alpha2, alpha3: regular ESP modules in stages 2 and 3.
      device: ``None`` -> CUDA (raises without a card); ``"cpu"`` runs the
        kernels' plain versions; ``"meta"`` builds a weightless shell for
        ``torch.func.functional_call``.
      generator: the ``torch.Generator`` the weights are drawn from (on the
        CPU, then moved to ``device``).
    """

    def __init__(self, num_classes: int = 19, alpha2: int = 2,
                 alpha3: int = 3, device=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.alpha2, self.alpha3 = alpha2, alpha3
        self._materialise(device, lambda: self._build(generator, num_classes))

    def _build(self, g: torch.Generator, c: int) -> None:
        self.stem = nn.Parameter(conv_init(g, 3, 3, 3, 16))
        self.stem_bn = nn.ParameterDict(bn_init(16))
        self.stem_a = nn.Parameter(torch.full((1,), 0.25))
        self.down1 = ESP(g, 16, 64)
        for i in range(self.alpha2):
            self.add_module(f"l2_{i}", ESP(g, 64, 64))
        self.down2 = ESP(g, 64, 128)
        for i in range(self.alpha3):
            self.add_module(f"l3_{i}", ESP(g, 128, 128))
        self.head = nn.Parameter(conv_init(g, 1, 1, 128, c))
        self.skip2 = nn.Parameter(conv_init(g, 1, 1, 64, c))
        for name in ("up1", "up2", "up3"):
            self.register_parameter(name,
                                    nn.Parameter(conv_init(g, 3, 3, c, c)))

    def forward(self, x: torch.Tensor, decomposed: bool = True,
                strategy: str = "batched", backend: str = "kernels",
                compute_dtype=None) -> torch.Tensor:
        """x: (N, H, W, 3), H and W divisible by 8 -> logits (N, H, W,
        num_classes), in ``compute_dtype`` when it is given (the input is
        cast once, every conv casts its weight)."""
        cd = canon_dtype(compute_dtype)
        if cd is not None:
            x = x.to(cd)
        kw = dict(decomposed=decomposed, strategy=strategy, backend=backend,
                  compute_dtype=cd)
        sc, sh = fold_bn(self.stem_bn)
        h = conv2d(x, self.stem, stride=2, backend=backend,       # H/2
                   epilogue=_EP_BN_ACT, scale=sc, shift=sh,
                   alpha=self.stem_a, compute_dtype=cd)
        h = self.down1(h, stride=2, **kw)                          # H/4, 64
        for i in range(self.alpha2):
            h = getattr(self, f"l2_{i}")(h, **kw)
        skip = conv2d(h, self.skip2, backend=backend, compute_dtype=cd)
        h = self.down2(h, stride=2, **kw)                          # H/8, 128
        for i in range(self.alpha3):
            h = getattr(self, f"l3_{i}")(h, **kw)
        h = conv2d(h, self.head, backend=backend, compute_dtype=cd)
        up = dict(stride=2, transposed=True, output_padding=1,
                  decomposed=decomposed, backend=backend, compute_dtype=cd)
        # the decoder's skip-add fuses into the transposed kernel's output
        h = conv2d(h, self.up1, epilogue=_EP_RES, residual=skip, **up)  # H/4
        h = conv2d(h, self.up2, **up)                                    # H/2
        return conv2d(h, self.up3, **up)


__all__ = ["ESPNet", "ESP", "ESP_DILATIONS"]
