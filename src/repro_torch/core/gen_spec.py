"""Generative-decoder workload tables (DCGAN generators, diffusion U-Net
decoder), the port's copy of ``repro.core.gen_spec``.

Each entry records one convolution workload the generator executes, as
:mod:`repro_torch.models.dcgan` and :mod:`repro_torch.models.unet_decoder`
build it.  ``GenServer`` prices admission off these tables
(:meth:`repro_torch.launch.serve_gen.GenServer.admission_estimate`), for the
geometry it actually runs.

Geometry notes:

* DCGAN upsampling is ``k=4, s=2, p_lo=2, output_padding=0`` — PyTorch's
  ``ConvTranspose2d(4, stride=2, padding=1)`` exact-2x geometry.  The pads
  are not the default ``(k-1)//2``, so every entry records ``padding``.
* The U-Net decoder alternates ``k=4`` and ``k=2`` upsampling (both with
  ``p_lo = k//2``).
* DCGAN's latent projection (z -> 4x4xC) is a dense matmul, recorded as the
  1x1-conv workload that issues the same MAC count.
"""

from __future__ import annotations

import math

from repro_torch.core.enet_spec import ConvLayer

#: per-level upsampling kernels of the U-Net decoder
UNET_UP_KERNELS = (4, 2, 4)

#: default U-Net decoder widths: level i runs at ``8 * 2**i`` spatial with
#: this many channels (the skip concat doubles the first conv's input)
UNET_WIDTHS = (256, 128, 64)


def dcgan_layers(size: int = 64, nz: int = 100, ngf: int = 64,
                 out_ch: int = 3) -> list[ConvLayer]:
    """DCGAN generator at 64x64 or 128x128 (Radford et al. 2016): the
    projection to ``4x4 x (ngf * size/8)``, then ``k=4, s=2`` transposed
    convs halving channels and doubling resolution, and a ``k=4, s=2``
    head to ``out_ch``."""
    if size not in (64, 128):
        raise ValueError(f"DCGAN generator sizes are 64/128, got {size}")
    n_up = int(math.log2(size // 4))        # 4 stages at 64, 5 at 128
    c = ngf * (size // 8)                   # 512 at 64, 1024 at 128
    L = [ConvLayer("proj", "conv", 4, 4, nz, c, 1, 1)]
    hw = 4
    for i in range(1, n_up):
        hw *= 2
        L.append(ConvLayer(f"up{i}", "transposed", hw, hw, c, c // 2, 4, 4,
                           stride=2, group="transposed", output_padding=0,
                           padding=2))
        c //= 2
    L.append(ConvLayer("head", "transposed", hw * 2, hw * 2, c, out_ch, 4, 4,
                       stride=2, group="transposed", output_padding=0,
                       padding=2))
    return L


def unet_decoder_layers(widths: tuple[int, ...] = UNET_WIDTHS,
                        skip_chs: tuple[int, ...] | None = None,
                        hw: int = 8, out_ch: int = 3) -> list[ConvLayer]:
    """Diffusion U-Net decoder stack (mid 8x8 -> 64x64 image): per level
    ``i`` at ``hw * 2**i`` with ``widths[i]`` channels, skip concat, two
    dense 3x3 convs, a ``k in {4, 2}``, s=2 transposed upsample; then a
    dense 3x3 head to ``out_ch``."""
    if skip_chs is None:
        skip_chs = tuple(widths)
    if len(skip_chs) != len(widths):
        raise ValueError(f"{len(skip_chs)} skip widths for {len(widths)} "
                         f"levels")
    L: list[ConvLayer] = []
    for i, (c, cs) in enumerate(zip(widths, skip_chs)):
        k = UNET_UP_KERNELS[i % len(UNET_UP_KERNELS)]
        c_next = widths[i + 1] if i + 1 < len(widths) else widths[-1] // 2
        L.append(ConvLayer(f"lvl{i}.conv1", "conv", hw, hw, c + cs, c, 3, 3))
        L.append(ConvLayer(f"lvl{i}.conv2", "conv", hw, hw, c, c, 3, 3))
        hw *= 2
        L.append(ConvLayer(f"lvl{i}.up_k{k}", "transposed", hw, hw, c, c_next,
                           k, k, stride=2, group="transposed",
                           output_padding=0, padding=k // 2))
    L.append(ConvLayer("head", "conv", hw, hw, widths[-1] // 2, out_ch, 3, 3))
    return L


#: name -> zero-arg table constructor
GEN_WORKLOADS = {
    "dcgan64": lambda: dcgan_layers(64),
    "dcgan128": lambda: dcgan_layers(128),
    "unet_dec": lambda: unet_decoder_layers(),
}


__all__ = ["ConvLayer", "dcgan_layers", "unet_decoder_layers",
           "GEN_WORKLOADS", "UNET_UP_KERNELS", "UNET_WIDTHS"]
