"""ENet @ 512x512 per-layer workload table (paper §III test case), the
port's copy of ``repro.core.enet_spec``.

ENet (Paszke et al. 2016) trained on Cityscapes, resized to 512x512 as in the
paper.  Each entry records the convolution workload only (the accelerator's
job); pooling/unpooling/PReLU run on the side units and do not consume MAC
cycles.  Bottleneck internal channels are ``C/4`` per the ENet paper.

Layer kinds:
  - ``conv``        dense convolution (1x1 projections, 3x3 regular, 2x2/s2
                    downsample, 5x1+1x5 asymmetric — each asymmetric half is
                    its own entry)
  - ``dilated``     3x3 dilated convolution, ``D`` zeros between taps
                    (dilation step d = D+1; ENet uses d = 2,4,8,16)
  - ``transposed``  3x3 stride-2 upsampling convolution
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ConvLayer:
    name: str
    kind: str            # conv | dilated | transposed
    h_out: int           # output spatial height
    w_out: int           # output spatial width
    cin: int
    cout: int
    kh: int = 3
    kw: int = 3
    D: int = 0           # zeros between taps (dilated only);  d = D + 1
    stride: int = 1      # upsampling factor (transposed) or output stride (dilated)
    group: str = "general"  # general | dilated | transposed (paper Fig. 10 split)
    output_padding: int = 1  # transposed only: extra high-side output size
    # transposed only: low-side pad of the zero-inserted input (p_lo).  None
    # means the framework default (k-1)//2 that every ENet/ESPNet layer uses;
    # generative decoders record explicit pads (DCGAN k=4/s=2 upsampling is
    # p_lo=2, U-Net k=2/s=2 is p_lo=1 — repro_torch.core.gen_spec).
    padding: int | None = None


def _bottleneck_regular(prefix: str, hw: int, c: int, D: int = 0, asym: bool = False):
    """Regular / dilated / asymmetric non-downsampling bottleneck (ENet §3)."""
    ci = c // 4
    layers = [ConvLayer(f"{prefix}.reduce", "conv", hw, hw, c, ci, 1, 1)]
    if asym:
        layers += [
            ConvLayer(f"{prefix}.conv5x1", "conv", hw, hw, ci, ci, 5, 1),
            ConvLayer(f"{prefix}.conv1x5", "conv", hw, hw, ci, ci, 1, 5),
        ]
    elif D > 0:
        layers.append(
            ConvLayer(f"{prefix}.dil(D={D})", "dilated", hw, hw, ci, ci, 3, 3, D=D,
                      group="dilated")
        )
    else:
        layers.append(ConvLayer(f"{prefix}.conv3x3", "conv", hw, hw, ci, ci, 3, 3))
    layers.append(ConvLayer(f"{prefix}.expand", "conv", hw, hw, ci, c, 1, 1))
    return layers


def _bottleneck_down(prefix: str, hw_out: int, cin: int, cout: int):
    ci = cout // 4
    return [
        ConvLayer(f"{prefix}.reduce2x2s2", "conv", hw_out, hw_out, cin, ci, 2, 2),
        ConvLayer(f"{prefix}.conv3x3", "conv", hw_out, hw_out, ci, ci, 3, 3),
        ConvLayer(f"{prefix}.expand", "conv", hw_out, hw_out, ci, cout, 1, 1),
    ]


def _bottleneck_up(prefix: str, hw_out: int, cin: int, cout: int):
    ci = cout // 4
    return [
        ConvLayer(f"{prefix}.reduce", "conv", hw_out // 2, hw_out // 2, cin, ci, 1, 1),
        ConvLayer(f"{prefix}.deconv3x3s2", "transposed", hw_out, hw_out, ci, ci,
                  3, 3, stride=2, group="transposed"),
        ConvLayer(f"{prefix}.expand", "conv", hw_out, hw_out, ci, cout, 1, 1),
        # skip-branch channel projection
        ConvLayer(f"{prefix}.skip1x1", "conv", hw_out // 2, hw_out // 2, cin, cout, 1, 1),
    ]


def enet_512_layers(num_classes: int = 19) -> list[ConvLayer]:
    L: list[ConvLayer] = []
    # initial block: 3x3/s2 conv, 3 -> 13 (concat 3-ch maxpool -> 16)
    L.append(ConvLayer("initial", "conv", 256, 256, 3, 13, 3, 3))
    # stage 1 (128x128, 64ch): down + 4 regular
    L += _bottleneck_down("b1.0", 128, 16, 64)
    for i in range(1, 5):
        L += _bottleneck_regular(f"b1.{i}", 128, 64)
    # stage 2 (64x64, 128ch): down + reg/dil2/asym/dil4/reg/dil8/asym/dil16
    L += _bottleneck_down("b2.0", 64, 64, 128)
    stage = [
        (0, False), (1, False), (0, True), (3, False),
        (0, False), (7, False), (0, True), (15, False),
    ]
    for i, (D, asym) in enumerate(stage, start=1):
        L += _bottleneck_regular(f"b2.{i}", 64, 128, D=D, asym=asym)
    # stage 3: same as stage 2 minus the downsample
    for i, (D, asym) in enumerate(stage, start=1):
        L += _bottleneck_regular(f"b3.{i}", 64, 128, D=D, asym=asym)
    # stage 4 (decoder, 128x128, 64ch): up + 2 regular
    L += _bottleneck_up("b4.0", 128, 128, 64)
    for i in range(1, 3):
        L += _bottleneck_regular(f"b4.{i}", 128, 64)
    # stage 5 (256x256, 16ch): up + 1 regular
    L += _bottleneck_up("b5.0", 256, 64, 16)
    L += _bottleneck_regular("b5.1", 256, 16)
    # fullconv: 3x3 stride-2 transposed, 16 -> classes, 512x512
    L.append(ConvLayer("fullconv", "transposed", 512, 512, 16, num_classes,
                       3, 3, stride=2, group="transposed"))
    return L


def dilated_layer_sets(layers: list[ConvLayer]) -> dict[int, list[ConvLayer]]:
    """Group dilated layers by D (paper Fig. 11: L1..L4 <-> D = 1,3,7,15)."""
    out: dict[int, list[ConvLayer]] = {}
    for l in layers:
        if l.kind == "dilated":
            out.setdefault(l.D, []).append(l)
    return out


def transposed_layer_sets(layers: list[ConvLayer]) -> dict[int, list[ConvLayer]]:
    """Group transposed layers by output size (paper Fig. 12: 128/256/512)."""
    out: dict[int, list[ConvLayer]] = {}
    for l in layers:
        if l.kind == "transposed":
            out.setdefault(l.h_out, []).append(l)
    return out
