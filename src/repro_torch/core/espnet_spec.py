"""ESPNet @ 512x512 per-layer workload table (second accelerator workload),
the port's copy of ``repro.core.espnet_spec``.

Mirrors :mod:`repro_torch.models.espnet` (the compact ESPNet variant: K = 4 pyramid
branches at d = 1, 2, 4, 8, alpha2 = 2, alpha3 = 3, deconv decoder) the same
way :mod:`repro_torch.core.enet_spec` mirrors :mod:`repro_torch.models.enet` — each entry
records the convolution workload only.

Differences from the ENet table that matter to the cycle model:

* dilation rates are *small and mixed* (2/4/8 in one module, vs ENet's
  per-layer 2..16) — the dilated efficiency band is sampled at the high end;
* the downsampling ESP modules are **strided dilated** convolutions — the
  output-class schedule (DESIGN.md §2c), which ENet never exercises;
* the decoder is deconv-only (no skip max-unpool), so the transposed share
  is carried entirely by 3x3/s2 layers at 128/256/512.
"""

from __future__ import annotations

from repro_torch.core.enet_spec import ConvLayer

ESP_DILATIONS = (1, 2, 4, 8)


def esp_module_layers(prefix: str, hw_in: int, cin: int, cout: int,
                      stride: int = 1) -> list[ConvLayer]:
    """ESP module: 1x1 reduce + K parallel 3x3 branches (one per dilation).

    The d = 1 branch is a plain dense conv (group "general"); d > 1 branches
    are dilated convs (group "dilated"), strided when the module downsamples.
    """
    K = len(ESP_DILATIONS)
    cb = cout // K
    hw_out = hw_in // stride
    layers = [ConvLayer(f"{prefix}.reduce", "conv", hw_in, hw_in, cin, cb, 1, 1)]
    for d in ESP_DILATIONS:
        if d == 1:
            layers.append(ConvLayer(f"{prefix}.br_d1", "conv", hw_out, hw_out,
                                    cb, cb, 3, 3, stride=stride))
        else:
            layers.append(ConvLayer(f"{prefix}.br_d{d}", "dilated", hw_out,
                                    hw_out, cb, cb, 3, 3, D=d - 1,
                                    stride=stride, group="dilated"))
    return layers


def espnet_512_layers(num_classes: int = 19, alpha2: int = 2,
                      alpha3: int = 3) -> list[ConvLayer]:
    L: list[ConvLayer] = []
    L.append(ConvLayer("stem", "conv", 256, 256, 3, 16, 3, 3))
    L += esp_module_layers("down1", 256, 16, 64, stride=2)
    for i in range(alpha2):
        L += esp_module_layers(f"l2.{i}", 128, 64, 64)
    L.append(ConvLayer("skip2", "conv", 128, 128, 64, num_classes, 1, 1))
    L += esp_module_layers("down2", 128, 64, 128, stride=2)
    for i in range(alpha3):
        L += esp_module_layers(f"l3.{i}", 64, 128, 128)
    L.append(ConvLayer("head", "conv", 64, 64, 128, num_classes, 1, 1))
    for i, hw in enumerate((128, 256, 512), start=1):
        L.append(ConvLayer(f"up{i}", "transposed", hw, hw, num_classes,
                           num_classes, 3, 3, stride=2, group="transposed"))
    return L
