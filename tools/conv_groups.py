#!/usr/bin/env python
"""Per-group sums of the conv models' kernel times from a chip_smoke report.

``chip_smoke.py`` writes every timed kernel call of phases 18-22 (ESPNet,
DCGAN, the U-Net denoiser, the Whisper frontend) to
``chiprun_out/chip_smoke.json`` as per-geometry rows.  This script sums
them into the layer groups PERF.md's per-model tables show: calls, device
ms, bound ms and library ms, per model, dtype and pass.

Usage::

    python tools/conv_groups.py [chiprun_out/chip_smoke.json]
"""

from __future__ import annotations

import json
import re
import sys

_GEO = re.compile(r"x\((\d+), (\d+), (\d+), (\d+)\) "
                  r"w\((\d+), (\d+), (\d+), (\d+)\) s(\d+)")


def group(model: str, row: dict) -> str:
    """The layer group of one per-geometry row of ``model``."""
    geo, kernel = row["geometry"], row["kernel"]
    _, _, _, cin, kh, _, _, cout, s = map(int, _GEO.match(geo).groups())
    tconv = kernel == "transposed_conv2d"
    valid = "pads((0, 0), (0, 0))" in geo
    if model.startswith("ESPNet"):
        if tconv:
            return "k3 s2 transposed (decoder; backward: down branches' dx)"
        if cin == 3:
            return "stem 3x3 s2, Cin 3"
        if kh == 1:
            return "1x1 reduce, skip2, head"
        if cin == 19:
            return "decoder dx, Cin 19, s2 VALID"
        if valid:
            return "class windows of down1/down2, VALID"
        return "3x3 d=1, phase-batched dilated (and their dx)"
    if model.startswith("DCGAN"):
        return f"{'k4 s2 transposed' if tconv else 'dx, s2 VALID'} {cin}->{cout}"
    if model.startswith("U-Net"):
        if kh == 1:
            return "1x1 encoders, Cin 3"
        if tconv:
            return "k4/k2 s2 transposed upsamplers"
        if s == 2:
            return "upsamplers' dx, s2 VALID"
        if 3 in (cin, cout):
            return "head 3x3 (and its dx)"
        return "3x3 convs, Cin 64-512 (and their dx)"
    return f"(1, 3) s{s} {cin}->{cout}"


def main(path: str = "chiprun_out/chip_smoke.json") -> int:
    with open(path) as f:
        report = json.load(f)
    print(report["card"])
    for model, entry in report["models"].items():
        for key, rows in entry["times"].items():
            if not key.endswith("_geometries"):
                continue
            sums: dict[str, dict] = {}
            for row in rows:
                g = sums.setdefault(group(model, row), dict.fromkeys(
                    ("calls", "ms", "bound_ms", "library_ms"), 0))
                g["calls"] += row["calls"]
                for k in ("ms", "bound_ms", "library_ms"):
                    g[k] += row[k]
            print(f"{model}, {key[:-len('_geometries')].replace('_', ' ')}:")
            print("| group | calls | ms | bound ms | library ms |")
            for name, g in sorted(sums.items(), key=lambda kv: -kv[1]["ms"]):
                print(f"| {name} | {g['calls']} | {g['ms']:.3f} | "
                      f"{g['bound_ms']:.3f} | {g['library_ms']:.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
