#!/usr/bin/env python3
"""Host-bound times of one checkout of the port, for A/B runs on one card.

Every conv launch of the port resolves its launch plan on the host, so a
change to that lookup shows first where the host bounds the time: a
served lane's tick and an eager forward.  This script times, for the
checkout at ``--root`` (its ``chip_smoke.py`` and ``src/``):

* the ENet-512 batch-4 fp32 forward, ``backend="kernels"``, wall ms
  (median of 20, ending in a synchronize);
* ``chip_smoke.py``'s saturated fp32 drains (phase 23f) of the GenServer
  denoiser and DCGAN-64 lanes on both backends: the mean warm tick, ms
  (the torch backend launches no kernel of the port: the control);
* ``launch_plan`` of each conv kernel on two ENet-512 geometries, host us
  a call.

It runs each checkout's own code with an empty plan table and prints one
JSON line.  Compare two checkouts on one card in one job, in the
order A B B A::

    python3 tools/host_ab.py --root . --label change
    python3 tools/host_ab.py --root path/to/parent --label parent

Needs a CUDA device and the checkout's kernels built
(``python3 -c "from repro_torch.kernels import build; build.build()"``
with ``PYTHONPATH=<root>/src``, or a first call that builds them).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

LOOKUP_CALLS = 20000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="the checkout to time")
    ap.add_argument("--label", required=True, help="its name in the output")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    if not torch.cuda.is_available():
        print("host_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as table:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = table
        os.environ.pop("REPRO_TORCH_AUTOTUNE", None)
        import chip_smoke as cs
        from repro_torch.kernels import conv2d as kconv
        from repro_torch.kernels import transposed_conv as ktr

        smoke = cs.Smoke(torch)
        smoke.build.build()
        out = {"label": args.label, "root": args.root}
        model, x = smoke.make_model()
        with torch.no_grad():
            out["enet_fwd_ms"] = smoke.wall_ms(lambda: model(x), reps=20)
        del model, x
        den, gan = smoke.serving_params()
        params = {"unet_dec": den, "dcgan64": gan}
        for workload in ("unet_dec", "dcgan64"):
            for backend in ("kernels", "torch"):
                srv = smoke.timed_drain(workload, params[workload], backend,
                                        "fp32", "saturated")
                warm = sum(1 for t in srv._tick_log if not t[4])
                out[f"{workload}_{backend}_tick_ms"] = (
                    1e3 * srv.stats()["warm_wall_s"] / warm)
                del srv
        g = torch.Generator().manual_seed(0)
        xc = torch.randn(4, 64, 64, 128, generator=g).cuda()
        wc = torch.randn(3, 3, 128, 128, generator=g).cuda()
        xt = torch.randn(4, 128, 128, 64, generator=g).cuda()
        wt = torch.randn(3, 3, 64, 16, generator=g).cuda()
        for name, call in (("conv2d", lambda: kconv.launch_plan(xc, wc, 1)),
                           ("tconv", lambda: ktr.launch_plan(xt, wt))):
            call()
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(LOOKUP_CALLS):
                    call()
                runs.append((time.perf_counter() - t0) / LOOKUP_CALLS * 1e6)
            out[f"{name}_launch_plan_us"] = statistics.median(runs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
