#!/usr/bin/env python
"""How far one sLSTM layer's fp32 gradients lie from fp64's, by length.

One sLSTM layer of xLSTM-1.3B at its published width (d_model 2048, the
2730-wide FFN; ``repro_torch.models.xlstm``), its weights, input and output
cotangent drawn from a seed in fp32.  For each sequence length the script
takes the gradients of x and of every leaf:

* in fp64, every op, the recurrence included (``xlstm._slstm_step`` on
  fp64 operands, the torch backend), as the exact side;
* in fp32 through ``xlstm.slstm_block`` on each backend given (``torch``;
  ``kernels`` too on a CUDA device, every product on kernel 3).

It prints, per length and gradient, each fp32 backend's distance from the
fp64 gradient (relative L2, and the largest error over the largest entry)
and the two fp32 backends' distance from each other: whether two fp32
implementations part by about what fp32 rounding alone gives, as the
backward's growth over the steps amplifies it.

Usage::

    python tools/slstm_growth.py [--device cuda] [--seqs 64,256,1024]
        [--out chiprun_out/slstm_growth.json]

On the CPU only the torch backend runs (the kernels backend there is the
same plain arithmetic).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.models.layers import linear  # noqa: E402


def fp64_block(p, x):
    """``xlstm.slstm_block`` from a zero state with every op in fp64."""
    b, s, d = x.shape
    xg = linear(x, p["w_gates"], "torch")
    zero = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    state = (zero, zero, zero, torch.full_like(zero, -1e30))
    hs = []
    for t in range(s):
        state = xlstm._slstm_step(p["r_gates"], state, xg[:, t], "torch")
        hs.append(state[2])
    y = torch.stack(hs, dim=1)
    ff = F.gelu(linear(y, p["ff_up"], "torch"), approximate="tanh")
    return linear(ff, p["ff_down"], "torch")


def grads(block, p, x, cot, dtype):
    leaves = {k: v.to(dtype).requires_grad_() for k, v in p.items()}
    tx = x.to(dtype).requires_grad_()
    y = block(leaves, tx)
    return dict(zip(["x", *leaves], torch.autograd.grad(
        y, [tx, *leaves.values()], cot.to(dtype))))


def distance(a, b):
    """(relative L2, largest error over the largest entry) of a from b."""
    a, b = a.double(), b.double()
    return (((a - b).norm() / b.norm()).item(),
            ((a - b).abs().max() / b.abs().max()).item())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seqs", default="64,256,1024")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-1.3b").replace(dtype="float32")
    backends = ["kernels", "torch"] if dev.type == "cuda" else ["torch"]
    g = torch.Generator(dev).manual_seed(args.seed)
    p = xlstm.slstm_init(g, cfg, torch.float32, dev)
    seqs = [int(s) for s in args.seqs.split(",")]
    x = torch.randn((1, max(seqs), cfg.d_model), generator=g, device=dev)
    cot = torch.randn((1, max(seqs), cfg.d_model), generator=g, device=dev)
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"), "seqs": {}}
    for s in seqs:
        xs, cs = x[:, :s], cot[:, :s]
        exact = grads(fp64_block, p, xs, cs, torch.float64)
        got = {b: grads(lambda q, t, b=b: xlstm.slstm_block(
            q, t, cfg, backend=b)[0], p, xs, cs, torch.float32)
            for b in backends}
        row = out["seqs"][s] = {}
        for k, ref in exact.items():
            row[k] = {f"{b} vs fp64": distance(got[b][k], ref)
                      for b in backends}
            if len(backends) == 2:
                row[k]["kernels vs torch"] = distance(got["kernels"][k],
                                                      got["torch"][k])
        print(f"seq {s}: relative L2 / largest error over largest entry")
        for k, r in row.items():
            print(f"  {k:8s} " + "; ".join(
                f"{what} {l2:.3e} / {mx:.3e}" for what, (l2, mx) in r.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
