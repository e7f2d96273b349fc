#!/usr/bin/env python3
"""What gloo's ``all_gather`` moves a second between ranks sharing a card.

The port's collectives (``repro_torch.distributed.collectives``) all run
on ``torch.distributed.all_gather`` over gloo when the ranks share one
card (NCCL refuses two ranks on one device).  This script starts
``--ranks`` processes (gloo, a ``file://`` rendezvous in a temporary
directory, one thread each, as ``repro_torch.launch.mesh.launch`` does)
and times ``all_gather`` of one tensor a rank, per size, of:

* ``cuda``: a CUDA tensor (gloo stages it through the host itself);
* ``host``: a host tensor copied from the card first and back after, the
  copies inside the time;
* ``pinned``: the same through pinned host buffers allocated once.

It prints one JSON line: per kind and size (MiB a rank), the median ms
of ``--reps`` calls and the GB/s each rank receives ((ranks - 1) x
size / time).  ``--device cpu`` times host tensors only (no card)::

    python3 tools/gloo_bench.py --ranks 4              # on the card
    python3 tools/gloo_bench.py --ranks 4 --device cpu --sizes 1 16
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import tempfile
import time


def _rank(rank, args, tmp):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=args.ranks)
    out = {}
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    kinds = ("cuda", "host", "pinned") if cuda else ("host",)
    for mib in args.sizes:
        n = int(mib * 2 ** 20) // 2
        t = torch.randn(n, device=dev).to(torch.bfloat16)
        for kind in kinds:
            if kind == "pinned":
                src = torch.empty(n, dtype=t.dtype, pin_memory=True)
                parts = [torch.empty(n, dtype=t.dtype, pin_memory=True)
                         for _ in range(args.ranks)]
            times = []
            for _ in range(args.reps + 1):
                if cuda:
                    torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                if kind == "cuda" or not cuda:
                    got = [torch.empty_like(t) for _ in range(args.ranks)]
                    dist.all_gather(got, t)
                elif kind == "host":
                    h = t.cpu()
                    got = [torch.empty_like(h) for _ in range(args.ranks)]
                    dist.all_gather(got, h)
                    got = [g.to(dev) for g in got]
                else:
                    src.copy_(t)
                    dist.all_gather(parts, src)
                    got = [g.to(dev, non_blocking=True) for g in parts]
                if cuda:
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            ms = 1e3 * statistics.median(times[1:])
            moved = (args.ranks - 1) * n * 2
            out[f"{kind} {mib} MiB"] = {"ms": ms,
                                        "gb_s": moved / (ms / 1e3) / 1e9}
    if rank == 0:
        print(json.dumps({"ranks": args.ranks, "device": args.device,
                          "all_gather": out}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sizes", type=float, nargs="+",
                    default=[1, 16, 64, 256])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="gloo_bench_")
    try:
        mp.start_processes(_rank, args=(args, tmp), nprocs=args.ranks,
                           start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
