"""What each rank runs on the data axis (DESIGN.md §13): the rank programs
of the CPU tests and of ``chip_smoke.py`` phase 33.

:func:`run` is the rank entry that :func:`repro_torch.launch.mesh.launch`
starts: it lays a ``(data,)`` mesh over the process group and runs a list
of jobs, each a ``(name, keywords)`` pair of :data:`JOBS`, in one rank
session (a spawn costs seconds; a session runs every job of a world).
Inputs arrive as numpy arrays, identical on every rank; results leave as
CPU tensors, numpy arrays and numbers.

* ``"conv"``: :func:`repro_torch.distributed.sharding.shard_conv2d` on
  seeded operands, forward and with gradients, beside the unsharded
  :func:`repro_torch.core.decompose.conv2d` on the same rank;
* ``"allreduce"``: :func:`repro_torch.distributed.compression.
  mesh_allreduce` of this rank's run of a chunk stack;
* ``"train"``: :func:`repro_torch.launch.train_recipes.
  make_sharded_train_step` steps of a recipe from given parameters;
* ``"serve"``: a :class:`repro_torch.launch.serve_gen.GenServer` drain
  over the mesh, with a snapshot at a tick or from a restored snapshot.

Each job reads the kernel wrappers' launch counters around its main call
(they count CUDA launches only).

  from repro_torch.launch.mesh import launch
  outs = launch(data_axis.run, 4, device="cpu",
                args=([("conv", {"cases": [...]})],))
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.decompose import conv2d
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compression import mesh_allreduce
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.launch import train_recipes as ttr
from repro_torch.launch.mesh import live_mesh
from repro_torch.launch.serve_gen import GenServer

_COUNTERS = {"conv2d": kconv.conv2d,
             "transposed_conv2d": ktr.transposed_conv2d}


def _reset_counts() -> None:
    for w in _COUNTERS.values():
        w.launches = 0


def _counts() -> dict:
    return {k: w.launches for k, w in _COUNTERS.items()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes: equal digests, equal bits."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def _cpu(obj):
    return ttr._map_tensors(lambda t: t.detach().cpu(), obj)


class _ConvRows(TorchDispatchMode):
    """Records the batch of every ``aten.convolution`` run under it (the
    torch backend's convs: the rows a rank convolves)."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.rows.append(args[0].shape[0])
        return func(*args, **(kwargs or {}))


def conv_job(mesh, cases, seed: int = 0, tensors: bool = True) -> dict:
    """Per case ``(label, x shape, w shape, conv keywords)``: the sharded
    forward, its gradients of ``sum(out)``, the launches of the sharded
    forward and the batch of each torch-backend conv in it
    (``conv_rows``), and digests; on mesh rank 0 (every rank with
    ``tensors``) the
    unsharded call's output and gradients beside them.  The gathered
    output and the reduced gradients are the same on every rank, so the
    digests carry rank 0's comparison to the others.  ``tensors=False``
    keeps only the digests and errors."""
    dev = mesh.device
    out = {}
    for i, (label, xs, ws, kw) in enumerate(cases):
        rng = np.random.default_rng(seed + i)
        x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32))
        x = x.to(dev)
        w = torch.from_numpy(rng.standard_normal(ws, dtype=np.float32))
        w = w.to(dev)
        _reset_counts()
        with torch.no_grad(), _ConvRows() as rows:
            y = shd.shard_conv2d(mesh, x, w, **kw)
        _sync(dev)
        launches = _counts()
        _, dx, dw = shd.shard_conv2d(mesh, x, w, with_grads=True, **kw)
        res = {"launches": launches, "conv_rows": rows.rows,
               "digest": digest(y),
               "grad_digests": (digest(dx), digest(dw))}
        out[label] = res
        if mesh.rank and not tensors:
            continue
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        yr = conv2d(xr, wr, **kw)
        rdx, rdw = torch.autograd.grad(yr, (xr, wr), torch.ones_like(yr))
        yr = yr.detach()
        res.update({"equal": torch.equal(y, yr),
                    "dx_err": (dx - rdx).abs().max().item(),
                    "dx_scale": rdx.abs().max().item(),
                    "dw_err": (dw - rdw).abs().max().item(),
                    "dw_scale": rdw.abs().max().item()})
        if tensors:
            res.update(_cpu({"y": y, "dx": dx, "dw": dw, "ref": yr,
                             "ref_dx": rdx, "ref_dw": rdw}))
    return out


def allreduce_job(mesh, stacks: dict, transport: str = "dense") -> dict:
    """This rank's contiguous run of each ``(C, ...)`` stack through
    :func:`mesh_allreduce`."""
    group = shd.data_group(mesh)
    sh = shd.batch_sharding(mesh, ndim=1)
    local = {k: sh.shard(torch.from_numpy(v).to(mesh.device))
             for k, v in stacks.items()}
    return _cpu(mesh_allreduce(local, group, transport=transport))


def train_job(mesh, params: dict, batch: dict, steps: int = 3,
              runs=(("kernels", "dense"),), virtual_shards: int = 8) -> dict:
    """``steps`` sharded ENet steps from ``params`` on ``batch`` per
    ``(backend, transport)`` of ``runs``: per step the metrics, the chunk
    losses and the wall ms; the first step's launches; the final state."""
    dev = mesh.device
    params = {k: torch.from_numpy(np.asarray(v)).to(dev)
              for k, v in params.items()}
    batch = ttr.batch_to(batch, dev)
    out = {}
    for backend, transport in runs:
        step = ttr.make_sharded_train_step(
            "enet", mesh, virtual_shards=virtual_shards,
            grad_transport=transport, backend=backend)
        st = ttr.place_state(mesh, ttr.init_state(params))
        chunks = ttr.shard_batch(mesh, batch, virtual_shards=virtual_shards)
        rec = {"metrics": [], "ms": [], "launches": None}
        for i in range(steps):
            _reset_counts()
            _sync(dev)
            t0 = time.perf_counter()
            st, m = step(st, chunks)
            _sync(dev)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                rec["launches"] = _counts()
            rec["metrics"].append(_cpu(m))
        rec["state"] = _cpu(st)
        out[(backend, transport)] = rec
    return out


def serve_job(mesh, server_kw: dict | None = None, requests=(),
              snapshot=None, restore: str | None = None) -> dict:
    """A drain over the mesh: ``requests`` are ``(workload, steps, seed)``
    submitted to a new server, or ``restore`` names a snapshot directory
    to resume (resharded onto this mesh).  ``snapshot=(tick, dir)`` writes
    a snapshot when the drain reaches that tick.  Returns the images, the
    stats and the drain's wall seconds."""
    dev = mesh.device
    if restore is not None:
        srv = GenServer.restore(restore, mesh=mesh, device=dev)
    else:
        srv = GenServer(mesh=mesh, device=dev, **dict(server_kw or {}))
        for wl, steps, seed in requests:
            srv.submit(wl, steps=steps, seed=seed)
    _reset_counts()
    t0 = time.perf_counter()
    if snapshot is not None:
        tick, directory = snapshot
        while srv._tick < tick:
            srv.step()
        srv.snapshot(directory)
    images = srv.run()
    _sync(dev)
    return {"images": images, "wall_s": time.perf_counter() - t0,
            "launches": _counts(), "ticks": srv._tick,
            "stats": srv.stats()}


JOBS = {"conv": conv_job, "allreduce": allreduce_job, "train": train_job,
        "serve": serve_job}


def run(device, jobs) -> dict:
    """The rank entry: a ``(data,)`` mesh over the process group, then
    each ``(name, keywords)`` of ``jobs``; returns ``{name: result}`` (a
    name repeated gets ``name#i``) and ``"seconds"``, each job's wall."""
    return run_worlds(device, [(None, jobs)])[0]


def run_worlds(device, worlds) -> dict:
    """The rank entry for several worlds in one spawn: ``worlds`` is a
    list of ``(ranks, jobs)``, each a ``(data,)`` mesh over those global
    ranks (``None``: all).  Every rank makes every world's groups first;
    then each rank runs, in list order, the jobs of the worlds it is in,
    so worlds on disjoint ranks run at the same time.  Returns ``{world
    index: {name: result}}`` for this rank's worlds."""
    # fp32 stays fp32 on the card: no TF32 in the torch backend's convs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = []
    for ranks, _ in worlds:
        mesh = live_mesh(None, device, ranks)
        mesh.everyone()
        meshes.append(mesh)
    return {i: _run_jobs(mesh, jobs)
            for i, (mesh, (_, jobs)) in enumerate(zip(meshes, worlds))
            if mesh.rank is not None}


def _run_jobs(mesh, jobs) -> dict:
    out, seconds = {}, {}
    for i, (name, kw) in enumerate(jobs):
        key = name if name not in out else f"{name}#{i}"
        t0 = time.perf_counter()
        out[key] = JOBS[name](mesh, **kw)
        seconds[key] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


__all__ = ["JOBS", "run", "run_worlds", "digest", "conv_job", "allreduce_job",
           "train_job", "serve_job"]
