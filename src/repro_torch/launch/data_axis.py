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
  over the mesh, with a snapshot at a tick or from a restored snapshot;
* ``"lm"``: an LM :class:`repro_torch.launch.serve.Server` over the
  mesh's model axis (tensor parallelism and FSDP): a prefill's logits and
  each layer's output, greedy decode steps' logits, ``Server.generate``'s
  tokens and the bytes each rank holds.

The worlds of :func:`run_worlds` may be ``(data, model)`` meshes: the
model axis of ``shard_conv2d(spatial=True)``, ``GenServer(spatial=True)``
and the LM server (the CPU tests' and ``chip_smoke.py`` phase 34's).

Each job reads the kernel wrappers' launch counters around its main call
(they count CUDA launches only).

  from repro_torch.launch.mesh import launch
  outs = launch(data_axis.run, 4, device="cpu",
                args=([("conv", {"cases": [...]})],))
"""

from __future__ import annotations

import contextlib
import hashlib
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.decompose import conv2d
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import HALO_STATS, reset_halo_stats
from repro_torch.distributed.compression import mesh_allreduce
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.launch import train_recipes as ttr
from repro_torch.launch.mesh import live_mesh, mesh_of
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
    """Per case ``(label, x shape, w shape, conv keywords)`` (with
    ``spatial=True`` among them, the rows over the model axis): the
    sharded forward, its gradients of ``sum(out)``, the launches of the
    sharded forward, the batch of each torch-backend conv in it
    (``conv_rows``), the x shape of each kernel launch (``launch_rows``),
    what the halo exchanges moved (``halos``) and digests; on mesh rank 0
    (every rank with ``tensors``) the
    unsharded call's output and gradients beside them.  The gathered
    output and the reduced gradients are the same on every rank, so the
    digests carry rank 0's comparison to the others.  ``tensors=False``
    keeps only the digests and errors."""
    dev = mesh.device
    out = {}
    for i, (label, xs, ws, kw) in enumerate(cases):
        kw = dict(kw)
        spatial = kw.pop("spatial", False)
        rng = np.random.default_rng(seed + i)
        x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32))
        x = x.to(dev)
        w = torch.from_numpy(rng.standard_normal(ws, dtype=np.float32))
        w = w.to(dev)
        _reset_counts()
        reset_halo_stats()
        with torch.no_grad(), _ConvRows() as rows, _launch_shapes() as shp:
            y = shd.shard_conv2d(mesh, x, w, spatial=spatial, **kw)
        _sync(dev)
        launches, halos = _counts(), dict(HALO_STATS)
        _, dx, dw = shd.shard_conv2d(mesh, x, w, spatial=spatial,
                                     with_grads=True, **kw)
        res = {"launches": launches, "conv_rows": rows.rows,
               "launch_rows": shp, "halos": halos,
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


@contextlib.contextmanager
def _launch_shapes():
    """Records the x shape of every launch of kernels 1 and 2 under it
    (the CUDA launchers; on the CPU their plain versions)."""
    shapes = []
    saved = (kconv.conv2d_cuda, kconv.conv2d_plain, ktr.tconv_cuda,
             ktr.tconv_plain)

    def wrap(fn, kind):
        def call(x, *a, **k):
            shapes.append((kind, tuple(x.shape)))
            return fn(x, *a, **k)
        return call

    kconv.conv2d_cuda = wrap(saved[0], "conv2d")
    kconv.conv2d_plain = wrap(saved[1], "conv2d")
    ktr.tconv_cuda = wrap(saved[2], "transposed_conv2d")
    ktr.tconv_plain = wrap(saved[3], "transposed_conv2d")
    try:
        yield shapes
    finally:
        (kconv.conv2d_cuda, kconv.conv2d_plain, ktr.tconv_cuda,
         ktr.tconv_plain) = saved


def halo_job(mesh, shape, h_lo: int, h_hi: int, seed: int = 0) -> dict:
    """:func:`repro_torch.distributed.collectives.exchange_halos` over the
    model axis on this rank's band of a seeded (N, H, W) tensor (the same
    on every rank), and its adjoint on a seeded cotangent of the extended
    band: the extended band, the halo rows received, the band's gradient
    and what each pass moved (:data:`HALO_STATS`)."""
    from repro_torch.distributed.collectives import exchange_halos

    rng = np.random.default_rng(seed)
    whole = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    rows = shd.model_group(mesh)
    band = whole[:, shd.share(shape[1], rows)].to(mesh.device)
    band.requires_grad_()
    reset_halo_stats()
    with torch.enable_grad():
        ext, n_lo, n_hi = exchange_halos(band, h_lo, h_hi, rows)
        fwd = dict(HALO_STATS)
        g = torch.from_numpy(np.random.default_rng(seed + 1 + mesh.rank)
                             .standard_normal(tuple(ext.shape),
                                              dtype=np.float32))
        reset_halo_stats()
        (grad,) = torch.autograd.grad(ext, band, g.to(ext.device))
    return _cpu({"ext": ext.detach(), "n_lo": n_lo, "n_hi": n_hi,
                 "cotangent": g, "grad": grad, "forward": fwd,
                 "adjoint": dict(HALO_STATS)})


@contextlib.contextmanager
def _lm_calls():
    """Records every launch of kernels 3 and 4 under it as ``(name, shapes,
    dtype, causal, window)`` (the CUDA launchers; on the CPU their plain
    versions)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm

    calls = []
    saved = (kmm.matmul_cuda, kmm.matmul_plain, kfa.flash_attention_cuda,
             kfa.attention_plain)

    def mm(fn):
        def call(a, b):
            calls.append(("matmul", (tuple(a.shape), tuple(b.shape)),
                          str(a.dtype), None, 0))
            return fn(a, b)
        return call

    def fa(fn, plain):
        def call(q, k, v, causal=True, window=0):
            calls.append(("flash_attention", (tuple(q.shape),
                                              tuple(k.shape)),
                          str(q.dtype), causal, window))
            return (fn(q, k, v, causal=causal, window=window) if plain
                    else fn(q, k, v, causal, window))
        return call

    kmm.matmul_cuda, kmm.matmul_plain = mm(saved[0]), mm(saved[1])
    kfa.flash_attention_cuda = fa(saved[2], False)
    kfa.attention_plain = fa(saved[3], True)
    try:
        yield calls
    finally:
        (kmm.matmul_cuda, kmm.matmul_plain, kfa.flash_attention_cuda,
         kfa.attention_plain) = saved


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
    stats, the drain's wall seconds, the distinct x shapes of its kernel
    launches (``launch_rows``) and what its halo exchanges moved."""
    dev = mesh.device
    if restore is not None:
        srv = GenServer.restore(restore, mesh=mesh, device=dev)
    else:
        srv = GenServer(mesh=mesh, device=dev, **dict(server_kw or {}))
        for wl, steps, seed in requests:
            srv.submit(wl, steps=steps, seed=seed)
    _reset_counts()
    reset_halo_stats()
    t0 = time.perf_counter()
    with _launch_shapes() as shapes:
        if snapshot is not None:
            tick, directory = snapshot
            while srv._tick < tick:
                srv.step()
            srv.snapshot(directory)
        images = srv.run()
        _sync(dev)
    return {"images": images, "wall_s": time.perf_counter() - t0,
            "launches": _counts(), "ticks": srv._tick,
            "stats": srv.stats(), "launch_rows": sorted(set(shapes)),
            "halos": dict(HALO_STATS)}


def lm_job(mesh, arch: str, *, reduced: bool = True, dtype=None,
           layers: int | None = None, params=None, seed: int = 0,
           prompts=None, decode: int = 4, gen: int = 4,
           full_logits: bool = True, forced=None, device=None) -> dict:
    """The LM server of ``arch`` over ``mesh`` (``None``: one unmeshed
    process on ``device``), on the reference's ``params`` tree (numpy)
    or a draw from ``seed`` on the device; ``dtype`` and ``layers`` (a cut
    depth; widths kept) replace the config's.  On the ``prompts`` (B, S)
    int32: the prefill's logits (all positions, or with ``full_logits``
    false the last) and each layer's output, then ``decode`` greedy
    steps' logits (B, 1, V) (on ``forced`` (decode, B, 1) tokens where
    given, else greedy; ``decode_tokens`` are those fed), each gathered to
    the whole batch; the wall ms of the prefill and of each decode step;
    the launches of kernels 3 and 4 over them (``launches``) and the
    shapes of the prefill's and the first decode step's (``calls``);
    ``Server.generate(prompts, gen)``'s tokens; per leaf the elements this
    rank holds and the whole leaf's (``leaves``), and the bytes
    (``param_bytes``)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer

    dev = torch.device(device) if mesh is None else mesh.device
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    prompts = np.asarray(prompts, np.int32)
    b, s = prompts.shape
    max_len = s + max(decode, gen) + 1
    if params is not None:
        params = transformer.load_jax_params(params, cfg, device=dev)
    srv = Server(cfg, max_len=max_len, device=dev, params=params, mesh=mesh,
                 generator=torch.Generator(dev).manual_seed(seed))
    del params
    tp = srv.tp
    rows = slice(0, b) if tp is None else tp.batch_rows(b)

    def whole(t):
        return t if tp is None else tp.gather_batch(t.contiguous(), b)

    toks = torch.from_numpy(prompts).to(dev)[rows]
    caches = transformer.init_caches(
        cfg, toks.shape[0], max_len, dev,
        kv_heads=None if tp is None else tp.kv_heads())
    out = {"decode": [], "decode_ms": [], "calls": ([], [])}
    counters = (kmm.matmul, kfa.flash_attention)
    for c in counters:
        c.launches = 0
    with torch.no_grad(), _lm_calls() as calls:
        layer_out: list = []
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = transformer.decode_step(
            srv.params, toks, caches, 0, cfg, tp=tp, last=not full_logits,
            record=layer_out)
        _sync(dev)
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        first = len(calls)
        out["prefill"] = _cpu(whole(logits))
        out["layers"] = [_cpu(whole(x)) for x in layer_out]
        del layer_out
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        fed = []
        for i in range(decode):
            if forced is not None:
                tok = torch.from_numpy(np.asarray(forced[i], np.int64)).to(
                    dev)[rows]
            fed.append(whole(tok).cpu().numpy().astype(np.int32))
            _sync(dev)
            t0 = time.perf_counter()
            logits, caches = transformer.decode_step(
                srv.params, tok.to(torch.int32), caches, s + i, cfg, tp=tp)
            _sync(dev)
            out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
            out["decode"].append(_cpu(whole(logits)))
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            if i == 0:
                out["calls"] = (calls[:first], calls[first:])
        out["launches"] = {c.__name__: c.launches for c in counters}
        del caches
        out["decode_tokens"] = fed
        out["tokens"] = srv.generate(prompts, gen)
    flat = transformer.flatten_params(srv.params)
    like = transformer.flatten_params(transformer.init_params(
        None, cfg, device="meta"))
    out["leaves"] = {k: (flat[k].numel(), like[k].numel(),
                         None if tp is None else tuple(tp.specs[k]))
                     for k in like}
    out["param_bytes"] = srv.param_bytes()
    return out


JOBS = {"conv": conv_job, "halo": halo_job, "allreduce": allreduce_job,
        "train": train_job, "serve": serve_job, "lm": lm_job}


def run(device, jobs) -> dict:
    """The rank entry: a ``(data,)`` mesh over the process group, then
    each ``(name, keywords)`` of ``jobs``; returns ``{name: result}`` (a
    name repeated gets ``name#i``) and ``"seconds"``, each job's wall."""
    return run_worlds(device, [(None, jobs)])[0]


def run_worlds(device, worlds) -> dict:
    """The rank entry for several worlds in one spawn: ``worlds`` is a
    list of ``(ranks, jobs)`` or ``(ranks, jobs, shape)``, each a mesh over
    those global ranks (``None``: all): ``(data,)``, or with ``shape`` a
    ``(data, model)`` mesh of that shape.  Every rank makes every world's
    groups first; then each rank runs, in list order, the jobs of the
    worlds it is in, so worlds on disjoint ranks run at the same time.
    Returns ``{world index: {name: result}}`` for this rank's worlds."""
    # fp32 stays fp32 on the card: no TF32 in the torch backend's convs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = []
    for ranks, _, *shape in worlds:
        geometry = (mesh_of(shape[0], ("data", "model")) if shape
                    else None)
        mesh = live_mesh(geometry, device, ranks)
        shd.make_groups(mesh)
        meshes.append(mesh)
    return {i: _run_jobs(mesh, world[1])
            for i, (mesh, world) in enumerate(zip(meshes, worlds))
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
           "train_job", "serve_job", "lm_job", "halo_job"]
