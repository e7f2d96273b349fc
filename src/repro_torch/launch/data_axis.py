"""What each rank runs on the data and model axes (DESIGN.md §13): the rank
programs of the CPU tests and of ``chip_smoke.py`` phases 33-35.

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
  tokens and the bytes each rank holds;
* ``"train_lm"``: LM train steps over the mesh
  (``steps.make_train_step(mesh=)``) or unmeshed, their metrics, the
  launches by part (:func:`count_parts`), what the gathers moved, the
  state gathered whole, a checkpoint saved or restored, and a run held to
  one an earlier world kept in this process (:func:`train_lm_job`);
* ``"train_loop"``: :func:`repro_torch.launch.train.train` over the mesh,
  with an injected fault;
* ``"adjoint"``: the adjoint identities of training's collectives;
* ``"init"``: a sharded draw of the LM state, its peak live bytes beside
  those of the whole draw cut afterwards, and its bits against them.

The worlds of :func:`run_worlds` may be ``(data, model)`` meshes: the
model axis of ``shard_conv2d(spatial=True)``, ``GenServer(spatial=True)``,
the LM server (the CPU tests' and ``chip_smoke.py`` phase 34's) and LM
training (phase 35's).

Each job reads the kernel wrappers' launch counters around its main call
(they count CUDA launches only).

  from repro_torch.launch.mesh import launch
  outs = launch(data_axis.run, 4, device="cpu",
                args=([("conv", {"cases": [...]})],))
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

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
    """sha256 of a tensor's bytes: equal digests, equal bits (bf16 through
    its 16-bit words)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().data).hexdigest()


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


#: :func:`count_parts`' open bodies, innermost last: ``[part, ...]``
_OPEN: list = []


def _part_now() -> str:
    """The part a launch made now belongs to (:func:`count_parts`)."""
    return _OPEN[-1][0] if _OPEN else "forward"


@contextlib.contextmanager
def _lm_calls():
    """Records every launch of kernels 3 and 4 under it as ``(name, shapes,
    dtype, causal, window, part)`` (the CUDA launchers; on the CPU their
    plain versions; ``part`` as :func:`count_parts` splits them, or
    ``"forward"`` outside it)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm

    calls = []
    saved = (kmm.matmul_cuda, kmm.matmul_plain, kfa.flash_attention_cuda,
             kfa.attention_plain)

    def mm(fn):
        def call(a, b):
            calls.append(("matmul", (tuple(a.shape), tuple(b.shape)),
                          str(a.dtype), None, 0, _part_now()))
            return fn(a, b)
        return call

    def fa(fn, plain):
        def call(q, k, v, causal=True, window=0):
            calls.append(("flash_attention", (tuple(q.shape),
                                              tuple(k.shape)),
                          str(q.dtype), causal, window, _part_now()))
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


@contextlib.contextmanager
def count_parts(parts: dict, read):
    """Split the launches made inside the block by part, from the counts
    ``read()`` gives (``{"matmul": n, "flash_attention": n}``) on entry to
    and exit from the backward pass (the outermost ``torch.autograd.
    grad``) and each forward and backward body of ``MatmulFn``,
    ``BatchedMatmulFn`` and ``FlashAttentionFn``.  A launch is the
    innermost body's: ``backward`` in a Function's backward body;
    ``recompute`` in a forward body inside the backward pass (a
    checkpointed forward run again, which a backward body's read of its
    saved tensors starts); ``forward`` outside the backward pass.  Fills
    ``parts[name][part]`` when the block ends."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm

    start = read()
    own = {p: dict.fromkeys(start, 0)
           for p in ("forward", "recompute", "backward")}
    # open bodies: [part, counts on entry, launches of nested bodies]
    stack = _OPEN
    fns = [(torch.autograd, "grad", "grad")] + [
        (cls, kind, kind) for cls in (kmm.MatmulFn, kfa.FlashAttentionFn,
                                      kmm.BatchedMatmulFn)
        for kind in ("forward", "backward")]
    orig = [getattr(owner, attr) for owner, attr, _ in fns]

    def body(kind, fn):
        def wrapper(*args, **kw):
            in_grad = any(f[0] != "forward" for f in stack)
            part = ("backward" if kind == "backward" else "recompute"
                    if kind == "grad" or in_grad else "forward")
            stack.append([part, read(), dict.fromkeys(start, 0)])
            try:
                return fn(*args, **kw)
            finally:
                part, entry, nested = stack.pop()
                for n, c in read().items():
                    total = c - entry[n]
                    own[part][n] += total - nested[n]
                    if stack:
                        stack[-1][2][n] += total
        return wrapper

    for (owner, attr, kind), fn in zip(fns, orig):
        wrapped = body(kind, fn)
        setattr(owner, attr, wrapped if owner is torch.autograd
                else staticmethod(wrapped))
    try:
        yield
    finally:
        for (owner, attr, _), fn in zip(fns, orig):
            setattr(owner, attr, fn if owner is torch.autograd
                    else staticmethod(fn))
    outside = {n: c - start[n] - sum(o[n] for o in own.values())
               for n, c in read().items()}
    for n in start:
        parts[n] = {"forward": own["forward"][n] + outside[n],
                    "recompute": own["recompute"][n],
                    "backward": own["backward"][n]}


@contextlib.contextmanager
def first_grads(store: dict):
    """Keep in ``store`` the gradients the first train step made inside
    the block hands AdamW (``steps.adamw_update``'s first argument)."""
    from repro_torch.launch import steps

    orig = steps.adamw_update

    def update(grads, *args, **kw):
        if not store:
            store.update(grads)
        return orig(grads, *args, **kw)

    steps.adamw_update = update
    try:
        yield
    finally:
        steps.adamw_update = orig


@contextlib.contextmanager
def _timing_collectives(dev):
    """Times every ``torch.distributed.all_gather`` under it (the port's
    collectives all run on it): ``calls``, ``bytes`` this rank received,
    ``seconds`` inside the call and, on a card, ``wait_seconds`` spent
    first in a synchronize (the device work queued before the call, which
    gloo's copy of a CUDA tensor would otherwise wait for inside it)."""
    import torch.distributed as dist

    stats = {"calls": 0, "bytes": 0, "seconds": 0.0, "wait_seconds": 0.0}
    orig = dist.all_gather

    def timed(parts, t, *args, **kw):
        t0 = time.perf_counter()
        _sync(dev)
        t1 = time.perf_counter()
        try:
            return orig(parts, t, *args, **kw)
        finally:
            stats["calls"] += 1
            stats["bytes"] += (len(parts) - 1) * t.numel() * t.element_size()
            stats["wait_seconds"] += t1 - t0
            stats["seconds"] += time.perf_counter() - t1

    dist.all_gather = timed
    try:
        yield stats
    finally:
        dist.all_gather = orig


#: what a job keeps in this rank's process for a later world's job on the
#: same global rank (``train_lm_job``'s ``keep`` and ``hold``/``restore``)
_KEPT: dict = {}


def _held_parts(grads: dict, want: dict, tp) -> dict:
    """Per leaf of ``want`` (whole reference gradients, on the host): this
    rank's block of it against this rank's ``grads`` block, as the parts
    that add up over the ranks: (sum of squared differences, sum of
    squares of the reference, largest difference, largest |reference|).
    Every element of a leaf lies on equally many ranks, so the ranks'
    sums give the whole leaf's relative L2 exactly."""
    from repro_torch.distributed.sharding import NamedSharding

    out = {}
    for k, w in want.items():
        g = grads[k]
        if tp is not None:
            w = NamedSharding(tp.mesh, tp.specs[k]).shard(w)
        w = w.to(g.device).double()
        d = g.double() - w
        out[k] = (float(torch.sum(d * d)), float(torch.sum(w * w)),
                  float(d.abs().max()), float(w.abs().max()))
    return out


def held(parts: list) -> dict:
    """Per leaf, from every rank's :func:`_held_parts`: (relative L2, the
    largest error over max(1, max|reference|))."""
    out = {}
    for k in parts[0]:
        num, den, err, top = (sum(p[k][i] for p in parts) if i < 2 else
                              max(p[k][i] for p in parts) for i in range(4))
        out[k] = ((num / max(den, 1e-300)) ** 0.5, err / max(1.0, top))
    return out


def train_lm_job(mesh, arch: str, *, reduced: bool = True,
                 overrides: dict | None = None, params=None, seed: int = 0,
                 batches=(), microbatches: int = 1, warmup: int = 2,
                 total_steps: int = 10, unmeshed: bool = False,
                 whole: bool = False, grads: bool = False,
                 keep: str | None = None, hold: str | None = None,
                 save: str | None = None, expect=(),
                 restore: str | None = None, grads_only: bool = False,
                 device=None) -> dict:
    """``len(batches)`` LM train steps of ``arch`` (``overrides`` replace
    config fields: ``dtype``, ``num_layers``, ``remat``) over ``mesh``
    (``steps.make_train_step(mesh=)``; with ``unmeshed`` or a ``mesh`` of
    ``None``, the one-device step on the rank's device or ``device``), on
    the global ``batches`` (numpy ``tokens``, ``labels``, ``mask``, the
    same on every rank), from the reference's ``params`` tree (numpy) or a
    draw from ``seed`` on the device, or from the newest checkpoint under
    ``restore``.

    Returns per step the metrics, the wall ms and what the collectives
    moved and took (``metrics``, ``ms``, ``collectives``); the kernels'
    launches over the first step (``launches``: the wrappers' counters,
    CUDA launches only) and, by part, every launch of kernels 3 and 4
    through its CUDA launcher or its plain version (``parts``,
    :func:`count_parts`) with their shapes (``calls``); per parameter and
    AdamW-moment leaf the elements this rank holds, the whole leaf's and
    its spec (``leaves``); the bytes of parameters plus AdamW state this
    rank holds and the whole's (``state_bytes``).  On mesh rank 0:
    ``whole``, the parameters after each step and the final AdamW state
    gathered whole (``params``, ``opt``); ``grads``, the first step's
    gradients gathered whole (``grads``).

    ``keep``: keep the first step's whole gradients (on the host) and the
    metrics in this rank's process under that key (an unmeshed run, on
    every rank of its world; with ``grads_only``, the first batch's loss
    and gradients alone, ``steps.make_value_and_grad``, no AdamW state);
    ``hold``: this rank's blocks of the first
    step's gradients against the kept ones, as the parts :func:`held`
    adds up over the ranks (``held``).  ``save``: after the last step,
    gather the state whole onto rank 0, which writes a checkpoint there
    at the step reached and keeps, for each mesh shape of ``expect``, the
    digest of every rank's block of every leaf under ``(save, shape)``.
    ``restore``: start from that directory's newest checkpoint, restored
    into this mesh's blocks: each rank returns the digests of its blocks
    (``digests``, in the state's leaf order) and mesh rank 0 the kept ones
    for this mesh's shape where this process has them (``expected``,
    one list a mesh rank); with ``whole``, rank 0 also the saved and the
    restored state gathered whole (``saved``, ``restored``)."""
    from repro_torch.checkpoint.ckpt import (flatten_tree, latest_step,
                                             restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.train import init_state
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init

    dev = torch.device(device) if mesh is None else mesh.device
    cfg = (get_reduced if reduced else get_config)(arch)
    cfg = cfg.replace(**dict(overrides or {}))
    if grads_only:
        params = (transformer.load_jax_params(params, cfg, device=dev)
                  if params is not None else transformer.init_params(
                      torch.Generator(dev).manual_seed(seed), cfg, dev))
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in batches[0].items()}
        loss, g = lsteps.make_value_and_grad(
            cfg, microbatches=microbatches)(params, batch)
        _KEPT[keep] = {"grads": {k: v.detach().cpu() for k, v in g.items()},
                       "metrics": [{"loss": float(loss)}]}
        return {"metrics": _KEPT[keep]["metrics"]}
    on = None if unmeshed else mesh
    step = lsteps.make_train_step(cfg, warmup=warmup,
                                  total_steps=total_steps,
                                  microbatches=microbatches, mesh=on)
    tp = step.tp
    lead = tp is None or mesh.rank == 0
    out = {"metrics": [], "ms": [], "collectives": []}
    abstract = init_state(cfg, None, "meta")
    if restore is not None:
        s0 = latest_step(restore)
        state = restore_checkpoint(
            restore, s0, abstract, device=dev,
            shardings=None if tp is None else tp.shardings(abstract))
        out["restored_step"] = s0
        out["digests"] = [digest(t) for t in flatten_tree(state)[0]]
        shape = None if tp is None else tuple(mesh.shape.values())
        if lead and (restore, shape) in _KEPT:
            out["expected"] = _KEPT[(restore, shape)]
        if whole:
            w = state if tp is None else tp.unshard(state)
            if lead:
                out["restored"] = _cpu(w)
            del w
        params, opt = state
    elif params is not None:
        params = transformer.load_jax_params(params, cfg, device=dev)
        if tp is not None:
            params = lsteps.shard_params(tp, params)
        opt = adamw_init(transformer.flatten_params(params),
                         memory_mode=cfg.opt_memory_mode)
    else:
        params, opt = init_state(cfg, torch.Generator(dev).manual_seed(seed),
                                 dev, tp)
    flat = transformer.flatten_params(params)
    like = transformer.flatten_params(abstract[0])
    out["leaves"] = {
        f"{part}{k}": (t.numel(), like[k].numel(),
                       None if tp is None else tuple(tp.specs[k]))
        for part, tree in (("", flat), ("mu.", opt.mu))
        for k, t in tree.items()}
    out["state_bytes"] = tuple(
        sum(t.numel() * t.element_size() for t in flatten_tree(tree)[0])
        for tree in ((params, opt), abstract))
    counters = (kmm.matmul, kfa.flash_attention)
    first: dict = {}
    out["params"] = []
    for i, b in enumerate(batches):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in b.items()}
        for c in counters:
            c.launches = 0
        parts: dict = {}
        with _lm_calls() as calls, first_grads(first if i == 0 else {}):
            def read():
                n = {"matmul": 0, "flash_attention": 0}
                for c in calls:
                    n[c[0]] += 1
                return n

            _sync(dev)
            t0 = time.perf_counter()
            with count_parts(parts, read), _timing_collectives(dev) as coll:
                params, opt, m = step(params, opt, batch)
            _sync(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["collectives"].append(coll)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["launches"] = {c.__name__: c.launches for c in counters}
            out["parts"] = parts
            out["calls"] = list(calls)
            if keep:
                _KEPT[keep] = {"grads": {k: v.detach().cpu()
                                         for k, v in first.items()}}
            if hold:
                out["held"] = _held_parts(first, _KEPT[hold]["grads"], tp)
            if grads:
                g = first if tp is None else tp.unshard(first)
                if lead:
                    out["grads"] = _cpu(g)
                del g
            first.clear()
        if whole:
            w = params if tp is None else tp.unshard(params)
            if lead:
                out["params"].append(_cpu(w))
            del w
    if whole:
        o = opt if tp is None else tp.unshard(opt)
        if lead:
            out["opt"] = _cpu(o)
        del o
    if keep:
        _KEPT[keep]["metrics"] = out["metrics"]
    if save is not None:
        state = (params, opt) if tp is None else tp.unshard((params, opt))
        if lead:
            state = _cpu(state)
            save_checkpoint(save, int(opt.step), state)
            leaves = flatten_tree(state)[0]
            for shape in expect:
                geo = mesh_of(shape, ("data", "model"))
                specs = flatten_tree(tree_shardings(geo, state))[0]
                cut = [(r, t, sh) for r in range(geo.size)
                       for t, sh in zip(leaves, specs)]
                # hashlib and the copies release the GIL: one thread a core
                with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
                    got = list(pool.map(
                        lambda c: digest(c[2].shard(c[1], rank=c[0])), cut))
                _KEPT[(save, tuple(shape))] = [
                    got[r * len(leaves):(r + 1) * len(leaves)]
                    for r in range(geo.size)]
            if whole:
                out["saved"] = state
        del state
        if tp is not None:
            torch.distributed.barrier(group=mesh.everyone())
    return out


def train_loop_job(mesh, arch: str, *, reduced: bool = True,
                   overrides: dict | None = None, ckpt_dir: str,
                   fail_at=(), **loop) -> dict:
    """:func:`repro_torch.launch.train.train` of ``arch`` over ``mesh``
    with ``ckpt_dir``, a ``FailureInjector`` firing at the steps of
    ``fail_at`` on this rank (every rank of a world gets the same), and
    ``loop``'s keywords (``steps``, ``global_batch``, ...): the loop's
    metrics, and on mesh rank 0 the newest checkpoint's state."""
    from repro_torch.checkpoint.ckpt import latest_step, restore_checkpoint
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.distributed.fault_tolerance import FailureInjector
    from repro_torch.launch import train

    cfg = (get_reduced if reduced else get_config)(arch)
    cfg = cfg.replace(**dict(overrides or {}))
    out = {"metrics": train.train(
        cfg, mesh=mesh, ckpt_dir=ckpt_dir,
        injector=FailureInjector(set(fail_at)) if fail_at else None,
        **loop)}
    if mesh.rank == 0:
        out["state"] = restore_checkpoint(
            ckpt_dir, latest_step(ckpt_dir),
            train.init_state(cfg, None, "meta"))
    return out


def adjoint_job(mesh, shape, seed: int = 0) -> dict:
    """For each of training's collectives, on seeded tensors of ``shape``:
    this rank's terms of <A x, y> and of <x, A^T y> (``y``'s backward),
    in fp64.  A tensor replicated over ``model`` (the output of
    ``sum_partials``, the input of ``copy_in``) is one vector of its
    space, not one a rank: it is drawn from the data coordinate alone and
    its inner product counted on model rank 0 only.  ``fsdp_gather`` over
    ``data`` (on dim 1) maps each rank's block to a copy of the whole on
    every rank (each with its own cotangent: its own rows' gradient)."""
    from repro_torch.distributed.collectives import (copy_in, fsdp_gather,
                                                     sum_partials)

    data = mesh.coords.get("data", 0)
    first = mesh.coords.get("model", 0) == 0

    def draw(tag, like, replicated):
        g = torch.Generator().manual_seed(
            seed + 97 * tag + 1000 * (data if replicated else mesh.rank + 7))
        return torch.randn(like, generator=g, dtype=torch.float64)

    cases = {"fsdp_gather": (lambda t: fsdp_gather(t, 1, shd.data_group(mesh)),
                             False, False),
             "sum_partials": (lambda t: sum_partials(t, shd.model_group(mesh)),
                              False, True),
             "copy_in": (lambda t: copy_in(t, shd.model_group(mesh)),
                         True, False)}
    out = {}
    for tag, (name, (fn, x_rep, y_rep)) in enumerate(cases.items()):
        x = draw(2 * tag, shape, x_rep).requires_grad_()
        ax = fn(x)
        y = draw(2 * tag + 1, ax.shape, y_rep)
        (aty,) = torch.autograd.grad(ax, x, y)
        out[name] = (float(torch.sum(ax * y)) if first or not y_rep else 0.0,
                     float(torch.sum(x * aty)) if first or not x_rep else 0.0)
    return out


class LiveBytes(TorchDispatchMode):
    """The most bytes of tensor storage made under it and alive at once
    (``peak``): each storage an op returns, seen for the first time,
    counts from then until it is freed."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen: set[int] = set()

    def _freed(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            if id(s) in self._seen:
                continue
            self._seen.add(id(s))
            self.live += s.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._freed, id(s), s.nbytes())
        return out


def init_job(mesh, arch: str, *, reduced: bool = True,
             overrides: dict | None = None, seed: int = 0) -> dict:
    """``launch.train.init_state`` of ``arch`` over ``mesh`` from ``seed``
    (each leaf cut to this rank's block as it is drawn) and, for contrast,
    the whole parameters drawn, then cut (``ModelParallel.place``) and
    given their AdamW state: each one's peak live bytes
    (:class:`LiveBytes`; ``peak``, ``peak_whole``), the bytes of the state
    kept (``kept``), and whether the two draws give the same bits
    (``bitwise``)."""
    from repro_torch.checkpoint.ckpt import flatten_tree
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.train import init_state
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init

    cfg = (get_reduced if reduced else get_config)(arch)
    cfg = cfg.replace(**dict(overrides or {}))
    tp = lsteps.model_parallel(cfg, mesh)

    def gen():
        return torch.Generator(mesh.device).manual_seed(seed)

    with LiveBytes() as cut:
        state = init_state(cfg, gen(), mesh.device, tp)
    with LiveBytes() as after:
        blocks = tp.place(transformer.flatten_params(
            transformer.init_params(gen(), cfg, mesh.device)))
        opt = adamw_init(blocks, memory_mode=cfg.opt_memory_mode)
    del opt
    kept = transformer.flatten_params(state[0])
    return {"peak": cut.peak, "peak_whole": after.peak,
            "kept": sum(t.numel() * t.element_size()
                        for t in flatten_tree(state)[0]),
            "bitwise": all(digest(kept[k]) == digest(t)
                           for k, t in blocks.items())}


JOBS = {"conv": conv_job, "halo": halo_job, "allreduce": allreduce_job,
        "train": train_job, "serve": serve_job, "lm": lm_job,
        "train_lm": train_lm_job, "train_loop": train_loop_job,
        "adjoint": adjoint_job, "init": init_job}


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
        if mesh.device.type == "cuda":
            # the ranks share one card: a job's cached blocks go back
            torch.cuda.empty_cache()
    out["seconds"] = seconds
    return out


__all__ = ["JOBS", "run", "run_worlds", "digest", "held", "conv_job",
           "allreduce_job",
           "train_job", "serve_job", "lm_job", "halo_job", "train_lm_job",
           "train_loop_job", "adjoint_job", "count_parts", "first_grads"]
