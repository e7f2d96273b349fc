"""Per-geometry launch-plan autotuning of the port's two conv kernels.

The port of ``repro.kernels.autotune`` (DESIGN.md §7).  The reference tunes
a Pallas tile ``(th, tc)``; here a candidate is a launch plan
(:class:`~repro_torch.kernels.conv2d.ConvPlan`): one of the Cout tiles the
kernel builds, with resident or streamed weights.  The dense kernel
(``csrc/conv2d.cu``) builds tiles 0, 1, 2, 3, 5 and 6 of ``conv2d.TILES``
(no dense instance of the one-group 32-wide tile 4), the transposed kernel
(``csrc/transposed_conv.cu``) tiles 0-4; a plan is resident only where the
weight slab fits (``conv2d.slab_fits``; a chunk's ``k*k`` taps for kernel
2).  The copy width ``vec`` follows the operand's address at launch and is
not tuned.

A key is one kernel launch: ``"dense"`` for kernel 1 (every dense conv,
every phase-batched dilated conv, the dx of the backward passes) or
``"tconv"`` for kernel 2, with the input and weight shapes, stride,
padding, dtype and the epilogue's fingerprint (:func:`make_key`).  The
analytic policy (:mod:`repro_torch.kernels.tiling_policy`) ranks a
geometry's candidates and :func:`tune` times the top :data:`POLICY_TOP`
plus the shape's default plan on the card, and caches the winner in memory
and on disk.

Cache layout and invalidation:

* one JSON file per device name, torch version, CUDA version, kernel
  sources and schema (:func:`cache_path`) — another card, an upgraded
  torch or CUDA, an edited kernel (the hash ``kernels/build.py`` keys its
  libraries by) or a schema bump each start a clean table;
* the directory is ``$REPRO_TORCH_AUTOTUNE_CACHE`` or
  ``~/.cache/repro-torch-autotune``;
* entries map :func:`make_key` strings to ``[tile, resident]``.

:func:`get_plan` is what the launches consult
(``conv2d.launch_plan``, ``transposed_conv.launch_plan``): a hit returns
the tuned plan, a miss the shape's default (``conv_plan`` /
``tconv_plan``) *without timing anything* unless tuning is switched on
(``$REPRO_TORCH_AUTOTUNE=1``), and never times on a CPU tensor.  So with
an empty table every launch takes the plan the shape alone gives.  The
switches keep the reference's meanings under the port's own names, so
setting one package's never moves the other: ``$REPRO_TORCH_AUTOTUNE``
(tune on a miss), ``$REPRO_TORCH_AUTOTUNE_SWEEP`` (time every candidate)
and ``$REPRO_TORCH_AUTOTUNE_CACHE``.  The reference's legacy calibrated
prune (``$REPRO_AUTOTUNE_PRUNE``) has no counterpart: the policy is the
one way candidates are chosen.

A plan can change a launch's bits (its tile sets the order of the
reduction), and a rank's share of a batch is another shape than the whole
batch, which the table may give another plan.  Inside
:func:`whole_batch_plans` a launch of a share's rows looks its plan up as
the launch of the whole batch, so the share's rows carry the bits the
whole batch's launch gives them (the data axis runs its shares there).

A row band of an image (the model axis: each rank convolves its rows
and their halos) is another launch shape too, with other pads.  Inside
:func:`whole_image_plans` a band's launch looks its plan up as the launch
over the whole image, so a band's rows carry the whole image's bits.

A launch's lookup is paid in full once per geometry and process: the
string key is built from the launch's raw arguments the first time, and
later launches of the same arguments read the plan from a dict keyed by
those arguments (:data:`_FAST`).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import pathlib

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import tiling_policy
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.kernels.epilogue import NO_EPILOGUE, fingerprint
from repro_torch.kernels.util import canon_dtype, device_kind, time_call

#: the table's layout version; a bump starts a clean table
_SCHEMA = 1
#: how many analytically ranked candidates tune() times (plus the default)
POLICY_TOP = 3
#: the kernels' launch kinds: kernel 1 and kernel 2
KINDS = ("dense", "tconv")
#: the tiles each kernel builds
DENSE_TILES = (0, 1, 2, 3, 5, 6)
TCONV_TILES = (0, 1, 2, 3, 4)

#: key -> plan, in this process (a miss's default is cached too, so a
#: lookup is paid once, the timing never)
_MEM: dict[str, kconv.ConvPlan] = {}
#: the on-disk table of each cache file read so far
_DISK: dict[pathlib.Path, dict[str, tuple[int, bool]]] = {}
#: a launch's raw arguments -> its plan: what a repeated launch reads
#: (cleared whenever a plan is tuned, so it never outlives a table entry)
_FAST: dict[tuple, kconv.ConvPlan] = {}
#: (share rows, whole rows) of the enclosing whole_batch_plans, innermost
#: last
_WHOLE: list[tuple[int, int]] = []
#: (kind, band launch's x shape past the batch and padding, the whole
#: image's) of the :func:`whole_image_plans` in force, innermost last
_BANDS: list[tuple] = []


def autotune_enabled() -> bool:
    """``$REPRO_TORCH_AUTOTUNE=1``: tune a CUDA launch's geometry on a miss."""
    return os.environ.get("REPRO_TORCH_AUTOTUNE", "").lower() in (
        "1", "true", "on")


@functools.lru_cache(maxsize=1)
def kernel_sources_hash() -> str:
    """The content hash of the two conv kernels' sources and flags (the one
    ``build.library_path`` names their libraries by)."""
    h = hashlib.sha256()
    for name in ("conv2d", "transposed_conv"):
        h.update(build.library_path(name).stem.encode())
    return h.hexdigest()[:16]


def cache_path(device=None) -> pathlib.Path:
    """The table's file for ``device`` (default: this host's card, else the
    CPU): device name, torch and CUDA versions, kernel sources, schema."""
    base = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    root = pathlib.Path(base) if base else (
        pathlib.Path.home() / ".cache" / "repro-torch-autotune")
    cuda = torch.version.cuda or "none"
    return root / (f"{device_kind(device)}-torch{torch.__version__}"
                   f"-cuda{cuda}-src{kernel_sources_hash()}-v{_SCHEMA}.json")


def _dtype(dtype) -> torch.dtype:
    """A torch dtype, or the one a string alias names (``"bf16"``)."""
    return canon_dtype(dtype) if isinstance(dtype, str) else dtype


def _dtype_name(dtype) -> str:
    return str(_dtype(dtype)).removeprefix("torch.")


def make_key(kind: str, x_shape: tuple, w_shape: tuple, *, stride: int = 1,
             dtype=torch.float32, padding=None,
             output_padding: int | None = None, epilogue=None) -> str:
    """Canonical table key of one kernel launch.

    Padding is canonicalised as the kernels take it: a dense launch's
    ``None``, ``"SAME"``, ``"VALID"``, an int or explicit pads become the
    resolved ``(top, bottom, left, right)`` pads, so ``"SAME"`` and the
    pads it resolves to share a key; a transposed launch's ``None`` is
    ``p_lo = (k-1)//2`` and ``output_padding=None`` is 1.  The epilogue
    joins the key through its fingerprint: a fused residual adds a staged
    tile to the plan's shared memory.
    """
    g = tiling_policy.geometry(kind, x_shape, w_shape, stride=stride,
                               padding=padding,
                               output_padding=output_padding)
    if kind == "dense":
        (pt, pb), (pl, pr) = g.pads
        pad, op = f"{pt}.{pb}.{pl}.{pr}", 0
    else:
        pad, op = g.pads[0], g.pads[1] - g.pads[0]
    return (f"{kind}/n{g.n}x{g.h}x{g.w}x{g.cin}/k{g.kh}x{g.kw}x{g.cout}"
            f"/s{stride}/p{pad}/op{op}/{_dtype_name(dtype)}"
            f"/ep{fingerprint(epilogue)}")


def default_plan(kind: str, x_shape: tuple, w_shape: tuple, *,
                 stride: int = 1, dtype=torch.float32) -> kconv.ConvPlan:
    """The plan the shape alone gives (``conv_plan`` / ``tconv_plan``)."""
    dt = _dtype(dtype)
    cin, cout = x_shape[-1], w_shape[-1]
    if kind == "dense":
        return kconv.conv_plan(cin, cout, w_shape[0], w_shape[1], stride, dt)
    if kind == "tconv":
        return ktr.tconv_plan(cin, cout, w_shape[0], dt)
    raise ValueError(f"unknown kernel kind {kind!r}; known: {KINDS}")


def candidates(kind: str, x_shape: tuple, w_shape: tuple, *,
               dtype=torch.float32) -> list[kconv.ConvPlan]:
    """The plans the kernel builds for this launch, narrowest tile first,
    resident before streamed.

    Tiles wider than the narrowest one covering Cout are dropped (they only
    add idle lanes), as the reference drops oversized tiles; a plan is
    resident only where its weights fit ``RESIDENT_BYTES``.
    """
    dt = _dtype(dtype)
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; known: {KINDS}")
    cin, cout = x_shape[-1], w_shape[-1]
    tiles = DENSE_TILES if kind == "dense" else TCONV_TILES
    widths = sorted({kconv.TILES[t][0] for t in tiles})
    cover = next((b for b in widths if b >= cout), widths[-1])
    vec = kconv.copy_vec(cin, dt)
    out = []
    for t in tiles:
        bn = kconv.TILES[t][0]
        if bn > cover:
            continue
        if kind == "dense":
            fits = kconv.slab_fits(w_shape[0] * w_shape[1] * cin, t, dt)
        else:
            fits = (w_shape[0] ** 2 * ktr.CHUNK * bn * dt.itemsize
                    <= kconv.RESIDENT_BYTES)
        out += [kconv.ConvPlan(vec, t, res, dt)
                for res in ((True, False) if fits else (False,))]
    return out


def _load_disk(path: pathlib.Path) -> dict[str, tuple[int, bool]]:
    table = _DISK.get(path)
    if table is None:
        table = {}
        if path.exists():
            try:
                raw = json.loads(path.read_text())
                table = {k: (int(v[0]), bool(v[1]))
                         for k, v in raw.get("entries", {}).items()}
            except (json.JSONDecodeError, OSError, KeyError, TypeError,
                    ValueError):
                table = {}      # corrupt table: retune rather than crash
        _DISK[path] = table
    return table


def _persist(key: str, plan: kconv.ConvPlan, device) -> None:
    path = cache_path(device)
    table = _load_disk(path)
    table[key] = (plan.tile, plan.resident)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"device": device_kind(device),
               "torch_version": torch.__version__,
               "cuda_version": torch.version.cuda,
               "kernel_sources": kernel_sources_hash(), "schema": _SCHEMA,
               "entries": {k: list(v) for k, v in sorted(table.items())}}
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(payload, indent=1))
    tmp.replace(path)           # atomic: a reader sees the old or the new


def clear_memory_cache() -> None:
    """Drop the in-process caches (tests; after moving the cache dir): the
    next lookup reads the table from disk again."""
    _MEM.clear()
    _DISK.clear()
    _FAST.clear()


def _operands(kind, x_shape, w_shape, epilogue, dtype, device):
    """x, w and the epilogue's operands of a timed launch, drawn with numpy
    from seed 0 (the residual has the output's shape)."""
    rng = np.random.default_rng(0)

    def draw(shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(device=device, dtype=dt)

    x, w = draw(x_shape), draw(w_shape)
    spec = NO_EPILOGUE if epilogue is None else epilogue
    cout = w_shape[-1]
    eps = []
    for name in spec.slots:
        if name == "residual":
            g = tiling_policy.geometry(kind, x_shape, w_shape)
            eps.append(draw((x_shape[0], g.oh, g.ow, cout)))
        else:
            eps.append(draw((cout,), torch.float32))
    return x, w, spec, tuple(eps)


def _launcher(kind, x, w, stride, padding, output_padding, spec, eps):
    """``plan -> None``: one launch of the kernel with an explicit plan."""
    g = tiling_policy.geometry(kind, tuple(x.shape), tuple(w.shape),
                               stride=stride, padding=padding,
                               output_padding=output_padding)
    if kind == "dense":
        return lambda plan: kconv.conv2d_cuda(x, w, stride, g.pads, spec,
                                              eps, plan=plan)
    p_lo, p_hi = g.pads
    return lambda plan: ktr.tconv_cuda(x, w, stride, p_lo, p_hi, spec, eps,
                                       plan=plan)


def tune(kind: str, x_shape: tuple, w_shape: tuple, *, stride: int = 1,
         dtype=torch.float32, padding=None,
         output_padding: int | None = None, epilogue=None, iters: int = 3,
         calibration=None, device="cuda",
         timings: dict | None = None) -> kconv.ConvPlan:
    """Time the promising plans of one launch on the card; cache and
    persist the winner, and return it.

    :mod:`repro_torch.kernels.tiling_policy` ranks the candidate grid and
    its top :data:`POLICY_TOP` plus the default plan are timed (device
    time, best of ``iters`` after a warm-up,
    :func:`repro_torch.kernels.util.time_call`);
    ``$REPRO_TORCH_AUTOTUNE_SWEEP=1`` times every candidate.  The default
    plan is always timed, so tuning never picks below it.  A
    :class:`~repro_torch.core.calibrate.Calibration` weighs the policy's
    per-wave term by its fitted dispatch overhead
    (``tiling_policy._cell_weight``).  Deterministic given the timings:
    candidates run in a fixed order, ties keep the earlier one.

    ``timings``, when given, receives ``{plan: seconds}`` of every timed
    plan.  Runs only on CUDA tensors: on a CPU-only host, or for a CPU
    ``device``, it raises (the plain versions are not the kernels).  A plan
    that fails to build or launch raises; it is never skipped.
    """
    from repro_torch.core.calibrate import CaptureCase, modeled_cycles

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"autotune times the CUDA kernels and needs a CUDA device, got "
            f"{dev} (available: {torch.cuda.is_available()})")
    dt = _dtype(dtype)
    key = make_key(kind, x_shape, w_shape, stride=stride, dtype=dt,
                   padding=padding, output_padding=output_padding,
                   epilogue=epilogue)
    default = default_plan(kind, x_shape, w_shape, stride=stride, dtype=dt)
    # the capture case whose modeled cycles price this launch (the table's
    # kinds are the calibration's engine kinds "dense" and "tconv")
    case = CaptureCase(kind, tuple(x_shape), tuple(w_shape), stride=stride)
    cands = tiling_policy.top_candidates(
        kind, x_shape, w_shape, candidates(kind, x_shape, w_shape, dtype=dt),
        top=POLICY_TOP, default_plan=default, stride=stride,
        padding=padding, output_padding=output_padding, dtype=dt,
        epilogue=epilogue, base_cycles=modeled_cycles(case),
        calibration=calibration, card=tiling_policy.card_of(dev))
    if default not in cands:
        cands = [default, *cands]
    x, w, spec, eps = _operands(kind, x_shape, w_shape, epilogue, dt, dev)
    launch = _launcher(kind, x, w, stride, padding, output_padding, spec,
                       eps)
    best, best_t = default, float("inf")
    for plan in cands:
        t = time_call(launch, plan, iters=iters, device=dev,
                      device_only=True)
        if timings is not None:
            timings[plan] = t
        if t < best_t:
            best, best_t = plan, t
    _MEM[key] = best
    _FAST.clear()
    _persist(key, best, dev)
    return best


@contextlib.contextmanager
def whole_batch_plans(share: int, whole: int):
    """Inside, a launch of ``share`` rows takes the plan of the same launch
    at ``whole`` rows (a launch of any other batch keeps its own): a rank
    running its share of a batch gets the plan, and so the bits, of the
    unsharded launch."""
    _WHOLE.append((share, whole))
    try:
        yield
    finally:
        _WHOLE.pop()


@contextlib.contextmanager
def whole_image_plans(kind: str, band_shape: tuple, band_padding,
                      whole_shape: tuple, whole_padding):
    """Inside, a ``kind`` launch on a row band of an image (x of
    ``band_shape`` past its batch, at ``band_padding``: the pads of
    :func:`kernels.conv2d.launch_plan` or the ``p_lo`` of
    :func:`kernels.transposed_conv.launch_plan`) takes the plan of the
    same launch over the whole image (``whole_shape``,
    ``whole_padding``): a rank convolving its band gets the plan, and so
    the bits, of the unsharded launch.  Nests with
    :func:`whole_batch_plans` (the batch is mapped first)."""
    _BANDS.append((kind, tuple(band_shape), _frozen(band_padding),
                   tuple(whole_shape), _frozen(whole_padding)))
    try:
        yield
    finally:
        _BANDS.pop()


def get_plan(kind: str, x_shape: tuple, w_shape: tuple, *, stride: int = 1,
             dtype=torch.float32, padding=None,
             output_padding: int | None = None, epilogue=None,
             device=None) -> kconv.ConvPlan:
    """The plan of one launch: memory -> disk table -> tune or default.

    A miss tunes only when ``$REPRO_TORCH_AUTOTUNE=1`` and the launch is on
    a CUDA ``device``; otherwise it returns the shape's default plan
    without timing anything (and remembers the miss for this process), so
    an empty table changes no launch.  The table of ``device`` (default:
    this host's card) is read once per process, and a repeated launch is
    one dict lookup on its raw arguments.  Inside
    :func:`whole_batch_plans` a share's launch is looked up at the whole
    batch.
    """
    if _WHOLE and x_shape[0] == _WHOLE[-1][0]:
        x_shape = (_WHOLE[-1][1], *x_shape[1:])
    if _BANDS:
        k, band, pad, whole, whole_pad = _BANDS[-1]
        if (k == kind and tuple(x_shape[1:]) == band
                and _frozen(padding) == pad):
            x_shape, padding = (x_shape[0], *whole), whole_pad
    fast = (kind, x_shape, w_shape, stride, dtype, _frozen(padding),
            output_padding, epilogue, device)
    hit = _FAST.get(fast)
    if hit is not None:
        return hit
    key = make_key(kind, x_shape, w_shape, stride=stride, dtype=dtype,
                   padding=padding, output_padding=output_padding,
                   epilogue=epilogue)
    hit = _MEM.get(key)
    if hit is None:
        entry = _load_disk(cache_path(device)).get(key)
        if entry is not None:
            dt = _dtype(dtype)
            hit = kconv.ConvPlan(kconv.copy_vec(x_shape[-1], dt), entry[0],
                                 entry[1], dt)
        elif (autotune_enabled() and device is not None
              and torch.device(device).type == "cuda"):
            hit = tune(kind, x_shape, w_shape, stride=stride, dtype=dtype,
                       padding=padding, output_padding=output_padding,
                       epilogue=epilogue, device=device)
        else:
            hit = default_plan(kind, x_shape, w_shape, stride=stride,
                               dtype=dtype)
        _MEM[key] = hit
    _FAST[fast] = hit
    return hit


def _frozen(padding):
    """``padding`` as a dict key: explicit pads given as lists become
    tuples."""
    if isinstance(padding, (list, tuple)):
        return tuple(_frozen(p) for p in padding)
    return padding


__all__ = ["KINDS", "POLICY_TOP", "DENSE_TILES", "TCONV_TILES", "get_plan",
           "whole_batch_plans", "whole_image_plans",
           "tune", "make_key", "candidates", "default_plan", "cache_path",
           "clear_memory_cache", "autotune_enabled", "kernel_sources_hash"]
