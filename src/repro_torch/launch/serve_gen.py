"""Generative serving loop of the port: continuous-batching sampling of the
U-Net denoiser and DCGAN through the decomposition engine (DESIGN.md §9).

The port of ``repro.launch.serve_gen``.  Requests arrive as ``(workload,
steps, seed, slo)`` and are packed into per-workload device batches
(*lanes*).  A diffusion lane runs mixed-timestep DDIM steps over the
denoiser: each scheduler tick is one dispatch of ``scan_steps`` DDIM steps
(:func:`repro_torch.launch.steps.make_gen_scan_step`, a Python loop where
the reference runs ``lax.scan``), with per-slot trajectories padded into
``(B, K)`` timestep matrices, so requests at different timesteps and with
different step budgets share one batch.  With ``backend="kernels"`` on the
card every conv of a substep runs on the two hand-written conv kernels (11
dense and 3 transposed launches a substep at any width); ``"torch"``
composes ``F.conv2d`` (the reference's ``"xla"`` rung).  A DCGAN lane runs
the generator once per tick and completes every active slot.

The scheduler is the reference's: SLO classes (:class:`SLOClass`) order
admission by ``(aged, rank, deadline, arrival)``; a request whose
calibrated estimate exceeds its remaining deadline budget is shed at
admission; requests can be cancelled or time out queued or in flight;
``autoscale=True`` doubles or halves a lane's batch with its backlog.  A
lane dispatch that the fault plane fails (an
:class:`~repro_torch.distributed.fault_tolerance.InjectedFault`) is retried
with exponential backoff, then the lane degrades in place from
``"kernels"`` to ``"torch"`` and keeps its trajectories
(``stats()["degraded"]``, ``["retries"]``).  Any other error propagates:
a kernel that fails to build or launch is never served by the plain path.  Non-finite samples are re-run from their seed;
:class:`StragglerWatchdog` flags shed the lowest-priority pending class;
:meth:`GenServer.snapshot` / :meth:`GenServer.restore` checkpoint and
resume a drain through :mod:`repro_torch.checkpoint`, bit for bit.

Where the port differs from the reference:

* Noise: :func:`init_noise` draws from a CPU ``torch.Generator`` seeded with
  the request's seed and moves the draw to the lane's device, so a sample
  depends on its seed alone, on any device (the reference draws from
  ``jax.random.PRNGKey(seed)``; the numbers differ).
* Eager PyTorch compiles nothing per batch shape.  A tick is *cold* when
  it is a lane's first at a batch size (on the card that tick loads the
  kernel library; on the torch backend cuDNN picks its algorithms); the
  ``warm_*`` statistics leave cold ticks out.  On CUDA each lane tick ends
  with a synchronize, so a tick's wall time covers its device work.
* Default parameters are drawn from ``torch.Generator().manual_seed(
  param_seed)``, so they differ from the reference's for the same seed;
  ``params=`` takes the reference's trees (nested dicts of numpy arrays).
* Results are numpy fp32 arrays; a bf16 lane's samples are widened
  exactly (numpy has no bf16).
* ``calibration=`` takes a :class:`repro_torch.core.calibrate.Calibration`
  (or any object with ``predict_layers(layers, backend=, dtype=)`` and
  ``predict_layers_split(layers, backend=)``); the CLI loads
  ``calibrate.default_cache_path()`` when a capture left one there, and
  prints the cycle model's ``serve_report`` after the drain.
* ``mesh=`` takes a :class:`repro_torch.launch.mesh.LiveMesh`: the server
  runs on every rank of the process group (SPMD), each rank running the
  same scheduler over the same request stream.  A lane's slots split over
  the mesh's data axes where its batch divides them (the reference's
  ``image_sharding``; otherwise every rank runs them all): each rank ticks
  its share, and the shares are all-gathered, so every rank holds the
  whole lane state and every finished image.  Ranks along the model axis
  replicate.  The lanes' library products (the denoiser's timestep MLP,
  DCGAN's projection: ``torch.matmul``, as the reference computes them
  outside its kernels) run over every slot on every rank, and only the
  convs split: cuBLAS (and the CPU's BLAS) picks its algorithm by the row
  count, so a share's rows would carry other bits than the whole batch's
  (DCGAN-64's projection did at a 1-slot share on the H100), while kernels
  1 and 2 compute a row the same in any batch at one launch plan, and a
  share's launches take the whole batch's plans (the plan table may hold
  another for the share's shape; ``autotune.whole_batch_plans``).
  Decisions read off a
  clock (calibrated shedding, the watchdog) are the mesh's rank 0's,
  broadcast, so the ranks never part; rank 0 alone writes a snapshot.
* ``spatial=True`` also splits the diffusion lane's image rows over the
  mesh's model axis (the reference's ``image_sharding(spatial=True)``):
  each rank's step runs the denoiser on its band of its slots' rows,
  exchanging the halo rows each conv reads with the bands beside it
  (``decompose.conv2d(rows=)``), and the bands are gathered, so every rank
  still holds the whole lane state and a snapshot is the same on any
  mesh.  The rows split where the image's rows divide by the model extent
  and a band holds whole rows of the 8x8 mid-block (every pool factor
  divides it); otherwise they stay whole on every rank, as the
  reference's divisibility guard resolves.  A band's launches take the
  whole image's plans (``autotune.whole_image_plans``), so a spatial drain
  is bitwise the unmeshed one.  As in the reference, the DCGAN lanes take
  no ``spatial``: their rows stay whole.

CPU-scale usage (the CLI runs on CUDA unless ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.serve_gen --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --requests 6 \\
      --steps 8,5,3 --batch 4 --scan-steps 4 --slo realtime
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --smoke \\
      --device cpu --devices 4      # 4 gloo ranks, a (2, 2) mesh
  PYTHONPATH=src python -m repro_torch.launch.serve_gen --smoke \
      --device cpu --devices 4 --spatial   # rows over the model axis too
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import calibrate as cal
from repro_torch.core import cycle_model as cm
from repro_torch.core import gen_spec
from repro_torch.core.cycle_model import np_percentile
from repro_torch.core.decompose import BACKENDS
from repro_torch.core.gen_spec import GEN_WORKLOADS, UNET_WIDTHS
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import (all_gather_cat,
                                                 gather_bands)
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     InjectedFault,
                                                     StragglerWatchdog)
from repro_torch.kernels import autotune
from repro_torch.kernels.util import canon_dtype, resolve_device
from repro_torch.launch.steps import (DDIM_T_MAX, ddim_timesteps,
                                      make_gen_scan_step)
from repro_torch.models import unet_decoder
from repro_torch.models.common import flatten_tree, to_device, unflatten_tree
from repro_torch.models.dcgan import DCGAN

#: the rung a failing lane degrades to
FALLBACK_BACKEND = "torch"

_LOG = logging.getLogger(__name__)


def init_noise(seed: int, shape: tuple[int, ...]) -> torch.Tensor:
    """Seeded x_T (or latent), fp32 on the CPU: shared by the server and
    the reference loop, so a served request is reproducible from its seed
    on any device."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32)


# ---------------------------------------------------------------------------
# SLO classes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SLOClass:
    """One service-level class: admission priority + latency contract.

    ``rank`` orders admission (lower admits first).  ``target_us`` is the
    latency budget from submit; with a calibrated ``est_us`` a request whose
    remaining budget cannot cover its estimate is shed at admission.
    ``timeout_ticks`` is the class's default tick lifetime (``None``: never
    expires).
    """
    name: str
    rank: int
    target_us: float | None = None
    timeout_ticks: int | None = None


#: built-in classes; ``submit(..., slo=...)`` takes a name here or an
#: ad-hoc :class:`SLOClass`
SLO_CLASSES = {
    "realtime": SLOClass("realtime", 0, target_us=1e6),
    "standard": SLOClass("standard", 1),
    "batch": SLOClass("batch", 2),
}

#: admission waits longer than this many ticks promote a request to the
#: front regardless of class (the cross-class anti-starvation bound)
DEFAULT_STARVATION_TICKS = 64

#: fused depth when ``scan_steps="auto"`` finds no calibration coverage
DEFAULT_SCAN_STEPS = 4

#: upper bound of the auto-chosen depth
MAX_SCAN_STEPS = 8


def choose_scan_steps(calibration, layers, *, backend: str = "kernels",
                      batch: int = 1, target_tick_us: float = 50_000.0,
                      max_scan: int = MAX_SCAN_STEPS) -> int:
    """The largest depth K whose predicted tick time — ``batch x K`` passes
    of compute plus one dispatch overhead
    (``calibration.predict_layers_split``) — stays within
    ``target_tick_us``, clamped to ``[1, max_scan]``; without a calibration
    (or without coverage) :data:`DEFAULT_SCAN_STEPS`."""
    if max_scan < 1:
        raise ValueError(f"max_scan must be >= 1, got {max_scan}")
    split = (calibration.predict_layers_split(layers, backend=backend)
             if calibration is not None else None)
    if split is None:
        return min(DEFAULT_SCAN_STEPS, max_scan)
    compute_us, dispatch_us = split
    per_step = batch * compute_us
    if per_step <= 0.0:
        return max_scan
    k = int((target_tick_us - dispatch_us) // per_step)
    return max(1, min(max_scan, k))


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

@dataclass
class GenRequest:
    """One sampling request; ticks are scheduler steps, not wall time."""
    rid: int
    workload: str
    steps: int
    seed: int
    submit_tick: int
    slo: SLOClass = SLO_CLASSES["standard"]
    timeout_ticks: int | None = None
    submit_wall: float = field(default_factory=time.perf_counter)
    admit_tick: int = -1
    done_tick: int = -1
    done_wall: float = 0.0
    result: np.ndarray | None = None
    # pending -> active -> done, or terminal without a result: cancelled /
    # timeout / shed / corrupt
    status: str = "pending"
    # calibrated admission estimate (us) of the whole request, or None
    est_us: float | None = None
    # completion-time corruption detections that re-queued the request
    requeues: int = 0

    @property
    def wait_ticks(self) -> int:
        return self.admit_tick - self.submit_tick

    @property
    def latency_s(self) -> float:
        """Submit-to-completion wall latency (0.0 until done)."""
        return (self.done_wall - self.submit_wall) if self.done_wall else 0.0

    def deadline_us(self) -> float:
        """Absolute wall deadline in perf-counter microseconds (inf without
        a latency target)."""
        if self.slo.target_us is None:
            return math.inf
        return self.submit_wall * 1e6 + self.slo.target_us


# ---------------------------------------------------------------------------
# Lanes
# ---------------------------------------------------------------------------

class _Lane:
    """What both lane kinds share: slots, activity, the device sync, and
    the split of the slots over a mesh's data axes."""

    mesh = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    #: the model-axis group a lane's image rows split over (``None``:
    #: whole rows)
    row_group = None

    def _spread(self, fn, *rows: torch.Tensor) -> torch.Tensor:
        """``fn(*rows)`` over every slot: on a mesh whose data extent
        divides the batch, each rank runs its share of the slots and the
        shares are gathered in slot order; otherwise ``fn`` runs them all
        (the reference's divisibility guard resolves to replicated).  A
        share's kernel launches take the whole batch's plans
        (:func:`repro_torch.kernels.autotune.whole_batch_plans`).  With
        :attr:`row_group`, ``fn`` takes this rank's band of the first tensor's
        (the image's) rows and returns its band, and the bands are
        gathered in rank order."""
        if self.mesh is None:
            return fn(*rows)
        sh = shd.image_sharding(self.mesh, tuple(rows[0].shape))
        split = sh.spec[0] is not None
        if not split and self.row_group is None:
            return fn(*rows)
        shares = [sh.shard(r) for r in rows] if split else list(rows)
        if self.row_group is not None:
            shares[0] = shares[0][:, shd.share(shares[0].shape[1],
                                               self.row_group)]
        with autotune.whole_batch_plans(shares[0].shape[0],
                                        rows[0].shape[0]):
            out = fn(*shares)
        if self.row_group is not None:
            out = gather_bands(out, [out.shape[1]] * shd.model_size(
                self.mesh), self.row_group)
        return (all_gather_cat(out, shd.data_group(self.mesh)) if split
                else out)

    @property
    def busy(self) -> bool:
        return bool(self.active.any())

    @property
    def active_count(self) -> int:
        return int(self.active.sum())

    def free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _occupied(self, new_batch: int) -> list[int]:
        occ = [i for i, s in enumerate(self.slots) if s is not None]
        if len(occ) > new_batch:
            raise ValueError(
                f"cannot shrink to {new_batch}: {len(occ)} slots occupied")
        return occ


class _DiffusionLane(_Lane):
    """Resizable batch of diffusion slots over one K-step dispatch."""

    kind = "diffusion"

    def __init__(self, params: dict, *, batch: int, widths: tuple[int, ...],
                 hw: int, out_ch: int, backend: str, decomposed: bool,
                 device: torch.device, scan_steps: int = 1,
                 compute_dtype: str | None = None, mesh=None,
                 spatial: bool = False):
        self.mesh = mesh
        size = hw * 2 ** len(widths)
        self.image_shape = (size, size, out_ch)
        if spatial and mesh is not None:
            self.row_group = spatial_rows(mesh, self.image_shape, hw,
                                          decomposed)
        self.params = params
        self.scan_steps = scan_steps
        self.backend = backend
        self.decomposed = decomposed
        self.device = device
        self.compute_dtype = compute_dtype
        # the image state lives in the compute dtype: the step's fp32 DDIM
        # update casts back to it, so a bf16 lane stays bf16 end to end
        self._x_dtype = canon_dtype(compute_dtype) or torch.float32
        self._step = self._make_step()
        self.device_steps = 0       # host dispatches (one per busy tick)
        self.substeps = 0           # active trajectory steps taken
        # batch sizes this lane has ticked at (a tick at a new one is cold)
        self.seen_sizes: set[int] = set()
        self._alloc(batch)

    def _make_step(self):
        return make_gen_scan_step(self.scan_steps, decomposed=self.decomposed,
                                  backend=self.backend,
                                  compute_dtype=self.compute_dtype,
                                  rows=self.row_group)

    def set_backend(self, backend: str) -> None:
        """Swap the dispatch backend in place (graceful degradation,
        DESIGN.md §11): every slot's image state, trajectory cursor and
        request stay where they are."""
        if backend == self.backend:
            return
        self.backend = backend
        self._step = self._make_step()
        self.seen_sizes = set()

    def corrupt(self, slot: int) -> None:
        """Chaos hook: poison one slot's image state with NaNs."""
        self.x[slot % self.batch] = float("nan")

    def state_arrays(self) -> dict[str, torch.Tensor]:
        return {"x": self.x}

    def load_state(self, arrays: dict) -> None:
        self.x = torch.as_tensor(arrays["x"]).to(self.device, self._x_dtype)

    def param_leaves(self) -> dict[str, torch.Tensor]:
        """Parameters by dotted name (``flatten_tree``'s names)."""
        return flatten_tree(self.params)

    def load_param_leaves(self, leaves: dict) -> None:
        self.params = to_device(unflatten_tree(leaves), self.device)

    def _alloc(self, batch: int) -> None:
        self.batch = batch
        self.x = torch.zeros((batch,) + self.image_shape, dtype=self._x_dtype,
                             device=self.device)
        self.slots: list[GenRequest | None] = [None] * batch
        self._traj: list[np.ndarray | None] = [None] * batch
        self._pos = [0] * batch
        self.active = np.zeros(batch, bool)

    def admit(self, req: GenRequest, slot: int) -> None:
        self.slots[slot] = req
        self._traj[slot] = ddim_timesteps(req.steps)
        self._pos[slot] = 0
        self.active[slot] = True
        self.x[slot] = init_noise(req.seed, self.image_shape).to(
            self.device, self.x.dtype)

    def release(self, slot: int) -> None:
        """Vacate a slot (cancel/timeout); its stale image rows stay out of
        every later substep through the activity mask."""
        self.slots[slot] = self._traj[slot] = None
        self._pos[slot] = 0
        self.active[slot] = False

    def resize(self, new_batch: int) -> None:
        """Re-pack occupied slots, in slot order, into a ``new_batch`` lane;
        each request's image state and trajectory position move with it."""
        occ = self._occupied(new_batch)
        if new_batch == self.batch:
            return
        x_old = self.x
        moved = [(self.slots[i], self._traj[i], self._pos[i]) for i in occ]
        self._alloc(new_batch)
        if occ:
            self.x[:len(occ)] = x_old[torch.tensor(occ, device=self.device)]
        for i, (s, tr, p) in enumerate(moved):
            self.slots[i], self._traj[i], self._pos[i] = s, tr, p
            self.active[i] = True

    def tick(self) -> list[GenRequest]:
        b, k = self.batch, self.scan_steps
        t = np.zeros((b, k), np.int64)
        t_next = np.full((b, k), -1, np.int64)
        act = np.zeros((b, k), bool)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            traj, p = self._traj[i], self._pos[i]
            for j in range(min(k, len(traj) - p)):
                t[i, j] = traj[p + j]
                if p + j + 1 < len(traj):
                    t_next[i, j] = traj[p + j + 1]
                act[i, j] = True
        self.seen_sizes.add(self.batch)
        keys = ["t", "t_next", "active"]
        rows = [torch.from_numpy(v).to(self.device) for v in (t, t_next, act)]
        with torch.no_grad():
            if self.mesh is not None:
                # each substep's timestep MLP over every slot, on every
                # rank (the module docstring says why)
                keys.append("cond")
                rows.append(torch.stack([unet_decoder.timestep_cond(
                    self.params, rows[0][:, j], self._x_dtype)
                    for j in range(k)], dim=1))
            self.x = self._spread(
                lambda x, *r: self._step(self.params, x, dict(zip(keys, r))),
                self.x, *rows)
        self._sync()
        self.device_steps += 1
        self.substeps += int(act.sum())
        done, host = [], None
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self._pos[i] += int(act[i].sum())
            if self._pos[i] == len(self._traj[i]):        # landed on x0
                if host is None:
                    host = self.x.float().cpu().numpy()
                req.result = host[i].copy()
                done.append(req)
                self.release(i)
        return done


def spatial_rows(mesh, image_shape: tuple, hw: int,
                 decomposed: bool = True):
    """The model-axis group a diffusion lane's image rows split over:
    where :func:`~repro_torch.distributed.sharding.image_sharding`'s guard
    resolves the rows over ``model`` and a band holds whole rows of the
    ``hw``-row mid-block (the one follows from the other), and the
    upsamplers are decomposed (the naive zero-laden form runs whole); else
    ``None`` (whole rows, logged)."""
    m = shd.model_size(mesh)
    if m == 1 or hw % m or not decomposed:
        _LOG.info("GenServer(spatial=True): the %d-row images (mid-block "
                  "%d) stay whole over a model extent of %d",
                  image_shape[0], hw, m)
        return None
    return shd.model_group(mesh)


class _DCGANLane(_Lane):
    """Single-shot generation: one tick runs the generator over every
    latent slot and completes the active ones."""

    kind = "dcgan"
    scan_steps = 1

    def __init__(self, model: DCGAN, *, batch: int, nz: int, backend: str,
                 decomposed: bool, device: torch.device,
                 compute_dtype: str | None = None, mesh=None):
        self.mesh = mesh
        self.model = model
        self.nz = nz
        self.backend = backend
        self.decomposed = decomposed
        self.device = device
        self.compute_dtype = compute_dtype
        self.device_steps = 0
        self.substeps = 0
        self.seen_sizes: set[int] = set()
        self._alloc(batch)

    def set_backend(self, backend: str) -> None:
        if backend == self.backend:
            return
        self.backend = backend
        self.seen_sizes = set()

    def corrupt(self, slot: int) -> None:
        self.z[slot % self.batch] = float("nan")

    def state_arrays(self) -> dict[str, torch.Tensor]:
        return {"z": self.z}

    def load_state(self, arrays: dict) -> None:
        self.z = torch.as_tensor(arrays["z"]).to(self.device, torch.float32)

    def param_leaves(self) -> dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.model.named_parameters()}

    @torch.no_grad()
    def load_param_leaves(self, leaves: dict) -> None:
        for name, p in self.model.named_parameters():
            p.copy_(torch.as_tensor(leaves[name]))

    def _alloc(self, batch: int) -> None:
        self.batch = batch
        self.z = torch.zeros((batch, self.nz), dtype=torch.float32,
                             device=self.device)
        self.slots: list[GenRequest | None] = [None] * batch
        self.active = np.zeros(batch, bool)

    def admit(self, req: GenRequest, slot: int) -> None:
        self.slots[slot] = req
        self.active[slot] = True
        self.z[slot] = init_noise(req.seed, (self.nz,)).to(self.device)

    def release(self, slot: int) -> None:
        self.slots[slot] = None
        self.active[slot] = False

    def resize(self, new_batch: int) -> None:
        occ = self._occupied(new_batch)
        if new_batch == self.batch:
            return
        z_old, slots = self.z, [self.slots[i] for i in occ]
        self._alloc(new_batch)
        if occ:
            self.z[:len(occ)] = z_old[torch.tensor(occ, device=self.device)]
        for i, s in enumerate(slots):
            self.slots[i] = s
            self.active[i] = True

    def tick(self) -> list[GenRequest]:
        self.seen_sizes.add(self.batch)
        with torch.no_grad():
            if self.mesh is None:
                imgs = self.model(self.z, decomposed=self.decomposed,
                                  backend=self.backend,
                                  compute_dtype=self.compute_dtype)
            else:
                # the projection over every slot, on every rank (the
                # module docstring says why); the transposed stages split
                imgs = self._spread(lambda h: self.model.decode(
                    h, self.decomposed, self.backend, self.compute_dtype),
                    self.model.project(self.z, self.compute_dtype))
        imgs = imgs.float().cpu().numpy()
        self.device_steps += 1
        done = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.substeps += 1
            req.result = imgs[i].copy()
            done.append(req)
            self.release(i)
        return done


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class GenServer:
    """Continuous-batching generative server over the decomposition engine.

    One lane per workload (``"unet_dec"``, ``"dcgan64"``, ``"dcgan128"``),
    built on the first request for it.  ``submit`` enqueues, ``step`` runs
    one scheduler tick (expire timeouts, autoscale, admit into free slots,
    then one dispatch per busy lane), ``run`` drains the queue and returns
    ``rid -> image``.

    ``device``: ``None`` -> CUDA (raises without a card), ``"cpu"`` runs
    the kernels' plain versions.  ``backend``: ``"kernels"`` (the
    hand-written conv kernels) or ``"torch"``.  ``compute_dtype``:
    ``None``/``"fp32"`` or ``"bf16"``.  ``params`` overrides a workload's
    parameters with the reference's tree (nested dicts of numpy arrays);
    otherwise a lane draws its weights from ``param_seed`` (not the
    reference's weights for that seed: the generators differ).  ``mesh``:
    a :class:`~repro_torch.launch.mesh.LiveMesh` the lanes span (the module
    docstring); its device is the server's unless ``device`` is given.
    ``spatial=True`` splits the diffusion lane's image rows over the
    mesh's model axis too (the DCGAN lanes' rows stay whole, as the
    reference's); without a mesh it changes nothing.
    The other arguments are the reference's (its class docstring gives
    them); ``interpret`` is not ported.
    """

    def __init__(self, *, batch: int = 4, backend: str = "kernels",
                 device=None, decomposed: bool = True, mesh=None,
                 spatial: bool = False,
                 unet_widths: tuple[int, ...] = UNET_WIDTHS, unet_hw: int = 8,
                 out_ch: int = 3, dcgan_nz: int = 100, dcgan_ngf: int = 64,
                 params: dict | None = None, param_seed: int = 0,
                 calibration=None, scan_steps: int | str = 1,
                 autoscale: bool = False, min_batch: int = 1,
                 max_batch: int | None = None, shrink_patience: int = 2,
                 starvation_ticks: int = DEFAULT_STARVATION_TICKS,
                 faults: FailureInjector | None = None,
                 watchdog: StragglerWatchdog | None = None,
                 max_retries: int = 3, retry_backoff_s: float = 0.05,
                 stuck_shed_after: int = 3, max_requeues: int = 1,
                 snapshot_dir: str | None = None, snapshot_every: int = 0,
                 snapshot_keep: int = 3, compute_dtype=None):
        if isinstance(scan_steps, str):
            if scan_steps != "auto":
                raise ValueError(
                    f"scan_steps must be an int >= 1 or 'auto', "
                    f"got {scan_steps!r}")
        elif scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; known: "
                             f"{BACKENDS}")
        self.mesh = mesh
        self.spatial = spatial
        self.device = resolve_device(
            device if device is not None or mesh is None else mesh.device)
        self.batch = batch
        self.backend = backend
        self.decomposed = decomposed
        # "float32" / "bfloat16" (or None): a JSON-able snapshot field
        cd = canon_dtype(compute_dtype)
        self.compute_dtype = None if cd is None else str(cd).removeprefix(
            "torch.")
        self.unet_widths = tuple(unet_widths)
        self.unet_hw, self.out_ch = unet_hw, out_ch
        self.dcgan_nz, self.dcgan_ngf = dcgan_nz, dcgan_ngf
        self._params = dict(params or {})
        self._param_seed = param_seed
        self.calibration = calibration
        self.scan_steps = scan_steps
        self.autoscale = autoscale
        self.min_batch = max(1, min_batch)
        self.max_batch = max(batch, max_batch or batch * 4)
        self.shrink_patience = shrink_patience
        self.starvation_ticks = starvation_ticks
        self.faults = faults
        self.watchdog = watchdog
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.stuck_shed_after = max(1, stuck_shed_after)
        self.max_requeues = max_requeues
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.snapshot_keep = snapshot_keep
        # fault-tolerance counters (stats(), DESIGN.md §11)
        self._degraded: dict[str, str] = {}   # workload -> fallback backend
        self._retries = 0
        self._recoveries = 0
        self._snapshots = 0
        self._stuck = 0                       # consecutive stuck-tick flags
        self._lanes: dict[str, _DiffusionLane | _DCGANLane] = {}
        self._idle_ticks: dict[str, int] = {}
        self._pending: list[GenRequest] = []
        self._done: dict[int, GenRequest] = {}
        self._requests: dict[int, GenRequest] = {}
        self._tick = 0
        self._next_rid = 0
        self._t0: float | None = None
        # per-tick log: (wall_s, dispatches, completions, substeps, cold)
        self._tick_log: list[tuple[float, int, int, int, bool]] = []

    # -------------------------------------------------------------- lanes --
    def _workload_layers(self, workload: str):
        """Layer table of the geometry this server executes (its widths,
        not the canonical ones)."""
        if workload == "unet_dec":
            return gen_spec.unet_decoder_layers(
                self.unet_widths, hw=self.unet_hw, out_ch=self.out_ch)
        if workload in ("dcgan64", "dcgan128"):
            return gen_spec.dcgan_layers(
                int(workload[5:]), nz=self.dcgan_nz, ngf=self.dcgan_ngf,
                out_ch=self.out_ch)
        raise ValueError(f"unknown workload {workload!r}; "
                         f"known: {sorted(GEN_WORKLOADS)}")

    def _lane_scan_steps(self, workload: str) -> int:
        if workload != "unet_dec":
            return 1            # single-shot lanes have no trajectory
        if self.scan_steps == "auto":
            return choose_scan_steps(self.calibration,
                                     self._workload_layers(workload),
                                     backend=self.backend, batch=self.batch)
        return int(self.scan_steps)

    def _init_params(self, workload: str):
        """A lane's parameters on the device: the override if given, else a
        seeded init (also the template restore() loads snapshotted leaves
        into).  The denoiser's are a nested dict, DCGAN's a module."""
        given = self._params.get(workload)
        g = torch.Generator().manual_seed(self._param_seed)
        if workload == "unet_dec":
            if given is not None:
                return to_device(given, self.device)
            return unet_decoder.init_denoiser_params(
                g, widths=self.unet_widths, out_ch=self.out_ch,
                device=self.device)
        if workload in ("dcgan64", "dcgan128"):
            model = DCGAN(int(workload[5:]), nz=self.dcgan_nz,
                          ngf=self.dcgan_ngf, out_ch=self.out_ch,
                          device="meta" if given is not None else self.device,
                          generator=g)
            if given is not None:
                model.to_empty(device=self.device)
                model.load_jax_params(given)
            return model
        raise ValueError(f"unknown workload {workload!r}; "
                         f"known: {sorted(GEN_WORKLOADS)}")

    def _lane(self, workload: str, *, batch: int | None = None,
              scan_steps: int | None = None):
        """The lane for ``workload``, built on first use; ``batch`` /
        ``scan_steps`` override the configured sizing (restore() passes the
        snapshotted values)."""
        lane = self._lanes.get(workload)
        if lane is not None:
            return lane
        p = self._init_params(workload)
        kw = dict(backend=self.backend, decomposed=self.decomposed,
                  batch=batch or self.batch, device=self.device,
                  compute_dtype=self.compute_dtype, mesh=self.mesh)
        if workload == "unet_dec":
            lane = _DiffusionLane(
                p, widths=self.unet_widths, hw=self.unet_hw,
                out_ch=self.out_ch, spatial=self.spatial,
                scan_steps=(scan_steps if scan_steps is not None
                            else self._lane_scan_steps(workload)), **kw)
        else:
            lane = _DCGANLane(p, nz=self.dcgan_nz, **kw)
        self._lanes[workload] = lane
        self._idle_ticks[workload] = 0
        return lane

    # ---------------------------------------------------------- scheduling --
    def admission_estimate(self, workload: str,
                           steps: int = 1) -> float | None:
        """Calibrated estimate (us) of one request: the calibration's
        prediction for this server's layer table x ``steps``; None without
        a calibration or without coverage ("no estimate", not zero)."""
        if self.calibration is None:
            return None
        us = self.calibration.predict_layers(
            self._workload_layers(workload), backend=self.backend,
            dtype=self.compute_dtype or "float32")
        return None if us is None else us * max(steps, 1)

    def submit(self, workload: str, *, steps: int = 1, seed: int = 0,
               slo: str | SLOClass = "standard",
               timeout_ticks: int | None = None) -> int:
        """Enqueue a request; returns its id.  DCGAN is single-shot
        (``steps`` forced to 1); diffusion runs a ``steps``-step DDIM
        trajectory.  ``slo`` is a name of :data:`SLO_CLASSES` or an
        :class:`SLOClass`; ``timeout_ticks`` overrides the class's."""
        self._lane(workload)        # fail fast on unknown workloads
        if isinstance(slo, str):
            try:
                slo = SLO_CLASSES[slo]
            except KeyError:
                raise ValueError(f"unknown SLO class {slo!r}; known: "
                                 f"{sorted(SLO_CLASSES)}") from None
        if workload != "unet_dec":
            steps = 1
        req = GenRequest(self._next_rid, workload, steps, seed, self._tick,
                         slo=slo,
                         timeout_ticks=(slo.timeout_ticks
                                        if timeout_ticks is None
                                        else timeout_ticks))
        req.est_us = self.admission_estimate(workload, steps)
        self._next_rid += 1
        self._pending.append(req)
        self._requests[req.rid] = req
        return req.rid

    def cancel(self, rid: int, status: str = "cancelled") -> bool:
        """Cancel a request queued or in flight (its slot is reusable on
        the next tick); terminal requests are left alone.  Returns whether
        anything was cancelled."""
        req = self._requests.get(rid)
        if req is None or req.status in ("done", "cancelled", "timeout",
                                         "shed", "corrupt"):
            return False
        if req.status == "pending":
            self._pending.remove(req)
        else:                                   # active: vacate the slot
            lane = self._lanes[req.workload]
            lane.release(lane.slots.index(req))
        req.status = status
        return True

    def _expire(self) -> None:
        """Time out requests (queued or in flight) past their tick budget."""
        for req in list(self._requests.values()):
            if req.status not in ("pending", "active"):
                continue
            if req.timeout_ticks is None:
                continue
            if self._tick - req.submit_tick >= req.timeout_ticks:
                self.cancel(req.rid, status="timeout")

    def _admission_key(self, req: GenRequest):
        """Aged requests first, then SLO rank, deadline, arrival."""
        aged = (self._tick - req.submit_tick) >= self.starvation_ticks
        return (0 if aged else 1, req.slo.rank, req.deadline_us(), req.rid)

    def _admit(self) -> None:
        now_us = time.perf_counter() * 1e6
        by_lane: dict[str, list[GenRequest]] = {}
        for req in self._pending:
            by_lane.setdefault(req.workload, []).append(req)
        for workload, reqs in by_lane.items():
            lane = self._lane(workload)
            for req in sorted(reqs, key=self._admission_key):
                # the stamped estimate says the SLO is already unmeetable
                if (req.est_us is not None and self._agree(
                        req.deadline_us() - now_us < req.est_us)):
                    self._pending.remove(req)
                    req.status = "shed"
                    continue
                slot = lane.free_slot()
                if slot is None:
                    break               # lane full; later classes wait too
                req.admit_tick = self._tick
                req.status = "active"
                lane.admit(req, slot)
                self._pending.remove(req)

    def _autoscale(self) -> None:
        """Grow a backlogged lane / shrink an underused one, one rung (x2 /
        /2) a tick within ``[min_batch, max_batch]``; a pure function of
        the queue state."""
        backlog: dict[str, int] = {}
        for req in self._pending:
            backlog[req.workload] = backlog.get(req.workload, 0) + 1
        for workload, lane in self._lanes.items():
            want = backlog.get(workload, 0)
            free = lane.batch - lane.active_count
            if want > free and lane.batch < self.max_batch:
                lane.resize(min(lane.batch * 2, self.max_batch))
                self._idle_ticks[workload] = 0
                continue
            half = lane.batch // 2
            if (want == 0 and half >= self.min_batch
                    and lane.active_count <= half):
                self._idle_ticks[workload] += 1
                if self._idle_ticks[workload] >= self.shrink_patience:
                    lane.resize(half)
                    self._idle_ticks[workload] = 0
            else:
                self._idle_ticks[workload] = 0

    # ------------------------------------------------------ fault handling --
    def _lane_tick(self, workload: str, lane) -> list[GenRequest]:
        """One lane dispatch behind the retry/degrade ladder (DESIGN.md
        §11): an injected ``raise`` fault is retried ``max_retries`` times
        with exponential backoff; a lane still failing on ``"kernels"``
        then degrades in place to ``"torch"`` and the ladder restarts
        there.  A torch lane that exhausts its retries propagates.  The
        faults fire before the dispatch, so a retry re-enters untouched
        state.  Only :class:`InjectedFault` is caught: any other error of
        the dispatch propagates at once."""
        backoff = self.retry_backoff_s
        attempts, failed = 0, False
        while True:
            try:
                if self.faults is not None and self.faults.take(
                        self._tick, kind="raise", target=workload,
                        backend=lane.backend):
                    raise InjectedFault(
                        f"injected {lane.backend} dispatch failure on lane "
                        f"{workload!r} at tick {self._tick}")
                done = lane.tick()
            except InjectedFault:
                failed = True
                attempts += 1
                if attempts <= self.max_retries:
                    self._retries += 1
                    if backoff > 0:
                        time.sleep(backoff)
                    backoff *= 2
                    continue
                if lane.backend != FALLBACK_BACKEND:
                    lane.set_backend(FALLBACK_BACKEND)
                    self._degraded[workload] = FALLBACK_BACKEND
                    attempts, backoff = 0, self.retry_backoff_s
                    continue
                raise
            if failed:
                self._recoveries += 1
            return done

    def _result_ok(self, req: GenRequest) -> bool:
        """Completion-time corruption gate: a non-finite sample is never
        surfaced; the request re-runs from its seed up to ``max_requeues``
        times, then lands as ``"corrupt"``."""
        if req.result is not None and np.isfinite(req.result).all():
            return True
        req.result = None
        if req.requeues < self.max_requeues:
            req.requeues += 1
            req.status = "pending"
            req.admit_tick = -1
            self._pending.append(req)
            self._recoveries += 1
        else:
            req.status = "corrupt"
        return False

    def _agree(self, flag: bool) -> bool:
        """A decision read off a clock, made the same on every rank of a
        mesh: rank 0's."""
        if self.mesh is None:
            return bool(flag)
        return bool(self.mesh.replicate(torch.tensor(int(flag))).item())

    def _shed_lowest_class(self) -> None:
        """Stuck-tick shedding: drop every pending request of the lowest-
        priority class present; in-flight work is never shed."""
        if not self._pending:
            return
        worst = max(r.slo.rank for r in self._pending)
        for req in [r for r in self._pending if r.slo.rank == worst]:
            self._pending.remove(req)
            req.status = "shed"

    def step(self) -> list[GenRequest]:
        """One scheduler tick; returns the requests it completed.

        Fault injection points, in tick order: ``kill`` (before any state
        changes; recovery is :meth:`restore`), ``slow`` (a stall inside the
        timed window), ``corrupt`` (poisons a lane slot), ``raise`` (inside
        :meth:`_lane_tick`'s ladder).
        """
        t_start = time.perf_counter()
        if self._t0 is None:
            self._t0 = t_start
        inj = self.faults
        if inj is not None and inj.take(self._tick, kind="kill"):
            raise InjectedFault(f"injected server kill at tick {self._tick}")
        self._expire()
        if self.autoscale:
            self._autoscale()
        self._admit()
        if inj is not None:
            stall = inj.sleep_faults(self._tick)
            if stall > 0:
                time.sleep(stall)
            for f in inj.take(self._tick, kind="corrupt"):
                lane = (self._lanes.get(f.target) if f.target is not None
                        else next((l for l in self._lanes.values()
                                   if l.busy), None))
                if lane is not None:
                    lane.corrupt(f.slot)
        done: list[GenRequest] = []
        dispatches = substeps = 0
        cold = False
        for workload, lane in self._lanes.items():
            if lane.busy:
                cold = cold or lane.batch not in lane.seen_sizes
                sub0 = lane.substeps
                done.extend(self._lane_tick(workload, lane))
                dispatches += 1
                substeps += lane.substeps - sub0
        self._tick += 1
        t_end = time.perf_counter()
        done = [r for r in done if self._result_ok(r)]
        for req in done:
            req.done_tick = self._tick
            req.done_wall = t_end
            req.status = "done"
            self._done[req.rid] = req
        self._tick_log.append(
            (t_end - t_start, dispatches, len(done), substeps, cold))
        if self.watchdog is not None and dispatches:
            self._stuck = (self._stuck + 1 if self._agree(
                self.watchdog.observe(self._tick - 1, t_end - t_start))
                else 0)
            if self._stuck >= self.stuck_shed_after:
                self._shed_lowest_class()
                self._stuck = 0
        if (self.snapshot_dir is not None and self.snapshot_every > 0
                and self._tick % self.snapshot_every == 0):
            self.snapshot()
        return done

    def run(self) -> dict[int, np.ndarray]:
        """Drain queue and in-flight work; returns ``rid -> image`` of the
        completed requests (the others' status is on :meth:`request`)."""
        while self._pending or any(l.busy for l in self._lanes.values()):
            self.step()
        return {rid: r.result for rid, r in sorted(self._done.items())}

    # ---------------------------------------------------- snapshot/restore --
    _CONFIG_ATTRS = ("batch", "backend", "decomposed", "unet_hw", "out_ch",
                     "dcgan_nz", "dcgan_ngf", "scan_steps", "autoscale",
                     "min_batch", "max_batch", "shrink_patience",
                     "starvation_ticks", "max_retries", "retry_backoff_s",
                     "stuck_shed_after", "max_requeues", "snapshot_every",
                     "snapshot_keep", "compute_dtype", "spatial")

    def _snapshot_config(self) -> dict:
        cfg = {k: getattr(self, k) for k in self._CONFIG_ATTRS}
        cfg["unet_widths"] = list(self.unet_widths)
        cfg["param_seed"] = self._param_seed
        cfg["device"] = str(self.device)
        if self.mesh is not None:
            # the geometry only: restore() lays it over the process group
            # it runs in, or reshards onto a mesh= override
            cfg["mesh"] = self.mesh.geometry()
        return cfg

    @staticmethod
    def _req_meta(req: GenRequest) -> dict:
        """JSON form of a request without its image; wall-clock fields are
        left out (``perf_counter`` is process-relative), so restore()
        re-bases every live request to one "now"."""
        return {"rid": req.rid, "workload": req.workload, "steps": req.steps,
                "seed": req.seed, "submit_tick": req.submit_tick,
                "slo": {"name": req.slo.name, "rank": req.slo.rank,
                        "target_us": req.slo.target_us,
                        "timeout_ticks": req.slo.timeout_ticks},
                "timeout_ticks": req.timeout_ticks,
                "admit_tick": req.admit_tick, "done_tick": req.done_tick,
                "status": req.status, "est_us": req.est_us,
                "requeues": req.requeues}

    @staticmethod
    def _req_from_meta(m: dict, now: float) -> GenRequest:
        s = m["slo"]
        req = GenRequest(m["rid"], m["workload"], m["steps"], m["seed"],
                         m["submit_tick"],
                         slo=SLOClass(s["name"], s["rank"],
                                      target_us=s["target_us"],
                                      timeout_ticks=s["timeout_ticks"]),
                         timeout_ticks=m["timeout_ticks"])
        req.submit_wall = now
        req.admit_tick = m["admit_tick"]
        req.done_tick = m["done_tick"]
        req.status = m["status"]
        req.est_us = m["est_us"]
        req.requeues = m["requeues"]
        if req.status == "done":
            req.done_wall = now
        return req

    def snapshot(self, directory: str | None = None) -> str:
        """Checkpoint the full scheduler-visible state atomically: lane
        state and parameters (arrays ``lane:{wl}:{name}`` and
        ``param:{wl}:{i:05d}``, leaves in the sorted order of their dotted
        names), trajectory cursors, request and SLO metadata, the queue,
        completed results and the fault counters (manifest ``extra``),
        through the manifest+COMMITTED layout.  On a mesh every rank holds
        the same state: rank 0 writes, and every rank waits for it."""
        directory = directory or self.snapshot_dir
        if directory is None:
            raise ValueError("snapshot() needs a directory argument or a "
                             "server constructed with snapshot_dir=")
        arrays: dict = {}
        lanes_meta: dict[str, dict] = {}
        for wl, lane in self._lanes.items():
            lm = {"kind": lane.kind, "batch": lane.batch,
                  "backend": lane.backend, "scan_steps": lane.scan_steps,
                  "device_steps": lane.device_steps,
                  "substeps": lane.substeps,
                  "idle_ticks": self._idle_ticks[wl],
                  "slots": [None if s is None else self._req_meta(s)
                            for s in lane.slots]}
            if lane.kind == "diffusion":
                lm["pos"] = [int(p) for p in lane._pos]
            lanes_meta[wl] = lm
            for k, v in lane.state_arrays().items():
                arrays[f"lane:{wl}:{k}"] = v
            leaves = lane.param_leaves()
            for i, name in enumerate(sorted(leaves)):
                arrays[f"param:{wl}:{i:05d}"] = leaves[name]
        done_meta, dropped_meta = [], []
        for req in self._requests.values():
            if req.status == "done":
                done_meta.append(self._req_meta(req))
                arrays[f"done:{req.rid:08d}"] = req.result
            elif req.status in ("cancelled", "timeout", "shed", "corrupt"):
                dropped_meta.append(self._req_meta(req))
        meta = {"tick": self._tick, "next_rid": self._next_rid,
                "config": self._snapshot_config(), "lanes": lanes_meta,
                "pending": [self._req_meta(r) for r in self._pending],
                "done": done_meta, "dropped": dropped_meta,
                "degraded": dict(self._degraded), "retries": self._retries,
                "recoveries": self._recoveries,
                "snapshots": self._snapshots + 1}
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.save_checkpoint(directory, self._tick, arrays,
                                 keep=self.snapshot_keep, extra=meta)
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier(group=self.mesh.everyone())
        self._snapshots += 1
        return directory

    @classmethod
    def restore(cls, directory: str, *, step: int | None = None,
                **overrides) -> "GenServer":
        """Rebuild a server from the latest (or given) snapshot and resume.

        The restored drain reproduces the uninterrupted one sample for
        sample, bit for bit on one device and backend: the image state and
        parameters round-trip exactly and the step is timestep-data driven.
        Work done after the snapshot in the killed process is recomputed.
        ``overrides`` are constructor keywords (``calibration=``,
        ``faults=``, ``device=``, ``mesh=``; they are not serialised).  A
        meshed snapshot keeps its mesh's geometry, which a restore lays
        over its own process group; ``mesh=`` reshards onto another rank
        count (or none), bit for bit, since the lane state is whole on
        every rank.
        """
        if step is None:
            step = ckpt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed snapshot under {directory!r}")
        arrays, meta = ckpt.load_flat(directory, step)
        cfg = dict(meta["config"])
        cfg["unet_widths"] = tuple(cfg["unet_widths"])
        geometry = cfg.pop("mesh", None)
        if geometry is not None and "mesh" not in overrides:
            import torch.distributed as dist

            from repro_torch.launch.mesh import LiveMesh, mesh_of
            mesh = mesh_of(geometry["shape"], geometry["axes"])
            world = dist.get_world_size() if dist.is_initialized() else 1
            if mesh.size != world:
                raise ValueError(
                    f"snapshot took a {tuple(geometry['shape'])} mesh but "
                    f"{world} rank(s) run; pass mesh= to restore() to "
                    f"reshard")
            cfg["mesh"] = LiveMesh(mesh, overrides.get("device",
                                                       cfg["device"]))
        kw = dict(cfg, snapshot_dir=directory)
        kw.update(overrides)
        server = cls(**kw)
        now = time.perf_counter()
        server._tick = meta["tick"]
        server._next_rid = meta["next_rid"]
        server._degraded = dict(meta["degraded"])
        server._retries = meta["retries"]
        server._recoveries = meta["recoveries"] + 1  # this restore is one
        server._snapshots = meta["snapshots"]
        for wl, lm in meta["lanes"].items():
            lane = server._lane(wl, batch=lm["batch"],
                                scan_steps=lm["scan_steps"])
            if lm["backend"] != lane.backend:
                lane.set_backend(lm["backend"])
            prefix = f"param:{wl}:"
            names = sorted(lane.param_leaves())
            keys = sorted(k for k in arrays if k.startswith(prefix))
            if len(keys) != len(names):
                raise ValueError(f"snapshot holds {len(keys)} parameters of "
                                 f"lane {wl!r}; its model has {len(names)}")
            lane.load_param_leaves({n: arrays[k]
                                    for n, k in zip(names, keys)})
            sp = f"lane:{wl}:"
            lane.load_state({k[len(sp):]: v for k, v in arrays.items()
                             if k.startswith(sp)})
            lane.device_steps = lm["device_steps"]
            lane.substeps = lm["substeps"]
            for i, sm in enumerate(lm["slots"]):
                if sm is None:
                    continue
                req = cls._req_from_meta(sm, now)
                lane.slots[i] = req
                lane.active[i] = True
                if lane.kind == "diffusion":
                    lane._traj[i] = ddim_timesteps(req.steps)
                server._requests[req.rid] = req
            if lane.kind == "diffusion":
                lane._pos = list(lm["pos"])
            server._idle_ticks[wl] = lm["idle_ticks"]
        for m in meta["pending"]:
            req = cls._req_from_meta(m, now)
            server._pending.append(req)
            server._requests[req.rid] = req
        for m in meta["done"]:
            req = cls._req_from_meta(m, now)
            req.result = np.asarray(arrays[f"done:{req.rid:08d}"])
            server._done[req.rid] = req
            server._requests[req.rid] = req
        for m in meta["dropped"]:
            server._requests[m["rid"]] = cls._req_from_meta(m, now)
        return server

    # ------------------------------------------------------------- metrics --
    @property
    def completed(self) -> dict[int, GenRequest]:
        return dict(self._done)

    def request(self, rid: int) -> GenRequest:
        """Any submitted request by id (whatever its lifecycle state)."""
        return self._requests[rid]

    def stats(self) -> dict[str, float]:
        """Counts, throughput and latency of the run so far.  ``warm_*``
        leave out cold ticks (a lane's first at a batch size)."""
        wall = (time.perf_counter() - self._t0) if self._t0 else 0.0
        dev_steps = sum(l.device_steps for l in self._lanes.values())
        substeps = sum(l.substeps for l in self._lanes.values())
        n = len(self._done)
        waits = [r.wait_ticks for r in self._done.values()]
        lats = sorted(r.latency_s for r in self._done.values())
        statuses = [r.status for r in self._requests.values()]
        warm = [t for t in self._tick_log if not t[4]]
        warm_wall = sum(t[0] for t in warm)
        warm_imgs = sum(t[2] for t in warm)
        warm_sub = sum(t[3] for t in warm)
        return {
            "requests": n,
            "ticks": self._tick,
            "device_steps": dev_steps,
            "substeps": substeps,
            "wall_s": wall,
            "images_per_s": n / wall if wall else 0.0,
            "steps_per_s": dev_steps / wall if wall else 0.0,
            "warm_wall_s": warm_wall,
            "warm_images_per_s": warm_imgs / warm_wall if warm_wall else 0.0,
            "warm_steps_per_s": warm_sub / warm_wall if warm_wall else 0.0,
            "latency_p50_s": np_percentile(lats, 50.0),
            "latency_p99_s": np_percentile(lats, 99.0),
            "mean_wait_ticks": float(np.mean(waits)) if waits else 0.0,
            "max_wait_ticks": float(np.max(waits)) if waits else 0.0,
            "cancelled": float(statuses.count("cancelled")),
            "timeout": float(statuses.count("timeout")),
            "shed": float(statuses.count("shed")),
            "degraded": float(len(self._degraded)),
            "retries": float(self._retries),
            "recoveries": float(self._recoveries),
            "corrupt": float(statuses.count("corrupt")),
            "snapshots": float(self._snapshots),
        }


def reference_sample(params: dict, *, steps: int, seed: int, image_size: int,
                     out_ch: int = 3, backend: str = "kernels",
                     decomposed: bool = True, t_max: int = DDIM_T_MAX,
                     compute_dtype=None, device=None) -> np.ndarray:
    """Unbatched single-request DDIM loop at batch 1, one step a dispatch:
    the oracle the served (mixed-timestep, continuously batched, K-step)
    path is held to.  ``params`` is the denoiser's tree on ``device``
    (``None`` -> CUDA).  Returns the fp32 sample (bf16 widened)."""
    dev = resolve_device(device)
    step = make_gen_scan_step(1, t_max=t_max, decomposed=decomposed,
                              backend=backend, compute_dtype=compute_dtype)
    traj = ddim_timesteps(steps, t_max)
    x_dtype = canon_dtype(compute_dtype) or torch.float32
    x = init_noise(seed, (image_size, image_size, out_ch))[None].to(
        dev, x_dtype)
    with torch.no_grad():
        for i, t in enumerate(traj):
            nxt = int(traj[i + 1]) if i + 1 < len(traj) else -1
            batch = {"t": torch.full((1, 1), int(t), dtype=torch.int64),
                     "t_next": torch.full((1, 1), nxt, dtype=torch.int64),
                     "active": torch.ones((1, 1), dtype=torch.bool)}
            x = step(params, x, {k: v.to(dev) for k, v in batch.items()})
    return x.float().cpu().numpy()[0]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="unet_dec",
                    choices=sorted(GEN_WORKLOADS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--steps", default="8,5,3",
                    help="comma list of diffusion step budgets, cycled")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--backend", default="kernels", choices=BACKENDS)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                    help="compute dtype of the lanes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scan-steps", default="auto",
                    help="DDIM steps per dispatch (int, or 'auto': from a "
                         "calibration, else 4)")
    ap.add_argument("--slo", default="standard", choices=sorted(SLO_CLASSES),
                    help="SLO class stamped on every submitted request")
    ap.add_argument("--timeout-ticks", type=int, default=None,
                    help="per-request scheduler-tick timeout")
    ap.add_argument("--autoscale", action="store_true",
                    help="grow/shrink lane batches with backlog")
    ap.add_argument("--snapshot-dir", default=None,
                    help="checkpoint scheduler state here; with a committed "
                         "snapshot there the server restores and resumes")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="auto-snapshot every N ticks (0: on demand only)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny widths: 16x16 images, small DCGAN")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to spawn (gloo; all on --device's card or "
                         "on the CPU): the lanes span a (data, model) mesh "
                         "of them (DESIGN.md §13)")
    ap.add_argument("--spatial", action="store_true",
                    help="with --devices: the diffusion lane's image rows "
                         "split over the mesh's model axis, halos "
                         "exchanged")
    return ap


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    ns = _parser().parse_args(argv)
    if ns.devices > 1:
        from repro_torch.launch.mesh import launch
        launch(_serve_rank, ns.devices, device=ns.device, args=(argv,))
        return
    _serve(ns)


def _serve_rank(device, argv) -> None:
    """One rank of ``--devices N``: the drain over a (data, model) mesh of
    the ranks, reported by rank 0."""
    from repro_torch.launch.mesh import live_mesh, make_smoke_mesh

    _serve(_parser().parse_args(argv), live_mesh(make_smoke_mesh(), device))


def _serve(ns, mesh=None) -> None:
    def say(*args):
        if mesh is None or mesh.rank == 0:
            print(*args)

    scan: int | str = ns.scan_steps if ns.scan_steps == "auto" \
        else int(ns.scan_steps)
    kw: dict = dict(batch=ns.batch, backend=ns.backend, device=ns.device,
                    scan_steps=scan, autoscale=ns.autoscale,
                    snapshot_dir=ns.snapshot_dir,
                    snapshot_every=ns.snapshot_every,
                    compute_dtype=None if ns.dtype == "fp32" else ns.dtype,
                    mesh=mesh, spatial=ns.spatial)
    if ns.smoke:
        kw.update(unet_widths=(8, 8), unet_hw=4, dcgan_nz=16, dcgan_ngf=4)
    cache = cal.default_cache_path()
    if cache.exists():          # calibrated admission estimates when a
        kw["calibration"] = cal.Calibration.load(cache)  # capture left one
    step_list = [int(s) for s in ns.steps.split(",")]
    if ns.snapshot_dir and ckpt.latest_step(ns.snapshot_dir) is not None:
        server = GenServer.restore(ns.snapshot_dir, device=ns.device,
                                   mesh=mesh,
                                   snapshot_every=ns.snapshot_every,
                                   calibration=kw.get("calibration"))
        say(f"[serve_gen] restored tick {server._tick} from "
            f"{ns.snapshot_dir}; resuming the drain")
    else:
        server = GenServer(**kw)
        for i in range(ns.requests):
            server.submit(ns.workload, steps=step_list[i % len(step_list)],
                          seed=ns.seed + i, slo=ns.slo,
                          timeout_ticks=ns.timeout_ticks)
    images = server.run()
    st = server.stats()
    lane = server._lanes.get(ns.workload)
    say(f"[serve_gen] {st['requests']} requests "
        f"({ns.workload}, steps {ns.steps}, slo={ns.slo}, "
        f"scan_steps={getattr(lane, 'scan_steps', 1)}, {ns.backend}, "
        f"{ns.dtype}, {server.device}) in "
        f"{st['wall_s']:.2f}s over {st['ticks']} ticks / "
        f"{st['device_steps']} dispatches ({st['substeps']} substeps): "
        f"{st['images_per_s']:.2f} img/s "
        f"(warm {st['warm_images_per_s']:.2f}), "
        f"p50 {st['latency_p50_s'] * 1e3:.0f} ms / "
        f"p99 {st['latency_p99_s'] * 1e3:.0f} ms")
    if st["degraded"] or st["retries"] or st["recoveries"] or st["snapshots"]:
        say(f"[serve_gen] fault plane: {st['degraded']:.0f} degraded "
            f"lane(s), {st['retries']:.0f} retries, "
            f"{st['recoveries']:.0f} recoveries, "
            f"{st['snapshots']:.0f} snapshots")
    dropped = int(st["cancelled"] + st["timeout"] + st["shed"] +
                  st["corrupt"])
    if dropped:
        say(f"[serve_gen] dropped {dropped} request(s): "
            f"{st['cancelled']:.0f} cancelled, {st['timeout']:.0f} "
            f"timed out, {st['shed']:.0f} shed at admission, "
            f"{st['corrupt']:.0f} corrupt")
    if images:
        shp = next(iter(images.values())).shape
        say(f"[serve_gen] image shape {shp}; "
            f"mean wait {st['mean_wait_ticks']:.1f} ticks "
            f"(max {st['max_wait_ticks']:.0f})")
    if mesh is None or mesh.rank == 0:
        print_serve_report(server, ns.workload, step_list, ns.requests,
                           getattr(lane, "scan_steps", 1))


def print_serve_report(server: "GenServer", workload: str,
                       step_list: list[int], requests: int,
                       scan_steps: int) -> dict:
    """Print the cycle model's ``serve_report`` of a drain (the paper's
    168-MAC array at 500 MHz, canonical widths: no time of the card) and,
    with a calibration, its estimate of this host's time; returns the
    report."""
    rep = cm.serve_report(GEN_WORKLOADS[workload](), steps=max(step_list),
                          scan_steps=scan_steps,
                          steps_list=[step_list[i % len(step_list)]
                                      for i in range(requests)],
                          calibration=server.calibration,
                          backend=server.backend)
    print(f"[serve_gen] cycle model ({workload}, canonical widths, "
          f"{max(step_list)} steps/sample, "
          f"{rep['dispatches_per_image']:.0f} dispatches/image): "
          f"{rep['images_per_s_ours']:.1f} img/s decomposed vs "
          f"{rep['images_per_s_naive']:.1f} naive "
          f"({rep['serve_speedup_vs_naive']:.2f}x); modeled drain "
          f"p50 {rep['latency_p50_ms']:.1f} ms / "
          f"p99 {rep['latency_p99_ms']:.1f} ms")
    if "calibrated_us_per_image" in rep:
        print(f"[serve_gen] calibrated host estimate: "
              f"{rep['calibrated_us_per_image']:.0f} us/image "
              f"({rep['calibrated_images_per_s']:.2f} img/s on this host, "
              f"{server.backend})")
    return rep


__all__ = ["init_noise", "np_percentile", "SLOClass", "SLO_CLASSES",
           "DEFAULT_STARVATION_TICKS", "DEFAULT_SCAN_STEPS", "MAX_SCAN_STEPS",
           "choose_scan_steps", "GenRequest", "GenServer",
           "reference_sample", "print_serve_report", "main"]


if __name__ == "__main__":
    main()
