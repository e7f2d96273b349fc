"""Meshes of the port: their geometry, the live mesh over a process group,
and the launcher that starts one process per rank.

The port of ``repro.launch.mesh``.  The reference is single-controller:
one process holds a ``jax.sharding.Mesh`` over its devices.  The port is
SPMD: one process per rank under ``torch.distributed``, each running the
same program.  Three layers:

* :class:`Mesh` is the geometry alone: ``shape``, an ordered ``{axis:
  size}``, and ``axis_names``.  :func:`make_production_mesh` gives the
  16x16 (one pod) and 2x16x16 (two pods) geometries the sharding rules are
  written for; :func:`make_smoke_mesh` and :func:`make_train_mesh` size a
  ``(data, model)`` or ``(data,)`` geometry to a rank count.  The rules of
  :mod:`repro_torch.distributed.sharding` read only ``shape``.
* :class:`LiveMesh` is a geometry over the current process group: ranks
  are laid out row-major over the axes (as ``jax.make_mesh`` lays out
  devices), and :meth:`LiveMesh.group` gives the subgroup of the ranks that
  differ only along some axes (one ``dist.new_group`` per subgroup, made
  by every rank in the same order).
* :func:`launch` starts ``world`` ranks with ``torch.multiprocessing``
  (start method ``spawn``), each with ``torch.set_num_threads(1)`` (oneDNN
  orders a CPU reduction by its thread count), joined through a ``file://``
  rendezvous in a temporary directory (no network).  The backend follows
  the devices: ranks on the CPU use gloo; ranks that share one CUDA card
  use gloo over CUDA tensors (NCCL refuses two ranks on one card); ranks
  on distinct cards use NCCL (untested: the port's machines have one
  card).  A rank that raises makes :func:`launch` raise; there is no
  fallback backend.  On CUDA the parent builds the kernels before it
  spawns, so the ranks only load the libraries.

CPU usage (each rank's function must live in an importable module)::

    from repro_torch.launch.mesh import launch
    outs = launch(fn, 4, device="cpu", args=(...,))   # [fn's value per rank]
"""

from __future__ import annotations

import itertools
import math
import os
import shutil
import tempfile
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class Mesh:
    """A mesh geometry: ``shape`` maps each axis to its size, in order."""
    shape: dict = field(hash=False)
    axis_names: tuple = ()

    def __post_init__(self):
        if not self.axis_names:
            object.__setattr__(self, "axis_names", tuple(self.shape))
        if tuple(self.shape) != tuple(self.axis_names):
            raise ValueError(f"axis_names {self.axis_names} do not follow "
                             f"the shape's axes {tuple(self.shape)}")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def geometry(self) -> dict:
        """JSON form: ``{"shape": [sizes], "axes": [names]}``."""
        return {"shape": [int(self.shape[a]) for a in self.axis_names],
                "axes": list(self.axis_names)}

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes, rank: int) -> int:
        """Mesh rank ``rank``'s row-major index along ``axes`` (0 for no
        axes); ranks lie row-major over the axes."""
        coords, r = {}, rank
        for a in reversed(self.axis_names):
            r, coords[a] = divmod(r, self.shape[a])
        i = 0
        for a in axes:
            i = i * self.shape[a] + coords[a]
        return i


def mesh_of(shape, axes) -> Mesh:
    return Mesh(dict(zip(axes, (int(s) for s in shape))), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 two pods (512 chips): the
    geometry only, as the sharding rules read it."""
    if multi_pod:
        return mesh_of((2, 16, 16), ("pod", "data", "model"))
    return mesh_of((16, 16), ("data", "model"))


def _world(devices: int | None) -> int:
    if devices:
        return devices
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_smoke_mesh(devices: int | None = None, model: int = 2) -> Mesh:
    """A ``(data, model)`` geometry over ``devices`` ranks (default: the
    current process group's size, or 1)."""
    n = _world(devices)
    model = min(model, n)
    return mesh_of((n // model, model), ("data", "model"))


def make_train_mesh(devices: int | None = None) -> Mesh:
    """A 1-D ``(data,)`` geometry for the sharded conv train step: the
    recipes chunk the batch over ``data`` only (DESIGN.md §13)."""
    return mesh_of((_world(devices),), ("data",))


class LiveMesh(Mesh):
    """A geometry over ranks of the current ``torch.distributed`` process
    group: ``ranks`` (global ranks, ascending; default every rank).

    Mesh rank ``r`` (``ranks[r]``) sits at the row-major coordinates of
    ``r`` over the axes; ``rank`` is this process's mesh rank, ``None``
    when it is not in ``ranks``.  ``device`` is where this rank computes.
    Subgroups are made by :meth:`group`, which every rank of the process
    group must call at the same point of the program (SPMD, members or
    not), since ``dist.new_group`` is collective over the world.
    """

    def __init__(self, geometry: Mesh, device=None, ranks=None):
        import torch.distributed as dist

        super().__init__(dict(geometry.shape), tuple(geometry.axis_names))
        if not dist.is_initialized():
            raise RuntimeError("LiveMesh needs an initialised process group "
                               "(start the ranks with launch())")
        world = dist.get_world_size()
        ranks = list(range(world) if ranks is None else ranks)
        if len(ranks) != self.size or ranks != sorted(set(ranks)):
            raise ValueError(f"mesh {self.geometry()} needs {self.size} "
                             f"ascending ranks, got {ranks}")
        if ranks[-1] >= world:
            raise ValueError(f"ranks {ranks} of a {world}-rank group")
        me = dist.get_rank()
        rank = ranks.index(me) if me in ranks else None
        object.__setattr__(self, "ranks", ranks)
        object.__setattr__(self, "rank", rank)
        object.__setattr__(self, "device", torch.device(
            device if device is not None else "cpu"))
        object.__setattr__(self, "_groups", {})
        sizes = [self.shape[a] for a in self.axis_names]
        layout = list(itertools.product(*(range(s) for s in sizes)))
        object.__setattr__(self, "_layout", layout)
        object.__setattr__(self, "coords", None if rank is None else
                           dict(zip(self.axis_names, layout[rank])))

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def index(self, axes, rank: int | None = None) -> int:
        """This rank's (or mesh rank ``rank``'s) row-major index along
        ``axes`` (0 for no axes)."""
        return super().index(axes, self.rank if rank is None else rank)

    def everyone(self):
        """The process group of every rank of the mesh."""
        return self.group(self.axis_names)

    def replicate(self, t: torch.Tensor) -> torch.Tensor:
        """Mesh rank 0's ``t`` on every rank of the mesh (a copy)."""
        from repro_torch.distributed.collectives import broadcast
        return broadcast(t, self.ranks[0], self.everyone())

    def group(self, axes):
        """The process group of the mesh ranks that share this rank's
        coordinates on every axis but ``axes`` (in row-major order along
        ``axes``); ``None`` on a rank outside the mesh."""
        import torch.distributed as dist

        axes = tuple(axes)
        if axes in self._groups:
            return self._groups[axes]
        pos = {a: i for i, a in enumerate(self.axis_names)}
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            members = [r for r, c in enumerate(self._layout)
                       if all(c[pos[a]] == v for a, v in zip(others, fixed))]
            g = dist.new_group([self.ranks[r] for r in members])
            if self.rank in members:
                mine = g
        self._groups[axes] = mine
        return mine


def live_mesh(geometry: Mesh | None = None, device=None,
              ranks=None) -> LiveMesh:
    """``geometry`` (default: :func:`make_train_mesh` of ``ranks``, or of
    the world) over ``ranks`` of the current process group."""
    if geometry is None:
        geometry = make_train_mesh(None if ranks is None else len(ranks))
    return LiveMesh(geometry, device, ranks)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def rank_devices(device, world: int) -> list[torch.device]:
    """Each rank's device: ``"cpu"``; one CUDA device for every rank
    (``None`` and ``"cuda"`` are ``cuda:0``; raises without a card); or a
    list of ``world`` devices."""
    from repro_torch.kernels.util import resolve_device

    if isinstance(device, (list, tuple)):
        devs = [resolve_device(d) for d in device]
        if len(devs) != world:
            raise ValueError(f"{len(devs)} devices for {world} ranks")
    else:
        d = resolve_device(device)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        devs = [d] * world
    return devs


def backend_for(devices: list[torch.device]) -> str:
    """gloo on the CPU and for ranks that share a card (one rank alone
    included); NCCL for ranks on distinct cards."""
    if any(d.type == "cpu" for d in devices):
        if any(d.type != "cpu" for d in devices):
            raise ValueError("ranks on the CPU and on cards at once")
        return "gloo"
    if len(set(devices)) < len(devices) or len(devices) == 1:
        return "gloo"
    return "nccl"


def _rank_main(rank, world, devices, backend, tmp, fn):
    import pickle
    import time

    import torch.distributed as dist

    t0 = time.perf_counter()
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    torch.set_num_threads(1)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    t1 = time.perf_counter()
    try:
        out = fn(dev, *args)
        t2 = time.perf_counter()
        torch.save({"value": out, "seconds": {
            "init": t1 - t0, "fn": t2 - t1}},
            os.path.join(tmp, f"rank{rank:03d}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


class Ranks:
    """The ranks of one :func:`launch` with ``join=False``."""

    def __init__(self, context, tmp: str, world: int):
        self._context, self._tmp, self.world = context, tmp, world
        #: per rank, after :meth:`result`: seconds to set the rank up (from
        #: the rank's first line: the device and the process group) and in
        #: ``fn``
        self.seconds = None

    def result(self) -> list:
        """Wait for every rank; their values in rank order.  A rank that
        raised makes this raise after the others are stopped."""
        try:
            while not self._context.join():
                pass
            saved = [torch.load(os.path.join(self._tmp, f"rank{r:03d}.pt"),
                                weights_only=False)
                     for r in range(self.world)]
            self.seconds = [s["seconds"] for s in saved]
            return [s["value"] for s in saved]
        finally:
            shutil.rmtree(self._tmp, ignore_errors=True)


def launch(fn, world: int, *, device=None, args: tuple = (),
           join: bool = True):
    """Run ``fn(device, *args)`` on ``world`` ranks; returns each rank's
    value, in rank order (moved to the CPU by ``fn``: values travel
    through ``torch.save``), or with ``join=False`` a :class:`Ranks` whose
    ``result()`` waits for them (several worlds may run at once).

    ``fn`` must be importable by a spawned process (a module function).
    A rank that raises makes this raise (``ProcessRaisedException``, with
    the rank's traceback) after the other ranks are stopped.
    """
    import torch.multiprocessing as mp

    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    devices = rank_devices(device, world)
    backend = backend_for(devices)
    if devices[0].type == "cuda":
        from repro_torch.kernels import build
        build.build()
    import pickle

    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        # the arguments travel through a file: pickled into a child's
        # start-up pipe, a large one would hold the parent until that child
        # has imported its modules, and the ranks would start one by one
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
        context = mp.start_processes(
            _rank_main, args=(world, devices, backend, tmp, fn),
            nprocs=world, join=False, start_method="spawn")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    ranks = Ranks(context, tmp, world)
    return ranks.result() if join else ranks


__all__ = ["Mesh", "LiveMesh", "mesh_of", "make_production_mesh",
           "make_smoke_mesh", "make_train_mesh", "live_mesh", "rank_devices",
           "backend_for", "Ranks", "launch"]
