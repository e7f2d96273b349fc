"""Logical-axis sharding rules of the port, and the data-parallel conv.

The port of ``repro.distributed.sharding``.  The rules are data, read
against a mesh geometry (:class:`repro_torch.launch.mesh.Mesh`, only its
``shape``), so they resolve for the 16x16 and 2x16x16 production meshes
without a device:

* ``_ACT_CANDIDATES``: a logical activation axis -> the ordered mesh-axis
  candidates; :func:`resolve_spec` takes the first that divides the dim
  and is not used yet (a constraint that does not divide is dropped);
* ``_PARAM_RULES``: a parameter name -> the logical axes of its trailing
  dims; :func:`param_pspec` applies them to the port's dotted names
  (``blocks.0.mixer.wq``, the reference's ``blocks/0/mixer/wq``).

A :class:`PartitionSpec` is a tuple with one entry a dim: ``None``, an
axis name, or a tuple of axis names.  A :class:`NamedSharding` pairs one
with a mesh; over a :class:`~repro_torch.launch.mesh.LiveMesh`,
:meth:`NamedSharding.shard` takes this rank's block of a tensor.

What runs across ranks is the data axis (DESIGN.md §13): the batch and
the decomposition's phase fold are plain data parallelism, and the
forward needs no collective but the gather of the outputs.
:func:`shard_conv2d` runs :func:`repro_torch.core.decompose.conv2d` with
its ``group=`` over the mesh's data axes.  The model axis (``spatial=``,
whose row halos the reference leaves to GSPMD, and the LM parameters
placed by :func:`param_pspec`) is a later item of ROADMAP.md: the rules
resolve for it, nothing executes it, and ``spatial=True`` raises.  The
port has no ``layers.lc`` constraint hook (its models place nothing), so
:func:`install` and :func:`use_mesh` only set the mesh that
:func:`current_mesh` returns.
"""

from __future__ import annotations

import math
import re
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from repro_torch.distributed.collectives import (all_gather_cat,
                                                 pad_rows, share)

#: what the model axis of the mesh waits for
MODEL_AXIS_ITEM = ("the model axis (spatial= row halos, LM parameters "
                   "over param_pspec) is a later item of ROADMAP.md "
                   "queue 1")

# logical activation axis -> ordered mesh-axis candidates (the first that
# divides the dim and is not already used wins; tuples shard over several
# axes).  The reference's table.
_ACT_CANDIDATES = {
    "data": (("pod", "data"), ("data",)),
    "data_kvseq": (("pod", "data"), ("data",)),
    "kvseq": (("pod", "data", "model"), ("data", "model"), ("pod", "data"),
              ("data",), ("model",)),
    "model": (("model",),),
    "model_kv": (("model",),),
    "expert": (("model",),),
    "fsdp": (("data",),),
    "seq": (("model",),),
    "spatial": (("model",),),
    "phase": (("pod", "data"), ("data",)),
}

# (name regex, logical axes of the LAST dims).  Stacked-layer leading axes
# are never sharded.  "fsdp" -> data axis.  The reference's rules.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("model", "fsdp")),
    (r"lm_head$", ("fsdp", "model")),
    (r"enc_pos$", (None, None)),
    (r"(wq|wk|wv)$", ("fsdp", "model")),
    (r"wo$", ("model", "fsdp")),
    (r"router$", ()),
    (r"we_gate$", ("expert", "fsdp", None)),
    (r"we_up$", ("expert", "fsdp", None)),
    (r"we_down$", ("expert", None, "fsdp")),
    (r"(w_gate|w_up)$", ("fsdp", "model")),
    (r"w_down$", ("model", "fsdp")),
    (r"in_proj$", ("fsdp", "model")),
    (r"out_proj$", ("model", "fsdp")),
    (r"x_proj$", ("model", None)),
    (r"dt_proj$", (None, "model")),
    (r"conv_w$", (None, "model")),
    (r"(conv_b|dt_bias|D)$", ("model",)),
    (r"A_log$", ("model", None)),
    (r"up_proj$", ("fsdp", "model")),
    (r"w_if$", ("model", None)),
    (r"(w_gates|r_gates|ff_up)$", ("fsdp", "model")),
    (r"ff_down$", ("model", "fsdp")),
    (r".*", ()),
]


class PartitionSpec(tuple):
    """One entry a dim: ``None``, a mesh axis, or a tuple of axes."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh."""
    mesh: object
    spec: PartitionSpec

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t`` (the mesh must be live): each dim
        whose entry names axes is cut into their extent, contiguously, at
        this rank's row-major index along them."""
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n, i = self.mesh.axes_size(axes), self.mesh.index(axes)
            per = t.shape[dim] // n
            t = t.narrow(dim, i * per, per)
        return t


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    return int(math.prod(mesh.shape[a] for a in axes))


def resolve_spec(mesh, logical: tuple, shape: tuple[int, ...]
                 ) -> PartitionSpec:
    """Logical names -> a spec, with the divisibility and reuse guards."""
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, logical):
        entry = None
        if name is not None:
            for cand in _ACT_CANDIDATES.get(name, ()):
                cand = tuple(a for a in cand if a in mesh.shape)
                if not cand or any(a in used for a in cand):
                    continue
                if dim % _axes_size(mesh, cand) == 0:
                    entry = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
        out.append(entry)
    return PartitionSpec(*out)


_CURRENT = None


def install(mesh) -> None:
    """Make ``mesh`` the current mesh.  The port has no ``lc`` hook for it
    to route (ROADMAP.md §3, "Not carried over")."""
    global _CURRENT
    _CURRENT = mesh


def uninstall() -> None:
    install(None)


def current_mesh():
    return _CURRENT


@contextmanager
def use_mesh(mesh):
    install(mesh)
    try:
        yield mesh
    finally:
        uninstall()


def param_pspec(mesh, path: str, shape: tuple[int, ...]) -> PartitionSpec:
    """The spec of a parameter by its name (dotted or ``/``-separated)."""
    for pat, logical in _PARAM_RULES:
        if re.search(pat, path):
            if not logical:
                return PartitionSpec()
            full = (None,) * (len(shape) - len(logical)) + tuple(logical)
            return resolve_spec(mesh, full, shape)
    return PartitionSpec()


def make_param_shardings(mesh, params: dict) -> dict:
    """``{name: NamedSharding}`` of a flat parameter dict (tensors, meta
    tensors or anything with a ``shape``)."""
    return {k: NamedSharding(mesh, param_pspec(mesh, k, tuple(v.shape)))
            for k, v in params.items()}


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh axes the batch (and the phase/parity fold) shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def data_axis_size(mesh) -> int:
    return _axes_size(mesh, data_axes(mesh))


def data_group(mesh):
    """The process group of a live mesh's data axes."""
    return mesh.group(data_axes(mesh))


def batch_sharding(mesh, ndim: int = 2) -> NamedSharding:
    """Tokens (B, S, ...) shard the batch over (pod, data)."""
    axes = data_axes(mesh)
    return NamedSharding(mesh, PartitionSpec(
        axes if len(axes) > 1 else axes[0], *([None] * (ndim - 1))))


def image_sharding(mesh, shape: tuple[int, ...], *,
                   spatial: bool = False) -> NamedSharding:
    """NHWC serving state: the batch over (pod, data), with ``spatial``
    the height over the model axis, each where it divides."""
    logical = ("data", "spatial" if spatial else None, None, None)
    return NamedSharding(mesh, resolve_spec(mesh, logical[:len(shape)],
                                            shape))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def phase_sharding(mesh, nphases: int, batch: int) -> NamedSharding:
    """The folded ``(nphases * batch, ...)`` phase/parity axis of a
    decomposed layout over the data axes, where it divides."""
    spec = resolve_spec(mesh, ("phase", None, None, None),
                        (nphases * batch, 1, 1, 1))
    return NamedSharding(mesh, spec)


def pad_batch(x: torch.Tensor, multiple: int):
    """Zero-pad the leading (batch) dim up to a multiple; returns (x,
    original batch)."""
    return pad_rows(x, multiple), x.shape[0]


def shard_conv2d(mesh, x: torch.Tensor, w: torch.Tensor, *,
                 spatial: bool = False, with_grads: bool = False,
                 **conv_kwargs):
    """:func:`repro_torch.core.decompose.conv2d` over the data axes of a
    live ``mesh``; every rank calls it with the same ``x``.

    The weights are broadcast from rank 0.  Each rank runs the conv on its
    share (:func:`repro_torch.core.decompose.split_kind`): its rows of the
    batch zero-padded to a multiple of the data extent, or for the
    phase-batched dilated engine its rows of the folded ``d*d*N`` phase
    batch, which is folded first and padded after (a batch of 1 at d = 2
    gives each of 4 ranks one phase block).  The output is gathered in
    batch order and padded rows are cropped.  A share's kernel launches
    take the plan of the unsharded launch (:func:`repro_torch.distributed.
    collectives.map_rows`), so the forward is bitwise the unsharded
    call's: kernels 1 and 2 compute a row the same in any batch at one
    plan.

    With ``with_grads=True`` returns ``(out, dx, dw)``, the gradients of
    ``sum(out)``: each rank differentiates its share; ``dx``'s rows are
    gathered (for the phase fold, whose shares scatter over the rows, the
    ranks' disjoint parts are summed), and ``dw`` is reduced by the
    fixed-order sum of :func:`repro_torch.distributed.compression.
    mesh_allreduce`.  Zero-padded rows add nothing to ``dw``.  The
    backward's launches take their shares' own plans.
    """
    from repro_torch.core.decompose import conv2d, split_kind
    from repro_torch.distributed.compression import mesh_allreduce

    if spatial:
        raise NotImplementedError(f"shard_conv2d(spatial=True): "
                                  f"{MODEL_AXIS_ITEM}")
    group = data_group(mesh)
    w = mesh.replicate(w)
    if not with_grads:
        return conv2d(x, w, group=group, **conv_kwargs)
    x = x.detach().requires_grad_()
    w = w.requires_grad_()
    with torch.enable_grad():
        y = conv2d(x, w, group=group, **conv_kwargs)
        dx, dw = torch.autograd.grad(y, (x, w), torch.ones_like(y))
    if split_kind(**conv_kwargs) == "phase":
        dx = mesh_allreduce({"dx": dx[None]}, group)["dx"]
    else:
        dx = pad_rows(dx, data_axis_size(mesh))
        dx = all_gather_cat(dx[share(dx.shape[0], group)], group)
    dw = mesh_allreduce({"dw": dw[None]}, group)["dw"]
    return y.detach(), dx[:x.shape[0]], dw


__all__ = ["PartitionSpec", "P", "NamedSharding", "MODEL_AXIS_ITEM",
           "resolve_spec", "install", "uninstall", "current_mesh",
           "use_mesh", "param_pspec", "make_param_shardings", "data_axes",
           "data_axis_size", "data_group", "batch_sharding",
           "image_sharding", "replicated", "phase_sharding", "pad_batch",
           "shard_conv2d"]
