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

What runs across ranks:

* the data axis (DESIGN.md §13): the batch and the decomposition's phase
  fold are plain data parallelism, and the forward needs no collective
  but the gather of the outputs;
* the model axis of an image (``spatial=``): its rows split in equal
  bands over ``model`` where :func:`image_sharding`'s guard resolves them,
  each rank convolving its band and the halo rows it exchanges with its
  neighbours (:func:`repro_torch.distributed.collectives.exchange_halos`;
  the reference leaves the halos to GSPMD), the output bands gathered;
* the model axis of an LM (:class:`ModelParallel`): each rank holds its
  block of every parameter by :func:`param_pspec` (FSDP over ``data``,
  heads, FFN and vocab over ``model``), gathers a layer's FSDP blocks
  before the layer runs, and sums the row-split products' partials over
  ``model`` in a fixed order.

:func:`shard_conv2d` runs :func:`repro_torch.core.decompose.conv2d` with
its ``group=`` over the mesh's data axes and, with ``spatial=True``, its
``rows=`` over the model axis.  Experts over the model axis, training
over it and sequence parallelism wait (:data:`MODEL_AXIS_ITEM`).  The
port has no ``layers.lc`` constraint hook (its models place nothing), so
:func:`install` and :func:`use_mesh` only set the mesh that
:func:`current_mesh` returns.
"""

from __future__ import annotations

import logging
import math
import re
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from repro_torch.distributed.collectives import (all_gather_cat,
                                                 gather_bands, pad_rows,
                                                 share)

#: what the model axis of the mesh still waits for
MODEL_AXIS_ITEM = ("experts over the model axis, training over it and "
                   "sequence parallelism are a later item of ROADMAP.md "
                   "queue 1")

_LOG = logging.getLogger(__name__)

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


def model_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def model_group(mesh):
    """The process group of a live mesh's model axis (``None`` without
    one)."""
    return mesh.group(("model",)) if "model" in mesh.shape else None


def make_groups(mesh) -> None:
    """Make every process group the mesh's collectives use (the data
    axes, the model axis, the whole mesh), in one order: groups are made
    collectively over the process group, so ranks running several meshes
    at once make them all first."""
    data_group(mesh)
    model_group(mesh)
    mesh.everyone()


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
    """:func:`repro_torch.core.decompose.conv2d` over a live ``mesh``;
    every rank calls it with the same ``x``.

    The weights are broadcast from rank 0.  Each rank runs the conv on its
    share of the batch over the data axes
    (:func:`repro_torch.core.decompose.split_kind`): its rows of the
    batch zero-padded to a multiple of the data extent, or for the
    phase-batched dilated engine its rows of the folded ``d*d*N`` phase
    batch, which is folded first and padded after (a batch of 1 at d = 2
    gives each of 4 ranks one phase block).  A share's kernel launches
    take the plan of the unsharded launch (:func:`repro_torch.distributed.
    collectives.map_rows`).

    With ``spatial=True`` the image's rows split in equal bands over the
    model axis where :func:`repro_torch.core.decompose.band_split` resolves
    them (the rows divide by the model extent, :func:`image_sharding`'s
    guard, and the band is a multiple of the stride or the dilation; else
    they stay whole on every rank, as the reference's spec resolves; that
    is logged):
    each rank takes its band of ``x``, exchanges the halo rows its conv
    reads with the bands beside it, and convolves its rows with the conv's
    padding only on an image edge (``conv2d(rows=)``); the output bands are
    gathered in rank order.  A band's launches take the whole image's
    plans (:func:`repro_torch.kernels.autotune.whole_image_plans`).  So
    the forward is bitwise the unsharded call's: kernels 1 and 2 compute a
    row the same in any batch and any band at one plan.

    With ``with_grads=True`` returns ``(out, dx, dw)``, the gradients of
    ``sum(out)``: each rank differentiates its share (its batch rows or
    phase blocks, its band; a halo's gradient goes back to the band that
    owns it); ``dx``'s rows are gathered (the ranks' disjoint parts are
    summed where the shares scatter over the rows: the phase fold, the
    bands), and ``dw`` is reduced by the fixed-order sum of
    :func:`repro_torch.distributed.compression.mesh_allreduce` over every
    rank that differentiated a share.  Zero-padded rows add nothing to
    ``dw``.  The backward's launches take their shares' own plans.
    """
    from repro_torch.core.decompose import band_split, conv2d, split_kind
    from repro_torch.distributed.compression import mesh_allreduce

    group = data_group(mesh)
    w = mesh.replicate(w)
    bands = None
    if spatial:
        bands = band_split(tuple(x.shape), tuple(w.shape), model_size(mesh),
                           **conv_kwargs)
        if isinstance(bands, str):
            _LOG.info("shard_conv2d(spatial=True): rows whole: %s", bands)
            bands = None

    def run(xx, ww):
        if bands is None:
            return conv2d(xx, ww, group=group, **conv_kwargs)
        rows = model_group(mesh)
        r, hb = mesh.coords["model"], xx.shape[1] // model_size(mesh)
        kw = dict(conv_kwargs)
        if kw.get("residual") is not None:
            kw["residual"] = kw["residual"][:, slice(*bands.out_rows[r])]
        y = conv2d(xx[:, r * hb:(r + 1) * hb], ww, group=group, rows=rows,
                   **kw)
        return gather_bands(y, bands.counts, rows)

    if not with_grads:
        return run(x, w)
    x = x.detach().requires_grad_()
    w = w.requires_grad_()
    with torch.enable_grad():
        y = run(x, w)
        dx, dw = torch.autograd.grad(y, (x, w), torch.ones_like(y))
    everyone = group if bands is None else mesh.everyone()
    if bands is not None or split_kind(**conv_kwargs) == "phase":
        dx = mesh_allreduce({"dx": dx[None]}, everyone)["dx"]
    else:
        dx = pad_rows(dx, data_axis_size(mesh))
        dx = all_gather_cat(dx[share(dx.shape[0], group)], group)
    dw = mesh_allreduce({"dw": dw[None]}, everyone)["dw"]
    return y.detach(), dx[:x.shape[0]], dw


# ---------------------------------------------------------------------------
# The LM's model axis: tensor parallelism and FSDP, served
# ---------------------------------------------------------------------------

def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class ModelParallel:
    """How the ranks of a live ``(data, model)`` mesh serve a decoder-only
    LM (the reference's ``Server`` places every parameter by
    :func:`make_param_shardings` on its smoke mesh; GSPMD runs the rest).

    Each rank holds its block of every parameter by :func:`param_pspec`
    (:meth:`place`): the dims whose spec names the data axes are FSDP
    blocks, gathered over the data group just before their layer runs and
    dropped after it (:meth:`layer`, :meth:`leaf`); the dims that name
    ``model`` are Megatron's tensor parallelism, read from the resolved
    specs:

    * ``wq``/``wk``/``wv`` split by columns: a rank holds its heads (q
      heads ``[r*H/m, ...)`` with KV heads ``[r*Hkv/m, ...)``, contiguous
      GQA groups), runs kernel 4 on them and keeps their KV cache; ``wo``
      split by rows, its partial products summed over ``model`` in a
      fixed order (:func:`~repro_torch.distributed.collectives.sum_over`);
    * ``w_gate``/``w_up`` by columns, ``w_down`` by rows, summed the same
      way;
    * ``embed`` rows by vocab: a rank looks up the ids in its range (zeros
      elsewhere) and the rows are summed over ``model`` (one term is
      nonzero, so the sum is exact); ``lm_head`` (or the tied
      ``embed.T``) by vocab columns, the logits gathered on V before the
      greedy argmax, which then breaks ties as on the whole row.

    A spec that does not split (the dim does not divide) keeps that part
    whole on every rank.  A column split that would cut a head raises
    ``ValueError``; a MoE, recurrent or encoder-decoder config over a
    model extent above 1 raises ``NotImplementedError``
    (:data:`MODEL_AXIS_ITEM`).  The batch splits over the data axes where
    it divides (:meth:`batch_rows`).  The residual stream between layers
    is whole on every model rank (no sequence split).
    """

    def __init__(self, mesh, cfg, shapes: dict):
        self.mesh, self.cfg = mesh, cfg
        self.m = model_size(mesh)
        self.dp = data_axis_size(mesh)
        self.specs = {k: param_pspec(mesh, k, tuple(v))
                      for k, v in shapes.items()}
        data = set(data_axes(mesh))
        #: per leaf, the dims whose blocks the data group gathers
        self.fsdp = {k: [d for d, e in enumerate(sp)
                         if data & set(_names(e))]
                     for k, sp in self.specs.items()}
        self._check(shapes)      # on the geometry, before any group
        self.vocab = self._splits("embed", 0)
        self.data, self.model = data_group(mesh), model_group(mesh)
        self.rank = mesh.coords.get("model", 0)

    def _splits(self, name: str, dim: int) -> bool:
        sp = self.specs[name]
        return dim < len(sp) and "model" in _names(sp[dim])

    def _check(self, shapes: dict) -> None:
        cfg, m = self.cfg, self.m
        if m > 1:
            bad = [k for k in cfg.block_pattern
                   if k not in ("attn", "attn_local")]
            what = ("an encoder-decoder" if cfg.encoder_layers else
                    "a MoE FFN" if cfg.moe is not None else
                    f"the {bad[0]} mixer" if bad else None)
            if what:
                raise NotImplementedError(
                    f"{cfg.name}: {what} over a model extent of {m}: "
                    f"{MODEL_AXIS_ITEM}")
        heads, ffn = {}, {}
        for pi in range(len(cfg.block_pattern)):
            pre = f"blocks.{pi}"
            split = {k: self._splits(f"{pre}.mixer.{k}", 2)
                     for k in ("wq", "wk", "wv")}
            split["wo"] = self._splits(f"{pre}.mixer.wo", 1)
            if any(split.values()):
                if (not all(split.values()) or cfg.num_heads % m
                        or cfg.kv_heads % m):
                    raise ValueError(
                        f"{cfg.name}: a column split of q/k/v over a model "
                        f"extent of {m} would cut a head ({cfg.num_heads} q "
                        f"heads, {cfg.kv_heads} KV heads)")
            heads[pi] = split["wq"]
            name = f"{pre}.ffn.w_gate"
            ffn[pi] = name in shapes and self._splits(name, 2)
        self.heads, self.ffn = heads, ffn

    def place(self, params: dict) -> dict:
        """This rank's block of every leaf of a flat ``{name: tensor}``
        dict, each a tensor of its own (the whole leaf can be dropped)."""
        return {k: NamedSharding(self.mesh, self.specs[k]).shard(
            t).contiguous().clone() for k, t in params.items()}

    def leaf(self, name: str, t: torch.Tensor, lead: int = 0
             ) -> torch.Tensor:
        """``t`` (leaf ``name``'s block, less ``lead`` stacked axes) with
        its FSDP dims gathered over the data group."""
        from repro_torch.distributed.collectives import gather_dim

        for d in self.fsdp[name]:
            t = gather_dim(t, d - lead, self.data)
        return t

    def layer(self, pi: int, p: dict) -> dict:
        """Layer views ``p`` of pattern position ``pi``'s stacks with their
        FSDP blocks gathered (the stacks' leading axis is gone)."""
        def walk(node, prefix):
            return {k: walk(v, f"{prefix}.{k}") if isinstance(v, dict)
                    else self.leaf(f"{prefix}.{k}", v, lead=1)
                    for k, v in node.items()}
        return walk(p, f"blocks.{pi}")

    def attn_reduce(self, pi: int):
        """The sum over ``model`` of the attention's output partials at
        pattern position ``pi`` (``None`` where the heads are whole)."""
        return self._reduce if self.heads[pi] else None

    def ffn_reduce(self, pi: int):
        return self._reduce if self.ffn[pi] else None

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed.collectives import sum_over
        return sum_over(t, self.model)

    def embed(self, table: torch.Tensor, token: torch.Tensor
              ) -> torch.Tensor:
        """The embedding rows of ``token`` from this rank's vocab block of
        the (FSDP-gathered) ``table``."""
        if not self.vocab:
            return table[token]
        from repro_torch.distributed.collectives import sum_over

        rows = table.shape[0]
        idx = token.long() - self.rank * rows
        hit = (idx >= 0) & (idx < rows)
        got = table[idx.clamp(0, rows - 1)]
        return sum_over(torch.where(hit[..., None], got,
                                    torch.zeros_like(got)), self.model)

    def logits(self, local: torch.Tensor) -> torch.Tensor:
        """This rank's vocab columns of the logits, gathered on V."""
        if not self.vocab:
            return local
        from repro_torch.distributed.collectives import gather_dim
        return gather_dim(local.contiguous(), local.dim() - 1, self.model)

    def kv_heads(self) -> int:
        """The KV heads of this rank's caches."""
        split = any(self.heads.values())
        return self.cfg.kv_heads // (self.m if split else 1)

    def batch_rows(self, b: int) -> slice:
        """This rank's rows of a batch of ``b`` (all where the data extent
        does not divide it)."""
        if b % self.dp:
            return slice(0, b)
        return share(b, self.data)

    def gather_batch(self, t: torch.Tensor, b: int) -> torch.Tensor:
        """The whole batch of ``b`` rows from each rank's
        :meth:`batch_rows`."""
        return t if b % self.dp else all_gather_cat(t.contiguous(),
                                                    self.data)


__all__ = ["PartitionSpec", "P", "NamedSharding", "MODEL_AXIS_ITEM",
           "resolve_spec", "install", "uninstall", "current_mesh",
           "use_mesh", "param_pspec", "make_param_shardings", "data_axes",
           "data_axis_size", "data_group", "model_size", "model_group",
           "make_groups", "ModelParallel",
           "batch_sharding",
           "image_sharding", "replicated", "phase_sharding", "pad_batch",
           "shard_conv2d"]
