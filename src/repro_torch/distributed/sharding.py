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
* the model axis of an LM (:class:`ModelParallel`), served and trained:
  each rank holds its block of every parameter (and, trained, of the
  AdamW state) by :func:`param_pspec` (FSDP over ``data``, heads, FFN and
  vocab over ``model``), gathers a layer's FSDP blocks before the layer
  runs (their gradients come back by a fixed-order reduce-scatter), and
  sums the row-split products' partials over ``model`` in a fixed order.

:func:`shard_conv2d` runs :func:`repro_torch.core.decompose.conv2d` with
its ``group=`` over the mesh's data axes and, with ``spatial=True``, its
``rows=`` over the model axis.  Experts over the model axis, sequence
parallelism and the recurrent and encoder-decoder mixers over it wait
(:data:`MODEL_AXIS_ITEM`).  The
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

from repro_torch.distributed.collectives import (all_gather_cat, copy_in,
                                                 fsdp_gather, gather_bands,
                                                 gather_dim, pad_rows, share,
                                                 sum_over, sum_partials)

#: what the model axis of the mesh still waits for
MODEL_AXIS_ITEM = ("experts over the model axis (served, then trained), "
                   "sequence parallelism, and recurrent or "
                   "encoder-decoder mixers over it are a later item of "
                   "ROADMAP.md queue 1")

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

    def shard(self, t: torch.Tensor, rank: int | None = None
              ) -> torch.Tensor:
        """This rank's block of ``t`` (the mesh must be live), or mesh rank
        ``rank``'s (any geometry): each dim whose entry names axes is cut
        into their extent, contiguously, at the rank's row-major index
        along them."""
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n, i = self.mesh.axes_size(axes), self.mesh.index(axes, rank)
            per = t.shape[dim] // n
            t = t.narrow(dim, i * per, per)
        return t

    def unshard(self, block: torch.Tensor) -> torch.Tensor | None:
        """The whole tensor from every rank's :meth:`shard` block, on the
        host of mesh rank 0 (``None`` on the others).  Every rank of the
        mesh calls it: the blocks are copied to the host and gathered to
        rank 0 over the mesh's group (gloo takes host tensors in its
        ``gather``), which puts each at its rank's offsets."""
        import torch.distributed as dist

        mesh = self.mesh
        b = block.detach().cpu().contiguous()
        if mesh.size == 1:
            return b.clone()
        lead = mesh.rank == 0
        parts = [torch.empty_like(b) for _ in range(mesh.size)] if lead \
            else None
        dist.gather(b, parts, dst=mesh.ranks[0], group=mesh.everyone())
        if not lead:
            return None
        axes = [() if e is None else e if isinstance(e, tuple) else (e,)
                for e in self.spec]
        axes += [()] * (b.dim() - len(axes))
        whole = b.new_empty(tuple(n * mesh.axes_size(a)
                                  for n, a in zip(b.shape, axes)))
        for r, part in enumerate(parts):
            view = whole
            for dim, a in enumerate(axes):
                if a:
                    n = b.shape[dim]
                    view = view.narrow(dim, mesh.index(a, r) * n, n)
            view.copy_(part)
        return whole


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


def tree_shardings(mesh, tree, specs: dict | None = None):
    """A tree of :class:`NamedSharding` of the structure of ``tree``: the
    parameter tree (by :func:`~repro_torch.models.transformer.
    flatten_params`' names), a flat ``{name: leaf}`` dict, an
    ``AdamWState`` (``step`` replicated, the master and the moments placed
    like the parameters, the reference's ``_opt_shardings``) or a tuple of
    those.  ``specs``: ``{name: PartitionSpec}``; by default each leaf's
    :func:`param_pspec` of its shape (the whole's)."""
    from repro_torch.optim.adamw import AdamWState

    if isinstance(tree, AdamWState):
        return AdamWState(NamedSharding(mesh, PartitionSpec()),
                          *(None if t is None
                            else tree_shardings(mesh, t, specs)
                            for t in tree[1:]))
    if isinstance(tree, tuple):
        return tuple(tree_shardings(mesh, t, specs) for t in tree)

    def walk(node, prefix):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        out = {}
        for k, v in items:
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, (dict, list)):
                out[k] = walk(v, name)
            else:
                out[k] = NamedSharding(mesh, specs[name] if specs is not None
                                       else param_pspec(mesh, name,
                                                        tuple(v.shape)))
        return out if isinstance(node, dict) else list(out.values())
    return walk(tree, "")


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
    """How the ranks of a live ``(data, model)`` mesh serve and train a
    decoder-only LM (the reference places every parameter by
    :func:`make_param_shardings` on its smoke mesh, and its ``train``
    shards the AdamW state like the parameters; GSPMD runs the rest).

    Each rank holds its block of every parameter by :func:`param_pspec`
    (:meth:`place`): the dims whose spec names the data axes are FSDP
    blocks, gathered over the data group just before their layer runs and
    dropped after it (:meth:`layer`, :meth:`leaf`); under autograd the
    gather's backward is the fixed-order reduce-scatter of the blocks'
    gradients over ``data`` (:func:`~repro_torch.distributed.collectives.
    fsdp_gather`), and the training path gathers a layer inside its
    checkpointed function, so the recompute gathers again.  The dims that
    name ``model`` are Megatron's tensor parallelism, read from the
    resolved specs:

    * ``wq``/``wk``/``wv`` split by columns: a rank holds its heads (q
      heads ``[r*H/m, ...)`` with KV heads ``[r*Hkv/m, ...)``, contiguous
      GQA groups), runs kernel 4 on them and keeps their KV cache; ``wo``
      split by rows, its partial products summed over ``model`` in a
      fixed order (:func:`~repro_torch.distributed.collectives.
      sum_partials`, whose backward is the identity);
    * ``w_gate``/``w_up`` by columns, ``w_down`` by rows, summed the same
      way;
    * the input of a column-split block enters through
      :func:`~repro_torch.distributed.collectives.copy_in` (:meth:`hooks`),
      whose backward sums every rank's partial input gradient; so does a
      replicated leaf used on this rank's heads (qk-norm's gains);
    * ``embed`` rows by vocab: a rank looks up the ids in its range (zeros
      elsewhere) and the rows are summed over ``model`` (one term is
      nonzero, so the sum is exact; backward, each rank scatters the rows'
      gradients into its own vocab block); ``lm_head`` (or the tied
      ``embed.T``) by vocab columns: served, the logits gathered on V
      before the greedy argmax, which then breaks ties as on the whole
      row; trained, the cross entropy runs on this rank's columns
      (:func:`repro_torch.models.layers.chunked_softmax_ce`'s ``tp``).

    A spec that does not split (the dim does not divide) keeps that part
    whole on every rank.  A column split that would cut a head raises
    ``ValueError``; a MoE, recurrent or encoder-decoder config over a
    model extent above 1, or trained (``train=True``) over more than one
    rank, raises ``NotImplementedError`` (:data:`MODEL_AXIS_ITEM`).
    Served, the batch splits over the data axes where it divides
    (:meth:`batch_rows`); trained, each microbatch of the global batch
    must split (:meth:`microbatch_rows`).  The residual stream between
    layers is whole on every model rank, in serving and in training (no
    sequence split: sequence parallelism, the ``seq`` rule, is queued).

    Training's reductions are fixed-order sums: the gradients of leaves
    whose spec names no data axis over ``data`` (:meth:`reduce_grads`),
    the gradient norm's per-leaf sums over the ranks that split each leaf
    (:meth:`global_norm`), the loss and its normalisers over ``data``
    (:meth:`data_sum`).  The AdamW state is placed like the parameters
    (:meth:`shardings`, the reference's ``_opt_shardings``), and
    :meth:`unshard` gathers a tree whole on rank 0 for a checkpoint.
    """

    def __init__(self, mesh, cfg, shapes: dict, train: bool = False):
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
        self._check(shapes, train)   # on the geometry, before any group
        self.vocab = self._splits("embed", 0)
        self.data, self.model = data_group(mesh), model_group(mesh)
        self.rank = mesh.coords.get("model", 0)

    def _splits(self, name: str, dim: int) -> bool:
        sp = self.specs.get(name, ())
        return dim < len(sp) and "model" in _names(sp[dim])

    def _check(self, shapes: dict, train: bool) -> None:
        cfg, m = self.cfg, self.m
        ranks = self.mesh.size if train else m
        if ranks > 1:
            bad = [k for k in cfg.block_pattern
                   if k not in ("attn", "attn_local")]
            what = ("an encoder-decoder" if cfg.encoder_layers else
                    "a MoE FFN" if cfg.moe is not None else
                    f"the {bad[0]} mixer" if bad else None)
            if what:
                where = (f"trained over a mesh of {ranks} ranks" if train
                         else f"over a model extent of {m}")
                raise NotImplementedError(
                    f"{cfg.name}: {what} {where}: {MODEL_AXIS_ITEM}")
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
        return {k: self.block(k, t) for k, t in params.items()}

    def block(self, name: str, t: torch.Tensor, lead: int = 0
              ) -> torch.Tensor:
        """This rank's block of leaf ``name``, or of one layer of its stack
        (``t`` less the ``lead`` stacked axes, which no rule splits), as a
        tensor of its own: the ``keep`` of a sharded ``init_params``."""
        spec = PartitionSpec(*self.specs[name][lead:])
        return NamedSharding(self.mesh, spec).shard(t).contiguous().clone()

    def leaf(self, name: str, t: torch.Tensor, lead: int = 0
             ) -> torch.Tensor:
        """``t`` (leaf ``name``'s block, less ``lead`` stacked axes) with
        its FSDP dims gathered over the data group (differentiable)."""
        for d in self.fsdp[name]:
            t = fsdp_gather(t, d - lead, self.data)
        return t

    def layer(self, pi: int, p: dict) -> dict:
        """Layer views ``p`` of pattern position ``pi``'s stacks with their
        FSDP blocks gathered (the stacks' leading axis is gone); where the
        heads are split, a replicated mixer leaf (qk-norm's gains) enters
        through :func:`~repro_torch.distributed.collectives.copy_in`."""
        def walk(node, prefix):
            out = {}
            for k, v in node.items():
                name = f"{prefix}.{k}"
                if isinstance(v, dict):
                    out[k] = walk(v, name)
                    continue
                v = self.leaf(name, v, lead=1)
                if (self.heads[pi] and ".mixer." in name
                        and not any("model" in _names(e)
                                    for e in self.specs[name])):
                    v = copy_in(v, self.model)
                out[k] = v
            return out
        return walk(p, f"blocks.{pi}")

    def hooks(self, pi: int) -> dict:
        """``apply_layer``'s keywords at pattern position ``pi``: the copy
        into, and the sum out of, the attention's and the FFN's split
        blocks (``None`` where a block is whole)."""
        return {"copy": (self._copy if self.heads[pi] else None,
                         self._copy if self.ffn[pi] else None),
                "reduce": (self.attn_reduce(pi), self.ffn_reduce(pi))}

    def attn_reduce(self, pi: int):
        """The sum over ``model`` of the attention's output partials at
        pattern position ``pi`` (``None`` where the heads are whole)."""
        return self._reduce if self.heads[pi] else None

    def ffn_reduce(self, pi: int):
        return self._reduce if self.ffn[pi] else None

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        return sum_partials(t, self.model)

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        return copy_in(t, self.model)

    def embed(self, table: torch.Tensor, token: torch.Tensor
              ) -> torch.Tensor:
        """The embedding rows of ``token`` from this rank's vocab block of
        the (FSDP-gathered) ``table``."""
        if not self.vocab:
            return table[token]
        rows = table.shape[0]
        idx = token.long() - self.rank * rows
        hit = (idx >= 0) & (idx < rows)
        got = table[idx.clamp(0, rows - 1)]
        return sum_partials(torch.where(hit[..., None], got,
                                        torch.zeros_like(got)), self.model)

    def head_input(self, h: torch.Tensor) -> torch.Tensor:
        """The final hidden states entering the vocab-split head."""
        return self._copy(h) if self.vocab else h

    def vocab_columns(self, n: int) -> int | None:
        """The first vocab id of this rank's ``n`` head columns (``None``
        where the head is whole)."""
        return self.rank * n if self.vocab else None

    def model_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every model rank's ``t`` (exact in any
        order; not differentiable)."""
        if not self.vocab:
            return t
        return torch.amax(all_gather_cat(t.detach()[None], self.model),
                          dim=0)

    def logits(self, local: torch.Tensor) -> torch.Tensor:
        """This rank's vocab columns of the logits, gathered on V."""
        if not self.vocab:
            return local
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

    # ------------------------------------------------------------ training
    def microbatch_rows(self, size: int) -> slice:
        """This data rank's rows of a microbatch of ``size`` rows: an equal
        contiguous share (the reference's batch sharding of each
        microbatch slice); a microbatch that does not split raises, since
        a row held twice would count twice in the gradients."""
        if size % self.dp:
            raise ValueError(f"a microbatch of {size} rows does not split "
                             f"over a data extent of {self.dp}")
        return share(size, self.data)

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The fixed-order sum of every data rank's ``t`` (the loss, the
        CE normalisers; not differentiable)."""
        return sum_over(t.detach(), self.data)

    def reduce_grads(self, grads: dict) -> dict:
        """``grads`` (flat, this rank's blocks) with each leaf whose spec
        names no data axis (its gradient so far from this rank's rows
        only: norms, and a dim FSDP could not split) summed over ``data``
        in :func:`repro_torch.distributed.compression.mesh_allreduce`'s
        fixed order; the FSDP leaves' reduce-scatter ran in the
        backward."""
        from repro_torch.distributed.compression import mesh_allreduce

        names = [k for k in sorted(grads) if not self.fsdp[k]]
        if self.dp == 1 or not names:
            return grads
        flat = torch.cat([grads[k].reshape(-1) for k in names])
        total = mesh_allreduce({"g": flat[None]}, self.data)["g"]
        out, at = dict(grads), 0
        for k in names:
            n = grads[k].numel()
            out[k] = total[at:at + n].view(grads[k].shape)
            at += n
        return out

    def split_axes(self, name: str) -> tuple:
        """The mesh axes leaf ``name``'s spec splits it over, in the
        mesh's order."""
        named = {a for e in self.specs[name] for a in _names(e)}
        return tuple(a for a in self.mesh.axis_names if a in named)

    def global_norm(self, grads: dict) -> torch.Tensor:
        """sqrt of the sum of squares of every leaf of the whole gradient,
        in fp32, from this rank's blocks: each leaf's sum of squares is
        summed over the ranks that split it (one fixed-order sum per set
        of axes, over every such leaf at once), a replicated leaf counts
        once, and the leaves are added in sorted name order as
        :func:`repro_torch.optim.adamw.global_norm` adds them."""
        sq = {k: torch.sum(torch.square(grads[k].float()))
              for k in sorted(grads)}
        by_axes: dict = {}
        for k in sq:
            by_axes.setdefault(self.split_axes(k), []).append(k)
        total = {}
        for axes, names in by_axes.items():
            v = torch.stack([sq[k] for k in names])
            if axes:
                v = sum_over(v, self.mesh.group(axes))
            total.update(zip(names, v))
        return torch.sqrt(sum(total[k] for k in sorted(total)))

    def shardings(self, tree):
        """:func:`tree_shardings` of ``tree`` (this layout's specs, so the
        leaves may be blocks or whole)."""
        return tree_shardings(self.mesh, tree, self.specs)

    def unshard(self, tree):
        """Every leaf of ``tree`` (this rank's blocks: parameters, AdamW
        state) gathered whole onto rank 0's host, leaf by leaf in JAX's
        flattening order (:meth:`NamedSharding.unshard`); ``None`` on the
        other ranks.  Every rank calls it."""
        from repro_torch.checkpoint.ckpt import flatten_tree, unflatten_tree

        leaves, _ = flatten_tree(tree)
        specs, _ = flatten_tree(self.shardings(tree))
        whole = [sh.unshard(t) for t, sh in zip(leaves, specs)]
        return unflatten_tree(tree, whole) if self.mesh.rank == 0 else None


__all__ = ["PartitionSpec", "P", "NamedSharding", "MODEL_AXIS_ITEM",
           "resolve_spec", "install", "uninstall", "current_mesh",
           "use_mesh", "param_pspec", "make_param_shardings",
           "tree_shardings", "data_axes",
           "data_axis_size", "data_group", "model_size", "model_group",
           "make_groups", "ModelParallel",
           "batch_sharding",
           "image_sharding", "replicated", "phase_sharding", "pad_batch",
           "shard_conv2d"]
