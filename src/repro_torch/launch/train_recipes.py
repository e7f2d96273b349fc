"""The train steps of the port: fp32 masters, AdamW, loss scaling.

The port of ``repro.launch.train_recipes``: the ``"enet"`` and ``"espnet"``
recipes (per-pixel NLL of a segmentation net, batches ``{"image",
"label"}``) and the ``"dcgan"`` one (the generator alone against a pixel
target, batches ``{"z", "target"}``), in fp32 or, with
``compute_dtype="bf16"``, in the reference's mixed precision (DESIGN.md
§12).  One step, as in the reference:

* **fp32 masters**: parameters and AdamW state are fp32 ``{name: tensor}``
  dicts (the names of the model's ``named_parameters()``), whatever the
  compute dtype; a bf16 forward casts them per conv, so the gradients land
  on them in fp32;
* **fp32 loss**: the logits or images (bf16 under
  ``compute_dtype="bf16"``) are promoted to fp32 before the reduction;
* **dynamic loss scaling** (:class:`repro_torch.optim.DynamicLossScale`):
  the loss is amplified before the gradient and the gradients divided
  after;
* **skip on non-finite**: a step whose unscaled gradients hold an inf or
  NaN applies no update (parameters and optimizer state pass through
  bitwise via :func:`repro_torch.optim.select_tree`) and backs the scale
  off.

The step runs eagerly: the forward's convs launch the two conv kernels
and autograd's backward re-enters them through the kernels'
``torch.autograd.Function`` classes (``backend="kernels"``), or runs
``F.conv2d`` compositions (``backend="torch"``, the yardstick).  Each
recipe's model runs as a function of a flat parameter dict
(:func:`model_forward`) through a weightless shell on the meta device,
whose configuration is read off the parameters' shapes.  A CUDA graph of
the step is a later lever (ROADMAP.md).

:func:`make_sharded_train_step` is the data-parallel step (DESIGN.md §13),
run by every rank of a :class:`~repro_torch.launch.mesh.LiveMesh`: the
batch is cut into a fixed number of *virtual shards* C (independent of the
rank count), each rank takes the gradients of its contiguous run of
chunks one chunk after another, and
:func:`repro_torch.distributed.compression.mesh_allreduce` sums the whole
``(C, ...)`` stack in one fixed order.  Every rounding is then the same on
every rank count: with the dense transport the step is bitwise the 1-rank
step.  Unlike the reference, which refuses its Pallas backend there (its
``custom_vjp`` has no ``vmap`` rule), the kernels backend runs it: the
port takes the chunks' gradients in a loop, with no ``vmap``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.distributed import sharding as _sharding
from repro_torch.distributed.collectives import all_gather_cat
from repro_torch.distributed.compression import mesh_allreduce
from repro_torch.kernels.util import canon_dtype
from repro_torch.core.decompose import BACKENDS
from repro_torch.models.dcgan import DCGAN
from repro_torch.models.enet import ENet
from repro_torch.models.espnet import ESPNet
from repro_torch.optim import (DynamicLossScale, LossScaleState, adamw_init,
                               adamw_update, select_tree)

#: the reference's recipes
RECIPES = ("enet", "espnet", "dcgan")


class TrainState(NamedTuple):
    """Everything one step threads: fp32 params, AdamW state, scaler."""
    params: dict
    opt: object
    scale: LossScaleState


def _seg_loss(forward, params: dict, batch: dict) -> torch.Tensor:
    """Mean per-pixel NLL, reduced in fp32."""
    logits = forward(params, batch["image"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["label"][..., None].long())
    return nll.mean()


def _gen_loss(forward, params: dict, batch: dict) -> torch.Tensor:
    """Generator pixel-regression objective, reduced in fp32."""
    img = forward(params, batch["z"])
    return (img.float() - batch["target"].float()).square().mean()


@functools.lru_cache(maxsize=None)
def _meta(cls, *config):
    """A weightless shell of ``cls(*config)`` on the meta device."""
    return cls(*config, device="meta", generator=torch.Generator())


def _count(params: dict, prefix: str) -> int:
    """Distinct top-level modules named ``<prefix><i>``."""
    return len({k.split(".")[0] for k in params if k.startswith(prefix)})


def _shell(model: str, params: dict):
    """The module structure ``functional_call`` runs the parameters of a
    recipe's model through: the model on the meta device (no weights),
    configured from the parameters' names and shapes."""
    if model == "enet":
        return _meta(ENet, params["fullconv"].shape[-1])
    if model == "espnet":
        return _meta(ESPNet, params["head"].shape[-1], _count(params, "l2_"),
                     _count(params, "l3_"))
    nz, proj = params["proj"].shape
    size = 4 * 2 ** (_count(params, "up") + 1)
    ngf = proj // 16 // (size // 8)
    return _meta(DCGAN, size, nz, ngf, params["head"].shape[-1])


def model_forward(model: str, *, backend: str = "kernels",
                  decomposed: bool = True, compute_dtype=None):
    """``forward(params, inputs)``: a recipe's model as a function of a flat
    parameter dict (the reference's ``<model>.forward``), through
    ``torch.func.functional_call`` on a weightless shell.  The output
    comes back in ``compute_dtype`` (``None``: fp32)."""
    if model not in RECIPES:
        raise ValueError(f"unknown recipe {model!r}; known: {RECIPES}")
    kwargs = {"backend": backend, "decomposed": decomposed,
              "compute_dtype": canon_dtype(compute_dtype)}

    def forward(params: dict, inputs: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(_shell(model, params), params,
                                          (inputs,), kwargs)

    return forward


def loss_fn(model: str, *, backend: str = "kernels", decomposed: bool = True,
            compute_dtype=None):
    """``loss(params, batch)`` of a recipe; the forward runs in
    ``compute_dtype`` and the loss is reduced in fp32."""
    forward = model_forward(model, backend=backend, decomposed=decomposed,
                            compute_dtype=compute_dtype)
    loss = _gen_loss if model == "dcgan" else _seg_loss
    return functools.partial(loss, forward)


def loss_and_grads(loss, params: dict, batch: dict, scale=None):
    """``(loss, {name: grad})`` of ``loss(params, batch)``; ``scale(loss)``,
    when given, is what is differentiated (the loss-scaled objective)."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    value = loss(leaves, batch)
    target = value if scale is None else scale(value)
    grads = torch.autograd.grad(target, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


def batch_to(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A batch of either kind (``{"image", "label"}`` or ``{"z",
    "target"}``) as tensors on ``device``, labels as int64."""
    out = {k: torch.from_numpy(np.asarray(v)).to(device)
           for k, v in batch.items()}
    if "label" in out:
        out["label"] = out["label"].long()
    return out


def init_state(params: dict,
               scaler: DynamicLossScale | None = None) -> TrainState:
    """fp32 masters, AdamW state and loss-scale state.  ``params`` maps
    names to tensors or arrays (a reference tree through
    :func:`repro_torch.models.common.flatten_tree`), all on one device."""
    params = {k: (v.detach() if isinstance(v, torch.Tensor)
                  else torch.tensor(v)).to(torch.float32, copy=True)
              for k, v in params.items()}
    dev = next(iter(params.values())).device
    scaler = scaler or DynamicLossScale()
    return TrainState(params, adamw_init(params), scaler.init(dev))


def make_train_step(model: str, *, backend: str = "kernels",
                    decomposed: bool = True, compute_dtype=None,
                    scaler: DynamicLossScale | None = None,
                    lr: float = 1e-3, weight_decay: float = 1e-4):
    """``step(state, batch) -> (state', metrics)`` for one recipe.

    ``compute_dtype`` (``None``/``"fp32"`` or ``"bf16"``) is the forward's
    and backward's activation dtype; the state stays fp32 either way.
    ``batch`` is ``{"image", "label"}`` (``{"z", "target"}`` for
    ``"dcgan"``) tensors on the state's device (:func:`batch_to`).
    Metrics, 0-d tensors: ``loss`` (unscaled, fp32),
    ``grad_norm`` (of the applied gradients; 0 on a skipped step),
    ``scale`` (after the update), ``skipped`` (1.0 when non-finite
    gradients suppressed the update).
    """
    scaler = scaler or DynamicLossScale()
    loss = loss_fn(model, backend=backend, decomposed=decomposed,
                   compute_dtype=compute_dtype)

    def step(state: TrainState, batch: dict):
        value, grads = loss_and_grads(
            loss, state.params, batch,
            lambda v: scaler.scale(state.scale, v))
        return _apply(scaler, state, value, scaler.unscale(state.scale, grads),
                      lr, weight_decay)

    return step


def _apply(scaler: DynamicLossScale, state: TrainState, value, grads: dict,
           lr: float, weight_decay: float):
    """The step's tail from the unscaled gradients: the finite check, the
    branchless skip, AdamW and the scaler update."""
    finite = scaler.all_finite(grads)
    # a non-finite gradient must not reach the AdamW moments: zero the
    # grads before the update, then discard the whole update anyway
    zeros = {k: torch.zeros_like(g) for k, g in grads.items()}
    safe = select_tree(finite, grads, zeros)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=finite.device)
    new_params, new_opt, gnorm = adamw_update(
        safe, state.opt, state.params, lr=lr_t, weight_decay=weight_decay)
    new_params = select_tree(finite, new_params, state.params)
    new_opt = select_tree(finite, new_opt, state.opt)
    scale_state = scaler.update(state.scale, finite)
    metrics = {"loss": value,
               "grad_norm": torch.where(finite, gnorm,
                                        torch.zeros_like(gnorm)),
               "scale": scale_state.scale,
               "skipped": 1.0 - finite.float()}
    return TrainState(new_params, new_opt, scale_state), metrics


# ---------------------------------------------------------------------------
# Sharded train step (DESIGN.md §13)
# ---------------------------------------------------------------------------

def shard_batch(mesh, batch: dict, *, virtual_shards: int = 8) -> dict:
    """Cut a batch into ``(C, B/C, ...)`` chunks, ``C = virtual_shards``
    (fixed, whatever the rank count, so no chunk boundary moves with it).
    On a live mesh returns this rank's contiguous run of chunks
    ``(C / data extent, B/C, ...)``; on a geometry, all of them."""
    c = virtual_shards
    nd = _sharding.data_axis_size(mesh)
    if c % nd:
        raise ValueError(
            f"virtual_shards={c} must be a multiple of the data-axis "
            f"extent {nd} so every rank holds whole chunks")

    def chunk(x):
        b = x.shape[0]
        if b % c:
            raise ValueError(
                f"batch dim {b} not divisible by virtual_shards={c}")
        return x.reshape((c, b // c) + tuple(x.shape[1:]))

    chunks = {k: chunk(v) for k, v in batch.items()}
    if not hasattr(mesh, "rank"):
        return chunks
    sh = _sharding.batch_sharding(mesh, ndim=1)
    return {k: sh.shard(v) for k, v in chunks.items()}


def _map_tensors(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(fn, v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


def place_state(mesh, state: TrainState) -> TrainState:
    """Replicate ``state`` over the mesh's ranks: every tensor broadcast
    from its rank 0 (a geometry passes it through)."""
    if not hasattr(mesh, "rank"):
        return state
    return _map_tensors(mesh.replicate, state)


def make_sharded_train_step(model: str, mesh, *, virtual_shards: int = 8,
                            grad_transport: str = "dense",
                            backend: str = "kernels",
                            decomposed: bool = True, compute_dtype=None,
                            scaler: DynamicLossScale | None = None,
                            lr: float = 1e-3, weight_decay: float = 1e-4):
    """``step(state, chunks) -> (state', metrics)`` on every rank of the
    live ``mesh``.

    ``chunks`` is this rank's :func:`shard_batch`; ``state`` comes from
    :func:`place_state`.  The recipe is :func:`make_train_step`'s (fp32
    masters, fp32 loss, dynamic loss scaling, the branchless skip): each
    local chunk's loss-scaled gradients are taken in turn (as the
    reference's ``lax.map``: never batched), their stacks reduced by
    :func:`~repro_torch.distributed.compression.mesh_allreduce`, the chunk
    losses all-gathered; the loss is the mean of the chunk means, and the
    gradients are unscaled, then divided by ``virtual_shards``.

    * ``grad_transport="dense"``: fp32 stacks; bitwise on every rank count.
    * ``grad_transport="bf16"``: bf16 stacks on the wire; not bitwise.

    ``backend``: ``"kernels"`` (kernels 1 and 2 forward and backward on
    every rank) or ``"torch"``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    scaler = scaler or DynamicLossScale()
    loss = loss_fn(model, backend=backend, decomposed=decomposed,
                   compute_dtype=compute_dtype)
    group = _sharding.data_group(mesh)

    def step(state: TrainState, chunks: dict):
        local = next(iter(chunks.values())).shape[0]
        grads, losses = [], []
        for i in range(local):
            value, g = loss_and_grads(
                loss, state.params, {k: v[i] for k, v in chunks.items()},
                lambda v: scaler.scale(state.scale, v))
            grads.append(g)
            losses.append(value)
        stacks = {k: torch.stack([g[k] for g in grads]) for k in grads[0]}
        del grads
        grad_sum = mesh_allreduce(stacks, group, transport=grad_transport)
        losses = all_gather_cat(torch.stack(losses), group)
        # equal-size chunks: the batch mean is the mean of chunk means
        value = torch.sum(losses.float()) / virtual_shards
        grads = scaler.unscale(state.scale, grad_sum)
        grads = {k: g / virtual_shards for k, g in grads.items()}
        state, metrics = _apply(scaler, state, value, grads, lr,
                                weight_decay)
        metrics["losses"] = losses
        return state, metrics

    return step


__all__ = ["RECIPES", "TrainState", "model_forward", "loss_fn",
           "loss_and_grads", "batch_to", "init_state", "make_train_step",
           "shard_batch", "place_state", "make_sharded_train_step"]
