"""Step-function builders: one step function per execution context.

The port of ``repro.launch.steps``:

* :func:`make_train_step` — the microbatched (gradient-accumulation) LM
  train step (its loss and gradients: :func:`make_value_and_grad`), on
  one device or, with ``mesh=``, on one rank of a ``(data, model)`` mesh
  (FSDP and tensor parallelism, :func:`model_parallel`); driven by
  :mod:`repro_torch.launch.train`.
* :func:`make_prefill_step` / :func:`make_serve_step` — LM prefill and
  KV-cached greedy decode; driven by :mod:`repro_torch.launch.serve`.  The
  reference's jitted serve step donates its caches; here the step writes
  them in place and returns them.
* :func:`make_gen_step` — one deterministic DDIM step over the U-Net
  denoiser (timestep embedding + denoiser forward through the conv kernels
  + DDIM update).  Timesteps and activity are data, so one step serves a
  batch of requests sitting at different timesteps.
* :func:`make_gen_scan_step` — ``K`` DDIM steps per dispatch.  The
  reference fuses them with ``lax.scan``; PyTorch runs eagerly, so here
  they are a Python loop over the single step (a CUDA graph of the K-step
  tick is a later lever, ROADMAP.md).

The LM builders take the model module from the config
(:func:`_model_fns`): :mod:`repro_torch.models.encdec` for an
encoder-decoder (whisper-small), whose batches carry ``frames`` (train,
prefill) or ``enc_out`` (serve), else :mod:`repro_torch.models.
transformer`.

The DDIM steps return a new image tensor and leave ``x`` as it was: where
the reference donates ``x`` to the jitted step, the port keeps the
functional form, and the serving lane rebinds its state to the result.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.util import canon_dtype
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (check_backend, chunked_softmax_ce,
                                       softmax_cross_entropy)
from repro_torch.optim import adamw_update, cosine_schedule


def _model_fns(cfg: ModelConfig):
    """The model module of ``cfg``: ``encdec`` for an encoder-decoder,
    else ``transformer`` (which refuses what it cannot run yet)."""
    if cfg.encoder_layers:
        return encdec
    transformer.check_supported(cfg)
    return transformer


def shard_params(tp, params: dict) -> dict:
    """This rank's blocks of a whole parameter tree over a
    :class:`~repro_torch.distributed.sharding.ModelParallel` layout, in the
    tree's structure (each block a tensor of its own)."""
    flat = tp.place(transformer.flatten_params(params))
    return transformer.unflatten_params(flat, params)


def model_parallel(cfg: ModelConfig, mesh):
    """The training layout of ``cfg`` over the live ``mesh``: a
    :class:`~repro_torch.distributed.sharding.ModelParallel` on the
    model's parameter shapes, which refuses what the mesh cannot train
    yet."""
    from repro_torch.distributed.sharding import ModelParallel

    like = transformer.flatten_params(
        _model_fns(cfg).init_params(None, cfg, device="meta"))
    return ModelParallel(mesh, cfg, {k: tuple(v.shape)
                                     for k, v in like.items()}, train=True)


def make_value_and_grad(cfg: ModelConfig, *, microbatches: int = 1,
                        backend: str = "kernels", tp=None):
    """``value_and_grad(params, batch) -> (loss, grads)`` of the train
    step: the mean CE loss (a 0-d fp32 tensor) and the flat gradients by
    ``flatten_params(params)``'s names, in the stacked layout.  A MoE
    config trains as any other, with no auxiliary loss, as the
    reference's: its stacked leaves (the fp32 ``ffn.router``, the expert
    stacks ``ffn.we_*``, ``ffn.shared.*``) get their gradients like the
    rest.

    A decoder-only model's loss is the chunked CE over the final hidden
    states; an encoder-decoder's is ``softmax_cross_entropy`` over the
    full logits of ``encdec.forward(tokens, frames)``, as the reference's.
    The gradients are taken with ``torch.autograd.grad`` through per-layer
    leaves (the model's ``unstack_blocks``).  With ``microbatches > 1`` the
    batch's rows (``frames`` with the rest) are cut into that many slices
    in order; their gradients are summed, in bf16 when
    ``cfg.opt_memory_mode == "bf16"`` and in fp32 otherwise, as the
    reference's accumulator, each slice's per-layer gradients added into
    their stack's slot, then divided by the count.  With one microbatch
    the gradients keep the parameters' dtype.

    ``tp`` (:func:`model_parallel`): one rank of a ``(data, model)`` mesh.
    ``params`` are then this rank's blocks and ``batch`` the GLOBAL batch,
    the same on every rank.  It is cut into the microbatches as above,
    and this data rank takes its share of the rows WITHIN each
    microbatch (:meth:`~repro_torch.distributed.sharding.ModelParallel.
    microbatch_rows`): each microbatch's CE is normalised by that
    microbatch's mask sum over every data rank, as in the reference,
    whose grouping a contiguous block of the batch cut locally would
    change.  The gradients are this rank's blocks of the whole one: the
    FSDP blocks' reduce-scatter runs in the backward, and the leaves no
    data axis splits are summed over ``data`` at the end (``reduce_grads``);
    the loss is summed over ``data``.  The same on every rank.
    """
    mod = _model_fns(cfg)
    check_backend(backend)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    acc_dtype = (torch.bfloat16 if cfg.opt_memory_mode == "bf16"
                 else torch.float32)

    def loss_fn(leaves, mb):
        if cfg.encoder_layers:
            logits = encdec.forward(leaves, mb["tokens"], mb["frames"], cfg,
                                    backend=backend)
            return softmax_cross_entropy(logits, mb["labels"], mb["mask"])
        hidden = transformer.forward(leaves, mb["tokens"], cfg,
                                     backend=backend, return_hidden=True,
                                     tp=tp)
        return chunked_softmax_ce(hidden, transformer.lm_head(leaves, cfg, tp),
                                  mb["labels"], mb["mask"], backend=backend,
                                  tp=tp)

    def loss_and_grads(leaves, flat, mb):
        loss = loss_fn(leaves, mb)
        # a leaf the loss does not reach (xLSTM's ``norm2``: no FFN when
        # ``d_ff == 0``) gets zeros, as ``jax.grad`` gives it
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    materialize_grads=True)
        return loss.detach(), dict(zip(flat, grads))

    def value_and_grad(params, batch):
        leaves = mod.unstack_blocks(params, cfg)
        flat = transformer.flatten_params(leaves)
        rows = batch["tokens"].shape[0]
        if rows % microbatches:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{microbatches} microbatches")
        size = rows // microbatches
        mine = slice(0, size) if tp is None else tp.microbatch_rows(size)
        if microbatches == 1:
            loss, g = loss_and_grads(leaves, flat,
                                     {k: v[mine] for k, v in batch.items()})
            grads = mod.stack_grads(g)
        else:
            grads = {k: torch.zeros(p.shape, dtype=acc_dtype,
                                    device=p.device)
                     for k, p in transformer.flatten_params(params).items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["mask"].device)
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size][mine]
                      for k, v in batch.items()}
                lmb, g = loss_and_grads(leaves, flat, mb)
                for name, gi in g.items():
                    key, r = mod.stacked_name(name)
                    slot = grads[key] if r is None else grads[key][r]
                    slot += gi.to(acc_dtype)
                loss = loss + lmb
                del g
            for a in grads.values():
                a.div_(microbatches)
            loss = loss / microbatches
        if tp is not None:
            grads, loss = tp.reduce_grads(grads), tp.data_sum(loss)
        return loss, grads

    return value_and_grad


def make_train_step(cfg: ModelConfig, *, lr_peak: float = 3e-4,
                    warmup: int = 2000, total_steps: int = 100_000,
                    microbatches: int = 1, backend: str = "kernels",
                    mesh=None):
    """Microbatched (gradient-accumulation) LM train step.

    Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``: ``params`` the stacked tree of the
    model's ``init_params``, ``opt_state`` an ``AdamWState`` over
    ``flatten_params(params)`` (``adamw_init(flat,
    memory_mode=cfg.opt_memory_mode)``), ``batch`` the ``tokens``,
    ``labels`` (B, S) and ``mask`` (B, S) tensors on the parameters'
    device, and for an encoder-decoder ``frames`` (B, encoder_ctx,
    d_model).  The metrics are 0-d tensors.

    Loss and gradients are :func:`make_value_and_grad`'s; ``lr`` is
    ``cosine_schedule(opt_state.step, ...)``, and AdamW updates the flat
    parameters (the returned tree holds new tensors; the arguments are
    left as they were).

    ``mesh`` (a live ``(data, model)`` mesh, :mod:`repro_torch.launch.
    mesh`): the step of this rank, the reference's ``train(cfg, mesh=)``
    step.  ``params`` and ``opt_state`` are this rank's blocks
    (``launch.train.init_state(tp=)``, or :func:`shard_params` of a whole
    tree, then ``adamw_init`` of the blocks: the AdamW state lies like the
    parameters), ``batch`` the global batch
    (:func:`make_value_and_grad`'s ``tp``); ``grad_norm`` is the whole
    gradient's (``ModelParallel.global_norm``) and AdamW updates each
    block elementwise, so the metrics are the same on every rank.  The
    step's layout is ``train_step.tp``.  A MoE, recurrent or
    encoder-decoder config over more than one rank raises
    ``NotImplementedError``.
    """
    tp = None if mesh is None else model_parallel(cfg, mesh)
    value_and_grad = make_value_and_grad(cfg, microbatches=microbatches,
                                         backend=backend, tp=tp)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        lr = cosine_schedule(opt_state.step, warmup, total_steps, lr_peak)
        new_flat, new_opt, gnorm = adamw_update(
            grads, opt_state, transformer.flatten_params(params), lr=lr,
            gnorm=None if tp is None else tp.global_norm(grads))
        new_params = transformer.unflatten_params(new_flat, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm,
                                     "lr": lr}

    train_step.tp = tp
    return train_step


def make_prefill_step(cfg: ModelConfig, backend: str = "kernels"):
    """``prefill_step(params, batch) -> logits`` (B, S, V): the cache-free
    forward of ``batch["tokens"]`` (B, S), over ``batch["frames"]`` for an
    encoder-decoder."""
    _model_fns(cfg)

    def prefill_step(params, batch):
        if cfg.encoder_layers:
            return encdec.forward(params, batch["tokens"], batch["frames"],
                                  cfg, backend=backend)
        return transformer.forward(params, batch["tokens"], cfg,
                                   backend=backend)

    return prefill_step


def make_serve_step(cfg: ModelConfig, backend: str = "kernels", tp=None):
    """One cached step: ``serve_step(params, caches, batch) -> (next_token
    (B, 1) int32, caches)`` for ``batch = {"token": (B, S), "cache_pos":
    host int}``, and for an encoder-decoder ``"enc_out"`` (B, T, D), the
    encoder output its cross attention reads.  The next token is the
    greedy ``argmax`` of the last position's logits, the first index on
    ties as JAX's ``argmax``.  ``tp``: the step of one rank of a
    :class:`~repro_torch.distributed.sharding.ModelParallel` layout, on
    its parameter blocks and caches; the head runs on the last position
    only and its vocab blocks are gathered before the argmax."""
    _model_fns(cfg)

    def serve_step(params, caches, batch):
        if tp is not None:
            logits, caches = transformer.decode_step(
                params, batch["token"], caches, batch["cache_pos"], cfg,
                backend=backend, tp=tp, last=True)
        elif cfg.encoder_layers:
            logits, caches = encdec.decode_step(
                params, batch["token"], batch["enc_out"], caches,
                batch["cache_pos"], cfg, backend=backend)
        else:
            logits, caches = transformer.decode_step(
                params, batch["token"], caches, batch["cache_pos"], cfg,
                backend=backend)
        next_token = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        return next_token.to(torch.int32), caches

    return serve_step


#: training-noise schedule length the DDIM trajectories subsample
DDIM_T_MAX = 1000


def ddim_alpha_bar(t_max: int = DDIM_T_MAX) -> torch.Tensor:
    """Cumulative signal level ``alpha_bar[t]`` of a linear beta schedule,
    fp32 on the CPU (computed there, so every device sees the same table)."""
    betas = torch.linspace(1e-4, 2e-2, t_max, dtype=torch.float32)
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(steps: int, t_max: int = DDIM_T_MAX) -> np.ndarray:
    """Host-side decreasing timestep trajectory of a ``steps``-step sample,
    evenly spaced over ``[t_max - 1, 0]`` (int32)."""
    if not 1 <= steps <= t_max:
        raise ValueError(f"steps must be in [1, {t_max}], got {steps}")
    return np.linspace(t_max - 1, 0, steps).round().astype(np.int32)


def make_gen_step(*, t_max: int = DDIM_T_MAX, decomposed: bool = True,
                  backend: str = "kernels", compute_dtype=None, rows=None):
    """One deterministic (eta=0) DDIM step over the U-Net denoiser.

    Returns ``gen_step(params, x, batch) -> x'``: ``x`` is the noisy image
    batch (B, S, S, C) and ``batch`` holds per-slot tensors on ``x``'s
    device:

    * ``t``      (B,) int — current timestep of each slot;
    * ``t_next`` (B,) int — next timestep, ``-1`` for the final step (land
      on x0);
    * ``active`` (B,) bool — inactive slots pass through bit for bit;
    * ``cond``   (B, C), optional — the denoiser's timestep conditioning of
      ``t`` (:func:`repro_torch.models.unet_decoder.timestep_cond`), when
      the caller computed it.

    The step runs :func:`repro_torch.models.unet_decoder.denoise` and the
    update ``x' = sqrt(ab') * x0_pred + sqrt(1 - ab') * eps``.
    ``compute_dtype`` (e.g. ``"bf16"``) runs the denoiser in that dtype; the
    update is evaluated in fp32 (the schedule spans ~1e-4 .. 1) and cast
    back to ``x.dtype``, so a bf16 lane stays bf16.  ``rows`` (the model
    axis of the image, a ``torch.distributed`` group): ``x`` is this
    rank's band of the rows (B, S / ranks, S, C), the denoiser runs on it
    (:func:`repro_torch.models.unet_decoder.denoise`) and the update is
    per element, so the step returns this rank's band.  Must run under
    ``torch.no_grad()`` on CUDA tensors (the kernels are forward only
    there).
    """
    from repro_torch.models import unet_decoder

    canon_dtype(compute_dtype)          # fail fast on an unported dtype
    alpha_bar = ddim_alpha_bar(t_max)
    on_device: dict[torch.device, torch.Tensor] = {}

    def gen_step(params, x, batch):
        t, t_next, active = batch["t"], batch["t_next"], batch["active"]
        ab = on_device.get(x.device)
        if ab is None:
            ab = on_device[x.device] = alpha_bar.to(x.device)
        eps = unet_decoder.denoise(params, x, t, decomposed=decomposed,
                                   backend=backend,
                                   compute_dtype=compute_dtype,
                                   cond=batch.get("cond"), rows=rows)
        ab_t = ab[t][:, None, None, None]
        ab_n = torch.where(t_next >= 0, ab[t_next.clamp(min=0)],
                           1.0)[:, None, None, None]
        xf, ef = x.float(), eps.float()
        x0 = (xf - torch.sqrt(1.0 - ab_t) * ef) * torch.rsqrt(ab_t)
        x_new = (torch.sqrt(ab_n) * x0
                 + torch.sqrt(1.0 - ab_n) * ef).to(x.dtype)
        return torch.where(active[:, None, None, None], x_new, x)

    return gen_step


def make_gen_scan_step(scan_steps: int, *, t_max: int = DDIM_T_MAX,
                       decomposed: bool = True, backend: str = "kernels",
                       compute_dtype=None, rows=None):
    """``scan_steps`` DDIM steps per dispatch.

    Returns ``gen_scan_step(params, x, batch) -> x'`` where ``batch`` holds
    padded per-slot trajectory matrices:

    * ``t``      (B, K) int — timestep of slot ``b`` at substep ``j``;
    * ``t_next`` (B, K) int — next timestep (``-1``: land on x0);
    * ``active`` (B, K) bool — padding columns pass through bit for bit;
    * ``cond``   (B, K, C), optional — each substep's conditioning.

    The loop body is exactly :func:`make_gen_step`'s step, so a K-step
    dispatch equals K single dispatches bit for bit, and the denoiser runs
    K times a dispatch whatever the activity.
    """
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    step = make_gen_step(t_max=t_max, decomposed=decomposed, backend=backend,
                         compute_dtype=compute_dtype, rows=rows)

    def gen_scan_step(params, x, batch):
        for j in range(scan_steps):
            x = step(params, x, {k: v[:, j] for k, v in batch.items()})
        return x

    return gen_scan_step


__all__ = ["shard_params", "model_parallel", "make_value_and_grad",
           "make_train_step",
           "make_prefill_step",
           "make_serve_step", "DDIM_T_MAX",
           "ddim_alpha_bar", "ddim_timesteps", "make_gen_step",
           "make_gen_scan_step"]
