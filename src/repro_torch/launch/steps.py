"""Step-function builders of the serving paths.

The port of ``repro.launch.steps``' serving builders (its train step comes
with LM training, ROADMAP.md):

* :func:`make_prefill_step` / :func:`make_serve_step` — LM prefill and
  KV-cached greedy decode over :mod:`repro_torch.models.transformer`;
  driven by :mod:`repro_torch.launch.serve`.  The reference's jitted serve
  step donates its caches; here the step writes them in place and returns
  them.
* :func:`make_gen_step` — one deterministic DDIM step over the U-Net
  denoiser (timestep embedding + denoiser forward through the conv kernels
  + DDIM update).  Timesteps and activity are data, so one step serves a
  batch of requests sitting at different timesteps.
* :func:`make_gen_scan_step` — ``K`` DDIM steps per dispatch.  The
  reference fuses them with ``lax.scan``; PyTorch runs eagerly, so here
  they are a Python loop over the single step (a CUDA graph of the K-step
  tick is a later lever, ROADMAP.md).

The DDIM steps return a new image tensor and leave ``x`` as it was: where
the reference donates ``x`` to the jitted step, the port keeps the
functional form, and the serving lane rebinds its state to the result.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.util import canon_dtype
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

def make_prefill_step(cfg: ModelConfig, backend: str = "kernels"):
    """``prefill_step(params, batch) -> logits`` (B, S, V): the cache-free
    forward of ``batch["tokens"]`` (B, S)."""
    transformer.check_supported(cfg)

    def prefill_step(params, batch):
        return transformer.forward(params, batch["tokens"], cfg,
                                   backend=backend)

    return prefill_step


def make_serve_step(cfg: ModelConfig, backend: str = "kernels"):
    """One cached step: ``serve_step(params, caches, batch) -> (next_token
    (B, 1) int32, caches)`` for ``batch = {"token": (B, S), "cache_pos":
    host int}``.  The next token is the greedy ``argmax`` of the last
    position's logits, the first index on ties as JAX's ``argmax``."""
    transformer.check_supported(cfg)

    def serve_step(params, caches, batch):
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
                  backend: str = "kernels", compute_dtype=None):
    """One deterministic (eta=0) DDIM step over the U-Net denoiser.

    Returns ``gen_step(params, x, batch) -> x'``: ``x`` is the noisy image
    batch (B, S, S, C) and ``batch`` holds per-slot tensors on ``x``'s
    device:

    * ``t``      (B,) int — current timestep of each slot;
    * ``t_next`` (B,) int — next timestep, ``-1`` for the final step (land
      on x0);
    * ``active`` (B,) bool — inactive slots pass through bit for bit.

    The step runs :func:`repro_torch.models.unet_decoder.denoise` and the
    update ``x' = sqrt(ab') * x0_pred + sqrt(1 - ab') * eps``.
    ``compute_dtype`` (e.g. ``"bf16"``) runs the denoiser in that dtype; the
    update is evaluated in fp32 (the schedule spans ~1e-4 .. 1) and cast
    back to ``x.dtype``, so a bf16 lane stays bf16.  Must run under
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
                                   compute_dtype=compute_dtype)
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
                       compute_dtype=None):
    """``scan_steps`` DDIM steps per dispatch.

    Returns ``gen_scan_step(params, x, batch) -> x'`` where ``batch`` holds
    padded per-slot trajectory matrices:

    * ``t``      (B, K) int — timestep of slot ``b`` at substep ``j``;
    * ``t_next`` (B, K) int — next timestep (``-1``: land on x0);
    * ``active`` (B, K) bool — padding columns pass through bit for bit.

    The loop body is exactly :func:`make_gen_step`'s step, so a K-step
    dispatch equals K single dispatches bit for bit, and the denoiser runs
    K times a dispatch whatever the activity.
    """
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    step = make_gen_step(t_max=t_max, decomposed=decomposed, backend=backend,
                         compute_dtype=compute_dtype)

    def gen_scan_step(params, x, batch):
        for j in range(scan_steps):
            x = step(params, x, {k: v[:, j] for k, v in batch.items()})
        return x

    return gen_scan_step


__all__ = ["make_prefill_step", "make_serve_step", "DDIM_T_MAX",
           "ddim_alpha_bar", "ddim_timesteps", "make_gen_step",
           "make_gen_scan_step"]
