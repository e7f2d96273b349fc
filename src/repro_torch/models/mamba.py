"""Mamba-1 selective SSM block (Jamba's sequence mixer), the port of
``repro.models.mamba``.

A block is ``in_proj``; a causal depthwise conv of width ``d_conv`` as
shifted adds; SiLU; the selective scan ``h_t = a_t * h_{t-1} + b_t`` over
an fp32 state (B, d_inner, d_state); the ``D`` skip; a ``silu(z)`` gate in
the model dtype; ``out_proj``.  Every product goes through
:func:`~repro_torch.models.layers.linear` (kernel 3 under
``backend="kernels"``): ``in_proj``, ``x_proj`` and ``out_proj`` in the
model dtype, ``dt_proj`` in fp32 on the fp32 copy of its weight, as the
reference's ``dt @ p["dt_proj"].astype(f32)``.

The scan keeps the reference's chunk structure (:func:`_selective_scan_
chunked`): chunks of :data:`SCAN_CHUNK` tokens only when the sequence is a
longer multiple of it, else one scan; within a chunk a scan of the
discretised pairs, and the carried state entering through the chunk's
``cumprod`` of the decays, so that the decay underflows where the
reference's does.  The reference's within-chunk ``associative_scan``
becomes a log-depth doubling scan (:func:`_scan`): the same recurrence,
its products taken in another order.  Under autograd each chunk runs
under a non-reentrant ``torch.utils.checkpoint``, as the reference
checkpoints its chunk body: the backward recomputes one chunk's (B, L,
d_inner, d_state) tensors at a time, where keeping every chunk's
doubling-scan levels would hold ~11.5 GiB a 512-token chunk at
Jamba-1.5-Large's width.  Serving (grad off) runs the chunks plainly and
launches the same products.  No kernel of the reference carries
the scan (it is XLA ops); a selective-scan kernel is a lever (ROADMAP.md).

Decode (S = 1) carries ``{"conv": (B, d_conv, d_inner) model dtype,
"ssm": (B, d_inner, d_state) fp32}``, written in place, as the attention
layers write their KV caches.  A block launches 4 products a call, or 2 +
2 x (S / SCAN_CHUNK) when the scan is chunked (``x_proj`` and ``dt_proj``
run once a chunk, and once more in the backward, where each checkpointed
chunk is recomputed).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear, normal_init

#: the reference's scan chunk (tests set it small on both packages)
SCAN_CHUNK = 512


def _cfg(cfg: ModelConfig):
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return m, d_in, dt_rank


def mamba_init(generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device=None) -> dict:
    """The reference's leaves, names, shapes and dtypes: the projections
    and ``conv_w``/``conv_b`` in ``dtype``; ``dt_bias``, ``A_log`` (log
    1..d_state on each channel) and ``D`` in fp32."""
    m, d_in, dt_rank = _cfg(cfg)
    f32 = torch.float32
    return {
        "in_proj": dense_init(generator, cfg.d_model, 2 * d_in, dtype,
                              device=device),
        "conv_w": normal_init(generator, (m.d_conv, d_in), m.d_conv ** -0.5,
                              dtype, device),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "x_proj": dense_init(generator, d_in, dt_rank + 2 * m.d_state, dtype,
                             device=device),
        "dt_proj": dense_init(generator, dt_rank, d_in, dtype, device=device),
        "dt_bias": torch.zeros((d_in,), dtype=f32, device=device),
        "A_log": torch.log(torch.arange(1, m.d_state + 1, dtype=f32,
                                        device=device)).repeat(d_in, 1),
        "D": torch.ones((d_in,), dtype=f32, device=device),
        "out_proj": dense_init(generator, d_in, cfg.d_model, dtype,
                               device=device),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    m, d_in, _ = _cfg(cfg)
    return {
        "conv": torch.zeros((batch, m.d_conv, d_in), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_in, m.d_state), dtype=torch.float32,
                           device=device),
    }


def _ssm_params(p, xc, cfg, backend):
    """Input-dependent (dt, B, C) and discretised (a, bx): ``a`` and ``bx``
    (..., d_in, N) fp32, ``Cc`` (..., N) fp32."""
    m, d_in, dt_rank = _cfg(cfg)
    proj = linear(xc, p["x_proj"], backend).float()
    dt, bc, cc = torch.split(proj, [dt_rank, m.d_state, m.d_state], dim=-1)
    dt = F.softplus(linear(dt, p["dt_proj"].float(), backend) + p["dt_bias"])
    a_mat = -torch.exp(p["A_log"])                            # (d_in, N)
    a = torch.exp(dt[..., None] * a_mat)                      # (..., d_in, N)
    bx = (dt * xc.float())[..., None] * bc[..., None, :]
    return a, bx, cc


def _scan(a, b):
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1 from ``h = 0``: the
    doubling (Hillis-Steele) scan of the reference's ``combine((al, bl),
    (ar, br)) = (al * ar, br + ar * bl)``, log2(S) steps over the whole
    tensors."""
    s, k = a.shape[1], 1
    while k < s:
        b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :-k]], dim=1)
        if 2 * k < s:
            a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def _selective_scan_chunked(p, xc, cfg, backend: str = "kernels"):
    """The scan of ``xc`` (B, S, d_in), contracted with C: (B, S, d_in)
    fp32.  Chunks of :data:`SCAN_CHUNK` when ``S`` is a larger multiple of
    it (each chunk's state ``h = local + cumprod(a) * h_in``), else one
    scan over ``S``, as the reference decides."""
    b, s, d_in = xc.shape
    chunk = SCAN_CHUNK if s % SCAN_CHUNK == 0 and s > SCAN_CHUNK else s
    if chunk == s:
        a, bx, cc = _ssm_params(p, xc, cfg, backend)
        return torch.einsum("bsdn,bsn->bsd", _scan(a, bx), cc)
    h = torch.zeros((b, d_in, cfg.mamba.d_state), dtype=torch.float32,
                    device=xc.device)
    remat = torch.is_grad_enabled()
    ys = []
    for c0 in range(0, s, chunk):
        args = (p, xc[:, c0:c0 + chunk], h, cfg, backend)
        h, y = (checkpoint(_chunk_body, *args, use_reentrant=False,
                           preserve_rng_state=False) if remat
                else _chunk_body(*args))
        ys.append(y)
    return torch.cat(ys, dim=1)


def _chunk_body(p, xblk, h_in, cfg, backend):
    """One chunk of the chunked scan from the carried state ``h_in`` (B,
    d_in, N): (the state after its last token, its output (B, L, d_in)
    fp32).  The state is a copy, not a view of the chunk's (B, L, d_in, N)
    states: the next chunk's checkpoint keeps its input for the backward,
    and a view would keep that whole tensor (512 MiB at Jamba-1.5-Large's
    width) alive with it."""
    a, bx, cc = _ssm_params(p, xblk, cfg, backend)
    hs = _scan(a, bx) + torch.cumprod(a, dim=1) * h_in[:, None]
    return hs[:, -1].clone(), torch.einsum("bldn,bln->bld", hs, cc)


def _causal_conv(xr, w, bias):
    """The causal depthwise conv over the sequence as the reference's
    shifted adds: ``sum_i pad(xr)[t - (k - 1 - i)] * w[i] + bias``, in
    ``xr``'s dtype, summed in the reference's order."""
    s, k = xr.shape[1], w.shape[0]
    return sum(F.pad(xr, (0, 0, k - 1 - i, 0))[:, :s] * w[i]
               for i in range(k)) + bias


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                cache: dict | None = None, backend: str = "kernels"
                ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, D) -> ((B, S, D), cache).  With ``cache`` (S must be 1)
    one decode step: the cache is written in place and returned."""
    m, d_in, _ = _cfg(cfg)
    s = x.shape[1]
    xz = linear(x, p["in_proj"], backend)
    xr, z = xz[..., :d_in], xz[..., d_in:]
    if cache is None:
        xc = F.silu(_causal_conv(xr, p["conv_w"], p["conv_b"]))
        y = _selective_scan_chunked(p, xc, cfg, backend)
        y = y + p["D"] * xc.float()
    else:
        if s != 1:
            raise ValueError(f"a Mamba decode step takes one token, got {s}")
        conv = torch.cat([cache["conv"][:, 1:], xr], dim=1)
        # the reference's einsum: an fp32 sum over the d_conv taps,
        # rounded once to the model dtype
        xc = (conv.float() * p["conv_w"].float()).sum(1).to(x.dtype) \
            + p["conv_b"]
        xc = F.silu(xc)[:, None, :]                           # (B, 1, d_in)
        a, bx, cc = _ssm_params(p, xc[:, 0], cfg, backend)    # (B, d_in, N)
        h = a * cache["ssm"] + bx
        y = torch.einsum("bdn,bn->bd", h, cc)[:, None, :]
        y = y + p["D"] * xc.float()
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(h)
    y = y.to(x.dtype) * F.silu(z)
    return linear(y, p["out_proj"], backend), cache
