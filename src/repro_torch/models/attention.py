"""Attention: MHA/GQA with RoPE, optional qk-norm, a sliding window and a
KV cache (the port of ``repro.models.attention``).

Head layout is merged (B, S, H, Dh), KV repeated to the full head count for
GQA, as in the reference.  Under ``backend="kernels"`` the scores go through
the port's flash-attention kernel (``kernels/flash_attention.py``), which
takes contiguous (B, H, S, Dh) operands, no GQA and a top-left causal mask
(query i sees keys j <= i).  The reference's cached mask is bottom-right,
``slot <= cache_pos + i``; the two agree in exactly the two cases serving
issues, and only those run on the kernel:

* a chunk at ``cache_pos = 0`` (parallel prefill): causal over its S slots;
* one token (decode) at any ``cache_pos``: non-causal over the live slots
  ``0..cache_pos``.

A chunk of more than one token at ``cache_pos > 0`` raises under
``backend="kernels"``; it never goes to a plain path.  Under autograd
(training) the kernel runs inside ``kernels.flash_attention.
FlashAttentionFn``, whose backward differentiates the reference model's
own query-chunked fp32 attention; serving (``torch.no_grad()``) calls the
kernel's wrapper directly.  Under
``backend="torch"`` every case runs ``F.scaled_dot_product_attention``
over the same live cache prefix, with an explicit mask where the chunk
needs one: the library yardstick.

The KV cache is updated in place: where the reference's jitted serve step
donates its caches and returns new ones, :func:`attention` writes the chunk
into ``kv_cache`` and returns that same dict.  The kernel still copies the
cache's live prefix (and, for GQA, its repeated heads) into contiguous
(B, H, T, Dh) operands at every step.

Cross attention (``xa=``, the encoder-decoder's, :mod:`repro_torch.models.
encdec`) takes k and v from ``xa``, applies no RoPE, neither writes nor
reads a cache, and is non-causal over all of ``xa``'s frames: the kernel's
non-causal case, which agrees with the reference's mask for any Sq and Sk.

Sliding-window layers (``kind="attn_local"`` with ``cfg.window``, Gemma-3's
local layers) take the reference's two paths:

* without a cache (training, ``make_prefill_step``) the causal mask is the
  band ``k_pos > q_pos - window``: the kernel's ``window`` under
  ``"kernels"`` (kernel 4 skips the kv tiles outside the band), an explicit
  boolean band mask to SDPA under ``"torch"``;
* with a cache, a ring of ``min(max_len, window)`` slots
  (:func:`init_kv_cache`): one token is written at slot ``cache_pos %
  size`` and attends, non-causal, over the live slots ``[:min(cache_pos +
  1, size)]``.  After the ring wraps its slots are not in position order;
  that is harmless because RoPE is applied before the write and the step
  is non-causal.  A chunk of more than one token runs only at ``cache_pos
  = 0`` and within the ring (causal within the chunk, the kernel's
  top-left case); anything else raises, where the reference's
  ``dynamic_update_slice`` would clamp the write (ROADMAP.md §3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as kfa
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (check_backend, dense_init, linear,
                                       rmsnorm, rmsnorm_init, rope)


def _check_kind(kind: str) -> None:
    if kind not in ("attn", "attn_local"):
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported: the port serves global "
            f"and sliding-window attention (ROADMAP.md, queue 1)")


def _window(cfg: ModelConfig, kind: str) -> int:
    """The band of a ``kind`` layer: ``cfg.window`` for ``attn_local``, 0
    (none) otherwise, as the reference's ``kind == "attn_local" and
    cfg.window``."""
    return cfg.window if kind == "attn_local" else 0


def attn_init(generator, cfg: ModelConfig, dtype=torch.bfloat16,
              device=None, cross: bool = False) -> dict:
    """q, k, v and o projections; qk-norm gains unless ``cross``."""
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(generator, d, cfg.num_heads * hd, dtype,
                         device=device),
        "wk": dense_init(generator, d, cfg.kv_heads * hd, dtype,
                         device=device),
        "wv": dense_init(generator, d, cfg.kv_heads * hd, dtype,
                         device=device),
        "wo": dense_init(generator, cfg.num_heads * hd, d, dtype,
                         device=device),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, kind: str,
                  dtype=torch.bfloat16, device=None,
                  kv_heads: int | None = None) -> dict:
    """Zero k and v of (batch, slots, kv_heads, head_dim): ``max_len``
    slots, or a sliding-window layer's ring of ``min(max_len, window)``.
    ``kv_heads``: a tensor-parallel rank's own heads (default all)."""
    _check_kind(kind)
    window = _window(cfg, kind)
    size = min(max_len, window) if window else max_len
    kvh = cfg.kv_heads if kv_heads is None else kv_heads
    shape = (batch, size, kvh, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ring_write(cache: dict, k: torch.Tensor, v: torch.Tensor, start: int):
    """Write a sliding-window layer's k and v (B, S, KVH, Dh) at positions
    ``start ..`` into its ring in place; return the live slots' k and v.

    One token goes to slot ``start % size`` and the live slots are
    ``[:min(start + 1, size)]``.  A chunk of S > 1 tokens is taken only at
    ``start = 0`` with S <= size (slots ``[:S]``): the reference writes any
    other chunk with ``dynamic_update_slice``, which clamps the start so
    that it fits the ring and so overwrites the wrong slots."""
    size, s = cache["k"].shape[1], k.shape[1]
    if s == 1:
        slot, live = start % size, min(start + 1, size)
    elif start:
        raise NotImplementedError(
            f"a {s}-token chunk at cache_pos {start} of a sliding-window "
            f"ring: only one token, or a chunk at cache_pos 0, is written "
            f"(the reference would clamp the write)")
    elif s > size:
        raise ValueError(f"a ring of {size} slots cannot take a {s}-token "
                         f"chunk")
    else:
        slot, live = 0, s
    cache["k"][:, slot:slot + s] = k
    cache["v"][:, slot:slot + s] = v
    return cache["k"][:, :live], cache["v"][:, :live]


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, KVH, T, Dh) -> (B, KVH*groups, T, Dh), each KV head's copies
    adjacent (the reference's head order), contiguous in one copy."""
    if groups == 1:
        return k
    b, kvh, t, hd = k.shape
    return k[:, :, None].expand(b, kvh, groups, t, hd).reshape(
        b, kvh * groups, t, hd)


def _attend(q, k, v, *, causal: bool, offset: int, backend: str,
            window: int = 0):
    """q (B, H, S, Dh) over k/v (B, H, T, Dh): query i sees keys j <= i +
    offset when ``causal``, every key otherwise, and with ``window`` > 0
    (causal, ``offset`` 0) only keys j > i - window.  ``offset`` is 0 or
    ``T - S`` (a chunk written behind ``T - S`` cached slots)."""
    s, t = q.shape[2], k.shape[2]
    if backend == "kernels":
        if causal and offset:
            raise NotImplementedError(
                f"the flash-attention kernel masks top-left: a {s}-token "
                f"chunk behind {offset} cached slots needs the bottom-right "
                f"mask (prefill at cache_pos 0, or decode one token)")
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return kfa.FlashAttentionFn.apply(q, k, v, causal, window)
        return kfa.flash_attention(q, k, v, causal=causal, window=window)
    check_backend(backend)
    kfa.check_window(s, t, causal, window)
    if not causal:
        return F.scaled_dot_product_attention(q, k, v)
    if not offset and not window:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    rows = torch.arange(s, device=q.device)[:, None] + offset
    cols = torch.arange(t, device=q.device)[None, :]
    mask = cols <= rows
    if window:
        mask &= cols > rows - window
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              kind: str = "attn", positions: torch.Tensor | None = None,
              kv_cache: dict | None = None, cache_pos: int | None = None,
              causal: bool = True, backend: str = "kernels",
              xa: torch.Tensor | None = None, reduce=None
              ) -> tuple[torch.Tensor, dict | None]:
    """Returns (output, kv_cache written in place or None).  x: (B, S, D).

    ``cache_pos`` is a host integer: token i of the chunk sits at absolute
    position ``cache_pos + i``.  Without a cache the causal mask is over
    the chunk's own positions (increasing, as the reference's forward
    passes them), which is the kernel's top-left mask.  With ``xa`` (B,
    Sk, D), cross attention: k and v from ``xa``, no RoPE, no cache, no
    mask.

    The head counts are read off the projections (``wq``'s and ``wk``'s
    columns over ``head_dim``): a tensor-parallel rank holds the column
    blocks of its q heads and of their KV heads (contiguous GQA groups),
    so the KV repeat acts on its local heads, and ``reduce`` sums ``wo``'s
    partial products (its row block) over the ranks."""
    _check_kind(kind)
    b, s, _ = x.shape
    hd = cfg.head_dim
    nh, kvh = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    groups = nh // kvh
    window = _window(cfg, kind)
    start = 0 if cache_pos is None else int(cache_pos)
    if positions is None:
        positions = torch.arange(start, start + s, device=x.device
                                 ).expand(b, s)

    kv_src = x if xa is None else xa
    sk = kv_src.shape[1]
    q = linear(x, p["wq"], backend).view(b, s, nh, hd)
    k = linear(kv_src, p["wk"], backend).view(b, sk, kvh, hd)
    v = linear(kv_src, p["wv"], backend).view(b, sk, kvh, hd)

    if cfg.qk_norm and "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if xa is None and cfg.rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    offset, new_cache = 0, None
    if xa is not None:
        causal, window = False, 0
    elif kv_cache is not None and window:
        k, v = _ring_write(kv_cache, k, v, start)
        new_cache = kv_cache
        # the ring holds only the band: one token sees every live slot, a
        # chunk at 0 is causal within itself
        causal, window = s > 1, 0
    elif kv_cache is not None:
        end = start + s
        if end > kv_cache["k"].shape[1]:
            raise ValueError(f"cache of {kv_cache['k'].shape[1]} slots "
                             f"cannot take positions {start}..{end - 1}")
        kv_cache["k"][:, start:end] = k
        kv_cache["v"][:, start:end] = v
        k, v = kv_cache["k"][:, :end], kv_cache["v"][:, :end]
        new_cache = kv_cache
        # one token sees every live slot; a longer chunk is causal within
        # itself, behind the ``start`` slots already cached
        causal, offset = s > 1, start

    qf = q.transpose(1, 2)                                # (B, H, S, Dh)
    kf = _repeat_kv(k.transpose(1, 2), groups)            # (B, H, T, Dh)
    vf = _repeat_kv(v.transpose(1, 2), groups)
    out = _attend(qf, kf, vf, causal=causal, offset=offset, backend=backend,
                  window=window if causal else 0)
    out = out.transpose(1, 2).reshape(b, s, nh * hd)
    out = linear(out, p["wo"], backend)
    return (out if reduce is None else reduce(out)), new_cache
