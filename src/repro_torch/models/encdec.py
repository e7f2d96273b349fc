"""Whisper-style encoder-decoder transformer, the port of
``repro.models.encdec``.

The encoder takes frame embeddings (B, T, D): the reference's stub, or the
port's Whisper frontend on the conv engine (:mod:`repro_torch.models.
whisper`, kernel 1), the pairing the reference's docstring points at.  It
adds the learned ``enc_pos`` in ``cfg.dtype`` (one bf16 rounding, as the
reference) and runs bidirectional self-attention layers (RoPE over the
frame positions, as the reference).  Each decoder layer is causal
self-attention with a KV cache, cross attention to the encoder output and
the SwiGLU FFN, each pre-RMSNorm residual.

Parameters carry across from the reference name for name: ``embed``,
``enc_pos``, ``enc_blocks`` and ``dec_blocks`` (stacked on a leading
``(encoder_layers,)`` / ``(num_layers,)`` axis), ``enc_norm``,
``dec_norm``, ``lm_head``.  The reference's ``lax.scan`` over each stack is
a Python loop over its layers; for training, :func:`unstack_blocks` gives
each layer leaves of its own and :func:`stack_grads` puts the gradients
back into the stacked layout, as in :mod:`~repro_torch.models.transformer`.

Under ``backend="kernels"`` every product is kernel 3 and every attention
kernel 4 (an encode launches 7 products and 1 attention a layer; a
decoder layer 11 and 2, its cross attention's k and v recomputed from the
encoder output at every step as in the reference; the LM head 1).  With
``cfg.remat`` and grad mode on, each encoder and decoder layer runs under
a non-reentrant ``torch.utils.checkpoint``, the reference's per-layer
``nothing_saveable`` checkpoint; the encoder output enters each decoder
layer's checkpoint as an input, so its gradient sums over the layers.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.util import canon_dtype, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, linear, mlp, mlp_init,
                                       normal_init, rmsnorm, rmsnorm_init)

#: the two layer stacks of the parameter tree
STACKS = ("enc_blocks", "dec_blocks")


def _enc_layer_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "attn": attn_mod.attn_init(generator, cfg, dtype, device=device),
        "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device),
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "norm2": rmsnorm_init(cfg.d_model, dtype, device),
    }


def _dec_layer_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "self_attn": attn_mod.attn_init(generator, cfg, dtype,
                                        device=device),
        "cross_attn": attn_mod.attn_init(generator, cfg, dtype,
                                         device=device, cross=True),
        "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device),
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "norm2": rmsnorm_init(cfg.d_model, dtype, device),
        "norm3": rmsnorm_init(cfg.d_model, dtype, device),
    }


def init_params(generator: torch.Generator | None, cfg: ModelConfig,
                device=None, keep=None) -> dict:
    """The reference's tree in ``cfg.dtype``, drawn from ``generator`` on
    its device and put on ``device`` (``None`` -> CUDA, raising without a
    card; ``"meta"`` for shapes only); ``keep`` as in
    :func:`repro_torch.models.transformer.init_params`."""
    if not cfg.encoder_layers:
        raise ValueError(f"{cfg.name} has no encoder; use "
                         f"repro_torch.models.transformer")
    dtype = canon_dtype(cfg.dtype)
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    g, k = generator, keep or transformer.whole
    return {
        "embed": k("embed", normal_init(g, (cfg.vocab, cfg.d_model),
                                        cfg.d_model ** -0.5, dtype, dev)),
        "enc_pos": k("enc_pos", normal_init(
            g, (cfg.encoder_ctx, cfg.d_model), 0.02, dtype, dev)),
        "enc_blocks": transformer.init_stacked(
            lambda: _enc_layer_init(g, cfg, dtype, dev), cfg.encoder_layers,
            keep, "enc_blocks"),
        "dec_blocks": transformer.init_stacked(
            lambda: _dec_layer_init(g, cfg, dtype, dev), cfg.num_layers,
            keep, "dec_blocks"),
        "enc_norm": k("enc_norm", rmsnorm_init(cfg.d_model, dtype, dev)),
        "dec_norm": k("dec_norm", rmsnorm_init(cfg.d_model, dtype, dev)),
        "lm_head": k("lm_head", dense_init(g, cfg.d_model, cfg.vocab, dtype,
                                           device=dev)),
    }


def load_jax_params(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's ``init_params(key, cfg)`` tree (numpy arrays, bf16
    as ``ml_dtypes``) as the port's tree on ``device``; a missing, extra
    or misshapen leaf raises before any tensor is made."""
    return transformer.load_tree(tree, init_params(None, cfg, "meta"),
                                 device)


def _remat(cfg: ModelConfig) -> bool:
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"{cfg.name}: remat_policy {cfg.remat_policy!r} is not ported "
            f"(only 'nothing': each layer recomputed whole)")
    return remat


def _run(layer, remat: bool, *args):
    if remat:
        return checkpoint(layer, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return layer(*args)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           backend: str = "kernels") -> torch.Tensor:
    """frames (B, T, D), any float dtype -> encoder output (B, T, D) in
    ``cfg.dtype``."""
    remat = _remat(cfg)
    eps = cfg.norm_eps
    x = (frames.to(canon_dtype(cfg.dtype))
         + params["enc_pos"][None, :frames.shape[1]])

    def layer(x, p):
        h, _ = attn_mod.attention(p["attn"], rmsnorm(p["norm1"], x, eps),
                                  cfg, causal=False, backend=backend)
        x = x + h
        return x + mlp(p["ffn"], rmsnorm(p["norm2"], x, eps), backend)

    for r in range(cfg.encoder_layers):
        x = _run(layer, remat, x,
                 transformer.layer_at(params["enc_blocks"], r))
    return rmsnorm(params["enc_norm"], x, eps)


def _dec_layer(p: dict, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, positions=None, cache=None, cache_pos=None,
               backend: str = "kernels"):
    """Self-attention (with ``cache`` written in place), cross attention
    to ``enc_out``, FFN.  Returns (y, cache)."""
    eps = cfg.norm_eps
    h, nc = attn_mod.attention(p["self_attn"], rmsnorm(p["norm1"], x, eps),
                               cfg, positions=positions, kv_cache=cache,
                               cache_pos=cache_pos, backend=backend)
    x = x + h
    h, _ = attn_mod.attention(p["cross_attn"], rmsnorm(p["norm2"], x, eps),
                              cfg, xa=enc_out, backend=backend)
    x = x + h
    return x + mlp(p["ffn"], rmsnorm(p["norm3"], x, eps), backend), nc


def forward(params: dict, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, backend: str = "kernels") -> torch.Tensor:
    """Teacher-forced forward: tokens (B, S), frames (B, T, D) -> logits
    (B, S, V)."""
    remat = _remat(cfg)
    enc_out = encode(params, frames, cfg, backend)
    x = params["embed"][tokens].to(canon_dtype(cfg.dtype))
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device).expand(b, s)

    def layer(x, enc_out, p):
        return _dec_layer(p, x, enc_out, cfg, positions, backend=backend)[0]

    for r in range(cfg.num_layers):
        x = _run(layer, remat, x, enc_out,
                 transformer.layer_at(params["dec_blocks"], r))
    x = rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    return linear(x, params["lm_head"], backend)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> dict:
    """The decoder's self-attention caches: ``{"k", "v"}`` of shape (L,
    B, max_len, KVH, Dh), zeros in ``cfg.dtype`` on ``device`` (``None``
    -> CUDA)."""
    dtype, dev = canon_dtype(cfg.dtype), resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {k: torch.zeros(shape, dtype=dtype, device=dev)
            for k in ("k", "v")}


def decode_step(params: dict, token: torch.Tensor, enc_out: torch.Tensor,
                caches: dict, cache_pos: int, cfg: ModelConfig,
                backend: str = "kernels") -> tuple[torch.Tensor, dict]:
    """One cached decoder step: token (B, S) at positions ``cache_pos ..
    cache_pos + S - 1``, cross attention to ``enc_out`` -> (logits (B, S,
    V), caches written in place)."""
    x = params["embed"][token].to(canon_dtype(cfg.dtype))
    for r in range(cfg.num_layers):
        cache = {k: c[r] for k, c in caches.items()}
        x, _ = _dec_layer(transformer.layer_at(params["dec_blocks"], r), x,
                          enc_out, cfg, cache=cache, cache_pos=cache_pos,
                          backend=backend)
    x = rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    return linear(x, params["lm_head"], backend), caches


# ------------------------------------------------------- training trees ---

def unstack_blocks(params: dict, cfg: ModelConfig) -> dict:
    """The tree with every leaf a fresh autograd leaf sharing its storage,
    and each stack a list of per-layer dicts of views, so each layer's
    gradient is a tensor of its own."""
    out = transformer.leaf_tree({k: v for k, v in params.items()
                                 if k not in STACKS})
    for name, n in zip(STACKS, (cfg.encoder_layers, cfg.num_layers)):
        out[name] = [transformer.leaf_tree(
            transformer.layer_at(params[name], r)) for r in range(n)]
    return out


def stacked_name(name: str) -> tuple[str, int | None]:
    """``enc_blocks.3.attn.wq`` -> ``("enc_blocks.attn.wq", 3)``; a leaf
    outside the stacks keeps its name and has no index."""
    parts = name.split(".")
    if parts[0] not in STACKS:
        return name, None
    return ".".join(parts[:1] + parts[2:]), int(parts[1])


def stack_grads(grads: dict) -> dict:
    """Flat gradients of an :func:`unstack_blocks` tree in the stacked
    layout (the names of ``flatten_params(params)``)."""
    return transformer.stack_grads(grads, stacked_name)


__all__ = ["init_params", "load_jax_params", "encode", "forward",
           "init_caches", "decode_step", "unstack_blocks", "stacked_name",
           "stack_grads", "STACKS"]
