"""Decoder-only LM assembly, the port of ``repro.models.transformer``.

The stack is ``repeat`` copies of ``cfg.block_pattern``; parameters are
stacked on a leading ``repeat`` axis per pattern position, as in the
reference, so a tree carries across name for name
(:func:`load_jax_params`).  The reference's ``lax.scan`` over superblocks
is a Python loop over ``repeat`` that indexes the stacks: a leading-axis
slice is contiguous and keeps the 16-byte alignment the kernels' ``wgmma``
variants need.

For training, :func:`unstack_blocks` gives each layer leaves of its own
(views of the stacks that require grad), and ``blocks[pi]`` may then be a
list of per-layer dicts: indexing one stacked leaf per layer would make
autograd build a full-size zero gradient in each ``select``'s backward
and add them up.  :func:`stack_grads` puts the per-layer gradients back
into the stacked layout.  ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant): only the layer boundaries are
kept and each layer is recomputed in the backward, the reference's
``nothing_saveable`` policy.

Each layer = a sequence mixer + an FFN, both pre-norm residual.  The
mixer is attention (global ``attn``, or ``attn_local``: a sliding window,
Gemma-3's local layers), a Mamba block (``mamba``, Jamba's;
:mod:`repro_torch.models.mamba`) or an xLSTM block (``mlstm``, ``slstm``;
:mod:`repro_torch.models.xlstm`).  The FFN
is the reference's per layer (:func:`_ffn_kind`): the MoE FFN
(:mod:`repro_torch.models.moe`) where ``(layer + 1) % moe.every_n_layers
== 0``, else the dense SwiGLU, or none when ``d_ff == 0``; as in the
reference, the kind is taken at each pattern position, so the configs align
``every_n_layers`` with the pattern (:func:`check_supported`).  Every
product goes through :func:`~repro_torch.models.layers.linear` and the
scores through the flash-attention kernel under ``backend="kernels"`` (a
dense layer launches 7 matmuls and 1 attention, and the LM head 1 matmul;
a MoE layer 4 + 1 two-dimensional matmuls for the attention and the
router, 3 more for a shared expert, and 3 of kernel 3's batched form for
the experts; a Mamba mixer 4, or 2 + 2 x (S / SCAN_CHUNK) when its scan is
chunked; an mLSTM mixer 6; an sLSTM mixer 3 + S, its recurrent product
once a step); a local layer's cache-free attention is the kernel's
windowed band, its cached attention a ring of ``window`` slots
(:mod:`repro_torch.models.attention`).  Each pattern position's cache is
sized by its kind (:func:`init_caches`): a KV cache or ring, or a
recurrent state of fixed size (Mamba's conv window and SSM state, the
mLSTM's (C, n, m) and conv window, the sLSTM's (c, n, h, m)); a recurrent
state takes one token a step.  Encoder-decoder configs are
:mod:`repro_torch.models.encdec`'s, and this module refuses them.

:func:`init_params` allocates each stack once and draws the layers into
its slices in turn (:func:`init_stacked`): a 30.5 B-parameter MoE model
never holds a second copy of its blocks while it stacks them.

:func:`decode_step` and :func:`forward` take ``tp=``, a
:class:`repro_torch.distributed.sharding.ModelParallel`: the parameters
are then this rank's blocks, each layer's FSDP blocks are gathered before
it runs, attention runs on this rank's heads (a cache holds their KV
heads, :func:`init_caches`'s ``kv_heads``), the column-split blocks'
inputs enter through the layout's copy and the row-split products'
partials are summed over the model axis, and the vocab-split embedding is
reduced and the head's logits are this rank's columns (gathered on V by
:func:`decode_step`; the training CE reads them where they lie).  Under
autograd each of those has its adjoint (the layout's docstring).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.ckpt import as_tensor
from repro_torch.kernels.util import canon_dtype, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, linear, mlp, mlp_init,
                                       normal_init, rmsnorm, rmsnorm_init)

#: the mixer kinds of ``cfg.block_pattern``
MIXERS = ("attn", "attn_local", "mamba", "mlstm", "slstm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for an encoder-decoder config, and
    ``ValueError`` for an unknown mixer or an FFN layout the stacks cannot
    hold."""
    for kind in cfg.block_pattern:
        if kind not in MIXERS:
            raise ValueError(f"{cfg.name}: unknown mixer {kind!r}")
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder config is not a decoder-only "
            f"model; use repro_torch.models.encdec")
    period = len(cfg.block_pattern)
    if any(_ffn_kind(cfg, r * period + pi) != _ffn_kind(cfg, pi)
           for r in range(cfg.repeat) for pi in range(period)):
        raise ValueError(
            f"{cfg.name}: moe.every_n_layers {cfg.moe.every_n_layers} does "
            f"not align with the {period}-layer pattern; each pattern "
            f"position's stack needs one FFN kind (as the reference's)")


def _ffn_kind(cfg: ModelConfig, layer_idx: int) -> str:
    """The reference's: ``"moe"`` where ``(layer_idx + 1) %
    moe.every_n_layers == 0``, else ``"dense"``, or ``"none"`` when ``d_ff
    == 0``.  Callers pass the pattern position, as the reference's
    superblock does."""
    if cfg.moe is not None and (layer_idx + 1) % cfg.moe.every_n_layers == 0:
        return "moe"
    return "dense" if cfg.d_ff > 0 else "none"


def _mixer_init(generator, cfg: ModelConfig, kind: str, dtype, device):
    if kind in ("attn", "attn_local"):
        return attn_mod.attn_init(generator, cfg, dtype, device=device)
    if kind == "mamba":
        return mamba_mod.mamba_init(generator, cfg, dtype, device)
    if kind == "mlstm":
        return xlstm_mod.mlstm_init(generator, cfg, dtype, device)
    return xlstm_mod.slstm_init(generator, cfg, dtype, device)


def layer_init(generator, cfg: ModelConfig, pattern_idx: int, dtype,
               device=None) -> dict:
    """One layer's parameters at pattern position ``pattern_idx``: its
    kind's mixer, the two norms and its position's FFN."""
    p = {
        "mixer": _mixer_init(generator, cfg, cfg.block_pattern[pattern_idx],
                             dtype, device),
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "norm2": rmsnorm_init(cfg.d_model, dtype, device),
    }
    fk = _ffn_kind(cfg, pattern_idx)
    if fk == "moe":
        p["ffn"] = moe_mod.moe_init(generator, cfg, dtype, device)
    elif fk == "dense":
        p["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def init_stacked(draw, repeat: int, keep=None, prefix: str = "") -> dict:
    """``repeat`` trees of ``draw()``, stacked leaf by leaf on a new leading
    axis: each stack is allocated once and each layer is drawn, in turn,
    into its slice, so at most one layer's tree lives beside the stacks.
    Bitwise the ``torch.stack`` of ``repeat`` draws in the same order.
    ``keep(name, t, 1)``: what to keep of each layer's leaf as it is drawn
    (its stack is then the kept pieces'), named ``prefix.path``."""
    def cut(one, at):
        return {k: cut(v, f"{at}.{k}") if isinstance(v, dict)
                else keep(f"{at}.{k}", v, 1) for k, v in one.items()}

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((repeat, *t.shape), dtype=t.dtype, device=t.device)

    def put(stack, one, r):
        for k, v in one.items():
            if isinstance(v, dict):
                put(stack[k], v, r)
            else:
                stack[k][r].copy_(v)

    def drawn():
        return draw() if keep is None else cut(draw(), prefix)

    one = drawn()
    stack = alloc(one)
    for r in range(repeat):
        if r:
            one = drawn()
        put(stack, one, r)
        del one
    return stack


def whole(name, t, lead=0):
    """The ``keep`` that keeps every leaf whole."""
    return t


def init_params(generator: torch.Generator | None, cfg: ModelConfig,
                device=None, keep=None) -> dict:
    """Parameters with per-pattern-position stacks of shape (repeat, ...),
    in ``cfg.dtype``, drawn from ``generator`` on its device (see
    :mod:`repro_torch.models.layers`) and put on ``device`` (``None`` ->
    CUDA, raising without a card; ``"meta"`` for shapes only).

    ``keep(name, t, lead)`` (e.g. ``ModelParallel.block``): what to keep
    of each leaf, by its :func:`flatten_params` name, as it is drawn (a
    stack's layer by layer, ``lead`` 1): every leaf is drawn whole, so the
    bits are the whole tree's, and at most one whole layer lives beside
    the kept pieces."""
    check_supported(cfg)
    dtype = canon_dtype(cfg.dtype)
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    k = keep or whole
    params = {"embed": k("embed", normal_init(
        generator, (cfg.vocab, cfg.d_model), cfg.d_model ** -0.5, dtype,
        dev))}
    if not cfg.tie_embeddings:
        params["lm_head"] = k("lm_head", dense_init(
            generator, cfg.d_model, cfg.vocab, dtype, device=dev))
    params["blocks"] = [
        init_stacked(lambda pi=pi: layer_init(generator, cfg, pi, dtype, dev),
                     cfg.repeat, keep, f"blocks.{pi}")
        for pi in range(len(cfg.block_pattern))]
    params["final_norm"] = k("final_norm",
                             rmsnorm_init(cfg.d_model, dtype, dev))
    return params


def flatten_params(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a tree of dicts and lists
    (``blocks.0.mixer.wq``)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    flat = {}
    for k, v in items:
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_params(v, name))
        else:
            flat[name] = v
    return flat


def load_jax_params(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's ``init_params(key, cfg)`` tree, as nested dicts and
    lists of numpy arrays (bf16 leaves as ``ml_dtypes`` arrays, carried
    through their bits), as the port's parameter tree on ``device``.

    Every leaf must be present with the shape and dtype that
    :func:`init_params` gives ``cfg``; anything missing, extra or
    misshapen raises before a tensor is made."""
    return load_tree(tree, init_params(None, cfg, device="meta"), device)


def load_tree(tree: dict, like: dict, device=None) -> dict:
    """``tree`` (nested dicts and lists of numpy arrays) as tensors on
    ``device``, after checking it leaf for leaf against ``like``, a tree of
    meta tensors: the shared body of the models' ``load_jax_params``."""
    want = flatten_params(like)
    got = {k: np.asarray(v) for k, v in flatten_params(tree).items()}
    if set(got) != set(want):
        raise KeyError(f"parameter trees differ: missing "
                       f"{sorted(set(want) - set(got))}, extra "
                       f"{sorted(set(got) - set(want))}")
    for name, t in want.items():
        dtype = "bfloat16" if "bfloat16" in str(got[name].dtype) else str(
            got[name].dtype)
        if (got[name].shape != tuple(t.shape)
                or dtype != str(t.dtype).removeprefix("torch.")):
            raise ValueError(f"{name}: {got[name].shape} {dtype} != "
                             f"{tuple(t.shape)} {t.dtype}")
    dev = resolve_device(device)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return as_tensor(node).to(dev)

    return build(tree)


def _index(tree: dict, r: int) -> dict:
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def layer_at(block, r: int) -> dict:
    """Layer ``r`` of a stack: the per-layer dict where ``block`` is a list
    (:func:`unstack_blocks`), else views of the stacked leaves."""
    return block[r] if isinstance(block, list) else _index(block, r)


def layer_params(params: dict, cfg: ModelConfig):
    """Yield ``(pattern_idx, repeat_idx, kind, ffn_kind, layer)`` in stack
    order, ``ffn_kind`` the pattern position's (:func:`_ffn_kind`),
    ``layer`` the per-layer views of the stacked parameters (or the
    per-layer dict itself where ``blocks[pattern_idx]`` is a list, as
    :func:`unstack_blocks` gives)."""
    for r in range(cfg.repeat):
        for pi, kind in enumerate(cfg.block_pattern):
            yield (pi, r, kind, _ffn_kind(cfg, pi),
                   layer_at(params["blocks"][pi], r))


def unstack_blocks(params: dict, cfg: ModelConfig) -> dict:
    """The parameter tree with every leaf a fresh autograd leaf that
    shares its storage (``detach().requires_grad_()``), and each
    ``blocks[pi]`` a list of ``repeat`` per-layer dicts of views of the
    stacks, so each layer's gradient is a tensor of its own."""
    out = leaf_tree({k: v for k, v in params.items() if k != "blocks"})
    out["blocks"] = [[leaf_tree(_index(block, r)) for r in range(cfg.repeat)]
                     for block in params["blocks"]]
    return out


def leaf_tree(tree: dict) -> dict:
    """``tree`` with every leaf a fresh autograd leaf sharing its storage
    (``detach().requires_grad_()``)."""
    return {k: leaf_tree(v) if isinstance(v, dict)
            else v.detach().requires_grad_() for k, v in tree.items()}


def stacked_name(name: str) -> tuple[str, int | None]:
    """``(stacked name, repeat index)`` of a flat name of an
    :func:`unstack_blocks` tree: ``blocks.0.3.mixer.wq`` ->
    ``("blocks.0.mixer.wq", 3)``; a leaf outside the blocks keeps its name
    and has no index."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return name, None
    return ".".join(parts[:2] + parts[3:]), int(parts[2])


def stack_grads(grads: dict, name_of=stacked_name) -> dict:
    """Flat ``{name: gradient}`` in the stacked layout (the names of
    ``flatten_params(params)``) from the flat gradients of an
    :func:`unstack_blocks` tree, each stack built once.  ``name_of`` maps
    a per-layer name to its stacked name and index (the encoder-decoder
    passes its own)."""
    out, stacks = {}, {}
    for name, g in grads.items():
        key, r = name_of(name)
        if r is None:
            out[key] = g
        else:
            stacks.setdefault(key, {})[r] = g
    for key, per in stacks.items():
        out[key] = torch.stack([per[r] for r in range(len(per))])
    return out


def unflatten_params(flat: dict, like, prefix: str = ""):
    """The tree of ``like`` (dicts and lists) with its leaves taken from
    ``flat`` by :func:`flatten_params`' names."""
    if isinstance(like, dict):
        return {k: unflatten_params(flat, v, f"{prefix}.{k}" if prefix
                                    else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [unflatten_params(flat, v, f"{prefix}.{i}" if prefix
                                 else str(i))
                for i, v in enumerate(like)]
    return flat[prefix]


def apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                ffn_kind: str, positions, cache=None, cache_pos=None,
                backend: str = "kernels", reduce=(None, None),
                copy=(None, None)):
    """One (mixer + FFN) layer.  Returns (y, cache written in place).
    ``reduce``: the attention's and the dense FFN's sums of partial
    products over the model axis (tensor parallelism), or ``None``;
    ``copy``: the entries of their normed inputs into the split blocks
    (backward, the sum of every rank's partial input gradient), or
    ``None``."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if copy[0] is not None:
        h = copy[0](h)
    if kind in ("attn", "attn_local"):
        mixed, new_cache = attn_mod.attention(
            p["mixer"], h, cfg, kind=kind, positions=positions,
            kv_cache=cache, cache_pos=cache_pos, backend=backend,
            reduce=reduce[0])
    else:
        block = {"mamba": mamba_mod.mamba_block,
                 "mlstm": xlstm_mod.mlstm_block,
                 "slstm": xlstm_mod.slstm_block}[kind]
        mixed, new_cache = block(p["mixer"], h, cfg, cache=cache,
                                 backend=backend)
    x = x + mixed
    if ffn_kind == "moe":
        x = x + moe_mod.moe_ffn(p["ffn"], rmsnorm(p["norm2"], x,
                                                  cfg.norm_eps), cfg, backend)
    elif ffn_kind == "dense":
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if copy[1] is not None:
            h = copy[1](h)
        x = x + mlp(p["ffn"], h, backend, reduce=reduce[1])
    return x, new_cache


def lm_head(params: dict, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """The head (D, V): ``lm_head``, or the tied ``embed.T``; with ``tp``,
    this rank's vocab columns with their FSDP blocks gathered."""
    head = params.get("lm_head")
    if head is None:
        embed = params["embed"]
        if tp is not None:
            embed = tp.leaf("embed", embed)
        return embed.T.to(canon_dtype(cfg.dtype))
    return head if tp is None else tp.leaf("lm_head", head)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            backend: str = "kernels", return_hidden: bool = False, tp=None
            ) -> torch.Tensor:
    """Training/prefill forward without a cache.  tokens (B, S) -> logits
    (B, S, V), or the final-normed hidden states (B, S, D) with
    ``return_hidden`` (training's chunked CE applies the head).

    With ``cfg.remat`` and grad mode on, each layer runs under a
    non-reentrant ``torch.utils.checkpoint``.  ``tp``: this rank's blocks
    over a :class:`~repro_torch.distributed.sharding.ModelParallel`
    layout (the module docstring), ``tokens`` this data rank's rows; each
    layer's FSDP blocks are gathered inside its (checkpointed) function,
    so the recompute gathers them again and no gathered layer outlives
    its use, and the logits are this rank's vocab columns.  The
    reference's ``embeddings=`` (stub modality frontends) comes with its
    caller (ROADMAP.md, queue 1)."""
    check_supported(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"{cfg.name}: remat_policy {cfg.remat_policy!r} is not ported "
            f"(only 'nothing': each layer recomputed whole)")
    embed = params["embed"]
    x = (embed[tokens] if tp is None
         else tp.embed(tp.leaf("embed", embed), tokens))
    x = x.to(canon_dtype(cfg.dtype))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for pi, _, kind, fk, p in layer_params(params, cfg):
        def layer(x, p=p, pi=pi, kind=kind, fk=fk):
            kw = {}
            if tp is not None:
                p, kw = tp.layer(pi, p), tp.hooks(pi)
            return apply_layer(p, x, cfg, kind, fk, positions,
                               backend=backend, **kw)[0]

        x = (checkpoint(layer, x, use_reentrant=False,
                        preserve_rng_state=False) if remat else layer(x))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x
    if tp is not None:
        x = tp.head_input(x)
    return linear(x, lm_head(params, cfg, tp), backend)


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype, device) -> dict:
    """One layer's cache of mixer ``kind``, as the reference's
    ``init_caches`` sizes it."""
    if kind in ("attn", "attn_local"):
        return attn_mod.init_kv_cache(cfg, batch, max_len, kind, dtype,
                                      device)
    if kind == "mamba":
        return mamba_mod.init_mamba_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return xlstm_mod.init_mlstm_cache(cfg, batch, device)
    return xlstm_mod.init_slstm_cache(cfg, batch, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None, kv_heads: int | None = None) -> list:
    """Per-pattern-position stacked caches with a leading (repeat,) axis on
    ``device`` (``None`` -> CUDA), each position's sized by its kind: a
    global layer's KV cache of ``max_len`` slots, a sliding-window layer's
    ring of ``min(max_len, cfg.window)``, both zeros in ``cfg.dtype``; a
    recurrent mixer's state in the dtypes the reference gives it (Mamba's
    conv window in ``cfg.dtype``, the rest fp32; the running maxima
    ``m`` at -1e30 where the reference starts them).  ``kv_heads``: an
    attention cache's heads on a tensor-parallel rank (default all)."""
    check_supported(cfg)
    dtype, dev = canon_dtype(cfg.dtype), resolve_device(device)
    caches = []
    for kind in cfg.block_pattern:
        if kv_heads is not None and kind in ("attn", "attn_local"):
            one = attn_mod.init_kv_cache(cfg, batch, max_len, kind, dtype,
                                         dev, kv_heads=kv_heads)
        else:
            one = _layer_cache(cfg, kind, batch, max_len, dtype, dev)
        caches.append({k: a[None].repeat((cfg.repeat,) + (1,) * a.dim())
                       for k, a in one.items()})
    return caches


def decode_step(params: dict, token: torch.Tensor, caches: list,
                cache_pos: int, cfg: ModelConfig, backend: str = "kernels",
                tp=None, last: bool = False, record: list | None = None
                ) -> tuple[torch.Tensor, list]:
    """One cached step.  token (B, S) at positions ``cache_pos ..
    cache_pos + S - 1`` -> (logits (B, S, V), caches).  S = 1 decodes;
    S > 1 at ``cache_pos = 0`` is the parallel prefill of a config whose
    mixers are all global attention (a recurrent mixer takes one token a
    step, as ``launch.serve.parallel_prefill_ok`` says).  The caches are
    written in place and returned.  ``tp``: this rank's blocks over a
    :class:`~repro_torch.distributed.sharding.ModelParallel` layout (the
    module docstring).  ``last``: the logits of the last position only
    (B, 1, V).  ``record`` receives each layer's output."""
    check_supported(cfg)
    embed = params["embed"]
    if tp is None:
        x = embed[token]
    else:
        x = tp.embed(tp.leaf("embed", embed), token)
    x = x.to(canon_dtype(cfg.dtype))
    for pi, r, kind, fk, p in layer_params(params, cfg):
        cache = {k: c[r] for k, c in caches[pi].items()}
        kw = {}
        if tp is not None:
            p, kw = tp.layer(pi, p), tp.hooks(pi)
        x, _ = apply_layer(p, x, cfg, kind, fk, None, cache=cache,
                           cache_pos=cache_pos, backend=backend, **kw)
        if record is not None:
            record.append(x)
    if last:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = linear(x, lm_head(params, cfg, tp), backend)
    return (logits if tp is None else tp.logits(logits)), caches
