"""The port's LM training against the JAX reference, on the CPU.

Inputs are drawn from a seed with numpy, or are the reference's
``init_params`` tree carried across by
``repro_torch.models.transformer.load_jax_params``; both packages get the
same ones.  The reduced ``stablelm-1.6b`` (MHA) and ``qwen3-32b`` (GQA,
qk-norm) configs run in fp32 (``cfg.replace(dtype="float32")`` on both
sides) and in bf16, on both port backends: on the CPU ``"kernels"`` runs
the matmul and flash-attention kernels' plain versions through their
autograd Functions, ``"torch"`` runs ``torch.matmul`` and SDPA.

Bars (ROADMAP.md, DESIGN.md §12): fp32 values at 1e-5 and gradients at
1e-4 x max(1, max|ref|); bf16 values within 5% and gradients within 10%
(of max|ref|, or relative L2 where a whole tensor is held).
"""

import importlib.util
import json
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.optim import adamw_init as jadamw_init
from repro_torch import checkpoint as tckpt
from repro_torch import configs
from repro_torch.data import LMDataPipeline
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     Heartbeat)
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import steps, train
from repro_torch.models import attention, layers, transformer
from repro_torch.optim import adamw_init

_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
_CFG_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}
_VALUE_BAR = {"fp32": 1e-5, "bf16": 5e-2}
_GRAD_BAR = {"fp32": 1e-4, "bf16": 1e-1}
_ARCHS = ("stablelm-1.6b", "qwen3-32b")
# two AdamW steps' change of each parameter and master against the
# reference's, relative L2, by the parameters' dtype: in bf16 an entry
# whose small gradient flips sign between the two moves the other way
# (Adam's first steps take +-lr), and the bf16 parameters' change is a few
# roundings; in fp32 only the moments are bf16
_DELTA_BAR = {"bfloat16": 0.25, "float32": 1e-2}

# chip_smoke.py's launch oracle (``lm_train_launches``) and its split of
# a step's launches by part (``Smoke.counting_parts``)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _no_sharding_hook(monkeypatch):
    """The reference's model functions without a mesh: another test file in
    this process may have left the sharding hook of its ``Server``."""
    monkeypatch.setattr(jlayers, "_CONSTRAINT_FN", None)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rtol, floor=1.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(floor, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, rtol * scale)
    return err


def _rel_l2(got, want):
    got, want = (_np(a).astype(np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _cfg(arch, dtype, **kw):
    return (configs.get_reduced(arch).replace(dtype=_CFG_DTYPE[dtype], **kw),
            jconfigs.get_reduced(arch).replace(dtype=_CFG_DTYPE[dtype],
                                               **kw))


def _both_params(arch, dtype, seed=0, **kw):
    tcfg, jcfg = _cfg(arch, dtype, **kw)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = transformer.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    return tcfg, jcfg, jp, tp


def _batch(vocab, rows, seq, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1),
                                                dtype=np.int32)
    mask = np.ones((rows, seq), np.float32)
    mask[0, :3] = 0.0   # a masked-out prefix: the loss is a masked mean
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            b.items()}


@pytest.fixture
def plain_counts(monkeypatch):
    """Count the matmul and attention plain dispatches (the kernels' plain
    versions stand in for them on the CPU)."""
    counts = {"matmul": 0, "flash_attention": 0}
    mm, fa = kmm.matmul_plain, kfa.attention_plain

    def count_mm(a, b):
        counts["matmul"] += 1
        return mm(a, b)

    def count_fa(q, k, v, *, causal=True, window=0):
        counts["flash_attention"] += 1
        return fa(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(kmm, "matmul_plain", count_mm)
    monkeypatch.setattr(kfa, "attention_plain", count_fa)
    return counts


# -------------------------------------------------------- cross entropy ---

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_reference(dtype, masked):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9), dtype=np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None

    def jloss(lg):
        return jlayers.softmax_cross_entropy(
            lg, jnp.asarray(labels), None if mask is None
            else jnp.asarray(mask))

    want, jg = jax.value_and_grad(jloss)(jnp.asarray(logits, _JDT[dtype]))
    tl = torch.from_numpy(logits).to(_TDT[dtype]).requires_grad_()
    got = layers.softmax_cross_entropy(
        tl, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    (tg,) = torch.autograd.grad(got, tl)
    assert got.dtype == torch.float32 and tg.dtype == _TDT[dtype]
    _close(got, want, _VALUE_BAR[dtype])
    _close(tg, jg, _GRAD_BAR[dtype])


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("seq", [64, 1024])
def test_chunked_ce_matches_reference(seq, dtype, backend, plain_counts):
    """Value and gradients (hidden and head) against the reference's; at
    S = 1024 the CE takes 2 chunks of 512, each head product recomputed in
    the backward, at S = 64 the full logits."""
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, seq, 32)).astype(np.float32)
    head = (rng.standard_normal((32, 96)) / 6).astype(np.float32)
    labels = rng.integers(0, 96, (2, seq), dtype=np.int32)
    mask = (rng.random((2, seq)) > 0.1).astype(np.float32)

    def jloss(h, w):
        return jlayers.chunked_softmax_ce(h, w, jnp.asarray(labels),
                                          jnp.asarray(mask))

    want, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden, _JDT[dtype]), jnp.asarray(head, _JDT[dtype]))
    th = torch.from_numpy(hidden).to(_TDT[dtype]).requires_grad_()
    tw = torch.from_numpy(head).to(_TDT[dtype]).requires_grad_()
    got = layers.chunked_softmax_ce(th, tw, torch.from_numpy(labels),
                                    torch.from_numpy(mask), backend=backend)
    gh, gw = torch.autograd.grad(got, (th, tw))
    _close(got, want, _VALUE_BAR[dtype])
    _close(gh, jgh, _GRAD_BAR[dtype])
    _close(gw, jgw, _GRAD_BAR[dtype])
    chunks = seq // 512 if seq > 512 else 1
    want_mm = (chunks * 4 if seq > 512 else 3) if backend == "kernels" else 0
    assert plain_counts["matmul"] == want_mm


# ------------------------------------------------- autograd Functions ---

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_matmul_fn_gradients_match_jax(dtype, plain_counts):
    """``MatmulFn``'s dA and dB against ``jax.grad`` of ``x @ w``; the
    backward is two more matmul dispatches on contiguous transposes."""
    rng = np.random.default_rng(3)
    x, w, cot = (rng.standard_normal(s).astype(np.float32)
                 for s in ((37, 24), (24, 40), (37, 40)))
    jfn = lambda a, b: jnp.sum((a @ b).astype(jnp.float32) * cot)  # noqa
    jga, jgb = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(x, _JDT[dtype]),
                                             jnp.asarray(w, _JDT[dtype]))
    tx = torch.from_numpy(x).to(_TDT[dtype]).requires_grad_()
    tw = torch.from_numpy(w).to(_TDT[dtype]).requires_grad_()
    before = kmm.MatmulFn.transposes
    y = layers.linear(tx, tw)
    assert y.grad_fn is not None and plain_counts["matmul"] == 1
    ga, gb = torch.autograd.grad(y, (tx, tw),
                                 torch.from_numpy(cot).to(_TDT[dtype]))
    assert plain_counts["matmul"] == 3
    assert kmm.MatmulFn.transposes - before == 2
    assert ga.dtype == gb.dtype == _TDT[dtype]
    _close(ga, jga, _GRAD_BAR[dtype])
    _close(gb, jgb, _GRAD_BAR[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("seq", [96, 1024])
def test_attention_fn_gradients_match_reference(seq, dtype, plain_counts):
    """``FlashAttentionFn`` (kernel 4 forward, the model's query-chunked
    attention differentiated backward) against ``jax.grad`` of the
    reference's ``_chunked_causal``; at S = 1024 both take chunks of 512
    query rows."""
    rng = np.random.default_rng(4)
    q, k, v, cot = (rng.standard_normal((2, 3, seq, 16)).astype(np.float32)
                    for _ in range(4))
    pos = jnp.broadcast_to(jnp.arange(seq)[None], (2, seq))

    def jfn(a, b, c):
        out = jattn._chunked_causal(a, b, c, pos, 0)
        return jnp.sum(out.astype(jnp.float32) * cot)

    jq, jk, jv = (jnp.asarray(a, _JDT[dtype]) for a in (q, k, v))
    want = jattn._chunked_causal(jq, jk, jv, pos, 0)
    jgrads = jax.grad(jfn, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).to(_TDT[dtype]).requires_grad_()
                  for a in (q, k, v))
    out = kfa.FlashAttentionFn.apply(tq, tk, tv, True)
    assert plain_counts["flash_attention"] == 1
    _close(out, want, _VALUE_BAR[dtype])
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(cot).to(_TDT[dtype]))
    assert plain_counts["flash_attention"] == 1   # no kernel in backward
    for g, jg in zip(grads, jgrads):
        assert g.dtype == _TDT[dtype]
        _close(g, jg, _GRAD_BAR[dtype])


# ------------------------------------------------------------ the model ---

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_forward_return_hidden_matches_reference(arch, dtype):
    tcfg, jcfg, jp, tp = _both_params(arch, dtype)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 12),
                                             dtype=np.int32)
    want = jtr.forward(jp, jnp.asarray(toks), jcfg, return_hidden=True)
    with torch.no_grad():
        for backend in ("kernels", "torch"):
            got = transformer.forward(tp, torch.from_numpy(toks), tcfg,
                                      backend=backend, return_hidden=True)
            assert got.shape == (2, 12, tcfg.d_model)
            assert got.dtype == _TDT[dtype]
            _close(got, want, _VALUE_BAR[dtype])


def _loss_grads(tp, tcfg, batch, backend="kernels", unstack=True):
    """The train step's loss and flat stacked gradients, through per-layer
    leaves (``unstack``) or through the stacked leaves themselves."""
    if unstack:
        leaves = transformer.unstack_blocks(tp, tcfg)
    else:
        leaves = transformer.unflatten_params(
            {k: v.detach().requires_grad_() for k, v in
             transformer.flatten_params(tp).items()}, tp)
    flat = transformer.flatten_params(leaves)
    hidden = transformer.forward(leaves, batch["tokens"], tcfg,
                                 backend=backend, return_hidden=True)
    loss = layers.chunked_softmax_ce(hidden, transformer.lm_head(leaves, tcfg),
                                     batch["labels"], batch["mask"],
                                     backend=backend)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    return loss, (transformer.stack_grads(grads) if unstack else grads)


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_remat_on_and_off_give_the_same_gradients(arch, backend):
    """Per-layer checkpointing recomputes each layer as it ran: the loss
    and every gradient are bit for bit the same without it."""
    tcfg, _, _, tp = _both_params(arch, "bf16")
    assert not tcfg.remat
    batch = _torch_batch(_batch(tcfg.vocab, 2, 16))
    loss0, g0 = _loss_grads(tp, tcfg, batch, backend)
    loss1, g1 = _loss_grads(tp, tcfg.replace(remat=True), batch, backend)
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    with pytest.raises(NotImplementedError, match="dots"):
        _loss_grads(tp, tcfg.replace(remat=True, remat_policy="dots"), batch,
                    backend)


@pytest.mark.parametrize("arch", _ARCHS)
def test_layer_leaf_views_give_the_stacked_gradient(arch):
    """Gradients through per-layer leaf views, stacked once, are bit for
    bit those of the stacked leaves indexed per layer; and they are the
    reference's ``jax.grad`` of the same loss."""
    tcfg, jcfg, jp, tp = _both_params(arch, "fp32")
    b = _batch(tcfg.vocab, 2, 16)
    batch = _torch_batch(b)
    loss_a, ga = _loss_grads(tp, tcfg, batch, unstack=True)
    loss_b, gb = _loss_grads(tp, tcfg, batch, unstack=False)
    assert torch.equal(loss_a, loss_b) and ga.keys() == gb.keys()
    for k in ga:
        assert ga[k].shape == tp_shape(tp, k) and torch.equal(ga[k], gb[k])

    def jloss(p):
        hidden = jtr.forward(p, jnp.asarray(b["tokens"]), jcfg,
                             return_hidden=True)
        return jlayers.chunked_softmax_ce(hidden, jtr.lm_head(p, jcfg),
                                          jnp.asarray(b["labels"]),
                                          jnp.asarray(b["mask"]))

    jl, jg = jax.value_and_grad(jloss)(jp)
    _close(loss_a, jl, _VALUE_BAR["fp32"])
    jflat = transformer.flatten_params(jax.tree.map(np.asarray, jg))
    for k in ga:
        _close(ga[k], jflat[k], _GRAD_BAR["fp32"])


def tp_shape(tp, name):
    return transformer.flatten_params(tp)[name].shape


# ------------------------------------------------------ the train step ---

def _opt_leaves(state):
    out = {"step": state.step}
    for part in ("master", "mu", "nu"):
        tree = getattr(state, part)
        if tree is not None:
            out.update({f"{part}.{k}": v for k, v in
                        transformer.flatten_params(tree).items()})
    return out


def _check_step(got, want, metrics, jmetrics, exact, moments_bf16,
                start=None):
    """One state against the reference's: the metrics, then every
    parameter and optimizer leaf.  ``exact`` (fp32 everywhere): values at
    1e-5, the gradient norm and every leaf at 1e-4 x max(1, max|ref|);
    moments at relative L2 1e-4.  Otherwise loss 5%, gradient norm 10%,
    parameters and masters at relative L2 5%, moments 10%; and, from the
    common ``start`` parameters, each parameter's and master's change at
    relative L2 ``_DELTA_BAR`` against the reference's change."""
    vbar, gbar = ((_VALUE_BAR["fp32"], _GRAD_BAR["fp32"]) if exact
                  else (_VALUE_BAR["bf16"], _GRAD_BAR["bf16"]))
    for k, bar in (("loss", vbar), ("grad_norm", gbar), ("lr", 1e-6)):
        g, w = float(metrics[k]), float(jmetrics[k])
        assert abs(g - w) <= bar * abs(w), (k, g, w)
    (tp, to), (jp, jo) = got, want
    jflat = transformer.flatten_params(jax.tree.map(np.asarray, jp))
    for k, t in transformer.flatten_params(tp).items():
        assert t.dtype == _TDT["fp32" if "float32" in str(jflat[k].dtype)
                               else "bf16"]
        if exact:
            _close(t, jflat[k], gbar)
        else:
            assert _rel_l2(t, jflat[k]) <= 0.05, k
    jopt = _opt_leaves(jax.tree.map(np.asarray, jo))
    topt = _opt_leaves(to)
    assert topt.keys() == jopt.keys()
    assert int(topt.pop("step")) == int(jopt.pop("step"))
    for k, t in topt.items():
        moment = not k.startswith("master.")
        if exact and not (moment and moments_bf16):
            if moment:
                assert _rel_l2(t, jopt[k]) <= gbar, k
            else:
                _close(t, jopt[k], gbar)
        else:
            assert _rel_l2(t, jopt[k]) <= (0.1 if moment else 0.05), k
    if exact:
        return
    # an update that was never applied reads 1.0 here, one at half the lr
    # 0.5, one of the wrong sign 2.0
    t0 = {k: _np(v) for k, v in transformer.flatten_params(start).items()}
    for k, t in transformer.flatten_params(tp).items():
        bar = _DELTA_BAR[str(jflat[k].dtype)]
        assert _rel_l2(_np(t) - t0[k], _np(jflat[k]) - t0[k]) <= bar, k
        if f"master.{k}" in topt:
            assert _rel_l2(_np(topt[f"master.{k}"]) - t0[k],
                           _np(jopt[f"master.{k}"]) - t0[k]) <= bar, k


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_train_step_matches_reference(arch, dtype, microbatches, mode):
    """Two steps of the port's ``make_train_step`` on both backends against
    two of the reference's jitted one, from the same state and batch."""
    tcfg, jcfg, jp, tp = _both_params(arch, dtype, opt_memory_mode=mode)
    b = _batch(tcfg.vocab, 4, 32, seed=6)
    jstep = jax.jit(jsteps.make_train_step(jcfg, warmup=2, total_steps=10,
                                           microbatches=microbatches))
    jo = jadamw_init(jp, memory_mode=mode)
    jbatch = jax.tree.map(jnp.asarray, b)
    jp1, jo1, _ = jstep(jp, jo, jbatch)
    jp2, jo2, jm2 = jstep(jp1, jo1, jbatch)
    exact = dtype == "fp32" and mode == "fp32"
    for backend in ("kernels", "torch"):
        step = steps.make_train_step(tcfg, warmup=2, total_steps=10,
                                     microbatches=microbatches,
                                     backend=backend)
        to = adamw_init(transformer.flatten_params(tp), memory_mode=mode)
        batch = _torch_batch(b)
        tp1, to1, _ = step(tp, to, batch)
        tp2, to2, m2 = step(tp1, to1, batch)
        assert (to2.master is None) == (mode == "bf16")
        _check_step((tp2, to2), (jp2, jo2), m2, jm2, exact,
                    moments_bf16=mode == "bf16", start=tp)


@pytest.mark.parametrize("arch", _ARCHS)
def test_train_step_at_seq_1024_matches_reference(arch):
    """At S = 1024 the step takes the chunked CE (2 chunks) and the
    query-chunked attention backward (2 chunks of 512)."""
    tcfg, jcfg, jp, tp = _both_params(arch, "fp32")
    b = _batch(tcfg.vocab, 2, 1024, seed=7)
    jstep = jax.jit(jsteps.make_train_step(jcfg, warmup=2, total_steps=10,
                                           microbatches=2))
    jo = jadamw_init(jp)
    jp1, jo1, jm1 = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
    step = steps.make_train_step(tcfg, warmup=2, total_steps=10,
                                 microbatches=2)
    tp1, to1, m1 = step(tp, adamw_init(transformer.flatten_params(tp)),
                        _torch_batch(b))
    _check_step((tp1, to1), (jp1, jo1), m1, jm1, exact=True,
                moments_bf16=False)


@pytest.mark.parametrize("case", [
    # (arch, overrides, seq, microbatches)
    ("stablelm-1.6b", {}, 64, 1),
    ("stablelm-1.6b", {"remat": True}, 1024, 2),
    ("qwen3-32b", {"remat": True}, 64, 2),
    ("qwen3-32b", {"tie_embeddings": True}, 1024, 1),
], ids=str)
def test_train_step_dispatch_counts(case, plain_counts):
    """One step's matmul and attention dispatches are what
    ``chip_smoke.lm_train_launches`` works out (on the card, its kernel
    launches), in all and by part as ``Smoke.counting_parts`` splits them
    (phase 26a's split, here over the plain dispatches)."""
    arch, kw, seq, mb = case
    cfg = configs.get_reduced(arch).replace(**kw)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    opt = adamw_init(transformer.flatten_params(params))
    step = steps.make_train_step(cfg, warmup=2, total_steps=10,
                                 microbatches=mb)
    smoke = chip_smoke.Smoke.__new__(chip_smoke.Smoke)
    smoke.torch, smoke.kmm, smoke.kfa = torch, kmm, kfa
    parts = {}
    with smoke.counting_parts(parts, lambda: dict(plain_counts)):
        step(params, opt, _torch_batch(_batch(cfg.vocab, 2, seq)))
    want = chip_smoke.lm_train_launches(cfg, seq, mb)
    assert plain_counts == {k: sum(v.values()) for k, v in want.items()}
    assert parts == want


@pytest.mark.parametrize("seq,chunks", [(64, 1), (512, 1), (1000, 1),
                                        (1024, 2), (4096, 8)])
def test_ce_chunks_is_the_references_rule(seq, chunks, plain_counts):
    """``layers.ce_chunks`` gives the head products ``chunked_softmax_ce``
    makes: the full logits (one product) at most one chunk long or off a
    multiple of the chunk, else one a chunk."""
    assert layers.ce_chunks(seq) == chunks
    rng = np.random.default_rng(3)
    hidden = torch.from_numpy(rng.standard_normal((1, seq, 8),
                                                  dtype=np.float32))
    head = torch.from_numpy(rng.standard_normal((8, 16), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 16, (1, seq), dtype=np.int32))
    layers.chunked_softmax_ce(hidden, head, labels, torch.ones(1, seq))
    assert plain_counts["matmul"] == chunks


def test_full_stablelm_step_launch_count():
    """StableLM-2-1.6B at seq 4096, 2 microbatches, remat on: 704 matmuls
    and 48 attentions a microbatch."""
    cfg = configs.get_config("stablelm-1.6b")
    assert cfg.remat
    got = chip_smoke.lm_train_launches(cfg, 4096, 2)
    assert got["matmul"] == {"forward": 352, "recompute": 352,
                             "backward": 704}
    assert got["flash_attention"] == {"forward": 48, "recompute": 48,
                                      "backward": 0}


def test_train_step_refuses_encdec_and_odd_microbatches():
    """An encoder-decoder config is accepted (its step is held to the
    reference in ``tests/test_torch_encdec.py``); a batch that does not
    split into the microbatches is refused, decoder-only or not."""
    from repro_torch.models import encdec

    wcfg = configs.get_reduced("whisper-small")
    wparams = encdec.init_params(torch.Generator().manual_seed(0), wcfg,
                                 device="cpu")
    wbatch = _torch_batch(dict(
        _batch(wcfg.vocab, 4, 8),
        frames=np.zeros((4, wcfg.encoder_ctx, wcfg.d_model), np.float32)))
    _, opt, m = steps.make_train_step(wcfg)(
        wparams, adamw_init(transformer.flatten_params(wparams)), wbatch)
    assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))
    cfg = configs.get_reduced("stablelm-1.6b")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    for c, p, b in ((cfg, params, _torch_batch(_batch(cfg.vocab, 4, 8))),
                    (wcfg, wparams, wbatch)):
        step = steps.make_train_step(c, microbatches=3)
        with pytest.raises(ValueError, match="microbatches"):
            step(p, adamw_init(transformer.flatten_params(p)), b)


# ------------------------------------------------------- serving path ---

def test_serving_path_runs_no_autograd_function(monkeypatch):
    """Under ``torch.no_grad()`` (and on parameters that need no grad)
    ``linear`` and ``attention`` call the kernels' wrappers directly."""
    def refuse(*a, **k):
        raise AssertionError("an autograd Function on the serving path")

    monkeypatch.setattr(kmm.MatmulFn, "apply", refuse)
    monkeypatch.setattr(kfa.FlashAttentionFn, "apply", refuse)
    cfg = configs.get_reduced("qwen3-32b")
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg,
                                     device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        transformer.forward(params, toks, cfg)
        caches = transformer.init_caches(cfg, 2, 10, device="cpu")
        transformer.decode_step(params, toks, caches, 0, cfg)
        x = torch.randn(2, 3, cfg.d_model, requires_grad=True)
        layers.linear(x, params["embed"].T)
    # grad mode on, but nothing requires grad: still the plain wrappers
    transformer.forward(params, toks, cfg)
    p = transformer.layer_params(params, cfg).__next__()[4]
    attention.attention(p["mixer"], torch.randn(2, 5, cfg.d_model), cfg)


# --------------------------------------------------------- data, ckpt ---

def test_lm_pipeline_matches_reference():
    """Batches bit-equal to the reference's at steps 0 and 7, by
    ``batch_at`` and through the prefetch thread, before and after a
    ``seek``."""
    kw = dict(global_batch=4, seq_len=24, vocab=1000, seed=5,
              process_index=0, process_count=1)
    ours, ref = LMDataPipeline(**kw), jpipe.LMDataPipeline(**kw)
    try:
        for s in (0, 7):
            got, want = ours.batch_at(s), ref.batch_at(s)
            for k in ("tokens", "labels", "mask"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        for _ in range(3):
            (sg, got), (sw, want) = next(ours), next(ref)
            assert sg == sw
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
        ours.seek(7)
        ref.seek(7)
        (sg, got), (sw, want) = next(ours), next(ref)
        assert sg == sw == 7
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert got["tokens"].shape == (4, 24)
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])
    finally:
        ours.close()
        ref.close()
    assert not ours._thread.is_alive()
    half = LMDataPipeline(4, 8, 50, seed=5, process_index=1,
                          process_count=2)
    try:
        assert half.batch_at(0)["tokens"].shape == (2, 8)
        with pytest.raises(ValueError, match="split"):
            LMDataPipeline(3, 8, 50, process_count=2)
    finally:
        half.close()


def _state(cfg, mode):
    params = transformer.init_params(torch.Generator().manual_seed(3), cfg,
                                     device="cpu")
    opt = adamw_init(transformer.flatten_params(params), memory_mode=mode)
    return params, opt._replace(step=torch.tensor(5, dtype=torch.int32))


def _assert_tree_equal(got, want):
    gl, wl = tckpt.flatten_tree(got)[0], tckpt.flatten_tree(want)[0]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_ckpt_tree_roundtrip_and_mismatch(tmp_path, mode):
    """A (params, AdamWState) tree round-trips bit for bit into a meta
    template; a tree with another leaf count or shape raises."""
    cfg = configs.get_reduced("qwen3-32b").replace(opt_memory_mode=mode)
    state = _state(cfg, mode)
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 5, state)
    manifest = json.load(open(os.path.join(d, "step_000005",
                                           "manifest.json")))
    assert "flat_keys" not in manifest
    abstract = train.init_state(cfg, None, "meta")
    got = tckpt.restore_checkpoint(d, 5, abstract)
    assert isinstance(got[1], type(state[1]))
    assert (got[1].master is None) == (mode == "bf16")
    _assert_tree_equal(got, state)
    with pytest.raises(ValueError, match="structure"):
        tckpt.restore_checkpoint(d, 5, (abstract[0], abstract[1],
                                        torch.zeros(1)))
    bad = transformer.unflatten_params(
        {k: (torch.zeros(3) if k == "final_norm" else v) for k, v in
         transformer.flatten_params(abstract[0]).items()}, abstract[0])
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(d, 5, (bad, abstract[1]))


def test_ckpt_tree_is_the_references(tmp_path):
    """The two packages read each other's tree checkpoints."""
    cfg = configs.get_reduced("stablelm-1.6b")
    jcfg = jconfigs.get_reduced("stablelm-1.6b")
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = (jp, jadamw_init(jp))
    jckpt.save_checkpoint(str(tmp_path / "ref"), 2, jstate)
    abstract = train.init_state(cfg, None, "meta")
    got = tckpt.restore_checkpoint(str(tmp_path / "ref"), 2, abstract)
    want = transformer.flatten_params(jax.tree.map(np.asarray, jp))
    for k, t in transformer.flatten_params(got[0]).items():
        np.testing.assert_array_equal(_np(t), np.asarray(want[k],
                                                         np.float32))
    tckpt.save_checkpoint(str(tmp_path / "port"), 2, got)
    back = jckpt.restore_checkpoint(str(tmp_path / "port"), 2,
                                    jax.eval_shape(lambda: jstate))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_heartbeat_dead_hosts(tmp_path):
    """Fresh hearts are alive; stale, corrupt and mid-rename (``.tmp``)
    hearts prove nothing, as the reference's monitor reads them."""
    d = str(tmp_path)
    Heartbeat(d, 0).beat(3)
    Heartbeat(d, 1).beat(3)
    with open(os.path.join(d, "heartbeat_001.json"), "w") as f:
        json.dump({"step": 3, "time": time.time() - 100}, f)
    with open(os.path.join(d, "heartbeat_002.json"), "w") as f:
        f.write('{"step": 3, "ti')
    with open(os.path.join(d, "heartbeat_003.json.tmp"), "w") as f:
        json.dump({"step": 3, "time": time.time()}, f)
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("not a heart")
    assert Heartbeat.dead_hosts(d, 10.0) == [1, 2, 3]
    assert Heartbeat.dead_hosts(d, 1000.0) == [2, 3]
    assert Heartbeat.dead_hosts(str(tmp_path / "none"), 1.0) == []
    with open(os.path.join(d, "heartbeat_000.json")) as f:
        assert json.load(f)["step"] == 3


# ------------------------------------------------------------- the loop ---

_LOOP = dict(steps=4, global_batch=4, seq_len=16, microbatches=2,
             ckpt_every=2, device="cpu", log_every=10)


def _final_state(d, cfg):
    return tckpt.restore_checkpoint(d, tckpt.latest_step(d),
                                    train.init_state(cfg, None, "meta"))


def test_train_resumes_bit_for_bit_after_an_injected_fault(tmp_path):
    """A failure injected at step 3 restores the step-2 checkpoint and
    replays: the run ends on the uninterrupted run's state bit for bit."""
    cfg = configs.get_reduced("stablelm-1.6b")
    clean = train.train(cfg, ckpt_dir=str(tmp_path / "a"), **_LOOP)
    hit = train.train(cfg, ckpt_dir=str(tmp_path / "b"),
                      injector=FailureInjector({3}), **_LOOP)
    assert clean["recoveries"] == 0 and hit["recoveries"] == 1
    assert clean["final_step"] == hit["final_step"] == 4
    assert hit["loss"] == clean["loss"] and np.isfinite(hit["loss"])
    assert hit["stragglers"] == 0
    _assert_tree_equal(_final_state(str(tmp_path / "b"), cfg),
                       _final_state(str(tmp_path / "a"), cfg))
    assert Heartbeat.dead_hosts(str(tmp_path / "b"), 60.0) == []
    # a restart resumes at the newest checkpoint and trains to 6
    more = train.train(cfg, ckpt_dir=str(tmp_path / "a"),
                       **dict(_LOOP, steps=6))
    assert more["final_step"] == 6 and more["recoveries"] == 0


def test_train_lets_a_real_error_propagate(tmp_path, monkeypatch):
    """Only the fault plane's ``InjectedFault`` is recovered; any other
    ``RuntimeError`` (a kernel that does not build or launch) ends the
    run, checkpoint or not.  Without a checkpoint directory an injected
    fault propagates too."""
    cfg = configs.get_reduced("stablelm-1.6b")

    def broken(*a, **k):
        def step(*a, **k):
            raise RuntimeError("matmul (wgmma): launch failed")
        step.tp = None   # the step's layout: one device
        return step

    monkeypatch.setattr(train, "make_train_step", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        train.train(cfg, ckpt_dir=str(tmp_path), **_LOOP)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="injected"):
        train.train(cfg, injector=FailureInjector({1}),
                    **dict(_LOOP, ckpt_every=100))


def test_train_cli_on_the_cpu(capsys):
    train.main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "2",
                "--batch", "2", "--seq", "16", "--microbatches", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step=1" in out and "'final_step': 2" in out
