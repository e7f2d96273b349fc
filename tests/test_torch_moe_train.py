"""MoE training in the port (``repro_torch``) against the JAX reference, on
the CPU.

The same numpy inputs, drawn from a seed, and the reference's parameters
(its ``init_params`` / ``moe_init`` trees carried across leaf for leaf) go
through ``jax.value_and_grad`` of the reference's functions and through the
port's autograd, at the reduced ``qwen3-moe-30b-a3b`` (8 experts, top-2,
groups of 64) and ``llama4-scout-17b-a16e`` (4 experts, top-1, a shared
expert) configs.  The reference's MoE is plain ``jnp`` (no Pallas kernel);
on the CPU the port's ``backend="kernels"`` runs kernel 3's plain versions
through ``MatmulFn`` and ``BatchedMatmulFn``, ``"torch"`` runs
``torch.matmul`` and ``torch.bmm`` under autograd.

Routing is discontinuous, and a route swapped by a last-bit difference is a
jump no bar covers.  The reference's routes are read from the very run
that the port is held to (``jax.lax.top_k`` wrapped so that an ordered
``jax.debug.callback`` hands each MoE layer's experts to the host, inside
the jitted step too: a jitted bf16 step routes other tokens than an eager
forward).  In fp32 the tests assert that the port's routes are the
reference's; in bf16 they force the port onto the reference's routes
(``moe.route(experts=)``) before holding values and gradients.

Bars (ROADMAP.md, DESIGN.md §12): fp32 values at 1e-5 and gradients at 1e-4
x max|ref|; bf16 values within 5% and each gradient tensor within 10%
relative L2.
"""

import contextlib
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.optim import adamw_init as jadamw_init
from repro_torch import checkpoint as tckpt
from repro_torch import configs
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     Heartbeat)
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import steps, train
from repro_torch.models import layers, moe, transformer
from repro_torch.optim import adamw_init

_ARCHS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
_CFG_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}
_VALUE_BAR = {"fp32": 1e-5, "bf16": 5e-2}
_GRAD_BAR = {"fp32": 1e-4, "bf16": 1e-1}
# (B, S, capacity factor), as tests/test_torch_moe.py: groups within the
# sequence, across the batch's tokens (some dropped), nearly all dropped
_CASES = {"within_sequence": (2, 128, None), "across_batch": (4, 1, None),
          "capacity_1e-9": (2, 128, 1e-9)}

# chip_smoke.py's phase-30 launch oracles and its split by part
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


def _hold_grad(got, want, dtype, what=""):
    """A gradient tensor against the reference's: fp32 at 1e-4 x max|ref|
    (no floor: the gradients are far below 1), bf16 at 10% relative L2."""
    assert got.shape == tuple(np.shape(want)), what
    assert np.isfinite(_np(got)).all(), what
    if dtype == "fp32":
        _close(got, want, _GRAD_BAR["fp32"], floor=0.0)
    else:
        assert _rel_l2(got, want) <= _GRAD_BAR["bf16"], what


def _cfgs(arch, dtype, cf=None, **kw):
    """The port's and the reference's reduced config of ``arch``."""
    out = []
    for mod in (configs, jconfigs):
        cfg = mod.get_reduced(arch).replace(dtype=_CFG_DTYPE[dtype], **kw)
        if cf is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=cf))
        out.append(cfg)
    return out


def _tensors(tree, dtype):
    """A reference tree of arrays as the port's tensors (an fp32 router
    stays fp32)."""
    return {k: _tensors(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(
                torch.float32 if v.dtype == jnp.float32 else dtype)
            for k, v in tree.items()}


def _flat(tree):
    return transformer.flatten_params(tree)


@pytest.fixture
def jax_routes(monkeypatch):
    """The experts of every ``lax.top_k`` the reference runs from here on,
    in call order, one (lead0, lead1, g, k) array a MoE layer: its routing
    is the only ``top_k`` of a forward.  Jitted code reports through an
    ordered ``jax.debug.callback``, so a trace made now records them each
    time it runs."""
    seen = []
    orig = jax.lax.top_k

    def top_k(x, k):
        vals, idx = orig(x, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return seen


@pytest.fixture
def routes():
    """``routes(force=None)``: a context that records each ``moe.route``
    call's (experts, kept) in the list it yields; with ``force`` (experts
    arrays, one a call in call order) each call takes its entry's experts
    (``route(experts=)``)."""

    @contextlib.contextmanager
    def ctx(force=None):
        seen, orig = [], moe.route
        it = iter(force or ())

        def rec(router, xt, cfg, backend="kernels", experts=None):
            if force is not None:
                experts = torch.from_numpy(np.array(next(it),
                                                    dtype=np.int64))
            out = orig(router, xt, cfg, backend, experts=experts)
            seen.append((out[0], out[3]))
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(moe, "route", rec)
            yield seen
        if force is not None:
            assert next(it, None) is None, "forced routes left over"

    return ctx


def _same_routes(t_routes, j_routes):
    """The port's experts, call by call, against the reference's (the kept
    masks follow from them the same way in both packages,
    ``tests/test_torch_moe.py``)."""
    assert len(t_routes) == len(j_routes) > 0
    for (idx, _), want in zip(t_routes, j_routes):
        np.testing.assert_array_equal(idx.numpy(), want)


@pytest.fixture
def plain_counts(monkeypatch):
    """Count kernel 3's plain dispatches, 2-D and batched, and kernel 4's
    (the kernels' plain versions stand in for them on the CPU)."""
    counts = {"matmul": 0, "matmul_batched": 0, "flash_attention": 0}
    mm, bmm, fa = kmm.matmul_plain, kmm.matmul_batched_plain, \
        kfa.attention_plain

    def wrap(name, fn):
        def inner(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return inner

    monkeypatch.setattr(kmm, "matmul_plain", wrap("matmul", mm))
    monkeypatch.setattr(kmm, "matmul_batched_plain",
                        wrap("matmul_batched", bmm))
    monkeypatch.setattr(kfa, "attention_plain", wrap("flash_attention", fa))
    return counts


# ------------------------------------------------ the batched backward ---

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 40, 320])
@pytest.mark.parametrize("e", [1, 4, 16])
def test_batched_matmul_fn_gradients_match_jax(e, m, dtype, plain_counts):
    """``BatchedMatmulFn``'s dA and dB against ``jax.grad`` of
    ``einsum("emk,ekn->emn")``: one batched dispatch forward, one for each
    gradient, each on one contiguous transpose, each gradient in its
    operand's dtype."""
    rng = np.random.default_rng(e * 1000 + m)
    a, b, cot = (rng.standard_normal(s).astype(np.float32)
                 for s in ((e, m, 24), (e, 24, 40), (e, m, 40)))

    def jfn(x, w):
        y = jnp.einsum("emk,ekn->emn", x, w,
                       preferred_element_type=jnp.float32).astype(x.dtype)
        return jnp.sum(y.astype(jnp.float32) * cot)

    jga, jgb = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(a, _JDT[dtype]),
                                             jnp.asarray(b, _JDT[dtype]))
    ta = torch.from_numpy(a).to(_TDT[dtype]).requires_grad_()
    tb = torch.from_numpy(b).to(_TDT[dtype]).requires_grad_()
    before = kmm.MatmulFn.transposes
    y = kmm.BatchedMatmulFn.apply(ta, tb)
    assert y.dtype == _TDT[dtype] and plain_counts["matmul_batched"] == 1
    ga, gb = torch.autograd.grad(y, (ta, tb),
                                 torch.from_numpy(cot).to(_TDT[dtype]))
    assert plain_counts == {"matmul": 0, "matmul_batched": 3,
                            "flash_attention": 0}
    assert kmm.MatmulFn.transposes - before == 2
    assert ga.dtype == gb.dtype == _TDT[dtype]
    _hold_grad(ga, jga, dtype, "dA")
    _hold_grad(gb, jgb, dtype, "dB")


def test_batched_matmul_fn_takes_only_the_gradients_asked_for(plain_counts):
    """A frozen weight takes no dB launch and no transpose of A."""
    a = torch.randn(4, 8, 16, requires_grad=True)
    b = torch.randn(4, 16, 8)
    before = kmm.MatmulFn.transposes
    (ga,) = torch.autograd.grad(kmm.BatchedMatmulFn.apply(a, b).sum(), (a,))
    assert plain_counts["matmul_batched"] == 2
    assert kmm.MatmulFn.transposes - before == 1
    torch.testing.assert_close(ga, torch.ones(4, 8, 8) @ b.transpose(1, 2))


# ---------------------------------------------------------- the FFN ---

def _ffn_value_and_grad(p, x, cot, cfg, backend, force=None, routes=None):
    """The port's ``moe_ffn`` value and its gradients by leaf name and
    ``"x"``, with its routes (forced to ``force`` when given)."""
    leaves = {k: v.detach().requires_grad_() for k, v in _flat(p).items()}
    tree = transformer.unflatten_params(leaves, p)
    tx = x.detach().requires_grad_()
    with routes(force) as seen:
        out = moe.moe_ffn(tree, tx, cfg, backend)
    grads = torch.autograd.grad(out, [tx, *leaves.values()], cot)
    return out, dict(zip(["x", *leaves], grads)), seen


#: the reference's runs, each made once for both port backends
_REF: dict = {}


def _ffn_reference(arch, case, dtype, jax_routes):
    """The reference ``moe_ffn``'s parameters, inputs, value, gradients and
    routes for ``(arch, case, dtype)``: jitted and run once, kept for the
    other backend's test."""
    key = ("ffn", arch, case, dtype)
    if key not in _REF:
        b, s, cf = _CASES[case]
        _, jcfg = _cfgs(arch, dtype, cf)
        jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, _JDT[dtype])
        rng = np.random.default_rng(4)
        x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
        cot = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)

        def jloss(p, xx):
            out = jmoe.moe_ffn(p, xx, jcfg)
            return jnp.sum(out.astype(jnp.float32) * cot), out

        (_, want), (jgp, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(
                jp, jnp.asarray(x, _JDT[dtype]))
        jax.effects_barrier()
        assert len(jax_routes) == 1
        _REF[key] = (jp, x, cot, want, jgp, jgx, list(jax_routes))
    return _REF[key]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("arch", _ARCHS)
def test_moe_ffn_gradients_match_reference(arch, case, backend, dtype,
                                           routes, jax_routes):
    """``moe_ffn``'s value and the gradients of x, the router, the expert
    stacks and the shared expert against ``jax.value_and_grad`` of the
    reference's ``moe_ffn``.  fp32: the port's own routes, asserted equal
    to the reference's; bf16: the port forced onto the reference's."""
    tcfg, jcfg = _cfgs(arch, dtype, _CASES[case][2])
    jp, x, cot, want, jgp, jgx, j_routes = _ffn_reference(arch, case, dtype,
                                                          jax_routes)
    force = None if dtype == "fp32" else j_routes
    got, grads, seen = _ffn_value_and_grad(
        _tensors(jp, _TDT[dtype]), torch.from_numpy(x).to(_TDT[dtype]),
        torch.from_numpy(cot).to(_TDT[dtype]), tcfg, backend, force, routes)
    _same_routes(seen, j_routes)
    assert got.dtype == _TDT[dtype]
    _close(got, want, _VALUE_BAR[dtype])
    jflat = {"x": jgx, **_flat(jax.tree.map(np.asarray, jgp))}
    assert grads.keys() == jflat.keys()
    for k, g in grads.items():
        _hold_grad(g, jflat[k], dtype, k)
        assert g.dtype == (torch.float32 if k == "router" else _TDT[dtype])
    if tcfg.moe.top_k == 1:
        # the softmax of one gate is 1 whatever its logit
        assert not np.asarray(jgp["router"]).any()
        assert not grads["router"].any()


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_dropped_slots_take_and_give_no_gradient(backend, routes,
                                                 monkeypatch):
    """Qwen3-MoE's reduced config (no shared expert) at capacity factor
    1e-9, one slot an expert a group: a token whose every slot is dropped
    gets an exactly zero gradient in both packages (none through the
    experts, none through its gates, ``gates * keep``); the row of the
    expert buffers that the dropped slots' clamped reads hit gets exactly
    its kept slot's gradient, the dropped reads adding zeros."""
    tcfg, jcfg = _cfgs("qwen3-moe-30b-a3b", "fp32", 1e-9)
    jp = jmoe.moe_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 128, tcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jgx = jax.jit(jax.grad(
        lambda xx: jnp.sum(jmoe.moe_ffn(jp, xx, jcfg) * cot)))(jnp.asarray(x))
    caught = {}
    orig = moe._experts

    def experts(p, xe, be):
        ye = orig(p, xe, be)
        ye.register_hook(lambda g: caught.setdefault("ye", g))
        return ye

    monkeypatch.setattr(moe, "_experts", experts)
    tp = _tensors(jp, torch.float32)
    _, grads, seen = _ffn_value_and_grad(
        tp, torch.from_numpy(x), torch.from_numpy(cot), tcfg, backend,
        routes=routes)
    (idx, keep), = seen
    dropped = ~keep.reshape(-1, tcfg.moe.top_k).any(-1).numpy()
    assert dropped.mean() > 0.5
    gx = grads["x"].reshape(-1, tcfg.d_model).numpy()
    assert not gx[dropped].any()
    assert not np.asarray(jgx).reshape(-1, tcfg.d_model)[dropped].any()
    assert np.abs(gx[~dropped]).min(-1).max() > 0
    # the last row of the flat buffers: the dropped slots' clamped reads
    # land on it; its gradient is its kept slot's gate times the output's
    # cotangent, or zero if no kept slot holds it
    e, k = tcfg.moe.num_experts, tcfg.moe.top_k
    ye_grad = caught["ye"]
    rows = ye_grad.shape[1]
    groups = idx.numel() // (idx.shape[-2] * k)
    cap = rows // groups
    g_len = idx.shape[-2]
    fi, fk = idx.reshape(-1, k), keep.reshape(-1, k)
    gates = moe.route(tp["router"], moe.group_tokens(torch.from_numpy(x),
                                                     tcfg), tcfg)[1]
    gates = gates.reshape(-1, k)
    pos = moe.route(tp["router"], moe.group_tokens(torch.from_numpy(x),
                                                   tcfg), tcfg)[2]
    pos = pos.reshape(-1, k)
    want = torch.zeros(tcfg.d_model)
    for t in range(fi.shape[0]):
        for j in range(k):
            row = fi[t, j] * rows + (t // g_len) * cap + pos[t, j]
            if fk[t, j] and row == e * rows - 1:
                want = gates[t, j] * torch.from_numpy(cot).reshape(
                    -1, tcfg.d_model)[t]
    assert torch.equal(ye_grad[e - 1, rows - 1], want)


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_top1_router_gradient_is_exactly_zero(backend):
    """Llama-4-Scout routes top-1: its one gate is the softmax of a single
    logit, the constant 1, so the router's gradient through a whole model's
    loss is exactly zero in both packages."""
    tcfg, jcfg = _cfgs("llama4-scout-17b-a16e", "fp32")
    jp = jtr.init_params(jax.random.PRNGKey(7), jcfg)
    tp = transformer.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    b = _batch(tcfg.vocab, 2, 64, seed=8)
    if "top1" not in _REF:
        _REF["top1"] = _reference_value_and_grad(jp, jcfg, b, 1)[1]
    jg = _REF["top1"]
    _, g = steps.make_value_and_grad(tcfg, backend=backend)(
        tp, _torch_batch(b))
    routers = [k for k in g if k.endswith("ffn.router")]
    assert routers
    for k in routers:
        assert not g[k].any() and not np.asarray(jg[k]).any()
        assert g[k].dtype == torch.float32
    assert g["embed"].abs().max() > 0


def test_aux_load_balance_loss_matches_reference():
    """The Switch-style auxiliary loss (which no path calls) against the
    reference's, value and router-logit gradient, on the reduced Qwen3-MoE
    router's logits (G, g, E) and their top-k."""
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((4, 64, 8)).astype(np.float32)
    _, idx = jax.lax.top_k(jnp.asarray(logits), 2)
    want, jg = jax.value_and_grad(
        lambda lg: jmoe.aux_load_balance_loss(lg, idx, 8))(
            jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = moe.aux_load_balance_loss(tl, torch.from_numpy(np.array(idx)), 8)
    (g,) = torch.autograd.grad(got, tl)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, 1e-6, floor=0.0)
    _close(g, jg, 1e-5, floor=0.0)


# ------------------------------------------------------- the whole step ---

def _batch(vocab, rows, seq, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1),
                                                dtype=np.int32)
    mask = np.ones((rows, seq), np.float32)
    mask[0, :3] = 0.0   # a masked-out prefix: the loss is a masked mean
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            b.items()}


def _both_params(arch, dtype, seed=0, **kw):
    tcfg, jcfg = _cfgs(arch, dtype, **kw)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = transformer.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    return tcfg, jcfg, jp, tp


def _jloss(jcfg):
    def loss(p, mb):
        hidden = jtr.forward(p, mb["tokens"], jcfg, return_hidden=True)
        return jlayers.chunked_softmax_ce(hidden, jtr.lm_head(p, jcfg),
                                          mb["labels"], mb["mask"])
    return loss


def _reference_value_and_grad(jp, jcfg, b, microbatches):
    """The reference train step's loss and gradients (the body of its
    ``make_train_step``: the jitted ``jax.value_and_grad`` of its loss per
    microbatch, summed in the accumulator's dtype, divided; one microbatch
    keeps the parameters' dtypes), as flat numpy by the port's names."""
    vg = jax.jit(jax.value_and_grad(_jloss(jcfg)))
    if microbatches == 1:
        loss, grads = vg(jp, jax.tree.map(jnp.asarray, b))
        return float(loss), _flat(jax.tree.map(np.asarray, grads))
    acc = jnp.bfloat16 if jcfg.opt_memory_mode == "bf16" else jnp.float32
    size = b["tokens"].shape[0] // microbatches
    loss, gsum = 0.0, None
    for i in range(microbatches):
        lv, g = vg(jp, {k: jnp.asarray(v[i * size:(i + 1) * size])
                        for k, v in b.items()})
        g = jax.tree.map(lambda a: a.astype(acc), g)
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        loss = loss + lv
    grads = jax.tree.map(lambda a: a / microbatches, gsum)
    return float(loss) / microbatches, _flat(jax.tree.map(np.asarray,
                                                          grads))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_value_and_grad_matches_reference(arch, dtype, microbatches,
                                          routes, jax_routes):
    """``make_value_and_grad`` on both backends against the reference train
    step's loss and gradients, every leaf: the fp32 router (D, E), the
    expert stacks (L, E, D, F) and (L, E, F, D), Llama-4's shared expert;
    in bf16 on the reference's routes."""
    tcfg, jcfg, jp, tp = _both_params(arch, dtype)
    assert not tcfg.remat
    b = _batch(tcfg.vocab, 4, 64, seed=10)
    jl, jg = _reference_value_and_grad(jp, jcfg, b, microbatches)
    jax.effects_barrier()
    j_routes = list(jax_routes)
    assert len(j_routes) == microbatches * tcfg.num_layers
    force = None if dtype == "fp32" else j_routes
    for backend in ("kernels", "torch"):
        vg = steps.make_value_and_grad(tcfg, microbatches=microbatches,
                                       backend=backend)
        with routes(force) as seen:
            loss, grads = vg(tp, _torch_batch(b))
        _same_routes(seen, j_routes)
        assert abs(float(loss) - jl) <= _VALUE_BAR[dtype] * abs(jl)
        assert grads.keys() == jg.keys()
        assert grads["blocks.0.ffn.we_gate"].shape == (
            tcfg.repeat, tcfg.moe.num_experts, tcfg.d_model,
            tcfg.moe.d_ff_expert)
        for k, g in grads.items():
            _hold_grad(g, jg[k], dtype, f"{backend} {k}")


def _opt_leaves(state):
    out = {"step": state.step}
    for part in ("master", "mu", "nu"):
        tree = getattr(state, part)
        if tree is not None:
            out.update({f"{part}.{k}": v for k, v in _flat(tree).items()})
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_train_step_matches_reference(arch, dtype, routes, jax_routes):
    """One ``make_train_step`` step (fp32 AdamW, 2 microbatches) on both
    backends against the reference's jitted ``make_train_step`` run without
    a mesh (in bf16 on its routes): the metrics,
    every parameter, master and moment.  fp32: values at 1e-5, the
    gradient norm and every leaf at 1e-4 x max(1, max|ref|), moments at
    relative L2 1e-4; bf16: loss 5%, gradient norm 10%, parameters and
    masters at relative L2 5%, moments 10%."""
    tcfg, jcfg, jp, tp = _both_params(arch, dtype, seed=1)
    b = _batch(tcfg.vocab, 4, 64, seed=11)
    microbatches = 2
    jstep = jax.jit(jsteps.make_train_step(jcfg, warmup=2, total_steps=10,
                                           microbatches=microbatches))
    jp1, jo1, jm = jstep(jp, jadamw_init(jp), jax.tree.map(jnp.asarray, b))
    jax.effects_barrier()
    j_routes = list(jax_routes)
    assert len(j_routes) == microbatches * tcfg.num_layers
    force = None if dtype == "fp32" else j_routes
    exact = dtype == "fp32"
    vbar, gbar = ((_VALUE_BAR["fp32"], _GRAD_BAR["fp32"]) if exact
                  else (_VALUE_BAR["bf16"], _GRAD_BAR["bf16"]))
    jflat = _flat(jax.tree.map(np.asarray, jp1))
    jopt = _opt_leaves(jax.tree.map(np.asarray, jo1))
    for backend in ("kernels", "torch"):
        step = steps.make_train_step(tcfg, warmup=2, total_steps=10,
                                     microbatches=microbatches,
                                     backend=backend)
        with routes(force) as seen:
            tp1, to1, m = step(tp, adamw_init(_flat(tp)), _torch_batch(b))
        _same_routes(seen, j_routes)
        for k, bar in (("loss", vbar), ("grad_norm", gbar), ("lr", 1e-6)):
            g, w = float(m[k]), float(jm[k])
            assert abs(g - w) <= bar * abs(w), (backend, k, g, w)
        for k, t in _flat(tp1).items():
            assert str(t.dtype).removeprefix("torch.") == str(
                jflat[k].dtype), k
            if exact:
                _close(t, jflat[k], gbar)
            else:
                assert _rel_l2(t, jflat[k]) <= 0.05, (backend, k)
        topt = _opt_leaves(to1)
        assert topt.keys() == jopt.keys()
        assert int(topt.pop("step")) == int(jopt["step"]) == 1
        for k, t in topt.items():
            moment = not k.startswith("master.")
            if exact:
                if moment:
                    assert _rel_l2(t, jopt[k]) <= gbar, (backend, k)
                else:
                    _close(t, jopt[k], gbar)
            else:
                assert _rel_l2(t, jopt[k]) <= (0.1 if moment else 0.05), \
                    (backend, k)


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_remat_on_and_off_give_the_same_gradients(arch, backend, routes):
    """Per-layer remat routes each MoE layer again in the recompute, on
    the same routes bit for bit, so the loss and every gradient are bit for
    bit those without remat."""
    tcfg, _, _, tp = _both_params(arch, "bf16")
    batch = _torch_batch(_batch(tcfg.vocab, 2, 64, seed=12))
    out = {}
    for remat in (False, True):
        vg = steps.make_value_and_grad(tcfg.replace(remat=remat),
                                       microbatches=2, backend=backend)
        with routes() as seen:
            out[remat] = vg(tp, batch), seen
    (l0, g0), plain = out[False]
    (l1, g1), rematted = out[True]
    layers_n = tcfg.num_layers
    assert len(plain) == 2 * layers_n and len(rematted) == 4 * layers_n
    for mb in range(2):
        fwd = rematted[mb * 2 * layers_n:(mb * 2 + 1) * layers_n]
        again = rematted[(mb * 2 + 1) * layers_n:(mb + 1) * 2 * layers_n]
        for (i0, k0), (i1, k1), (ip, kp) in zip(
                fwd, reversed(again), plain[mb * layers_n:]):
            assert torch.equal(i0, i1) and torch.equal(k0, k1)
            assert torch.equal(i0, ip) and torch.equal(k0, kp)
    assert torch.equal(l0, l1) and g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# ------------------------------------------------- launches, the loop ---

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", _ARCHS)
def test_train_step_dispatch_counts(arch, remat, plain_counts):
    """One step's dispatches of kernel 3 (2-D and batched) and kernel 4 are
    ``chip_smoke.lm_train_split``'s, in all and by part as
    ``Smoke.counting_parts`` splits them (phase 30's split, here over the
    plain dispatches); the fp32 routers' products are
    ``router_train_launches``; the transposes one a backward product."""
    cfg = configs.get_reduced(arch).replace(remat=remat)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    step = steps.make_train_step(cfg, warmup=2, total_steps=10,
                                 microbatches=2)
    smoke = chip_smoke.Smoke.__new__(chip_smoke.Smoke)
    smoke.torch, smoke.kmm, smoke.kfa = torch, kmm, kfa
    fp32 = {"n": 0}
    orig = kmm.matmul_plain

    def count_fp32(a, b):
        fp32["n"] += a.dtype == torch.float32
        return orig(a, b)

    parts = {}
    before = kmm.MatmulFn.transposes
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kmm, "matmul_plain", count_fp32)
        with smoke.counting_parts(parts, lambda: dict(plain_counts)):
            step(params, adamw_init(_flat(params)),
                 _torch_batch(_batch(cfg.vocab, 4, 64)))
    want = chip_smoke.lm_train_split(cfg, 64, 2)
    assert parts == want
    assert fp32["n"] == chip_smoke.router_train_launches(cfg, 2)
    assert kmm.MatmulFn.transposes - before == (
        want["matmul"]["backward"] + want["matmul_batched"]["backward"])


def test_phase_30_launch_oracle_at_full_width():
    """Phase 30's counts at the card's configurations: Qwen3-MoE-30B-A3B at
    2 layers, seq 4096 in 2 microbatches (remat on), and Llama-4-Scout at 2
    layers, seq 4096, one microbatch."""
    qwen = configs.get_config("qwen3-moe-30b-a3b").replace(num_layers=2)
    assert qwen.remat
    got = chip_smoke.lm_train_split(qwen, 4096, 2)
    # a layer: q, k, v, o and the router; 8 CE chunks of the head
    assert got["matmul"] == {"forward": 2 * (2 * 5 + 8),
                             "recompute": 2 * (2 * 5 + 8),
                             "backward": 4 * (2 * 5 + 8)}
    assert got["matmul_batched"] == {"forward": 12, "recompute": 12,
                                     "backward": 24}
    assert got["flash_attention"] == {"forward": 4, "recompute": 4,
                                      "backward": 0}
    assert chip_smoke.router_train_launches(qwen, 2) == 16
    scout = configs.get_config("llama4-scout-17b-a16e").replace(num_layers=2)
    got = chip_smoke.lm_train_split(scout, 4096, 1)
    assert got["matmul"]["forward"] == 2 * 8 + 8
    assert got["matmul_batched"] == {"forward": 6, "recompute": 6,
                                     "backward": 12}
    assert chip_smoke.router_train_launches(scout, 1) == 8


_LOOP = dict(steps=4, global_batch=4, seq_len=64, microbatches=2,
             ckpt_every=2, device="cpu", log_every=10)


def _final_state(d, cfg):
    return tckpt.restore_checkpoint(d, tckpt.latest_step(d),
                                    train.init_state(cfg, None, "meta"))


def test_train_resumes_bit_for_bit_after_an_injected_fault(tmp_path):
    """Reduced Qwen3-MoE through ``launch.train.train``: a failure injected
    at step 3 restores the step-2 checkpoint and replays, ending on the
    uninterrupted run's state bit for bit, the expert stacks included."""
    cfg = configs.get_reduced("qwen3-moe-30b-a3b")
    clean = train.train(cfg, ckpt_dir=str(tmp_path / "a"), **_LOOP)
    hit = train.train(cfg, ckpt_dir=str(tmp_path / "b"),
                      injector=FailureInjector({3}), **_LOOP)
    assert clean["recoveries"] == 0 and hit["recoveries"] == 1
    assert clean["final_step"] == hit["final_step"] == 4
    assert hit["loss"] == clean["loss"] and np.isfinite(hit["loss"])
    a = _final_state(str(tmp_path / "a"), cfg)
    bb = _final_state(str(tmp_path / "b"), cfg)
    fa, fb = _flat(a[0]), _flat(bb[0])
    assert "blocks.0.ffn.we_down" in fa and fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    for part in ("master", "mu", "nu"):
        ta, tb = _flat(getattr(a[1], part)), _flat(getattr(bb[1], part))
        for k in ta:
            assert torch.equal(ta[k], tb[k]), (part, k)
    assert Heartbeat.dead_hosts(str(tmp_path / "b"), 60.0) == []


def test_train_cli_on_the_cpu(capsys):
    train.main(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--steps", "2",
                "--batch", "4", "--seq", "64", "--microbatches", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step=1" in out and "'final_step': 2" in out


@pytest.mark.parametrize("arch", _ARCHS)
def test_training_accepts_the_moe_configs(arch):
    """The train entry points take both MoE configs, as the serve steps
    do; a step runs on the reduced config."""
    cfg = configs.get_reduced(arch)
    assert steps.make_train_step(cfg) is not None
    assert steps.make_value_and_grad(cfg) is not None
    assert steps.make_serve_step(cfg) is not None
    assert steps.make_prefill_step(cfg) is not None
    out = train.train(cfg, steps=1, global_batch=2, seq_len=8, device="cpu")
    assert out["final_step"] == 1 and np.isfinite(out["loss"])


def test_linear_and_experts_take_the_functions_only_under_autograd(
        plain_counts):
    """Serving (grad off, or no operand that requires grad) calls the
    kernels' wrappers and builds no autograd Function."""
    cfg = configs.get_reduced("qwen3-moe-30b-a3b")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    x = torch.randn(1, 64, cfg.d_model)
    with torch.no_grad():
        y = moe.moe_ffn(p, x, cfg)
    assert y.grad_fn is None and plain_counts["matmul_batched"] == 3
    y = moe.moe_ffn(p, x, cfg)
    assert y.grad_fn is None and plain_counts["matmul_batched"] == 6
    y = moe.moe_ffn(p, x.requires_grad_(), cfg)
    assert y.grad_fn is not None
    y.sum().backward()
    # the weights require no grad: each product's dA alone
    assert plain_counts["matmul_batched"] == 9 + 3
    assert layers.linear(x, p["router"]).grad_fn is not None
