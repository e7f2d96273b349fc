"""Training the xLSTM mixers and the reduced xLSTM in the port against the
JAX reference, on the CPU.

The same numpy inputs, drawn from a seed, and the same parameters (the
reference's ``mlstm_init`` / ``slstm_init`` / ``init_params`` carried
across leaf for leaf) go through the reference's ``jax.value_and_grad``
(jitted once per function and shape in this module), with its AdamW for a
train step, and through the port's autograd, at
``xlstm-1.3b``'s reduced configuration (d_model 64, 2 heads, mLSTM d_inner
128, sLSTM FFN 85 wide; 4 layers alternating mLSTM and sLSTM).  On the CPU
the port's ``backend="kernels"`` runs kernel 3's plain version through
``MatmulFn``, ``backend="torch"`` runs ``torch.matmul``.  The mLSTM's
chunkwise form runs with ``M_CHUNK`` set small on both packages.

Bars: fp32 gradients at 1e-4 x max(1, max|ref|), values at 1e-5; a train
step's new parameters at 1e-5 x max(1, max|ref|).  bf16 is held layer by
layer: each layer's VJP from the reference's recorded input, on a seeded
cotangent, no farther from the fp32 VJP of the same bf16 weights than the
reference's own bf16 VJP is, within a quarter (end to end, bf16 roundings
compound layer by layer in the two frameworks, ``tests/test_torch_xlstm.py``).
The helpers here serve ``tests/test_torch_mamba_train.py`` too.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models import xlstm as jxlstm
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro_torch import checkpoint as tckpt
from repro_torch import configs
from repro_torch.distributed.fault_tolerance import FailureInjector
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import steps, train
from repro_torch.models import layers, transformer, xlstm
from repro_torch.optim import adamw_init
from test_torch_mamba import _tensor

_ARCH = "xlstm-1.3b"
_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
_CFG_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}
_VALUE_BAR, _GRAD_BAR, _PARAM_BAR = 1e-5, 1e-4, 1e-5
_ADAM_EPS = 1e-8
# a bf16 layer's gradients no farther from the fp32 ones than the
# reference's bf16 gradients are, within a quarter (pooled over the layer's
# gradients), and each within twice
_BF16_SLACK, _LEAF_SLACK = 1.25, 2.0
# (sequence length, M_CHUNK): the parallel form; 4 chunks of 8
_FORMS = {"parallel": (24, 512), "chunkwise": (32, 8)}
_SEQ, _M_CHUNK = 32, 8

# chip_smoke.py's launch oracles (``lm_train_launches``,
# ``recurrent_train_launches``, ``train_variants``) and its split by part
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

#: the reference's jitted functions, traced once each in this module
_JITTED = {}


@pytest.fixture(autouse=True)
def _no_sharding_hook(monkeypatch):
    """The reference's model functions without a mesh: another test file in
    this process may have left the sharding hook of its ``Server``."""
    monkeypatch.setattr(jlayers, "_CONSTRAINT_FN", None)


def _chunk(monkeypatch, chunk):
    monkeypatch.setattr(jxlstm, "M_CHUNK", chunk)
    monkeypatch.setattr(xlstm, "M_CHUNK", chunk)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rtol, floor=1.0, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = max(floor, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, rtol * scale)
    return err


def _rel_l2(got, want):
    got, want = (_np(a).astype(np.float64) for a in (got, want))
    norm = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / norm) if norm else float(
        np.linalg.norm(got))


def _flat(tree):
    return transformer.flatten_params(tree)


def _tensors(tree, dtype):
    """A reference tree of arrays as tensors, leaf for leaf (fp32 leaves
    stay fp32)."""
    return {k: _tensors(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(
                torch.float32 if v.dtype == jnp.float32 else dtype)
            for k, v in tree.items()}


def _jitted(key, make):
    if key not in _JITTED:
        _JITTED[key] = jax.jit(make())
    return _JITTED[key]


def _rounded(key, fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off, so that each
    bf16 operation rounds its result as the reference's eager run does
    (XLA otherwise keeps fused bf16 chains in fp32); compiled once per
    ``key``."""
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
    return _JITTED[key](*args)


# --------------------------------------------- a mixer's gradients ---

def mixer_grads_ref(key, block, jcfg, jp, x, cot):
    """The reference's gradients of ``sum(block(p, x) * cot)``: (loss,
    {leaf: grad}, dx), jitted once per ``key``."""
    def loss(p, xx):
        return jnp.sum(block(p, xx, jcfg)[0].astype(jnp.float32) * cot)

    vg = _jitted(key, lambda: jax.value_and_grad(loss, argnums=(0, 1)))
    val, (gp, gx) = vg(jp, x)
    return float(val), jax.tree.map(np.asarray, gp), np.asarray(gx)


def mixer_grads(block, tcfg, tp, x, cot, backend):
    """The port's: (loss, {leaf: grad}, dx) by autograd."""
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    tx = x.detach().requires_grad_()
    y = block(leaves, tx, tcfg, backend=backend)[0]
    val = (y.float() * cot).sum()
    grads = torch.autograd.grad(val, [tx, *leaves.values()])
    return float(val), dict(zip(leaves, grads[1:])), grads[0]


def hold_grads(got, want, what=""):
    """(loss, grads, dx) of the port against the reference's in fp32."""
    (gv, gg, gx), (wv, wg, wx) = got, want
    assert abs(gv - wv) <= _VALUE_BAR * max(1.0, abs(wv)), (what, gv, wv)
    assert gg.keys() == wg.keys()
    for k in wg:
        assert gg[k].dtype == (torch.float32 if wg[k].dtype == np.float32
                               else torch.bfloat16), (what, k)
        _close(gg[k], wg[k], _GRAD_BAR, what=f"{what} {k}")
    _close(gx, wx, _GRAD_BAR, what=f"{what} dx")


def _mixer(kind, seed):
    """The reduced fp32 configs and one mixer's parameters, the
    reference's and the port's."""
    tcfg = configs.get_reduced(_ARCH).replace(dtype="float32")
    jcfg = jconfigs.get_reduced(_ARCH).replace(dtype="float32")
    init = {"mlstm": jxlstm.mlstm_init, "slstm": jxlstm.slstm_init}[kind]
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return tcfg, jcfg, jp, _tensors(jp, torch.float32)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("form", list(_FORMS))
def test_mlstm_gradients_match_reference(form, backend, monkeypatch):
    """``mlstm_block`` under autograd, the parallel form and the chunkwise
    one: dx and every leaf's gradient (``w_if`` through its fp32 product,
    the stabilisers ``m``, ``m_t``, ``m_state`` differentiated as the
    reference's) against ``jax.value_and_grad`` at 1e-4 x max(1,
    max|ref|)."""
    s, chunk = _FORMS[form]
    _chunk(monkeypatch, chunk)
    tcfg, jcfg, jp, tp = _mixer("mlstm", seed=1)
    x, cot = _inputs((2, s, tcfg.d_model), 2)
    want = mixer_grads_ref(("mlstm", s), jxlstm.mlstm_block, jcfg, jp,
                           jnp.asarray(x), jnp.asarray(cot))
    got = mixer_grads(xlstm.mlstm_block, tcfg, tp, torch.from_numpy(x),
                      torch.from_numpy(cot), backend)
    hold_grads(got, want, f"mlstm {form} {backend}")


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_slstm_gradients_match_reference(backend):
    """The sLSTM's loop over time under autograd (the recurrent product
    once a step) against the reference's ``lax.scan``, dx and every
    leaf."""
    tcfg, jcfg, jp, tp = _mixer("slstm", seed=3)
    x, cot = _inputs((2, 16, tcfg.d_model), 4)
    want = mixer_grads_ref(("slstm",), jxlstm.slstm_block, jcfg, jp,
                           jnp.asarray(x), jnp.asarray(cot))
    got = mixer_grads(xlstm.slstm_block, tcfg, tp, torch.from_numpy(x),
                      torch.from_numpy(cot), backend)
    hold_grads(got, want, f"slstm {backend}")


def test_slstm_sums_its_recurrent_gradient_in_fp32(monkeypatch):
    """One fp32 copy of ``r_gates`` a call: every step's recurrent product
    takes the same tensor, so autograd sums the steps' gradients in fp32
    and casts the sum to bf16 once.  The bf16 gradient of ``r_gates`` is
    bitwise that cast of the fp32 sum of the steps' dB products."""
    tcfg = configs.get_reduced(_ARCH)
    p = xlstm.slstm_init(torch.Generator().manual_seed(5), tcfg,
                         torch.bfloat16, "cpu")
    p = {k: v.requires_grad_() for k, v in p.items()}
    x = torch.randn(2, 6, tcfg.d_model,
                    generator=torch.Generator().manual_seed(6)).bfloat16()
    seen, orig = [], layers.linear

    def rec(a, w, backend="kernels"):
        if w.dtype == torch.float32:
            seen.append((w, a))
        return orig(a, w, backend)

    monkeypatch.setattr(xlstm, "linear", rec)
    y = xlstm.slstm_block(p, x, tcfg)[0]
    r32 = seen[0][0]
    assert len(seen) == 6 and all(w is r32 for w, _ in seen)
    steps_db = []
    r32.register_hook(lambda g: steps_db.append(g))
    (g,) = torch.autograd.grad(y.float().sum(), [p["r_gates"]])
    assert g.dtype == torch.bfloat16 and len(steps_db) == 1
    assert steps_db[0].dtype == torch.float32
    assert torch.equal(g, steps_db[0].to(torch.bfloat16))


# ------------------------------------------- kernel 3's backward shapes ---

# (what, M, K, N, dtype) of a forward product whose dA and dB the recurrent
# training path runs at new shapes, K and N cut where the CPU would be slow
# (the card holds the published widths, chip_smoke.py phase 32a)
_BACKWARD = [
    ("sLSTM recurrent product, batch 1", 1, 64, 256, "fp32"),
    ("sLSTM recurrent product, batch 4", 4, 64, 256, "fp32"),
    ("mLSTM w_if", 96, 128, 8, "fp32"),
    ("sLSTM ff_up, 2730 wide", 64, 96, 2730, "bf16"),
    ("sLSTM ff_down, 2730 deep", 64, 2730, 96, "bf16"),
]


@pytest.mark.parametrize("case", _BACKWARD, ids=[c[0] for c in _BACKWARD])
def test_matmul_fn_backward_shapes_match_jax(case):
    """``MatmulFn``'s dA and dB at the recurrent training path's shapes
    (dB of the sLSTM's recurrent product contracts over K = the batch, 1-4;
    ``w_if``'s dA over K = 8) against ``jax.grad``, each gradient in its
    operand's dtype."""
    _, m, k, n, dt = case
    rng = np.random.default_rng(m * k + n)
    a, b, cot = (rng.standard_normal(s).astype(np.float32)
                 for s in ((m, k), (k, n), (m, n)))
    b /= np.sqrt(k)
    jga, jgb = jax.grad(
        lambda x, w: jnp.sum((x @ w).astype(jnp.float32) * cot),
        argnums=(0, 1))(jnp.asarray(a, _JDT[dt]), jnp.asarray(b, _JDT[dt]))
    ta, tb = (torch.from_numpy(t).to(_TDT[dt]).requires_grad_()
              for t in (a, b))
    ga, gb = torch.autograd.grad(kmm.MatmulFn.apply(ta, tb), (ta, tb),
                                 torch.from_numpy(cot).to(_TDT[dt]))
    assert ga.dtype == gb.dtype == _TDT[dt]
    bar = _GRAD_BAR if dt == "fp32" else 2e-2
    _close(ga, jga, bar, what="dA")
    _close(gb, jgb, bar, what="dB")


# ------------------------------------------------------ the reduced model ---

def _both_params(dtype="fp32", seed=0, **kw):
    tcfg = configs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype], **kw)
    jcfg = jconfigs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype],
                                               **kw)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = transformer.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    return tcfg, jcfg, jp, tp


def batch_np(vocab, rows, seq, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1),
                                                dtype=np.int32)
    mask = np.ones((rows, seq), np.float32)
    mask[0, :3] = 0.0   # a masked-out prefix: the loss is a masked mean
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            b.items()}


def _jloss(jcfg):
    def loss(p, mb):
        hidden = jtr.forward(p, mb["tokens"], jcfg, return_hidden=True)
        return jlayers.chunked_softmax_ce(hidden, jtr.lm_head(p, jcfg),
                                          mb["labels"], mb["mask"])
    return loss


def reference_value_and_grad(key, jp, jcfg, b, microbatches):
    """The reference train step's loss and gradients (its
    ``make_train_step``'s body: the jitted ``jax.value_and_grad`` of its
    loss per microbatch, summed in the accumulator's dtype, divided), as
    flat numpy by the port's names; and the rounding the accumulation may
    add to each entry: with bf16 sums over 2 or more microbatches, 2^-7 of
    the mean |g| over the microbatches (a bf16 rounding of each term and
    of the sum), else 0."""
    vg = _jitted(key, lambda: jax.value_and_grad(_jloss(jcfg)))
    bf16 = jcfg.opt_memory_mode == "bf16"
    size = b["tokens"].shape[0] // microbatches
    loss, gsum, gabs = 0.0, None, None
    for i in range(microbatches):
        lv, g = vg(jp, {k: jnp.asarray(v[i * size:(i + 1) * size])
                        for k, v in b.items()})
        g = _flat(jax.tree.map(np.asarray, g))
        a = {k: np.abs(v.astype(np.float32)) for k, v in g.items()}
        gabs = a if gabs is None else {k: gabs[k] + a[k] for k in a}
        if microbatches > 1:    # the accumulator's dtype; numpy's bf16
            g = {k: v.astype(jnp.bfloat16 if bf16 else np.float32)
                 for k, v in g.items()}    # ops round as XLA's do
        gsum = g if gsum is None else {k: gsum[k] + g[k] for k in g}
        loss = loss + float(lv)
    grads = {k: (v.astype(np.float32) / microbatches).astype(v.dtype)
             for k, v in gsum.items()}
    rounding = {k: (2.0 ** -7 * v / microbatches
                    if bf16 and microbatches > 1 else 0 * v)
                for k, v in gabs.items()}
    return loss / microbatches, grads, rounding


def hold_value_and_grad(tcfg, tp, b, microbatches, want, backends):
    """Loss at 1e-5; each gradient at 1e-4 x max(1, max|ref|) plus the
    accumulation's rounding (``reference_value_and_grad``)."""
    jl, jg, rounding = want
    for backend in backends:
        vg = steps.make_value_and_grad(tcfg, microbatches=microbatches,
                                       backend=backend)
        loss, grads = vg(tp, torch_batch(b))
        assert abs(float(loss) - jl) <= _VALUE_BAR * abs(jl), backend
        assert grads.keys() == jg.keys()
        for k, g in grads.items():
            assert str(g.dtype).removeprefix("torch.") == str(jg[k].dtype)
            err = np.abs(_np(g) - _np(jg[k]))
            bar = _GRAD_BAR * max(1.0, float(np.abs(_np(jg[k])).max()))
            assert np.isfinite(err).all() and (
                err <= bar + rounding[k]).all(), (backend, k, err.max())


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_value_and_grad_matches_reference(microbatches, mode, monkeypatch):
    """``make_value_and_grad`` over the reduced xLSTM in fp32 (the mLSTM's
    chunkwise form, 4 chunks; the sLSTM loop) on both backends against
    the reference's loss and gradients, every leaf at 1e-4 x max(1,
    max|ref|): the fp32 ``w_if``, the stacked leaves, the untied head, and
    ``norm2``, which the loss does not reach (no FFN, d_ff 0): zeros on
    both sides.  With ``opt_memory_mode="bf16"`` two microbatches'
    gradients are summed in bf16 on both sides: each entry within that
    sum's rounding more."""
    _chunk(monkeypatch, _M_CHUNK)
    tcfg, jcfg, jp, tp = _both_params(opt_memory_mode=mode)
    b = batch_np(tcfg.vocab, 2 * microbatches, _SEQ, seed=7)
    want = reference_value_and_grad((_ARCH, "vg"), jp, jcfg, b,
                                    microbatches)
    assert not want[1]["blocks.0.norm2"].any()
    if mode == "bf16" and microbatches == 2:
        assert want[1]["blocks.0.mixer.wq"].dtype == jnp.bfloat16
    hold_value_and_grad(tcfg, tp, b, microbatches, want,
                        ("kernels", "torch"))


def _opt_leaves(state):
    out = {"step": state.step}
    for part in ("master", "mu", "nu"):
        tree = getattr(state, part)
        if tree is not None:
            out.update({f"{part}.{k}": v for k, v in _flat(tree).items()})
    return out


def hold_new_param(got, want, grad, rounding, lr, clip, what):
    """A new parameter (or master) after one AdamW step against the
    reference's at 1e-5 x max(1, max|ref|), but for the entries whose
    update the gradient bar leaves open.  The first step moves an entry by
    lr g / (|g| + eps) of the clipped gradient g = ``clip`` x the
    gradient, whose slope is lr eps / (|g| + eps)^2: an entry is open
    where a gradient within the bar, 1e-4 x max|g| of its leaf, could move
    it past the parameter bar that way, or where it lies
    within the bf16 accumulation's ``rounding`` of 0 (there an exact 0 is
    open too; else an exact 0 is not).  Open entries are held at 2 lr +
    1e-5 x max(1, max|ref|), the whole update either way.  Returns their
    count."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    g = clip * np.abs(np.asarray(grad, np.float32)).astype(np.float64)
    slope = lr * _ADAM_EPS / (g + _ADAM_EPS) ** 2
    open_ = (g < clip * rounding) | ((g > 0) & (
        slope * _GRAD_BAR * g.max(initial=0.0) > _PARAM_BAR * scale))
    err = np.abs(got - want)
    assert err[~open_].max(initial=0.0) <= _PARAM_BAR * scale, (
        what, err[~open_].max(), _PARAM_BAR * scale)
    assert err.max() <= 2 * lr + _PARAM_BAR * scale, (what, err.max())
    return int(open_.sum())


def reference_step(key, jcfg, jp, b, microbatches, mode):
    """One reference train step from ``jp`` and a fresh AdamW state in
    ``mode``, its ``make_train_step``'s body from its parts:
    ``reference_value_and_grad``'s loss and accumulated gradients, then
    ``cosine_schedule`` and ``adamw_update``, jitted.  (The whole jitted
    step compiles once for each microbatch count and mode: ~10 s each for
    the reduced Jamba on the CPU; the loss compiles once for all.)"""
    loss, flat, _ = reference_value_and_grad(key[:1] + ("vg",), jp, jcfg, b,
                                             microbatches)
    grads = jax.tree.map(jnp.asarray, transformer.unflatten_params(flat, jp))

    def update(g, o, p):
        lr = jcosine(o.step, 2, 10, 3e-4)
        new_p, new_o, gnorm = jadamw_update(g, o, p, lr=lr)
        return new_p, new_o, {"grad_norm": gnorm, "lr": lr}

    jp1, jo1, jm = _jitted(key[:1] + ("adamw", mode), lambda: update)(
        grads, jadamw_init(jp, memory_mode=mode), jp)
    return jp1, jo1, {**jm, "loss": loss}


def hold_train_step(tcfg, jcfg, jp, tp, b, microbatches, mode, key,
                    backends=("kernels", "torch")):
    """One ``make_train_step`` step (the reduced model in fp32, AdamW in
    ``mode``) on ``backends`` against the reference's
    (``reference_step``) from the same state and batch: loss at 1e-5,
    gradient norm at 1e-4, lr, every new parameter and master as
    ``hold_new_param`` holds it, moments at relative L2 1e-4 (fp32) or
    1e-2 (bf16: one bf16 rounding apart)."""
    jp1, jo1, jm = reference_step(key, jcfg, jp, b, microbatches, mode)
    jflat = _flat(jax.tree.map(np.asarray, jp1))
    _, jg, rounding = reference_value_and_grad(key[:1] + ("vg",), jp, jcfg,
                                               b, microbatches)
    lr, steep = float(jm["lr"]), 0
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))    # AdamW's clip_norm 1
    jopt = _opt_leaves(jax.tree.map(np.asarray, jo1))
    for backend in backends:
        step = steps.make_train_step(tcfg, warmup=2, total_steps=10,
                                     microbatches=microbatches,
                                     backend=backend)
        tp1, to1, m = step(tp, adamw_init(_flat(tp), memory_mode=mode),
                           torch_batch(b))
        for k, bar in (("loss", _VALUE_BAR), ("grad_norm", _GRAD_BAR),
                       ("lr", 1e-6)):
            g, w = float(m[k]), float(jm[k])
            assert abs(g - w) <= bar * abs(w), (backend, k, g, w)
        for k, t in _flat(tp1).items():
            assert str(t.dtype).removeprefix("torch.") == str(
                jflat[k].dtype), k
            steep += hold_new_param(t, jflat[k], jg[k], rounding[k], lr,
                                    clip, f"{backend} {k}")
        topt = _opt_leaves(to1)
        assert topt.keys() == jopt.keys()
        assert int(topt.pop("step")) == int(jopt["step"]) == 1
        assert (to1.master is None) == (mode == "bf16")
        for k, t in topt.items():
            if k.startswith("master."):
                name = k[len("master."):]
                steep += hold_new_param(t, jopt[k], jg[name], rounding[name],
                                        lr, clip, f"{backend} {k}")
            else:
                assert t.dtype == _TDT[mode], k
                assert _rel_l2(t, jopt[k]) <= (
                    _GRAD_BAR if mode == "fp32" else 1e-2), (backend, k)
    total = sum(t.numel() for t in _flat(tp).values()) * len(backends)
    print(f"{key} {mode}: {steep} of {total} parameter entries whose "
          f"update's direction the arithmetic leaves open, held at 2 lr")
    assert steep <= 0.01 * total


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches, mode, monkeypatch):
    """The reduced xLSTM's ``make_train_step`` in fp32, 1 and 2
    microbatches of 2 rows, ``opt_memory_mode`` fp32 and bf16 (bf16
    moments, no master, gradients summed in bf16 across microbatches),
    against the reference's step composed from its jitted
    ``value_and_grad`` and AdamW (``reference_step``)."""
    _chunk(monkeypatch, _M_CHUNK)
    tcfg, jcfg, jp, tp = _both_params(opt_memory_mode=mode)
    b = batch_np(tcfg.vocab, 2 * microbatches, _SEQ, seed=8)
    hold_train_step(tcfg, jcfg, jp, tp, b, microbatches, mode,
                    (_ARCH, "step", microbatches, mode))


def test_forward_return_hidden_and_head_match_reference(monkeypatch):
    """``forward(return_hidden=True)`` and ``lm_head`` (untied) of the
    ``ssm`` family against the reference's, fp32, both backends."""
    _chunk(monkeypatch, _M_CHUNK)
    tcfg, jcfg, jp, tp = _both_params()
    toks = batch_np(tcfg.vocab, 2, _SEQ, seed=9)["tokens"]
    want = jtr.forward(jp, jnp.asarray(toks), jcfg, return_hidden=True)
    _close(transformer.lm_head(tp, tcfg), jtr.lm_head(jp, jcfg), 0.0)
    with torch.no_grad():
        for backend in ("kernels", "torch"):
            got = transformer.forward(tp, torch.from_numpy(toks), tcfg,
                                      backend=backend, return_hidden=True)
            assert got.shape == (2, _SEQ, tcfg.d_model)
            _close(got, want, _VALUE_BAR)


# ------------------------------------------------- bf16, layer by layer ---

def reference_layer_inputs(jp, jcfg, toks):
    """Each layer's input in the reference's jitted forward over ``toks``,
    in call order (an ordered ``jax.debug.callback`` in ``apply_layer``,
    which fires inside the traced superblock scan)."""
    seen, orig = [], jtr.apply_layer

    def rec(p, x, *args, **kw):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), x,
                           ordered=True)
        return orig(p, x, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "apply_layer", rec)
        jax.block_until_ready(jax.jit(lambda p, t: jtr.forward(p, t, jcfg))(
            jp, jnp.asarray(toks)))
        jax.effects_barrier()
    return seen


def hold_layer_vjps(tcfg, jcfg, jp, tp, toks, topk=None, force=None):
    """Each layer of the bf16 model, fed the reference's input to it in its
    jitted forward (``reference_layer_inputs``), differentiated on a seeded
    cotangent: the reference's jitted VJP (``_rounded``: each bf16 operation
    rounded, as op by op), the port's on both backends, and
    the port's fp32 VJP of the same bf16 weights (fp32 holds the reference
    at 1e-4).  Each port backend's gradients (dx and each leaf) no farther
    from the fp32 ones, in relative L2 pooled over the layer (their root
    mean square), than the reference's are, within ``_BF16_SLACK``, and
    each gradient alone within ``_LEAF_SLACK`` of the reference's
    distance (one gradient's distance rests on a few roundings of its
    layer's inputs: the two frameworks round them apart).  A MoE layer
    runs the port on the routes the reference's VJP took (``topk``: the
    list its ``lax.top_k`` reports into; ``force(routes)``: a context in
    which the port's ``moe.route`` takes them).  Returns the worst
    ratio."""
    s = toks.shape[1]
    xs = reference_layer_inputs(jp, jcfg, toks)
    t32 = tcfg.replace(dtype="float32")
    positions = torch.arange(s).expand(toks.shape[0], s)
    jpos = jnp.broadcast_to(jnp.arange(s)[None], toks.shape)
    worst = 0.0
    order = list(transformer.layer_params(tp, tcfg))
    assert len(xs) == len(order)
    for i, ((pi, r, kind, fk, p), x) in enumerate(zip(order, xs)):
        jlp = jax.tree.map(lambda a: a[r], jp["blocks"][pi])
        cot = np.random.default_rng(100 + i).standard_normal(
            x.shape).astype(np.float32)

        def jvjp(q, xx, c, kind=kind, fk=fk):
            return jax.vjp(lambda q_, x_: jtr.apply_layer(
                q_, x_, jcfg, kind, fk, jpos)[0], q, xx)[1](c)

        if topk is not None:
            topk.clear()
        jgp, jgx = _rounded((tcfg.name, "layer vjp", s, kind, fk), jvjp,
                            jlp, jnp.asarray(x),
                            jnp.asarray(cot, jnp.bfloat16))
        jax.effects_barrier()
        routes = list(topk) if fk == "moe" else None
        want = {"x": np.asarray(jgx), **{f"p.{k}": np.asarray(v) for k, v in
                                         _flat(jgp).items()}}

        def port(params, xx, cfg, backend):
            leaves = {k: v.detach().requires_grad_() for k, v in
                      _flat(params).items()}
            tx = xx.detach().requires_grad_()
            tree = transformer.unflatten_params(leaves, params)
            with (force(routes) if routes else _nothing()):
                y = transformer.apply_layer(tree, tx, cfg, kind, fk,
                                            positions, backend=backend)[0]
            gs = torch.autograd.grad(y, [tx, *leaves.values()],
                                     torch.from_numpy(cot).to(y.dtype),
                                     materialize_grads=True)
            return {"x": gs[0], **{f"p.{k}": g for k, g in
                                   zip(leaves, gs[1:])}}

        p32 = {k: v.float() for k, v in _flat(p).items()}
        base = port(transformer.unflatten_params(p32, p),
                    _tensor(x).float(), t32, "kernels")
        for backend in ("kernels", "torch"):
            got = port(p, _tensor(x), tcfg, backend)
            assert got.keys() == want.keys() == base.keys()
            d = np.array([(_rel_l2(got[k], base[k]), _rel_l2(want[k], base[k]))
                          for k in want])
            assert all(np.isfinite(_np(g)).all() for g in got.values()), i
            # the layer's gradients pooled: the root mean square of their
            # relative L2 distances from the fp32 ones
            rms = np.sqrt((d ** 2).mean(axis=0))
            assert rms[0] <= _BF16_SLACK * rms[1], (i, kind, backend, rms)
            # each gradient alone, within twice the reference's distance
            k_bad = [(k, *d[j]) for j, k in enumerate(want)
                     if d[j, 0] > _LEAF_SLACK * d[j, 1] + 1e-7]
            assert not k_bad, (i, kind, backend, k_bad)
            worst = max(worst, rms[0] / rms[1])
    return worst


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_xlstm_bf16_layer_vjps_match_reference(monkeypatch):
    """The reduced xLSTM in bf16, layer by layer from the reference's
    inputs (``hold_layer_vjps``): the mLSTM's chunkwise form (S = 32,
    chunks of 8: the training form at 4,096 tokens), the sLSTM loop."""
    form = "chunkwise"
    s, chunk = _FORMS[form]
    _chunk(monkeypatch, chunk)
    tcfg, jcfg, jp, tp = _both_params("bf16")
    toks = batch_np(tcfg.vocab, 2, s, seed=10)["tokens"]
    worst = hold_layer_vjps(tcfg, jcfg, jp, tp, toks)
    print(f"{form}: worst bf16 gradient distance, port / reference's "
          f"{worst:.3f}")


# ------------------------------------------------- remat, launches, loop ---

@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_remat_on_and_off_give_the_same_gradients(backend, monkeypatch):
    """Per-layer remat recomputes each recurrent layer (the sLSTM loop, the
    chunkwise mLSTM) as it ran: the loss and every gradient bit for bit
    the same without it."""
    _chunk(monkeypatch, _M_CHUNK)
    tcfg, _, _, tp = _both_params("bf16")
    batch = torch_batch(batch_np(tcfg.vocab, 4, _SEQ, seed=11))
    out = {}
    for remat in (False, True):
        vg = steps.make_value_and_grad(tcfg.replace(remat=remat),
                                       microbatches=2, backend=backend)
        out[remat] = vg(tp, batch)
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1) and g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.fixture
def plain_counts(monkeypatch):
    """Count kernel 3's plain dispatches, 2-D and batched, and kernel 4's
    (the kernels' plain versions stand in for them on the CPU)."""
    counts = {"matmul": 0, "matmul_batched": 0, "flash_attention": 0}
    mm, bmm, fa = (kmm.matmul_plain, kmm.matmul_batched_plain,
                   kfa.attention_plain)

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


def hold_dispatch_counts(cfg, seq, microbatches, plain_counts):
    """One ``make_train_step`` step's dispatches, in all and by part as
    ``Smoke.counting_parts`` splits them, against ``chip_smoke.
    lm_train_split``; the transposes one a backward product.  Returns the
    split."""
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    step = steps.make_train_step(cfg, warmup=2, total_steps=10,
                                 microbatches=microbatches)
    smoke = chip_smoke.Smoke.__new__(chip_smoke.Smoke)
    smoke.torch, smoke.kmm, smoke.kfa = torch, kmm, kfa
    parts = {}
    before = kmm.MatmulFn.transposes
    with smoke.counting_parts(parts, lambda: dict(plain_counts)):
        step(params, adamw_init(_flat(params)),
             torch_batch(batch_np(cfg.vocab, 4, seq)))
    want = chip_smoke.lm_train_split(cfg, seq, microbatches)
    assert parts == want
    assert kmm.MatmulFn.transposes - before == (
        want["matmul"]["backward"] + want["matmul_batched"]["backward"])
    return want


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_dispatch_counts(remat, plain_counts, monkeypatch):
    """A step's kernel-3 dispatches over the reduced xLSTM (seq 32, 2
    microbatches): the sLSTM's recurrent product once a step forward (and
    again in the remat recompute), its dA and dB but no dA at the first
    step (h is the zero state); and by part and variant as
    ``train_variants`` of ``recurrent_train_launches`` works them out."""
    _chunk(monkeypatch, _M_CHUNK)
    cfg = configs.get_reduced(_ARCH).replace(remat=remat)
    want = hold_dispatch_counts(cfg, _SEQ, 2, plain_counts)
    by_variant = chip_smoke.train_variants(
        chip_smoke.recurrent_train_launches(cfg, _SEQ, 2))
    assert {p: 2 * sum(v.values()) for p, v in by_variant.items()} == \
        want["matmul"]
    slstm = cfg.repeat
    assert want["matmul"]["backward"] == 2 * want["matmul"]["forward"] \
        - 2 * slstm


def test_phase_32_launch_oracle_at_full_width():
    """Phase 32b's counts: xLSTM-1.3B at one pattern period (an mLSTM and
    an sLSTM layer), 1 x 4096 tokens, remat on: the mLSTM's 6 products,
    the sLSTM's 3 + 4096, 8 CE chunks of the head; by variant, the fp32
    products (``w_if``, the recurrent one, their dA and dB) and the
    2730-wide FFN's on ``simt``."""
    cfg = configs.get_config(_ARCH).replace(num_layers=2)
    assert cfg.remat and cfg.opt_memory_mode == "fp32"
    got = chip_smoke.lm_train_launches(cfg, 4096, 1)
    fwd = 6 + 3 + 4096 + 8
    assert got["matmul"] == {"forward": fwd, "recompute": fwd,
                             "backward": 2 * fwd - 1}
    var = chip_smoke.train_variants(
        chip_smoke.recurrent_train_launches(cfg, 4096, 1))
    assert {p: sum(v.values()) for p, v in var.items()} == got["matmul"]
    # forward: w_if, ff_up, ff_down and 4096 recurrent steps on simt
    assert var["forward"] == {"wgmma": 14, "simt": 4099}
    # backward: w_if's two, ff_up's dA (K 2730) and dB (N 2730), ff_down's
    # dA (N 2730), the recurrent steps' 8191
    assert var["backward"]["simt"] == 2 + 2 + 1 + 8191


_LOOP = dict(steps=4, global_batch=4, seq_len=_SEQ, microbatches=2,
             ckpt_every=2, device="cpu", log_every=10)


def final_state(d, cfg):
    return tckpt.restore_checkpoint(d, tckpt.latest_step(d),
                                    train.init_state(cfg, None, "meta"))


def hold_resume(cfg, tmp_path):
    """``launch.train.train``: a failure injected at step 3 restores the
    step-2 checkpoint and replays, ending on the uninterrupted run's state
    bit for bit (parameters, masters and moments)."""
    clean = train.train(cfg, ckpt_dir=str(tmp_path / "a"), **_LOOP)
    hit = train.train(cfg, ckpt_dir=str(tmp_path / "b"),
                      injector=FailureInjector({3}), **_LOOP)
    assert clean["recoveries"] == 0 and hit["recoveries"] == 1
    assert clean["final_step"] == hit["final_step"] == 4
    assert hit["loss"] == clean["loss"] and np.isfinite(hit["loss"])
    a = final_state(str(tmp_path / "a"), cfg)
    bb = final_state(str(tmp_path / "b"), cfg)
    for part_a, part_b in ((a[0], bb[0]), *(
            (getattr(a[1], n), getattr(bb[1], n))
            for n in ("master", "mu", "nu") if getattr(a[1], n))):
        fa, fb = _flat(part_a), _flat(part_b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k


def test_train_resumes_bit_for_bit_after_an_injected_fault(tmp_path,
                                                           monkeypatch):
    _chunk(monkeypatch, _M_CHUNK)
    hold_resume(configs.get_reduced(_ARCH), tmp_path)


def test_train_cli_on_the_cpu(capsys, monkeypatch):
    _chunk(monkeypatch, _M_CHUNK)
    train.main(["--arch", _ARCH, "--reduced", "--steps", "2", "--batch",
                "2", "--seq", str(_SEQ), "--microbatches", "2", "--device",
                "cpu"])
    out = capsys.readouterr().out
    assert "[train] step=1" in out and "'final_step': 2" in out
