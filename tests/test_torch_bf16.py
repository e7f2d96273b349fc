"""The bf16 slice of the port (``repro_torch``) against the JAX reference.

Each test feeds the same numpy-seeded inputs through the reference's xla
path with ``compute_dtype="bf16"`` and through the port, whose kernel
wrappers run their plain versions here on the CPU (the same fp32
accumulation and single rounding as the CUDA kernels, which
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold to them on the
card).  The bars, and why:

* epilogue-free conv outputs, per element:
  ``|port - ref| <= 2^-7 |ref| + 1e-5 max(1, max|ref|)``.  Both sides
  compute in fp32 (in another summation order: the 1e-5 term) and round
  once to bf16, where two nearly equal sums may land one bf16 step, at most
  2^-7 of the value, apart.
* fused-epilogue outputs: the reference's cross-backend bar
  ``max|port - ref| <= 0.02 max|ref| + 1e-3``
  (``tests/test_mixed_precision.py``).  The xla path rounds the conv
  output to bf16, applies the fp32 epilogue and rounds again; the kernels
  round once.  The port's torch backend rounds twice like the xla path; a
  residual that cancels the conv output can turn one step of summation
  order into more than 2^-7 of the result, so it too is held at the
  cross-backend bar, and the test prints its measured worst.
* gradients of ``mean(out.float()**2)``, which land fp32 on the fp32
  masters: within 10% relative L2 of the fp32 gradients and of the
  reference's bf16 ones (DESIGN.md §12).
* ENet forward: within 5% of the output range (DESIGN.md §12) of its own
  fp32 logits, and at the cross-backend bar of the reference's bf16 ones;
  one train step's loss within 5% and gradient norm within 10%.
* AdamW's bf16 memory mode: within one bf16 step of the reference per
  element (both update in fp32 and round the moments to bf16; a fused
  multiply-add on one side may move a rounding by one step).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_enet import _perturb

from repro import optim as joptim
from repro.core.decompose import conv2d as jconv2d
from repro.kernels.epilogue import EpilogueSpec as JSpec
from repro.launch import train_recipes as jtr
from repro.models import enet as jenet
from repro_torch import optim as toptim
from repro_torch.core.decompose import conv2d
from repro_torch.data import SegDataPipeline
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.util import canon_dtype
from repro_torch.launch import train_recipes as ttr
from repro_torch.models.enet import ENet, flatten_tree

_ROOT = Path(__file__).resolve().parents[1]
BF16_STEP = 2.0 ** -7
FP32_TOL = 1e-5
XBACKEND_RTOL, XBACKEND_ATOL = 0.02, 1e-3
FWD_RTOL, GRAD_RTOL = 0.05, 0.10

#: (id, conv2d kwargs) of the engines: dense, strided dense, dilated d2 and
#: d3, transposed s2, s2 op1 and s3
ENGINES = (
    ("dense", dict()),
    ("dense-s2", dict(stride=2)),
    ("dilated-d2", dict(dilation=2)),
    ("dilated-d3", dict(dilation=3)),
    ("tconv-s2", dict(transposed=True, stride=2)),
    ("tconv-s2op1", dict(transposed=True, stride=2, output_padding=1)),
    ("tconv-s3", dict(transposed=True, stride=3)),
)
#: every epilogue spec; the first is bare
SPECS = [(b, p, r) for b in (False, True) for p in (False, True)
         for r in ("none", "pre_act", "post_act")]


def _arrays(seed, cin=8, cout=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 13, 11, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.3).astype(np.float32)
    return rng, x, w


def _ep_arrays(rng, spec, out_shape):
    cout = out_shape[-1]
    ops = {}
    if spec[0]:
        ops["scale"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        ops["shift"] = rng.normal(0, 0.1, cout).astype(np.float32)
    if spec[1]:
        ops["alpha"] = rng.uniform(0.1, 0.4, cout).astype(np.float32)
    if spec[2] != "none":
        ops["residual"] = rng.standard_normal(out_shape).astype(np.float32)
    return ops


def _per_element_worst(got, ref):
    """Worst |got - ref| over the per-element bf16 bar (<= 1 passes)."""
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    bar = BF16_STEP * np.abs(ref) + FP32_TOL * max(1.0, np.abs(ref).max())
    return float((np.abs(got - ref) / bar).max())


def _xbackend_worst(got, ref):
    """max|got - ref| over the cross-backend bar (<= 1 passes)."""
    bar = XBACKEND_RTOL * np.abs(ref).max() + XBACKEND_ATOL
    return float(np.abs(got.astype(np.float64) - ref).max() / bar)


def _f32(t):
    return t.detach().float().numpy()


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


# ------------------------------------------------------------ dtypes ------

def test_canon_dtype_aliases():
    assert canon_dtype(None) is None
    assert canon_dtype("bf16") is torch.bfloat16
    assert canon_dtype("bfloat16") is torch.bfloat16
    assert canon_dtype("BF16") is torch.bfloat16
    assert canon_dtype("fp32") is torch.float32
    assert canon_dtype(torch.bfloat16) is torch.bfloat16
    with pytest.raises(ValueError):
        canon_dtype("int7")
    with pytest.raises(NotImplementedError, match="fp16"):
        canon_dtype("fp16")


def test_plain_versions_round_once():
    """The bf16 plain versions are the fp32 computation of the widened
    operands, epilogue included, rounded once: bit for bit."""
    rng, x, w = _arrays(1)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    spec = EpilogueSpec(bn=True, prelu=True, residual="pre_act")
    pads = ((1, 1), (1, 1))
    ops = _ep_arrays(rng, (True, True, "pre_act"), (2, 13, 11, 12))
    eps = tuple(torch.from_numpy(ops[s]) for s in spec.slots)
    eps16 = eps[:-1] + (eps[-1].bfloat16(),)
    got = kconv.conv2d_plain(xb, wb, 1, pads, spec, eps16)
    want = kconv.conv2d_plain(xb.float(), wb.float(), 1, pads, spec,
                              eps[:-1] + (eps16[-1].float(),)).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    got = ktr.tconv_plain(xb, wb, 2, 1, 2, EpilogueSpec(), ())
    want = ktr.tconv_plain(xb.float(), wb.float(), 2, 1, 2,
                           EpilogueSpec(), ()).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_wrappers_refuse_mixed_dtypes():
    x = torch.zeros(1, 4, 4, 2, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 2, 2)
    with pytest.raises(NotImplementedError, match="fp32 only or bf16 only"):
        kconv.conv2d(x, w)
    with pytest.raises(NotImplementedError, match="fp16"):
        kconv.conv2d(x.half(), w.half())
    with pytest.raises(ValueError, match="residual must be"):
        kconv.conv2d(x, w.bfloat16(), epilogue=EpilogueSpec(
            residual="post_act"), residual=torch.zeros(1, 4, 4, 2))
    out = conv2d(x, w, compute_dtype="bf16")     # the dispatcher casts w
    assert out.dtype == torch.bfloat16


# ----------------------------------------------------------- engines ------

@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "bn%d.pr%d.%s" % s)
@pytest.mark.parametrize("kind,kw", ENGINES, ids=[k for k, _ in ENGINES])
def test_engine_bf16_matches_reference(kind, kw, spec):
    """bf16 in -> bf16 out on both backends, against the reference's xla
    path in bf16 (per element when bare, at the cross-backend bar when
    fused)."""
    rng, x, w = _arrays(len(kind) + 7 * SPECS.index(spec))
    bare = spec == SPECS[0]
    out_shape = np.asarray(jconv2d(jnp.asarray(x), jnp.asarray(w),
                                   backend="xla", **kw)).shape
    ops = _ep_arrays(rng, spec, out_shape)
    jspec, tspec = JSpec(*spec), EpilogueSpec(*spec)
    ref = np.asarray(jconv2d(
        jnp.asarray(x), jnp.asarray(w), backend="xla", compute_dtype="bf16",
        epilogue=None if bare else jspec,
        **{k: jnp.asarray(v) for k, v in ops.items()}, **kw))
    assert ref.dtype == jnp.bfloat16
    ref = ref.astype(np.float32)
    worst = {}
    for backend in ("kernels", "torch"):
        y = conv2d(torch.from_numpy(x), torch.from_numpy(w), backend=backend,
                   compute_dtype="bf16", epilogue=None if bare else tspec,
                   **{k: torch.from_numpy(v) for k, v in ops.items()}, **kw)
        assert y.dtype == torch.bfloat16 and y.shape == ref.shape
        got = _f32(y)
        assert np.isfinite(got).all()
        worst[backend] = (_per_element_worst(got, ref) if bare
                          else _xbackend_worst(got, ref))
    print(f"{kind} {tspec}: worst/bar {worst}")
    assert max(worst.values()) <= 1.0, worst


@pytest.mark.parametrize("fused", [False, True], ids=["bare", "fused"])
@pytest.mark.parametrize("kind,kw", ENGINES, ids=[k for k, _ in ENGINES])
def test_engine_bf16_grads(kind, kw, fused):
    """Gradients of mean(out.float()**2) through bf16 land fp32 on the
    masters, within 10% relative L2 of the fp32 gradients and of the
    reference's bf16 ones, on both backends."""
    rng, x, w = _arrays(100 + len(kind))
    spec = (True, True, "pre_act") if fused else (False, False, "none")
    out_shape = np.asarray(jconv2d(jnp.asarray(x), jnp.asarray(w),
                                   backend="xla", **kw)).shape
    ops = _ep_arrays(rng, spec, out_shape) if fused else {}
    names = ["x", "w", *ops]
    jspec = JSpec(*spec) if fused else None

    def jloss(x_, w_, *e):
        y = jconv2d(x_, w_, backend="xla", compute_dtype="bf16",
                    epilogue=jspec, **dict(zip(ops, e)), **kw)
        return jnp.mean(jnp.square(y.astype(jnp.float32)))

    jgrads = jax.grad(jloss, argnums=tuple(range(len(names))))(
        jnp.asarray(x), jnp.asarray(w), *(jnp.asarray(v) for v in ops.values()))
    jgrads = [np.asarray(g, np.float32) for g in jgrads]
    for backend in ("kernels", "torch"):
        grads = {}
        for cd in (None, "bf16"):
            prims = [torch.from_numpy(a).requires_grad_()
                     for a in (x, w, *ops.values())]
            y = conv2d(prims[0], prims[1], backend=backend, compute_dtype=cd,
                       epilogue=EpilogueSpec(*spec) if fused else None,
                       **dict(zip(ops, prims[2:])), **kw)
            loss = y.float().square().mean()
            grads[cd] = torch.autograd.grad(loss, prims)
        for name, g16, g32, gj in zip(names, grads["bf16"], grads[None],
                                      jgrads):
            assert g16.dtype == torch.float32, name
            assert torch.isfinite(g16).all(), name
            r32, rj = _rel_l2(_f32(g16), _f32(g32)), _rel_l2(_f32(g16), gj)
            print(f"{kind} {backend} d{name}: rel L2 vs fp32 {r32:.2e}, "
                  f"vs reference bf16 {rj:.2e}")
            assert r32 <= GRAD_RTOL and rj <= GRAD_RTOL, (name, r32, rj)


# ------------------------------------------------------------- plans ------

@pytest.mark.parametrize("cin,vec", [(3, 1), (4, 4), (8, 8), (16, 8),
                                     (19, 1), (6, 1), (12, 4), (128, 8)])
def test_bf16_copy_widths(cin, vec):
    """bf16 copies: 16 bytes when 8 channels divide Cin, 8 when 4 do, else
    one element by a plain load (cp.async has no 2-byte form)."""
    plan = kconv.conv_plan(cin, 16, 3, 3, 1, torch.bfloat16)
    assert plan.vec == vec and plan.dtype == torch.bfloat16
    assert plan.variant == (f"bf16-{'scalar' if vec == 1 else f'vec{vec}'}"
                            "-resident")
    assert plan.variant in kconv.VARIANTS
    assert ktr.tconv_plan(cin, 16, 3, torch.bfloat16).vec == vec
    # an input 8 bytes past a 16-byte boundary takes 8-byte copies at most
    assert kconv.copy_vec(cin, torch.bfloat16, 8) == min(vec, 4)


def test_bf16_slabs_count_two_bytes():
    """Residency counts the dtype's bytes: a 3x3 32->64 slab (288 K rows x
    64 couts) is 72 KB in fp32 and 36 KB in bf16, against 48 KB; a k5
    transposed chunk of 32 couts 50 KB and 25 KB."""
    assert not kconv.conv_plan(32, 64, 3, 3, 1).resident
    assert kconv.conv_plan(32, 64, 3, 3, 1, torch.bfloat16).resident
    assert not kconv.conv_plan(64, 64, 3, 3, 1, torch.bfloat16).resident
    assert not ktr.tconv_plan(16, 32, 5).resident
    assert ktr.tconv_plan(16, 32, 5, torch.bfloat16).resident
    assert not ktr.tconv_plan(16, 32, 7, torch.bfloat16).resident


def test_bf16_forward_dispatches_bf16_calls(monkeypatch):
    """An ENet bf16 forward sends every conv to the wrappers in bf16 (86
    dense, 3 transposed), with bf16 residuals and fp32 channel operands."""
    seen = []
    plain, tplain = kconv.conv2d_plain, ktr.tconv_plain

    def rec(fn):
        def wrapper(x, w, *rest):
            spec, eps = rest[-2], rest[-1]
            seen.append((x.dtype, w.dtype,
                         {s: e.dtype for s, e in zip(spec.slots, eps)}))
            return fn(x, w, *rest)
        return wrapper

    monkeypatch.setattr(kconv, "conv2d_plain", rec(plain))
    monkeypatch.setattr(ktr, "tconv_plain", rec(tplain))
    model = ENet(19, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = model(torch.zeros(1, 32, 32, 3), compute_dtype="bf16")
    assert y.dtype == torch.bfloat16
    assert len(seen) == 89
    for xd, wd, ops in seen:
        assert xd == wd == torch.bfloat16
        assert all(d == (torch.bfloat16 if s == "residual" else torch.float32)
                   for s, d in ops.items())
    # every bottleneck's expand carries its skip as a bf16 residual
    assert sum("residual" in ops for _, _, ops in seen) == 27
    assert all(p.dtype == torch.float32 for p in model.parameters())


# -------------------------------------------------------------- ENet ------

_HW, _CLASSES = 64, 19


@pytest.fixture(scope="module")
def tree():
    params = jenet.init_params(jax.random.PRNGKey(0), num_classes=_CLASSES)
    return _perturb(jax.tree_util.tree_map(np.asarray, params),
                    np.random.default_rng(0))


@pytest.fixture(scope="module")
def batch():
    return SegDataPipeline(1, hw=_HW, classes=_CLASSES, seed=3).batch_at(0)


def test_enet_bf16_forward(tree, batch):
    x = batch["image"]
    ref = np.asarray(jenet.forward(tree, jnp.asarray(x),
                                   compute_dtype="bf16"))
    assert ref.dtype == jnp.bfloat16
    ref = ref.astype(np.float32)
    model = ENet(_CLASSES, device="cpu", generator=torch.Generator())
    model.load_jax_params(tree)
    with torch.no_grad():
        y16 = model(torch.from_numpy(x), compute_dtype="bf16")
        y32 = model(torch.from_numpy(x))
    assert y16.dtype == torch.bfloat16 and y16.shape == (1, _HW, _HW,
                                                        _CLASSES)
    got, full = _f32(y16), _f32(y32)
    assert np.isfinite(got).all()
    vs_ref = _xbackend_worst(got, ref)
    vs_fp32 = float(np.abs(got - full).max()
                    / (FWD_RTOL * np.abs(full).max() + 1e-3))
    print(f"ENet bf16: vs reference bf16 {vs_ref:.3f} of its bar, vs own "
          f"fp32 {vs_fp32:.3f} of its bar")
    assert vs_ref <= 1.0 and vs_fp32 <= 1.0


@pytest.fixture(scope="module")
def steps(tree, batch):
    """One "enet" step from the same fp32 state: the port's in fp32 and in
    bf16, and the reference's in bf16."""
    tb = ttr.batch_to(batch, "cpu")
    out = {}
    for cd in (None, "bf16"):
        state = ttr.init_state(flatten_tree(tree))
        out[cd] = ttr.make_train_step("enet", compute_dtype=cd)(state, tb)
    jstate = jtr.init_state(tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jm = jtr.make_train_step("enet", compute_dtype="bf16")(jstate, jbatch)
    out["reference"] = {k: float(v) for k, v in jm.items()}
    return out


def test_enet_bf16_step_matches_fp32_and_reference(steps):
    (s16, m16), (s32, m32) = steps["bf16"], steps[None]
    jm = steps["reference"]
    for m in (m16, m32):
        assert m["skipped"].item() == 0.0
        assert m["scale"].item() == toptim.DynamicLossScale().init_scale
        assert np.isfinite(m["loss"].item())
    assert all(p.dtype == torch.float32 for p in s16.params.values())
    assert all(t.dtype == torch.float32 for t in s16.opt.mu.values())
    loss, gnorm = m16["loss"].item(), m16["grad_norm"].item()
    print(f"bf16 step: loss {loss:.6f} (fp32 {m32['loss'].item():.6f}, "
          f"reference bf16 {jm['loss']:.6f}); grad_norm {gnorm:.6f} (fp32 "
          f"{m32['grad_norm'].item():.6f}, reference bf16 "
          f"{jm['grad_norm']:.6f})")
    for want_loss, want_gnorm in ((m32["loss"].item(),
                                   m32["grad_norm"].item()),
                                  (jm["loss"], jm["grad_norm"])):
        assert abs(loss / want_loss - 1) <= FWD_RTOL
        assert abs(gnorm / want_gnorm - 1) <= GRAD_RTOL
    assert jm["skipped"] == 0.0


def test_enet_bf16_step_skips_nonfinite_batch(tree, batch):
    state = ttr.init_state(flatten_tree(tree))
    bad = ttr.batch_to(batch, "cpu")
    bad["image"][0, 3, 5, 1] = float("nan")
    after, m = ttr.make_train_step("enet", compute_dtype="bf16")(state, bad)
    assert m["skipped"].item() == 1.0 and m["grad_norm"].item() == 0.0
    assert m["scale"].item() == state.scale.scale.item() / 2
    for name in state.params:
        assert torch.equal(after.params[name], state.params[name]), name
        for part in ("master", "mu", "nu"):
            assert torch.equal(getattr(after.opt, part)[name],
                               getattr(state.opt, part)[name]), (part, name)
    assert torch.equal(after.opt.step, state.opt.step)


# ------------------------------------------------------------- AdamW ------

def _bf16_step_of(a):
    """The bf16 spacing at each element of ``a`` (the larger of the two
    neighbours' distances)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16().abs()
    up = torch.nextafter(t, torch.tensor(float("inf"), dtype=torch.bfloat16))
    return (up.float() - t.float()).numpy()


def test_adamw_bf16_memory_mode_matches_reference():
    rng = np.random.default_rng(5)
    params = {k: rng.standard_normal(shape).astype(np.float32)
              for k, shape in (("a", (7, 5)), ("b", (3,)), ("c", (2, 2, 4)))}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tstate = toptim.adamw_init(tparams, memory_mode="bf16")
    jstate = joptim.adamw_init(jparams, memory_mode="bf16")
    assert tstate.master is None and jstate.master is None
    assert all(m.dtype == torch.bfloat16 for m in tstate.mu.values())
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.3
                 for k, v in params.items()}
        tparams, tstate, tn = toptim.adamw_update(
            {k: torch.from_numpy(g) for k, g in grads.items()}, tstate,
            tparams, lr=1e-2, weight_decay=1e-4)
        jparams, jstate, jn = joptim.adamw_update(
            {k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams,
            lr=jnp.float32(1e-2), weight_decay=1e-4)
        assert abs(tn.item() - float(jn)) <= 1e-6 * float(jn)
        for k in params:
            for got, want in ((tparams[k], jparams[k]),
                              (tstate.mu[k], jstate.mu[k]),
                              (tstate.nu[k], jstate.nu[k])):
                assert got.dtype == {jnp.bfloat16: torch.bfloat16,
                                     jnp.float32: torch.float32}[
                                         jnp.dtype(want.dtype).type]
                want = np.asarray(want.astype(jnp.float32))
                err = np.abs(_f32(got) - want)
                assert (err <= _bf16_step_of(want)).all(), (step, k)
    assert tstate.master is None and int(tstate.step) == 3


# ------------------------------------------------------------ launch ------

def test_train_enet_bf16_smoke_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_enet", "--smoke",
         "--device", "cpu", "--dtype", "bf16"], env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    losses = [float(line.split()[3]) for line in r.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "pixel accuracy on held-out batch" in r.stdout
