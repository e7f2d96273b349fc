"""ENet training of the port (``repro_torch``) against the JAX reference.

ENet gradients on the perturbed tree of ``tests/test_torch_enet.py`` (the
reference zero-inits every closing BN scale, which would hide each
bottleneck's conv chain) against ``jax.grad`` of the reference's
``_seg_loss`` on its xla path, leaf by leaf at the reference's gradient
bar (rtol = atol = 1e-4), through both backends of the port; the optimizer,
schedule, loss scaler and data pipeline against ``repro.optim`` and
``repro.data``; three train steps against
``repro.launch.train_recipes.make_train_step`` (losses within relative
1e-4); the branchless skip of a NaN batch, bit for bit; and the CPU drive
of ``python -m repro_torch.launch.train_enet``.
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
from numpy.testing import assert_allclose
from test_torch_enet import _perturb

from repro import optim as joptim
from repro.data import SegDataPipeline as JSegDataPipeline
from repro.launch import train_recipes as jtr
from repro.models import enet as jenet
from repro_torch import optim as toptim
from repro_torch.data import SegDataPipeline
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.launch import train_recipes as ttr
from repro_torch.models.enet import ENet, flatten_tree

_ROOT = Path(__file__).resolve().parents[1]
_CLASSES, _HW = 5, 64
_TOL = 1e-4


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def tree():
    params = jenet.init_params(jax.random.PRNGKey(0), num_classes=_CLASSES)
    return _perturb(jax.tree_util.tree_map(np.asarray, params),
                    np.random.default_rng(0))


@pytest.fixture(scope="module")
def pipe():
    return SegDataPipeline(1, hw=_HW, classes=_CLASSES)


@pytest.fixture(scope="module")
def ref_grads(tree, pipe):
    batch = _jbatch(pipe.batch_at(0))
    loss = jtr._loss_fn("enet", backend="xla", decomposed=True,
                        interpret=None, compute_dtype=None)
    value, grads = jax.value_and_grad(loss)(tree, batch)
    return float(value), flatten_tree(
        jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_enet_grads_match_reference(tree, pipe, ref_grads, backend):
    value, grads = ttr.loss_and_grads(
        ttr.loss_fn("enet", backend=backend),
        ttr.init_state(flatten_tree(tree)).params,
        ttr.batch_to(pipe.batch_at(0), "cpu"))
    want_value, want = ref_grads
    assert set(grads) == set(want)
    assert abs(value.item() - want_value) <= _TOL * abs(want_value)
    for name, g in grads.items():
        assert g.shape == want[name].shape, name
        assert_allclose(g.numpy(), want[name], rtol=_TOL, atol=_TOL,
                        err_msg=name)


def test_backward_dispatch_counts(monkeypatch, tree):
    """A step's forward sends 86 convs to the dense kernel's wrapper and 3
    to the transposed one's; its backward 165 and 4: the 79 fused convs
    and 2 fused upsamplers recomputed without their epilogue, 86 dense dx
    (75 square stride-1 through the transposed wrapper, which routes them
    to the dense one; 8 rectangular; the 3 transposed convs' dx) and the
    2 k2 s2 downsample reduces' dx on the transposed kernel.  The stem's
    dx is skipped.  ``chip_smoke.py`` pins the same counts as launches."""
    counts = {"conv2d": 0, "tconv": 0}

    def counting(key, fn):
        def wrapper(*args):
            counts[key] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(kconv, "conv2d_plain",
                        counting("conv2d", kconv.conv2d_plain))
    monkeypatch.setattr(ktr, "tconv_plain", counting("tconv", ktr.tconv_plain))
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in flatten_tree(tree).items()}
    x = torch.randn(1, 16, 16, 3)
    loss = ttr.model_forward("enet")(params, x).square().mean()
    assert counts == {"conv2d": 86, "tconv": 3}
    torch.autograd.grad(loss, list(params.values()))
    assert counts == {"conv2d": 86 + 165, "tconv": 3 + 4}


def test_fold_bn_grads_match_reference():
    """``fold_bn`` differentiates in every operand, with and without fixed
    statistics, as ``repro.models.common.fold_bn`` does."""
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon

    rng = np.random.default_rng(4)
    g, b, mu = (rng.standard_normal(6).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    wts = rng.standard_normal((2, 6)).astype(np.float32)

    def jloss(g_, b_, mu_, var_):
        scale, shift = jcommon.fold_bn({"g": g_, "b": b_}, mu_, var_)
        return jnp.sum(wts[0] * scale + wts[1] * jnp.sin(shift))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(g, b, mu, var)
    prims = [torch.tensor(v, requires_grad=True) for v in (g, b, mu, var)]
    scale, shift = tcommon.fold_bn({"g": prims[0], "b": prims[1]}, *prims[2:])
    got = torch.autograd.grad(
        (torch.from_numpy(wts[0]) * scale
         + torch.from_numpy(wts[1]) * torch.sin(shift)).sum(), prims)
    for a, w in zip(got, want):
        assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    scale, shift = tcommon.fold_bn({"g": prims[0], "b": prims[1]})
    assert scale is prims[0] and shift is prims[1]


# ----------------------------------------------------------- optim pieces

def _leaves(rng, scale=1.0):
    shapes = {"a.w": (3, 3, 2, 4), "a.bn.g": (4,), "b": (1,), "c.d": (5, 2)}
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("gscale", [0.01, 10.0])
def test_adamw_update_matches_reference(gscale):
    rng = np.random.default_rng(int(gscale * 100))
    params = _leaves(rng)
    jstate = joptim.adamw_init({k: jnp.asarray(v) for k, v in params.items()})
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = toptim.adamw_init(tparams)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for step in range(3):
        grads = _leaves(rng, gscale)
        jparams, jstate, jn = joptim.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams,
            lr=jnp.float32(1e-2), weight_decay=0.1)
        tparams, tstate, tn = toptim.adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, tstate,
            tparams, lr=torch.tensor(1e-2), weight_decay=0.1)
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert_allclose(tn.item(), float(jn), rtol=1e-6)
        for k in params:
            for got, want in ((tparams[k], jparams[k]),
                              (tstate.mu[k], jstate.mu[k]),
                              (tstate.nu[k], jstate.nu[k]),
                              (tstate.master[k], jstate.master[k])):
                assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                atol=1e-7, err_msg=k)


def test_adamw_bf16_memory_mode_waits_for_its_slice():
    # the bf16 slice has landed: the mode keeps bf16 moments and no master
    # (tests/test_torch_bf16.py holds its updates to the reference)
    state = toptim.adamw_init({"w": torch.zeros(2)}, memory_mode="bf16")
    assert state.master is None and state.mu["w"].dtype == torch.bfloat16
    assert state.nu["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="memory_mode"):
        toptim.adamw_init({"w": torch.zeros(2)}, memory_mode="fp8")


def test_schedules_match_reference():
    for step in range(0, 40, 3):
        assert_allclose(
            toptim.cosine_schedule(step, 5, 30, 1e-3).item(),
            float(joptim.cosine_schedule(jnp.int32(step), 5, 30, 1e-3)),
            rtol=1e-6)
        assert_allclose(
            toptim.linear_warmup(torch.tensor(step), 7, 2e-3).item(),
            float(joptim.linear_warmup(jnp.int32(step), 7, 2e-3)),
            rtol=1e-6)


def test_loss_scale_transitions_match_reference():
    kw = dict(init_scale=8.0, growth_interval=3, min_scale=1.0,
              max_scale=64.0)
    js, ts = joptim.DynamicLossScale(**kw), toptim.DynamicLossScale(**kw)
    jst, tst = js.init(), ts.init()
    for finite in (True, True, True, False, True, False, False, False,
                   False, True, True, True, True, True, True, True, True):
        jst = js.update(jst, jnp.asarray(finite))
        tst = ts.update(tst, torch.tensor(finite))
        assert tst.scale.item() == float(jst.scale)
        assert tst.good_steps.item() == int(jst.good_steps)
        assert tst.scale.dtype == torch.float32
        assert tst.good_steps.dtype == torch.int32
    grads = _leaves(np.random.default_rng(1))
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    assert_allclose(ts.scale(tst, torch.tensor(1.5)).item(),
                    float(js.scale(jst, jnp.float32(1.5))))
    for k, v in ts.unscale(tst, tg).items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(js.unscale(jst, jg)[k]))
    assert bool(ts.all_finite(tg)) and bool(js.all_finite(jg))
    for bad in (np.inf, np.nan):
        tg["c.d"][0, 0] = bad
        jg["c.d"] = jg["c.d"].at[0, 0].set(bad)
        assert not bool(ts.all_finite(tg)) and not bool(js.all_finite(jg))
    assert bool(ts.all_finite({}))


def test_select_tree_matches_reference():
    rng = np.random.default_rng(2)
    a, b = _leaves(rng), _leaves(rng)
    ta = toptim.AdamWState(torch.tensor(3, dtype=torch.int32), None,
                           {k: torch.from_numpy(v) for k, v in a.items()},
                           {"n": torch.full((2,), np.nan)})
    tb = toptim.AdamWState(torch.tensor(4, dtype=torch.int32), None,
                           {k: torch.from_numpy(v) for k, v in b.items()},
                           {"n": torch.zeros(2)})
    for pred in (True, False):
        got = toptim.select_tree(torch.tensor(pred), ta, tb)
        want = joptim.select_tree(jnp.asarray(pred), a, b)
        assert isinstance(got, toptim.AdamWState) and got.master is None
        assert got.step.item() == (3 if pred else 4)
        for k in a:
            np.testing.assert_array_equal(got.mu[k].numpy(),
                                          np.asarray(want[k]))
        assert torch.equal(got.nu["n"].isnan(), torch.full((2,), pred))


@pytest.mark.parametrize("batch,hw,classes,seed", [
    (2, 64, 19, 0), (1, 16, 5, 3), (3, 50, 7, 11), (1, 512, 19, 0)])
def test_seg_pipeline_bitwise_equal(batch, hw, classes, seed):
    tp = SegDataPipeline(batch, hw=hw, classes=classes, seed=seed)
    jp = JSegDataPipeline(batch, hw=hw, classes=classes, seed=seed)
    for step in (0, 1, 10_000):
        got, want = tp.batch_at(step), jp.batch_at(step)
        assert set(got) == set(want) == {"image", "label"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------- the step

def _nan_batch(pipe):
    b = pipe.batch_at(3)
    b["image"][0, 5, 7, 1] = np.nan
    return b


@pytest.fixture(scope="module")
def ref_steps(tree, pipe):
    """Three reference steps, then one on a NaN batch: per step the loss,
    grad norm, scale and skipped flag."""
    step = jtr.make_train_step("enet", backend="xla")
    state = jtr.init_state(tree)
    out = []
    for i, b in enumerate([pipe.batch_at(i) for i in range(3)]
                          + [_nan_batch(pipe)]):
        state, m = step(state, _jbatch(b))
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_three_steps_track_reference(tree, pipe, ref_steps):
    step = ttr.make_train_step("enet", backend="kernels")
    state = ttr.init_state(flatten_tree(tree))
    for i, want in enumerate(ref_steps[:3]):
        state, m = step(state, ttr.batch_to(pipe.batch_at(i), "cpu"))
        assert abs(m["loss"].item() - want["loss"]) <= _TOL * want["loss"]
        assert_allclose(m["grad_norm"].item(), want["grad_norm"], rtol=1e-3)
        assert m["scale"].item() == want["scale"]
        assert m["skipped"].item() == want["skipped"] == 0.0
    assert int(state.opt.step) == 3


def test_nan_batch_skips_bitwise(tree, pipe, ref_steps):
    step = ttr.make_train_step("enet", backend="kernels")
    state = ttr.init_state(flatten_tree(tree))
    state, _ = step(state, ttr.batch_to(pipe.batch_at(0), "cpu"))
    after, m = step(state, ttr.batch_to(_nan_batch(pipe), "cpu"))
    want = ref_steps[3]
    assert m["skipped"].item() == want["skipped"] == 1.0
    assert m["grad_norm"].item() == want["grad_norm"] == 0.0
    assert m["scale"].item() == state.scale.scale.item() / 2
    assert not np.isfinite(m["loss"].item())
    for name in state.params:
        assert torch.equal(after.params[name], state.params[name]), name
        for part in ("master", "mu", "nu"):
            assert torch.equal(getattr(after.opt, part)[name],
                               getattr(state.opt, part)[name]), (part, name)
    assert torch.equal(after.opt.step, state.opt.step)
    assert after.scale.good_steps.item() == 0


def test_recipes_refuse_what_is_not_ported():
    """Every recipe of the reference is ported: "espnet" and "dcgan" build
    and take a finite step on their own kind of batch; a name the
    reference does not know still raises."""
    from repro_torch.models.dcgan import DCGAN
    from repro_torch.models.espnet import ESPNet

    g = torch.Generator().manual_seed(0)
    cases = {
        "espnet": (ESPNet(3, device="cpu", generator=g),
                   {"image": np.zeros((1, 16, 16, 3), np.float32),
                    "label": np.ones((1, 16, 16), np.int32)}),
        "dcgan": (DCGAN(64, nz=8, ngf=2, device="cpu", generator=g),
                  {"z": np.ones((2, 8), np.float32),
                   "target": np.zeros((2, 64, 64, 3), np.float32)})}
    for name, (model, batch) in cases.items():
        state = ttr.init_state(dict(model.named_parameters()))
        after, m = ttr.make_train_step(name)(state,
                                             ttr.batch_to(batch, "cpu"))
        assert np.isfinite(m["loss"].item()) and m["skipped"].item() == 0.0
        assert int(after.opt.step) == 1, name
    with pytest.raises(ValueError, match="unknown recipe"):
        ttr.make_train_step("resnet")


def test_init_state_takes_module_parameters():
    model = ENet(3, device="cpu", generator=torch.Generator().manual_seed(0))
    state = ttr.init_state(dict(model.named_parameters()))
    assert set(state.params) == set(state.opt.master) == {
        n for n, _ in model.named_parameters()}
    assert all(not p.requires_grad for p in state.params.values())
    assert state.scale.scale.item() == 2.0 ** 15


def test_enet_forward_draws_no_weights():
    """The functional forward runs the parameters it is given through a
    meta-device shell: nothing is drawn, and the logits are the module's."""
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    shell = ENet(5, device="meta", generator=g)
    assert torch.equal(g.get_state(), state)
    assert all(p.is_meta for p in shell.parameters())
    model = ENet(5, device="cpu", generator=torch.Generator().manual_seed(1))
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x)
        got = ttr.model_forward("enet")(dict(model.named_parameters()), x)
    assert torch.equal(got, want)


def test_train_enet_smoke_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_enet", "--smoke",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    losses = [float(line.split()[3]) for line in r.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "pixel accuracy on held-out batch" in r.stdout
