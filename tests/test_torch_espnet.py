"""ESPNet of the port (``repro_torch``) against the JAX reference.

The reference tree comes from ``repro.models.espnet.init_params``; every BN
scale and shift and every PReLU slope is then redrawn from numpy (scales by
a factor in [0.7, 1.3] of their init, which keeps the ESP stack near unit
scale), so the comparison does not rest on init values.  The same tree goes
into the port through ``ESPNet.load_jax_params`` and both see the same
numpy inputs.  48x40 inputs give the downsampling ESPs uneven class-window
extents (24x20 -> 12x10 and 12x10 -> 6x5 at d = 2, 4, 8).  Bars, the
reference's own: fp32 forward ``rtol = atol = 1e-5``, gradients ``1e-4``
(``tests/test_transposed_property.py``); bf16 forward within 5% of the
output range, gradients within 10% relative L2 (DESIGN.md §12); a recipe
step's loss at relative 1e-4 (fp32) and 5% (bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.launch import train_recipes as jtr
from repro.models import espnet as jespnet
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.launch import train_recipes as ttr
from repro_torch.models.common import flatten_tree
from repro_torch.models.espnet import ESPNet

_SHAPE = (2, 48, 40, 3)
_CLASSES = 5
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
BF16_FWD, BF16_GRAD = 0.05, 0.10
#: the scalar PReLU slopes: a slope's gradient is one sum over a whole
#: activation that cancels to a small part of its terms, so bf16 rounding
#: moves it more than any single tensor's bar; they are held together
_SLOPES = ("a", "stem_a")


def perturb(tree, rng, slopes=("a", "stem_a", "a1", "a2", "aup")):
    """Redraw every ``{"g", "b"}`` pair (scale x U(0.7, 1.3), shift
    N(0, 0.1)) and every leaf named in ``slopes`` (U(0.1, 0.4))."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"g", "b"}:
            g = np.asarray(v["g"])
            out[k] = {"g": (g * rng.uniform(0.7, 1.3, g.shape)
                            ).astype(np.float32),
                      "b": rng.normal(0, 0.1, g.shape).astype(np.float32)}
        elif isinstance(v, dict):
            out[k] = perturb(v, rng, slopes)
        elif k.rsplit("_", 1)[-1] in slopes or k in slopes:
            out[k] = rng.uniform(0.1, 0.4, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def rel_l2(a, b) -> float:
    a, b = as_np(a), as_np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def range_err(got, want) -> float:
    """max |got - want| over the bf16 bar: 5% of the reference's range."""
    got, want = as_np(got), as_np(want)
    return float(np.abs(got - want).max()
                 / (BF16_FWD * np.abs(want).max() + 1e-3))


def held_grads(grads, want, names_together=()):
    """Per-tensor relative L2 of ``grads`` against ``want`` (flat dicts),
    the tensors in ``names_together`` pooled into one."""
    apart = {n: rel_l2(grads[n], want[n]) for n in want
             if n not in names_together}
    together = (rel_l2(np.concatenate([as_np(grads[n]).ravel()
                                       for n in names_together]),
                       np.concatenate([np.asarray(want[n]).ravel()
                                       for n in names_together]))
                if names_together else 0.0)
    return apart, together


class Counts:
    """Counts the kernel wrappers' plain versions (the launches on the
    card) through ``monkeypatch``."""

    def __init__(self, monkeypatch):
        self.n = {"conv2d": 0, "tconv": 0}
        for mod, attr, key in ((kconv, "conv2d_plain", "conv2d"),
                               (ktr, "tconv_plain", "tconv")):
            monkeypatch.setattr(mod, attr, self._wrap(key, getattr(mod,
                                                                   attr)))

    def _wrap(self, key, fn):
        def wrapper(*args):
            self.n[key] += 1
            return fn(*args)
        return wrapper

    def take(self) -> dict:
        out, self.n = self.n, {"conv2d": 0, "tconv": 0}
        return out


@pytest.fixture(scope="module")
def tree():
    params = jespnet.init_params(jax.random.PRNGKey(0), num_classes=_CLASSES)
    return perturb(jax.tree_util.tree_map(np.asarray, params),
                   np.random.default_rng(0))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    return {"image": rng.standard_normal(_SHAPE).astype(np.float32),
            "label": rng.integers(0, _CLASSES, _SHAPE[:3]).astype(np.int32)}


@pytest.fixture(scope="module")
def model(tree):
    m = ESPNet(_CLASSES, device="cpu", generator=torch.Generator())
    m.load_jax_params(tree)
    return m


@pytest.fixture(scope="module")
def ref(tree, batch):
    x = jnp.asarray(batch["image"])
    return {(dec, cd): np.asarray(jespnet.forward(
        tree, x, decomposed=dec, compute_dtype=cd)).astype(np.float32)
        for dec, cd in ((True, None), (False, None), (True, "bf16"))}


@pytest.mark.parametrize("decomposed,backend,strategy", [
    (True, "kernels", "batched"), (True, "torch", "batched"),
    (True, "torch", "ragged"), (False, "torch", "batched")])
def test_forward_matches_reference(model, batch, ref, decomposed, backend,
                                   strategy):
    with torch.no_grad():
        y = model(torch.from_numpy(batch["image"]), decomposed=decomposed,
                  strategy=strategy, backend=backend).numpy()
    assert y.shape == _SHAPE[:3] + (_CLASSES,)
    assert_allclose(y, ref[(decomposed, None)], rtol=FWD_TOL, atol=FWD_TOL)


def test_bf16_forward_matches_reference(model, batch, ref):
    with torch.no_grad():
        y = model(torch.from_numpy(batch["image"]), compute_dtype="bf16")
        y32 = model(torch.from_numpy(batch["image"]))
    assert y.dtype == torch.bfloat16 and np.isfinite(as_np(y)).all()
    vs_ref, vs_fp32 = range_err(y, ref[(True, "bf16")]), range_err(y, y32)
    print(f"ESPNet bf16: vs reference bf16 {vs_ref:.3f}, vs own fp32 "
          f"{vs_fp32:.3f} of the 5% bar")
    assert vs_ref <= 1.0 and vs_fp32 <= 1.0


def _jgrads(tree, batch, cd=None):
    loss = jtr._loss_fn("espnet", backend="xla", decomposed=True,
                        interpret=None, compute_dtype=cd)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    value, grads = jax.value_and_grad(loss)(tree, jb)
    return float(value), flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                             grads))


@pytest.fixture(scope="module")
def ref_grads(tree, batch):
    return {cd: _jgrads(tree, batch, cd) for cd in (None, "bf16")}


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_grads_match_reference(tree, batch, ref_grads, backend):
    value, grads = ttr.loss_and_grads(
        ttr.loss_fn("espnet", backend=backend),
        ttr.init_state(flatten_tree(tree)).params, ttr.batch_to(batch, "cpu"))
    want_value, want = ref_grads[None]
    assert set(grads) == set(want)
    assert abs(value.item() - want_value) <= GRAD_TOL * abs(want_value)
    for name, g in grads.items():
        assert_allclose(g.numpy(), want[name], rtol=GRAD_TOL, atol=GRAD_TOL,
                        err_msg=name)


def test_bf16_grads_match_reference(tree, batch, ref_grads):
    _, grads = ttr.loss_and_grads(
        ttr.loss_fn("espnet", compute_dtype="bf16"),
        ttr.init_state(flatten_tree(tree)).params, ttr.batch_to(batch, "cpu"))
    assert all(g.dtype == torch.float32 for g in grads.values())
    slopes = [n for n in grads if n.rsplit(".", 1)[-1] in _SLOPES]
    apart, together = held_grads(grads, ref_grads["bf16"][1], slopes)
    worst = max(apart, key=apart.get)
    print(f"ESPNet bf16 grads: worst {worst} {apart[worst]:.2e}; "
          f"{len(slopes)} slopes together {together:.2e}")
    assert max(apart.values()) <= BF16_GRAD and together <= BF16_GRAD


def test_dispatch_counts(tree, monkeypatch):
    """A forward sends 38 convs to the dense kernel's wrapper (stem, 5 a
    module over 7 ESP modules, skip2, head) and 3 to the transposed one's.
    The backward sends 39 and 3: the stem and up1 recomputed without
    their epilogue (the stem needs no dx), the dx of every other conv on
    the dense kernel but the two stride-2 d=1 branches', which take the
    transposed kernel.  ``chip_smoke.py`` pins the same counts as
    launches."""
    counts = Counts(monkeypatch)
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in flatten_tree(tree).items()}
    x = torch.randn(1, 16, 16, 3)
    loss = ttr.model_forward("espnet")(params, x).square().mean()
    assert counts.take() == {"conv2d": 38, "tconv": 3}
    torch.autograd.grad(loss, list(params.values()))
    assert counts.take() == {"conv2d": 39, "tconv": 3}
    with torch.no_grad():
        ttr.model_forward("espnet", compute_dtype="bf16")(params, x)
    assert counts.take() == {"conv2d": 38, "tconv": 3}


def test_init_mirrors_reference_tree():
    jp = flatten_tree(jax.tree_util.tree_map(
        np.asarray, jespnet.init_params(jax.random.PRNGKey(1))))
    model = ESPNet(19, device="cpu", generator=torch.Generator().manual_seed(1))
    params = dict(model.named_parameters())
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in jp.items()}
    for name, p in params.items():
        if name.endswith("bn.g") or name.endswith(".a") or name == "stem_a":
            assert_allclose(p.detach().numpy(), jp[name], rtol=1e-6)


def test_load_jax_params_rejects_mismatch(model, tree):
    bad = dict(tree)
    del bad["up3"]
    with pytest.raises(KeyError, match="up3"):
        model.load_jax_params(bad)
    bad = dict(tree, head=np.zeros((1, 1, 128, 4), np.float32))
    with pytest.raises(ValueError, match="head"):
        model.load_jax_params(bad)


def test_functional_forward_draws_no_weights(model, batch):
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    shell = ESPNet(_CLASSES, device="meta", generator=g)
    assert torch.equal(g.get_state(), state)
    assert all(p.is_meta for p in shell.parameters())
    x = torch.from_numpy(batch["image"][:1])
    with torch.no_grad():
        want = model(x)
        got = ttr.model_forward("espnet")(dict(model.named_parameters()), x)
    assert torch.equal(got, want)


# --------------------------------------------------------------- the recipe

@pytest.fixture(scope="module")
def ref_steps(tree, batch):
    """One reference "espnet" step per compute dtype, then one on a NaN
    batch (fp32)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for cd in (None, "bf16"):
        _, m = jtr.make_train_step("espnet", compute_dtype=cd)(
            jtr.init_state(tree), jb)
        out[cd] = {k: float(v) for k, v in m.items()}
    return out


@pytest.mark.parametrize("cd", [None, "bf16"])
def test_recipe_step_matches_reference(tree, batch, ref_steps, cd):
    state = ttr.init_state(flatten_tree(tree))
    after, m = ttr.make_train_step("espnet", compute_dtype=cd)(
        state, ttr.batch_to(batch, "cpu"))
    want = ref_steps[cd]
    loss_tol, norm_tol = (GRAD_TOL, 1e-3) if cd is None else (BF16_FWD,
                                                             BF16_GRAD)
    assert abs(m["loss"].item() / want["loss"] - 1) <= loss_tol
    assert abs(m["grad_norm"].item() / want["grad_norm"] - 1) <= norm_tol
    assert m["scale"].item() == want["scale"]
    assert m["skipped"].item() == want["skipped"] == 0.0
    assert all(p.dtype == torch.float32 for p in after.params.values())
    assert int(after.opt.step) == 1


def test_recipe_skips_nan_batch_bitwise(tree, batch):
    state = ttr.init_state(flatten_tree(tree))
    bad = ttr.batch_to(batch, "cpu")
    bad["image"][0, 5, 7, 1] = float("nan")
    after, m = ttr.make_train_step("espnet")(state, bad)
    assert m["skipped"].item() == 1.0 and m["grad_norm"].item() == 0.0
    assert m["scale"].item() == state.scale.scale.item() / 2
    for name in state.params:
        assert torch.equal(after.params[name], state.params[name]), name
        for part in ("master", "mu", "nu"):
            assert torch.equal(getattr(after.opt, part)[name],
                               getattr(state.opt, part)[name]), (part, name)
    assert torch.equal(after.opt.step, state.opt.step)
