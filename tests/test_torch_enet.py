"""ENet forward of the port (``repro_torch``) against the JAX reference.

The reference parameter tree is built by ``repro.models.enet.init_params``
and then every BN ``g``/``b`` and every PReLU slope is redrawn from numpy:
the reference zero-inits each bottleneck's closing BN scale
(``src/repro/models/enet.py:54``), so at init the reduce -> conv -> expand
chain of every bottleneck would be invisible in the output.  The same tree
goes into the port through ``ENet.load_jax_params`` and both forwards see
the same numpy input.  fp32 on both sides: the bar is relative L2 <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import enet as jenet
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.models import common as tcommon
from repro_torch.models.enet import ENet

_SHAPE = (2, 64, 64, 3)
_CLASSES = 5
_REL_L2 = 1e-4


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"g", "b"}:
            scale = 0.4 if k == "bn3" else 1.0
            out[k] = {"g": (scale * rng.uniform(0.5, 1.0, v["g"].shape)
                            ).astype(np.float32),
                      "b": rng.normal(0, 0.1, v["b"].shape).astype(np.float32)}
        elif isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("a1", "a2", "a3"):
            out[k] = rng.uniform(0.1, 0.4, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def setup():
    params = jenet.init_params(jax.random.PRNGKey(0), num_classes=_CLASSES)
    rng = np.random.default_rng(0)
    tree = _perturb(jax.tree_util.tree_map(np.asarray, params), rng)
    x = rng.standard_normal(_SHAPE).astype(np.float32)
    ref = {dec: np.asarray(jenet.forward(tree, jnp.asarray(x),
                                         decomposed=dec))
           for dec in (True, False)}
    model = ENet(_CLASSES, device="cpu", generator=torch.Generator())
    model.load_jax_params(tree)
    return model, torch.from_numpy(x), ref, tree


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("decomposed,backend,strategy", [
    (True, "kernels", "batched"), (True, "torch", "batched"),
    (True, "torch", "ragged"), (False, "torch", "batched")])
def test_forward_matches_reference(setup, decomposed, backend, strategy):
    model, x, ref, _ = setup
    with torch.no_grad():
        y = model(x, decomposed=decomposed, strategy=strategy,
                  backend=backend).numpy()
    want = ref[decomposed]
    assert y.shape == _SHAPE[:3] + (_CLASSES,)
    assert np.isfinite(y).all()
    assert _rel_l2(y, want) <= _REL_L2


def test_reference_decomposed_equals_naive(setup):
    """The perturbed tree keeps the reference's own decomposed == naive."""
    _, _, ref, _ = setup
    assert _rel_l2(ref[True], ref[False]) <= _REL_L2


def test_forward_dispatch_counts(setup, monkeypatch):
    """One forward dispatches 86 dense/dilated convs to the dense kernel's
    wrapper and 3 transposed convs to the parity kernel's (on the CPU the
    wrappers run their plain versions; on the card they count launches)."""
    model, x, _, _ = setup
    counts = {"dense": 0, "tconv": 0}

    def counting(key, fn):
        def wrapper(*args):
            counts[key] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(kconv, "conv2d_plain",
                        counting("dense", kconv.conv2d_plain))
    monkeypatch.setattr(ktr, "tconv_plain", counting("tconv", ktr.tconv_plain))
    with torch.no_grad():
        model(x[:1, :16, :16])
    assert counts == {"dense": 86, "tconv": 3}


def test_naive_has_no_kernel(setup):
    model, x, _, _ = setup
    with pytest.raises(ValueError, match="naive execution has no kernel"):
        with torch.no_grad():
            model(x, decomposed=False, backend="kernels")


def test_init_mirrors_reference_tree():
    """Same parameter names and HWIO shapes as ``init_params``; the closing
    BN scale of every bottleneck starts at zero, as in the reference."""
    jp = jenet.init_params(jax.random.PRNGKey(1), num_classes=19)
    flat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    model = ENet(19, device="cpu", generator=torch.Generator().manual_seed(1))
    params = dict(model.named_parameters())
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in flat.items()}
    for name, p in params.items():
        if name.endswith("bn3.g"):
            assert not p.any(), name
            assert not flat[name].any(), name


def test_load_jax_params_rejects_mismatch(setup):
    model, _, _, tree = setup
    bad = dict(tree)
    del bad["fullconv"]
    with pytest.raises(KeyError, match="fullconv"):
        model.load_jax_params(bad)
    bad = dict(tree)
    bad["initial"] = np.zeros((3, 3, 3, 12), np.float32)
    with pytest.raises(ValueError, match="initial"):
        model.load_jax_params(bad)


def test_forward_is_deterministic_from_generator():
    a = ENet(3, device="cpu", generator=torch.Generator().manual_seed(7))
    b = ENet(3, device="cpu", generator=torch.Generator().manual_seed(7))
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)


def test_common_ops_match_reference():
    """fold_bn (with and without running statistics), batch-statistics bn
    and prelu against ``repro.models.common``; conv_init's HWIO He scale."""
    rng = np.random.default_rng(3)
    p = {"g": rng.uniform(0.5, 1.5, 6).astype(np.float32),
         "b": rng.normal(size=6).astype(np.float32)}
    mu = rng.normal(size=6).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    x = rng.normal(size=(2, 5, 4, 6)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for args_j, args_t in (((), ()), ((jnp.asarray(mu), jnp.asarray(var)),
                                      (torch.from_numpy(mu),
                                       torch.from_numpy(var)))):
        for a, b in zip(jcommon.fold_bn(jp, *args_j),
                        tcommon.fold_bn(tp, *args_t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    np.testing.assert_allclose(
        tcommon.bn(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.bn(jp, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tcommon.prelu(torch.tensor(0.25), torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.prelu(0.25, jnp.asarray(x))))
    w = tcommon.conv_init(torch.Generator().manual_seed(0), 3, 3, 64, 256)
    assert w.shape == (3, 3, 64, 256)
    assert abs(w.std().item() - (2.0 / (9 * 64)) ** 0.5) < 2e-3
