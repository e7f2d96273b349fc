"""DCGAN and the U-Net decoder/denoiser of the port against the JAX reference.

Parameter trees come from the reference's ``init_params`` (BN and
GroupNorm affines and PReLU slopes redrawn from numpy, as in
``tests/test_torch_espnet.py``) and both packages see the same numpy
inputs, at small widths.  Bars, the reference's own: fp32 forward
``rtol = atol = 1e-5`` and gradients ``1e-4``
(``tests/test_transposed_property.py``); bf16 forward within 5% of the
output range, gradients within 10% relative L2 (DESIGN.md §12).  Also: the
``"dcgan"`` recipe's step against ``repro.launch.train_recipes``, the
launches a forward and a backward dispatch, and ``models.common``'s
helpers against ``repro.models.common``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from test_torch_espnet import (BF16_FWD, BF16_GRAD, FWD_TOL, GRAD_TOL, Counts,
                               as_np, held_grads, perturb, range_err)

from repro.launch import train_recipes as jtr
from repro.models import common as jcommon
from repro.models import dcgan as jdcgan
from repro.models import enet as jenet
from repro.models import unet_decoder as jud
from repro_torch.launch import train_recipes as ttr
from repro_torch.models import common as tcommon
from repro_torch.models import enet as tenet
from repro_torch.models import unet_decoder as tud
from repro_torch.models.dcgan import DCGAN

_NZ, _BATCH = 16, 2
_DCGAN = {64: 4, 128: 4}          # size -> ngf
_WIDTHS = (16, 8, 8)              # U-Net: 4x4 mid -> 32x32 out


def _tree(init, *args, **kw):
    return perturb(jax.tree_util.tree_map(np.asarray, init(*args, **kw)),
                   np.random.default_rng(0))


def _grad_tree(params, loss):
    """Gradients of ``loss(params)`` for a nested dict of leaves, as a flat
    dict of the reference's dotted names."""
    leaves = tcommon.flatten_tree(params)
    prims = {k: v.detach().clone().requires_grad_() for k, v in
             leaves.items()}

    grads = torch.autograd.grad(loss(tcommon.unflatten_tree(prims)),
                                list(prims.values()))
    return dict(zip(prims, grads))


def _jgrad_tree(loss, tree):
    return tcommon.flatten_tree(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(tree)))


# ------------------------------------------------------------------ DCGAN

@pytest.fixture(scope="module")
def dcgan():
    """size -> (reference tree, port module, latents, pixel target)."""
    rng = np.random.default_rng(2)
    out = {}
    for size, ngf in _DCGAN.items():
        tree = _tree(jdcgan.init_params, jax.random.PRNGKey(size), size=size,
                     nz=_NZ, ngf=ngf)
        m = DCGAN(size, nz=_NZ, ngf=ngf, device="cpu",
                  generator=torch.Generator())
        m.load_jax_params(tree)
        z = rng.standard_normal((_BATCH, _NZ)).astype(np.float32)
        target = rng.uniform(-1, 1, (_BATCH, size, size, 3)).astype(
            np.float32)
        out[size] = (tree, m, z, target)
    return out


@pytest.mark.parametrize("size", sorted(_DCGAN))
@pytest.mark.parametrize("decomposed,backend", [
    (True, "kernels"), (True, "torch"), (False, "torch")])
def test_dcgan_forward_matches_reference(dcgan, size, decomposed, backend):
    tree, m, z, _ = dcgan[size]
    want = np.asarray(jdcgan.forward(tree, jnp.asarray(z),
                                     decomposed=decomposed))
    with torch.no_grad():
        y = m(torch.from_numpy(z), decomposed=decomposed,
              backend=backend).numpy()
    assert y.shape == (_BATCH, size, size, 3) and np.abs(y).max() <= 1.0
    assert_allclose(y, want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("size", sorted(_DCGAN))
def test_dcgan_bf16_forward_matches_reference(dcgan, size):
    """The kernels (one rounding a stage) within 5% of the range of the
    reference's bf16 image, and the torch backend, which rounds twice a
    stage as the xla path does, at the reference's cross-backend bar
    (0.02 max|ref| + 1e-3, ``tests/test_mixed_precision.py``).  Not held
    to the fp32 image: over the 128x128 generator's five bf16 stages the
    reference's own bf16 image is 1.3x the 5% bar off its fp32 one."""
    tree, m, z, _ = dcgan[size]
    want = np.asarray(jdcgan.forward(tree, jnp.asarray(z),
                                     compute_dtype="bf16")).astype(np.float32)
    with torch.no_grad():
        y = m(torch.from_numpy(z), compute_dtype="bf16")
        yt = m(torch.from_numpy(z), compute_dtype="bf16", backend="torch")
    assert y.dtype == yt.dtype == torch.bfloat16
    assert range_err(y, want) <= 1.0
    assert np.abs(as_np(yt) - want).max() <= 0.02 * np.abs(want).max() + 1e-3


def _jgen_loss(cd):
    return jtr._loss_fn("dcgan", backend="xla", decomposed=True,
                        interpret=None, compute_dtype=cd)


@pytest.mark.parametrize("size", sorted(_DCGAN))
@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_dcgan_grads_match_reference(dcgan, size, backend):
    tree, _, z, target = dcgan[size]
    batch = {"z": z, "target": target}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = _jgrad_tree(lambda p: _jgen_loss(None)(p, jb), tree)
    _, grads = ttr.loss_and_grads(ttr.loss_fn("dcgan", backend=backend),
                                  ttr.init_state(tcommon.flatten_tree(tree))
                                  .params, ttr.batch_to(batch, "cpu"))
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert_allclose(g.numpy(), want[name], rtol=GRAD_TOL, atol=GRAD_TOL,
                        err_msg=name)


def test_dcgan_bf16_grads_match_reference(dcgan):
    tree, _, z, target = dcgan[64]
    batch = {"z": z, "target": target}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = _jgrad_tree(lambda p: _jgen_loss("bf16")(p, jb), tree)
    _, grads = ttr.loss_and_grads(
        ttr.loss_fn("dcgan", compute_dtype="bf16"),
        ttr.init_state(tcommon.flatten_tree(tree)).params,
        ttr.batch_to(batch, "cpu"))
    apart, _ = held_grads(grads, want)
    assert max(apart.values()) <= BF16_GRAD, apart


def test_dcgan_dispatch_counts(dcgan, monkeypatch):
    """64x64: 4 transposed launches a forward; the backward recomputes the
    3 fused stages (transposed) and takes the 4 stages' dx on the dense
    kernel (strided VALID).  128x128: 5 a forward."""
    counts = Counts(monkeypatch)
    for size, fwd, bwd in ((64, 4, {"conv2d": 4, "tconv": 3}),
                           (128, 5, {"conv2d": 5, "tconv": 4})):
        tree, _, z, _ = dcgan[size]
        params = {k: torch.tensor(v, requires_grad=True)
                  for k, v in tcommon.flatten_tree(tree).items()}
        y = ttr.model_forward("dcgan")(params, torch.from_numpy(z))
        assert counts.take() == {"conv2d": 0, "tconv": fwd}
        torch.autograd.grad(y.square().mean(), list(params.values()))
        assert counts.take() == bwd


def test_dcgan_init_mirrors_reference_tree():
    for size in (64, 128):
        jp = tcommon.flatten_tree(jax.tree_util.tree_map(
            np.asarray, jdcgan.init_params(jax.random.PRNGKey(0), size=size)))
        m = DCGAN(size, device="cpu", generator=torch.Generator())
        assert {k: tuple(v.shape) for k, v in m.named_parameters()} == \
            {k: v.shape for k, v in jp.items()}
    with pytest.raises(ValueError, match="64/128"):
        DCGAN(32, device="cpu", generator=torch.Generator())


@pytest.fixture(scope="module")
def dcgan_ref_steps(dcgan):
    tree, _, z, target = dcgan[64]
    jb = {"z": jnp.asarray(z), "target": jnp.asarray(target)}
    out = {}
    for cd in (None, "bf16"):
        _, m = jtr.make_train_step("dcgan", compute_dtype=cd)(
            jtr.init_state(tree), jb)
        out[cd] = {k: float(v) for k, v in m.items()}
    return out


@pytest.mark.parametrize("cd", [None, "bf16"])
def test_dcgan_recipe_step_matches_reference(dcgan, dcgan_ref_steps, cd):
    tree, _, z, target = dcgan[64]
    state = ttr.init_state(tcommon.flatten_tree(tree))
    after, m = ttr.make_train_step("dcgan", compute_dtype=cd)(
        state, ttr.batch_to({"z": z, "target": target}, "cpu"))
    want = dcgan_ref_steps[cd]
    loss_tol, norm_tol = (GRAD_TOL, 1e-3) if cd is None else (BF16_FWD,
                                                             BF16_GRAD)
    assert abs(m["loss"].item() / want["loss"] - 1) <= loss_tol
    assert abs(m["grad_norm"].item() / want["grad_norm"] - 1) <= norm_tol
    assert m["scale"].item() == want["scale"]
    assert m["skipped"].item() == want["skipped"] == 0.0
    assert all(p.dtype == torch.float32 for p in after.params.values())


def test_dcgan_recipe_skips_nan_batch_bitwise(dcgan):
    tree, _, z, target = dcgan[64]
    state = ttr.init_state(tcommon.flatten_tree(tree))
    bad = ttr.batch_to({"z": z, "target": target}, "cpu")
    bad["z"][1, 3] = float("nan")
    after, m = ttr.make_train_step("dcgan")(state, bad)
    assert m["skipped"].item() == 1.0 and m["grad_norm"].item() == 0.0
    assert m["scale"].item() == state.scale.scale.item() / 2
    for name in state.params:
        assert torch.equal(after.params[name], state.params[name]), name
        for part in ("master", "mu", "nu"):
            assert torch.equal(getattr(after.opt, part)[name],
                               getattr(state.opt, part)[name]), (part, name)


# ----------------------------------------------------- U-Net decoder, denoise

@pytest.fixture(scope="module")
def unet():
    rng = np.random.default_rng(3)
    tree = _tree(jud.init_params, jax.random.PRNGKey(2), widths=_WIDTHS)
    x = rng.standard_normal((1, 4, 4, _WIDTHS[0])).astype(np.float32)
    skips = tuple(rng.standard_normal((1, 4 * 2 ** i, 4 * 2 ** i, c))
                  .astype(np.float32) for i, c in enumerate(_WIDTHS))
    return tree, x, skips


def _unet_port(unet, **kw):
    tree, x, skips = unet
    return tud.forward(tcommon.to_device(tree, "cpu"), torch.from_numpy(x),
                       tuple(map(torch.from_numpy, skips)), **kw)


@pytest.mark.parametrize("decomposed,backend", [
    (True, "kernels"), (True, "torch"), (False, "torch")])
def test_unet_forward_matches_reference(unet, decomposed, backend):
    tree, x, skips = unet
    want = np.asarray(jud.forward(tree, jnp.asarray(x),
                                  tuple(map(jnp.asarray, skips)),
                                  decomposed=decomposed))
    with torch.no_grad():
        y = _unet_port(unet, decomposed=decomposed, backend=backend).numpy()
    assert y.shape == (1, 32, 32, 3)
    assert_allclose(y, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_unet_bf16_forward_matches_reference(unet):
    tree, x, skips = unet
    want = np.asarray(jud.forward(tree, jnp.asarray(x),
                                  tuple(map(jnp.asarray, skips)),
                                  compute_dtype="bf16"))
    with torch.no_grad():
        y = _unet_port(unet, compute_dtype="bf16")
        y32 = _unet_port(unet)
    assert y.dtype == torch.bfloat16
    assert range_err(y, want) <= 1.0 and range_err(y, y32) <= 1.0


@pytest.mark.parametrize("cd,backend", [(None, "kernels"), (None, "torch"),
                                        ("bf16", "kernels")])
def test_unet_grads_match_reference(unet, cd, backend):
    tree, x, skips = unet
    jx, js = jnp.asarray(x), tuple(map(jnp.asarray, skips))
    want = _jgrad_tree(lambda p: jnp.mean(jnp.square(jud.forward(
        p, jx, js, compute_dtype=cd).astype(jnp.float32))), tree)
    tx, ts = torch.from_numpy(x), tuple(map(torch.from_numpy, skips))
    grads = _grad_tree(tcommon.to_device(tree, "cpu"), lambda p: tud.forward(
        p, tx, ts, backend=backend, compute_dtype=cd).float().square()
        .mean())
    assert set(grads) == set(want)
    if cd is None:
        for name, g in grads.items():
            assert_allclose(g.numpy(), want[name], rtol=GRAD_TOL,
                            atol=GRAD_TOL, err_msg=name)
    else:
        slopes = [n for n in grads if n.rsplit("_", 1)[-1] in
                  ("a1", "a2", "aup")]
        apart, together = held_grads(grads, want, slopes)
        assert max(apart.values()) <= BF16_GRAD and together <= BF16_GRAD


@pytest.fixture(scope="module")
def denoiser():
    rng = np.random.default_rng(4)
    tree = _tree(jud.init_denoiser_params, jax.random.PRNGKey(5),
                 widths=_WIDTHS)
    x_t = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.array([3, 781], np.int32)
    return tree, x_t, t


@pytest.mark.parametrize("cd", [None, "bf16"])
def test_denoise_matches_reference(denoiser, cd):
    tree, x_t, t = denoiser
    want = np.asarray(jud.denoise(tree, jnp.asarray(x_t), jnp.asarray(t),
                                  compute_dtype=cd)).astype(np.float32)
    with torch.no_grad():
        y = tud.denoise(tcommon.to_device(tree, "cpu"), torch.from_numpy(x_t),
                        torch.from_numpy(t), compute_dtype=cd)
    assert y.shape == x_t.shape
    if cd is None:
        assert_allclose(y.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    else:
        assert y.dtype == torch.bfloat16 and range_err(y, want) <= 1.0


def test_denoise_grads_match_reference(denoiser):
    tree, x_t, t = denoiser
    want = _jgrad_tree(lambda p: jnp.mean(jnp.square(jud.denoise(
        p, jnp.asarray(x_t), jnp.asarray(t)))), tree)
    grads = _grad_tree(tcommon.to_device(tree, "cpu"), lambda p: tud.denoise(
        p, torch.from_numpy(x_t), torch.from_numpy(t)).square().mean())
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert_allclose(g.numpy(), want[name], rtol=GRAD_TOL, atol=GRAD_TOL,
                        err_msg=name)


def test_denoise_dispatch_counts_and_bf16_stays_bf16(denoiser, monkeypatch):
    """A denoise forward sends 11 convs to the dense wrapper (the stem, the
    3 encoders, 6 decoder convs, the head) and 3 to the transposed one's;
    in bf16 every one of them gets bf16 operands (the timestep MLP's
    masters are cast, so the mid features are not promoted).  The
    decoder's backward: 16 + 3 (the 6 fused convs and 3 fused upsamplers
    recomputed without their epilogue, the dx of the 6 convs and the head,
    and the 3 upsamplers' dx, strided VALID, all on the dense kernel)."""
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import transposed_conv as ktr

    tree, x_t, t = denoiser
    dtypes = []
    for mod, attr in ((kconv, "conv2d_plain"), (ktr, "tconv_plain")):
        fn = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, fn=fn: (
            dtypes.append(a[0].dtype), fn(*a))[1])
    counts = Counts(monkeypatch)
    p = tcommon.to_device(tree, "cpu")
    with torch.no_grad():
        tud.denoise(p, torch.from_numpy(x_t), torch.from_numpy(t),
                    compute_dtype="bf16")
    assert counts.take() == {"conv2d": 11, "tconv": 3}
    assert dtypes == [torch.bfloat16] * 14
    mid = torch.randn(1, 4, 4, _WIDTHS[0], requires_grad=True)
    skips = tuple(torch.randn(1, 4 * 2 ** i, 4 * 2 ** i, c)
                  for i, c in enumerate(_WIDTHS))
    dec = {k: v.requires_grad_() if isinstance(v, torch.Tensor) else
           {kk: vv.requires_grad_() for kk, vv in v.items()}
           for k, v in p["dec"].items()}
    y = tud.forward(dec, mid, skips)
    assert counts.take() == {"conv2d": 7, "tconv": 3}
    torch.autograd.grad(y.square().mean(),
                        [mid] + list(tcommon.flatten_tree(dec).values()))
    assert counts.take() == {"conv2d": 16, "tconv": 3}


def test_init_functions_mirror_reference_trees():
    jp = tcommon.flatten_tree(jax.tree_util.tree_map(
        np.asarray, jud.init_denoiser_params(jax.random.PRNGKey(0))))
    tp = tcommon.flatten_tree(tud.init_denoiser_params(
        torch.Generator(), device="cpu"))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert tud.UNET_WIDTHS == (256, 128, 64)
    assert tud.UNET_UP_KERNELS == (4, 2, 4)
    with pytest.raises(ValueError, match="skip widths"):
        tud.init_params(torch.Generator(), widths=(8, 8), skip_chs=(8,),
                        device="cpu")


# ----------------------------------------------------- models.common helpers

def test_common_helpers_match_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 12, 16)).astype(np.float32)
    p = {"g": rng.standard_normal(16).astype(np.float32),
         "b": rng.standard_normal(16).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    assert_allclose(tcommon.group_norm(tp, torch.from_numpy(x)).numpy(),
                    np.asarray(jcommon.group_norm(jp, jnp.asarray(x))),
                    rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        tcommon.group_norm(tp, torch.zeros(1, 2, 2, 12), groups=8)
    for a, b in zip(tcommon.fold_gn(tp), jcommon.fold_gn(jp)):
        assert_allclose(a.numpy(), np.asarray(b))
    gi = tcommon.gn_init(16)
    assert torch.equal(gi["g"], torch.ones(16))
    assert torch.equal(gi["b"], torch.zeros(16))
    t = np.array([0, 1, 17, 999], np.int32)
    assert_allclose(tcommon.timestep_embedding(torch.from_numpy(t),
                                               64).numpy(),
                    np.asarray(jcommon.timestep_embedding(jnp.asarray(t),
                                                          64)),
                    rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="even"):
        tcommon.timestep_embedding(torch.zeros(2), 5)


def test_fold_gn_matches_group_norm_on_normalised_input():
    """fold_gn is the identity-statistics fold of the group_norm oracle: on
    an input already normalised per group the two agree."""
    g = torch.Generator().manual_seed(7)
    p = {"g": torch.randn(16, generator=g), "b": torch.randn(16, generator=g)}
    xn = tcommon.group_norm({"g": torch.ones(16), "b": torch.zeros(16)},
                            torch.randn(2, 32, 32, 16, generator=g))
    sc, sh = tcommon.fold_gn(p)
    assert_allclose((xn * sc + sh).numpy(),
                    tcommon.group_norm(p, xn).numpy(), rtol=1e-4, atol=1e-4)


def test_tconv_init_scale_and_flatten_tree_home():
    w = tcommon.tconv_init(torch.Generator().manual_seed(0), 4, 4, 128, 256)
    assert w.shape == (4, 4, 128, 256)
    assert abs(w.std().item() - (2.0 / (16 * 128 // 4)) ** 0.5) < 2e-3
    assert tenet.flatten_tree is tcommon.flatten_tree
    flat = tcommon.flatten_tree(jax.tree_util.tree_map(
        np.asarray, jenet.init_params(jax.random.PRNGKey(0), num_classes=3)))
    assert "b1_0.bn1.g" in flat and "fullconv" in flat
