"""The Whisper frontend of the port against the JAX reference.

``repro_torch.models.whisper.frontend`` and ``repro.models.whisper.frontend``
(xla path) on the same numpy-drawn mel frames and weights: fp32 forward at
``rtol = atol = 1e-5`` and gradients at ``1e-4``, the reference's bars
(``tests/test_transposed_property.py``); fp32 only, as the reference is.
Both pad the 3-wide kernel (1, 1) at stride 2, Whisper's own padding, so
they also match the reference's plain ``lax`` oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from test_torch_espnet import FWD_TOL, GRAD_TOL, Counts

from repro.models import whisper as jwh
from repro_torch.models import whisper as twh

_MEL, _D = 16, 32


def _setup(t, seed=0):
    rng = np.random.default_rng(seed)
    params = {"conv1": rng.standard_normal((1, 3, _MEL, _D)).astype(np.float32)
              * (2.0 / (3 * _MEL)) ** 0.5,
              "conv2": rng.standard_normal((1, 3, _D, _D)).astype(np.float32)
              * (2.0 / (3 * _D)) ** 0.5}
    mel = rng.standard_normal((2, t, _MEL)).astype(np.float32)
    return params, mel


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("t", [64, 63])
def test_frontend_matches_reference(t, backend):
    params, mel = _setup(t)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(jwh.frontend(jp, jnp.asarray(mel)))
    with torch.no_grad():
        got = twh.frontend({k: torch.from_numpy(v) for k, v in params.items()},
                           torch.from_numpy(mel), backend=backend).numpy()
    assert got.shape == (2, (t + 1) // 2, _D) == want.shape
    assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    assert_allclose(got, np.asarray(jwh.frontend_reference(
        jp, jnp.asarray(mel))), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_frontend_grads_match_reference(backend):
    params, mel = _setup(40, seed=1)

    def jloss(p, x):
        return jnp.sum(jnp.square(jwh.frontend(p, x)))

    want = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(mel))
    prims = {k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}
    x = torch.tensor(mel, requires_grad=True)
    got = torch.autograd.grad(
        twh.frontend(prims, x, backend=backend).square().sum(),
        [prims["conv1"], prims["conv2"], x])
    for g, w, name in zip(got, (want[0]["conv1"], want[0]["conv2"], want[1]),
                          ("conv1", "conv2", "mel")):
        assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                        err_msg=name)


def test_frontend_dispatch_counts(monkeypatch):
    """Two dense-kernel launches a forward; the backward recomputes
    nothing (no epilogue): the second conv's dx (rectangular, stride 2)
    composes plain torch ops, as the reference falls back to lax, and the
    first conv's dx (stride 1) runs on the dense kernel."""
    counts = Counts(monkeypatch)
    params, mel = _setup(32)
    prims = {k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}
    x = torch.tensor(mel, requires_grad=True)
    y = twh.frontend(prims, x)
    assert counts.take() == {"conv2d": 2, "tconv": 0}
    torch.autograd.grad(y.sum(), [x, *prims.values()])
    assert counts.take() == {"conv2d": 1, "tconv": 0}


def test_init_frontend_params_shapes_and_device():
    p = twh.init_frontend_params(torch.Generator().manual_seed(0),
                                 device="cpu")
    assert p["conv1"].shape == (1, 3, twh.N_MELS, twh.D_MODEL)
    assert p["conv2"].shape == (1, 3, twh.D_MODEL, twh.D_MODEL)
    assert abs(p["conv2"].std().item() - (2.0 / (3 * 768)) ** 0.5) < 1e-3
    assert (twh.N_MELS, twh.N_FRAMES, twh.D_MODEL) == (
        jwh.N_MELS, jwh.N_FRAMES, jwh.D_MODEL)
