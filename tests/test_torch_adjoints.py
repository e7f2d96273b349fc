"""Gradients of the port (``repro_torch``) against the JAX reference.

Three levels, on inputs drawn with numpy and fed to both packages:

* the adjoint pieces of ``repro_torch.core.adjoints`` against
  ``repro.core.adjoints`` (fp32, only summation order differs: 1e-5);
* ``conv2d`` gradients of ``sum(sin(y))`` through the port's dispatcher
  (``backend="kernels"``: the kernel wrappers' autograd Functions, which
  run the kernels' plain versions on CPU tensors; ``"torch"``: native
  autograd of ``F.conv2d`` compositions) against ``jax.grad`` through
  ``repro.core.decompose.conv2d(backend="xla")``, over the geometry grids
  of ``tests/test_gradients.py`` and the seeded transposed geometries of
  ``tests/test_transposed_property.py``, at the reference's own gradient
  bar, rtol = atol = 1e-4;
* every fused epilogue spec on the dense, dilated and transposed paths,
  with the gradients of x, w and every epilogue operand, at the same bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from test_gradients import FAST_CASES, SLOW_CASES
from test_transposed_property import _FULL

from repro.core import adjoints as jadj
from repro.core.decompose import conv2d as jconv2d
from repro.kernels.epilogue import EpilogueSpec as JSpec
from repro_torch.core import adjoints as tadj
from repro_torch.core.decompose import conv2d as tconv2d
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.kernels.epilogue import EpilogueSpec

_TOL = 1e-4
_PIECE_TOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, tol):
    assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol,
                    atol=tol)


# ------------------------------------------------------------------ pieces

def test_flip_io_matches_reference():
    w = _rand(np.random.default_rng(0), 3, 2, 4, 5)
    got = tadj.flip_io(torch.from_numpy(w))
    assert got.shape == (3, 2, 5, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jadj.flip_io(jnp.asarray(w))))


@pytest.mark.parametrize("kh,kw,stride,tap_step", [
    (3, 3, 1, 1), (2, 2, 2, 1), (5, 1, 1, 1), (3, 3, 1, 2), (3, 3, 2, 3)])
def test_tap_correlation_matches_reference(kh, kw, stride, tap_step):
    rng = np.random.default_rng(kh * 10 + kw + stride + tap_step)
    a = _rand(rng, 2, 5, 4, 3)
    b = _rand(rng, 2, tap_step * (kh - 1) + stride * 4 + 1,
              tap_step * (kw - 1) + stride * 3 + 1, 6)
    got = tadj.tap_correlation(torch.from_numpy(a), torch.from_numpy(b), kh,
                               kw, stride=stride, tap_step=tap_step)
    want = jadj.tap_correlation(jnp.asarray(a), jnp.asarray(b), kh, kw,
                                stride=stride, tap_step=tap_step)
    assert got.shape == want.shape
    _close(got, want, _PIECE_TOL)


def _jtconv(g, wf, s, p, op):
    return jconv2d(g, wf, stride=s, transposed=True, padding=p,
                   output_padding=op)


def _ttconv(g, wf, s, p, op):
    return ktr.transposed_conv2d(g, wf, stride=s, padding=p,
                                 output_padding=op)


@pytest.mark.parametrize("h,w_in,k,stride,p_lo", [
    (9, 8, 3, 1, 1), (9, 8, 3, 2, 1), (8, 8, 2, 2, 0), (11, 10, 4, 2, 1),
    (7, 9, 2, 1, 0)])
def test_dense_conv_dx_dw_match_reference(h, w_in, k, stride, p_lo):
    rng = np.random.default_rng(h * w_in + k)
    p_hi = k - 1 - p_lo
    oh = (h + p_lo + p_hi - k) // stride + 1
    ow = (w_in + p_lo + p_hi - k) // stride + 1
    x, w, g = (_rand(rng, 2, h, w_in, 3), _rand(rng, k, k, 3, 4),
               _rand(rng, 2, oh, ow, 4))
    got = tadj.dense_conv_dx(torch.from_numpy(g), torch.from_numpy(w),
                             stride, p_lo, h, w_in, _ttconv)
    want = jadj.dense_conv_dx(jnp.asarray(g), jnp.asarray(w), stride, p_lo,
                              h, w_in, _jtconv)
    assert got.shape == want.shape == x.shape
    _close(got, want, _PIECE_TOL)
    got = tadj.dense_conv_dw(torch.from_numpy(x), torch.from_numpy(g), k, k,
                             stride, p_lo, p_lo)
    want = jadj.dense_conv_dw(jnp.asarray(x), jnp.asarray(g), k, k, stride,
                              p_lo, p_lo)
    assert got.shape == want.shape == w.shape
    _close(got, want, _PIECE_TOL)


@pytest.mark.parametrize("h,w_in,k,stride,p_lo,op", [
    (5, 6, 3, 2, 1, 1), (6, 5, 2, 2, 0, 0), (5, 5, 5, 3, 2, 1),
    (6, 6, 4, 2, 3, 1), (4, 3, 3, 2, 2, 1)])
def test_tconv_dx_dw_match_reference(h, w_in, k, stride, p_lo, op):
    rng = np.random.default_rng(h + w_in * k + op)
    p_hi = p_lo + op
    oh = (h - 1) * stride + p_lo + p_hi - k + 2
    ow = (w_in - 1) * stride + p_lo + p_hi - k + 2
    x, w, g = (_rand(rng, 2, h, w_in, 3), _rand(rng, k, k, 3, 4),
               _rand(rng, 2, oh, ow, 4))
    got = tadj.tconv_dx(
        torch.from_numpy(g), torch.from_numpy(w), stride, p_lo, p_hi,
        lambda gp, wf, s: kconv.conv2d(gp, wf, stride=s, padding="VALID"))
    want = jadj.tconv_dx(
        jnp.asarray(g), jnp.asarray(w), stride, p_lo, p_hi,
        lambda gp, wf, s: jconv2d(gp, wf, stride=s, padding=0))
    assert got.shape == want.shape == x.shape
    _close(got, want, _PIECE_TOL)
    got = tadj.tconv_dw(torch.from_numpy(x), torch.from_numpy(g), k, stride,
                        p_lo, p_hi)
    want = jadj.tconv_dw(jnp.asarray(x), jnp.asarray(g), k, stride, p_lo,
                         p_hi)
    assert got.shape == want.shape == w.shape
    _close(got, want, _PIECE_TOL)


@pytest.mark.parametrize("h,w_in,k,d", [(10, 9, 3, 2), (13, 13, 3, 4),
                                        (12, 11, 5, 3)])
def test_dilated_conv_dx_dw_match_reference(h, w_in, k, d):
    rng = np.random.default_rng(h + k + d)
    x, w, g = (_rand(rng, 2, h, w_in, 3), _rand(rng, k, k, 3, 4),
               _rand(rng, 2, h, w_in, 4))
    got = tadj.dilated_conv_dx(
        torch.from_numpy(g), torch.from_numpy(w), d,
        lambda gg, wf, dd: tconv2d(gg, wf, dilation=dd))
    want = jadj.dilated_conv_dx(
        jnp.asarray(g), jnp.asarray(w), d,
        lambda gg, wf, dd: jconv2d(gg, wf, dilation=dd))
    _close(got, want, _PIECE_TOL)
    got = tadj.dilated_conv_dw(torch.from_numpy(x), torch.from_numpy(g), k,
                               d)
    want = jadj.dilated_conv_dw(jnp.asarray(x), jnp.asarray(g), k, d)
    assert got.shape == want.shape == w.shape
    _close(got, want, _PIECE_TOL)


# --------------------------------------------------------- conv2d gradients

def _tconv_case(c):
    h, w, cin, cout, k, s, p_lo, op = c
    return (f"tconv_h{h}w{w}c{cin}x{cout}k{k}s{s}p{p_lo}op{op}",
            dict(stride=s, transposed=True, padding=p_lo, output_padding=op),
            (2, h, w, cin), (k, k, cin, cout))


_GEOMETRIES = FAST_CASES + SLOW_CASES + [_tconv_case(c) for c in _FULL[:8]]


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("case", _GEOMETRIES, ids=lambda c: c[0])
def test_conv2d_grads_match_reference(case, backend):
    name, kw, xs, ws = case
    rng = np.random.default_rng(sum(xs) + sum(ws))
    x, w = _rand(rng, *xs), _rand(rng, *ws)
    gx_j, gw_j = jax.grad(
        lambda a, b: jnp.sum(jnp.sin(jconv2d(a, b, backend="xla", **kw))),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = tconv2d(xt, wt, backend=backend, **kw)
    gx, gw = torch.autograd.grad(torch.sin(y).sum(), (xt, wt))
    _close(gx, gx_j, _TOL)
    _close(gw, gw_j, _TOL)


def test_rectangular_kernel_grads_match_reference():
    """The 5x1/1x5 pair (stride 1: dense kernel at explicit pads) and a
    rectangular stride-2 conv (torch composition, as the reference falls
    back to lax)."""
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 9, 8, 3)
    for ws, stride in (((5, 1, 3, 4), 1), ((1, 5, 3, 4), 1),
                       ((5, 1, 3, 4), 2), ((2, 3, 3, 4), 1)):
        w = _rand(rng, *ws)
        want = jax.grad(lambda a, b: jnp.sum(jnp.sin(
            jconv2d(a, b, stride=stride, backend="xla"))), argnums=(0, 1))(
                jnp.asarray(x), jnp.asarray(w))
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        y = tconv2d(xt, wt, stride=stride)
        got = torch.autograd.grad(torch.sin(y).sum(), (xt, wt))
        for a, b in zip(got, want):
            _close(a, b, _TOL)


# ------------------------------------------------------ epilogue gradients

_SPECS = [(b, p, r) for b in (False, True) for p in (False, True)
          for r in ("none", "pre_act", "post_act")]
_PATHS = {  # conv kwargs, x shape, w shape, output shape
    "dense": (dict(), (2, 7, 8, 3), (3, 3, 3, 5), (2, 7, 8, 5)),
    "dense_s2": (dict(stride=2), (2, 9, 8, 3), (3, 3, 3, 5), (2, 5, 4, 5)),
    "dilated": (dict(dilation=2), (2, 9, 8, 3), (3, 3, 3, 5), (2, 9, 8, 5)),
    "transposed": (dict(stride=2, transposed=True, output_padding=1),
                   (2, 4, 5, 3), (3, 3, 3, 5), (2, 8, 10, 5)),
}


@pytest.mark.parametrize("path", list(_PATHS))
@pytest.mark.parametrize("bn,prelu,residual", _SPECS,
                         ids=lambda v: str(v))
def test_epilogue_grads_match_reference(path, bn, prelu, residual):
    kw, xs, ws, ys = _PATHS[path]
    rng = np.random.default_rng(len(path) + 3 * bn + 5 * prelu)
    x, w = _rand(rng, *xs), _rand(rng, *ws)
    spec_j, spec_t = (JSpec(bn=bn, prelu=prelu, residual=residual),
                      EpilogueSpec(bn=bn, prelu=prelu, residual=residual))
    ops = {}
    if bn:
        ops["scale"], ops["shift"] = _rand(rng, ys[-1]), _rand(rng, ys[-1])
    if prelu:   # a scalar slope without BN, per-channel with it
        ops["alpha"] = 0.3 * _rand(rng, ys[-1] if bn else 1)
    if residual != "none":
        ops["residual"] = _rand(rng, *ys)
    names = list(ops)

    def jloss(a, b, *vals):
        y = jconv2d(a, b, backend="xla", epilogue=spec_j,
                    **dict(zip(names, vals)), **kw)
        return jnp.sum(jnp.sin(y))

    want = jax.grad(jloss, argnums=tuple(range(2 + len(names))))(
        jnp.asarray(x), jnp.asarray(w), *(jnp.asarray(v)
                                          for v in ops.values()))
    prims = [torch.from_numpy(v).requires_grad_()
             for v in (x, w, *ops.values())]
    y = tconv2d(prims[0], prims[1], epilogue=spec_t,
                **dict(zip(names, prims[2:])), **kw)
    assert tuple(y.shape) == ys
    got = torch.autograd.grad(torch.sin(y).sum(), prims)
    for label, a, b in zip(["x", "w", *names], got, want):
        assert a.shape == b.shape, label
        _close(a, b, _TOL)


def test_fused_epilogue_backward_recomputes_through_the_plain_conv(
        monkeypatch):
    """The fused conv's backward recomputes its pre-epilogue output with
    one more epilogue-free call (nothing is saved from the forward), then
    one dx call; the conv with no epilogue needs only the dx call."""
    calls = []
    plain = kconv.conv2d_plain

    def counting(x, w, stride, pads, spec, eps):
        calls.append(spec.empty)
        return plain(x, w, stride, pads, spec, eps)

    monkeypatch.setattr(kconv, "conv2d_plain", counting)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_rand(rng, 1, 6, 6, 4)).requires_grad_()
    w = torch.from_numpy(_rand(rng, 3, 3, 4, 4)).requires_grad_()
    spec = EpilogueSpec(bn=True, prelu=True)
    y = tconv2d(x, w, epilogue=spec, scale=torch.ones(4), shift=torch.zeros(4),
                alpha=torch.full((1,), 0.25))
    assert calls == [False]
    torch.autograd.grad(y.sum(), (x, w))
    assert calls == [False, True, True]
    calls.clear()
    y = tconv2d(x, w)
    torch.autograd.grad(y.sum(), (x, w))
    assert calls == [True, True]


def test_serving_path_builds_no_graph():
    """Under ``torch.no_grad()`` (and for inputs that need no gradient) the
    wrappers call the kernel path directly: the output has no grad_fn."""
    x = torch.randn(1, 6, 6, 4)
    w = torch.randn(3, 3, 4, 4, requires_grad=True)
    with torch.no_grad():
        assert tconv2d(x, w).grad_fn is None
    assert tconv2d(x, w.detach()).grad_fn is None
    assert tconv2d(x, w).grad_fn is not None
