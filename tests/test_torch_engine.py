"""The port's ``conv2d`` (``repro_torch``) against the JAX reference.

The same numpy inputs go through ``repro.core.decompose.conv2d`` with
``backend="xla"`` (the reference's plain path, to which its own Pallas
backend is pinned at 1e-5) and through the port's ``conv2d`` on both of its
backends: ``"torch"`` (plain ``F.conv2d`` compositions) and ``"kernels"``,
which on CPU tensors runs the CUDA kernels' plain versions.  Grids:

* the dense / dilated / strided-dilated / transposed grids of
  ``tests/test_general_engine.py``, at its bar (rtol = atol = 1e-4);
* the 48 seeded transposed geometries of
  ``tests/test_transposed_property.py`` (``_draw_cases`` copied with its
  seed), at 1e-5;
* every epilogue spec on each engine, at 1e-5;
* the naive zero-laden paths.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import transposed as jtr
from repro.core.decompose import conv2d as jconv2d
from repro.kernels import ref as jref
from repro.kernels.epilogue import EpilogueSpec as JSpec
from repro.kernels.epilogue import fingerprint as jfingerprint
from repro_torch.core import transposed as ttr
from repro_torch.core.decompose import conv2d as tconv2d
from repro_torch.kernels import ref as tref
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.kernels.epilogue import (EpilogueSpec, fingerprint,
                                          kernel_operands)

BACKENDS = ("torch", "kernels")


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(x, w, **kw):
    return np.asarray(jconv2d(jnp.asarray(x), jnp.asarray(w), backend="xla",
                              **kw))


def _port(x, w, **kw):
    return tconv2d(torch.from_numpy(x), torch.from_numpy(w), **kw).numpy()


def _check(x, w, backend, tol=1e-4, **kw):
    ref = _jax(x, w, **kw)
    got = _port(x, w, backend=backend, **kw)
    assert got.shape == ref.shape
    assert_allclose(got, ref, rtol=tol, atol=tol)


# ------------------------------------- grids of test_general_engine.py ---

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k", [2, 3, 4, 5])
@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("output_padding", [0, 1])
def test_tconv_general(k, s, output_padding, backend):
    x, w = _arrays(k * 16 + s, (1, 6, 7, 3), (k, k, 3, 5))
    _check(x, w, backend, stride=s, transposed=True, padding=(k - 1) // 2,
           output_padding=output_padding)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("h,w", [(5, 5), (8, 6), (9, 13)])
def test_tconv_odd_even_sizes(h, w, backend):
    x, wt = _arrays(h * w, (2, h, w, 4), (3, 3, 4, 4))
    _check(x, wt, backend, stride=3, transposed=True, output_padding=0)


@pytest.mark.parametrize("backend,strategy", [("torch", "ragged"),
                                              ("torch", "batched"),
                                              ("kernels", "batched")])
@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_strided_dilated(d, s, backend, strategy):
    x, w = _arrays(d * 10 + s, (2, 13, 11, 3), (3, 3, 3, 4))
    _check(x, w, backend, stride=s, dilation=d, strategy=strategy)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("d,s", [(2, 2), (4, 2), (3, 2), (2, 3), (6, 4)])
def test_strided_dilated_kernel_grid(d, s, backend):
    x, w = _arrays(d + s, (1, 12, 10, 4), (3, 3, 4, 4))
    _check(x, w, backend, stride=s, dilation=d)


@pytest.mark.parametrize("backend,strategy", [("torch", "ragged"),
                                              ("torch", "batched"),
                                              ("kernels", "batched")])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 16])
def test_dilated_stride1(d, backend, strategy):
    """Phase-batched with pad-up rows (13 and 11 are not multiples of d)."""
    x, w = _arrays(d, (2, 13, 11, 3), (3, 3, 3, 5))
    _check(x, w, backend, dilation=d, strategy=strategy)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k,s", [(2, 2), (3, 3), (4, 2), (5, 4)])
def test_dispatcher_transposed_general(k, s, backend):
    x, w = _arrays(k + s, (1, 6, 6, 2), (k, k, 2, 3))
    _check(x, w, backend, stride=s, transposed=True, output_padding=1)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("d,s", [(2, 2), (3, 2), (4, 3), (5, 4)])
def test_dispatcher_strided_dilated(d, s, backend):
    x, w = _arrays(d * s, (1, 14, 14, 2), (3, 3, 2, 2))
    _check(x, w, backend, stride=s, dilation=d)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("h,w", [(1, 1), (2, 1), (1, 5)])
def test_dense_tiny_inputs(h, w, backend):
    """Phase blocks shrink to 1x1 (ENet d=16 on 16x16 maps)."""
    x, wt = _arrays(h * 10 + w, (2, h, w, 4), (3, 3, 4, 4))
    _check(x, wt, backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kh,kw,stride,padding", [
    (5, 1, 1, None), (1, 5, 1, None), (2, 2, 1, None), (4, 4, 1, None),
    (2, 2, 2, 0), (3, 3, 2, None), (3, 3, 2, 1), (1, 1, 1, None),
    (3, 3, 3, 0)])
def test_dense_geometries(kh, kw, stride, padding, backend):
    """Rectangular 5x1/1x5, SAME-even (asymmetric pads), strided, int pads."""
    x, w = _arrays(kh * 7 + kw + stride, (2, 11, 10, 3), (kh, kw, 3, 13))
    _check(x, w, backend, stride=stride, padding=padding)


# ---------------------- seeded geometries of test_transposed_property.py ---

_RNG_SEED = 20240731
_CHANNELS = (1, 2, 3, 5, 6, 7, 9, 11, 13)


def _draw_cases(n: int, seed: int = _RNG_SEED) -> list[tuple]:
    """Copy of the reference test's draw: the same 48 geometries."""
    rng = np.random.default_rng(seed)
    cases = []
    while len(cases) < n:
        k = int(rng.integers(2, 6))
        s = int(rng.integers(2, 5))
        p_lo = int(rng.integers(0, k))
        op = int(rng.integers(0, s))
        h = int(rng.integers(2, 14))
        w = int(rng.integers(2, 14))
        cin = int(rng.choice(_CHANNELS))
        cout = int(rng.choice(_CHANNELS))
        oh = jtr.out_size(h, s, k, p_lo, p_lo + op)
        ow = jtr.out_size(w, s, k, p_lo, p_lo + op)
        if oh <= 0 or ow <= 0:
            continue
        cases.append((h, w, cin, cout, k, s, p_lo, op))
    return cases


_CASES = _draw_cases(48)


@functools.lru_cache(maxsize=None)
def _property_case(case):
    h, w, cin, cout, k, s, p_lo, op = case
    x, wt = _arrays(abs(hash(case)) % 2**32, (2, h, w, cin), (k, k, cin, cout))
    ref = _jax(x, wt, stride=s, transposed=True, padding=p_lo,
               output_padding=op)
    return x, wt, ref


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", _CASES,
                         ids=lambda c: "h{}w{}c{}x{}k{}s{}p{}op{}".format(*c))
def test_property_geometries(case, backend):
    h, w, cin, cout, k, s, p_lo, op = case
    x, wt, ref = _property_case(case)
    got = _port(x, wt, backend=backend, stride=s, transposed=True,
                padding=p_lo, output_padding=op)
    assert got.shape == ref.shape
    assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_property_geometries_include_zero_planes():
    """The draw covers k < s (parities with no live tap) and p_lo >= s."""
    assert any(k < s for _, _, _, _, k, s, _, _ in _CASES)
    assert any(p >= s for _, _, _, _, _, s, p, _ in _CASES)


# ------------------------------------------------------- epilogue specs ---

_SPECS = [(bn, prelu, res) for bn in (False, True) for prelu in (False, True)
          for res in ("none", "pre_act", "post_act")]
_ENGINES = {
    "dense": dict(xs=(2, 9, 8, 5), ws=(3, 3, 5, 7), kw={}),
    "dense_s2": dict(xs=(2, 9, 8, 5), ws=(2, 2, 5, 7),
                     kw=dict(stride=2, padding=0)),
    "dilated": dict(xs=(2, 9, 8, 5), ws=(3, 3, 5, 7), kw=dict(dilation=2)),
    "dilated_strided": dict(xs=(2, 9, 8, 5), ws=(3, 3, 5, 7),
                            kw=dict(dilation=3, stride=2)),
    "transposed": dict(xs=(2, 5, 4, 5), ws=(3, 3, 5, 7),
                       kw=dict(stride=2, transposed=True, output_padding=1)),
    "transposed_k_lt_s": dict(xs=(2, 5, 4, 5), ws=(2, 2, 5, 7),
                              kw=dict(stride=3, transposed=True, padding=1)),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("engine", sorted(_ENGINES))
@pytest.mark.parametrize("bn,prelu,res", _SPECS)
def test_epilogue_specs(engine, bn, prelu, res, backend):
    e = _ENGINES[engine]
    x, w = _arrays(len(engine) + 3 * bn + 5 * prelu, e["xs"], e["ws"])
    out_shape = _jax(x, w, **e["kw"]).shape
    cout = out_shape[-1]
    rng = np.random.default_rng(7)
    ops = {}
    if bn:
        ops["scale"] = rng.standard_normal(cout).astype(np.float32)
        ops["shift"] = rng.standard_normal(cout).astype(np.float32)
    if prelu:   # per-channel slope with a pre_act residual, else scalar
        ops["alpha"] = rng.uniform(0.1, 0.4, cout if res == "pre_act" else 1
                                   ).astype(np.float32)
    if res != "none":
        ops["residual"] = rng.standard_normal(out_shape).astype(np.float32)
    ref = _jax(x, w, epilogue=JSpec(bn=bn, prelu=prelu, residual=res),
               **{k: jnp.asarray(v) for k, v in ops.items()}, **e["kw"])
    got = _port(x, w, backend=backend,
                epilogue=EpilogueSpec(bn=bn, prelu=prelu, residual=res),
                **{k: torch.from_numpy(v) for k, v in ops.items()},
                **e["kw"])
    assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ naive paths ---

@pytest.mark.parametrize("d,s", [(2, 1), (3, 1), (2, 2), (4, 3)])
def test_dilated_naive(d, s):
    x, w = _arrays(d * s, (2, 13, 11, 3), (3, 3, 3, 4))
    _check(x, w, "torch", stride=s, dilation=d, decomposed=False)


@pytest.mark.parametrize("k,s,op", [(3, 2, 1), (4, 2, 0), (2, 3, 1),
                                    (5, 4, 2)])
def test_transposed_naive(k, s, op):
    x, w = _arrays(k * s, (2, 5, 6, 3), (k, k, 3, 4))
    _check(x, w, "torch", stride=s, transposed=True, output_padding=op,
           decomposed=False)


def test_naive_equals_oracle_and_zero_insert():
    """Naive transposed conv == F.conv_transpose2d oracle; the explicit
    zero-inserted input matches the reference's."""
    x, w = _arrays(3, (1, 4, 5, 2), (3, 3, 2, 3))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert_allclose(ttr.transposed_conv2d_naive(xt, wt, 2, 1, 1).numpy(),
                    ttr.transposed_conv2d_reference(xt, wt, 2, 1, 1).numpy(),
                    rtol=1e-5, atol=1e-5)
    assert_allclose(ttr.zero_insert_input(xt, 3).numpy(),
                    np.asarray(jtr.zero_insert_input(jnp.asarray(x), 3)))


# -------------------------------------------------- schedules and guards ---

@pytest.mark.parametrize("k", [2, 3, 4, 5])
@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("p_lo", [0, 1, 2])
def test_parity_schedule_matches_reference(k, s, p_lo):
    from repro.kernels.transposed_conv import parity_schedule as jsched

    assert ktr.parity_schedule(k, s, p_lo) == jsched(k, s, p_lo)


def test_kernels_backend_rejects_naive_and_ragged():
    x, w = (torch.from_numpy(a) for a in _arrays(11, (1, 8, 8, 2),
                                                  (3, 3, 2, 2)))
    with pytest.raises(ValueError, match="naive execution has no kernel"):
        tconv2d(x, w, dilation=2, decomposed=False)
    with pytest.raises(ValueError, match="phase-batched only"):
        tconv2d(x, w, dilation=2, strategy="ragged")
    with pytest.raises(ValueError, match="unknown backend"):
        tconv2d(x, w, backend="pallas")


def test_epilogue_operands_must_match_spec():
    x, w = (torch.from_numpy(a) for a in _arrays(12, (1, 4, 4, 2),
                                                  (3, 3, 2, 2)))
    with pytest.raises(ValueError, match="requires operand 'scale'"):
        tconv2d(x, w, epilogue=EpilogueSpec(bn=True))
    with pytest.raises(ValueError, match="does not take operand 'alpha'"):
        tconv2d(x, w, alpha=torch.ones(1))
    with pytest.raises(ValueError, match="residual shape"):
        kernel_operands(EpilogueSpec(residual="pre_act"),
                        (torch.zeros(1, 3, 4, 2),), (1, 4, 4, 2),
                        torch.device("cpu"))


@pytest.mark.parametrize("bn,prelu,res", _SPECS)
def test_fingerprint_matches_reference(bn, prelu, res):
    assert fingerprint(EpilogueSpec(bn=bn, prelu=prelu, residual=res)) == \
        jfingerprint(JSpec(bn=bn, prelu=prelu, residual=res))
    assert fingerprint(None) == jfingerprint(None) == "none"


@pytest.mark.parametrize("oracle,kw", [
    ("conv2d_ref", dict(stride=1, padding="SAME")),
    ("conv2d_ref", dict(stride=2, padding=1)),
    ("conv2d_ref", dict(stride=1, padding="VALID")),
    ("dilated_conv2d_ref", dict(dilation=3)),
    ("transposed_conv2d_ref", dict(stride=2, padding=1, output_padding=1)),
    ("transposed_conv2d_ref", dict(stride=3, padding=0, output_padding=2))])
def test_oracles_match_reference(oracle, kw):
    """The port's plain oracles (``kernels/ref.py``) equal the reference's."""
    x, w = _arrays(len(oracle) + len(kw), (2, 9, 7, 3), (3, 3, 3, 4))
    want = np.asarray(getattr(jref, oracle)(jnp.asarray(x), jnp.asarray(w),
                                            **kw))
    got = getattr(tref, oracle)(torch.from_numpy(x), torch.from_numpy(w),
                                **kw).numpy()
    assert got.shape == want.shape
    assert_allclose(got, want, rtol=1e-5, atol=1e-5)
