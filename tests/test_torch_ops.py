"""The port's kernel entry points (``repro_torch.kernels.ops``) against the
JAX reference's ``repro.kernels.ops``.

The same numpy inputs (drawn from a seed) go through the reference's ops,
whose ``matmul`` and ``attention`` run their Pallas kernels in interpret
mode on the CPU as ``tests/test_kernels.py`` runs them, and through the
port's ops on CPU tensors, which run the CUDA kernels' plain versions.
Tolerances are ``tests/test_kernels.py``'s: matmul 1e-4 (fp32) and 3e-2
(bf16), attention 2e-4 (fp32) and 3e-2 (bf16).  Causal attention with
Sq != Sk is held to the reference's kernel (top-left mask), not to its
``ref.attention_ref`` (bottom-right mask, NaN rows when Sq > Sk), which the
port's ``ref.attention_ref`` copies and is held to separately.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.epilogue import EpilogueSpec as JSpec
from repro.kernels.epilogue import apply_reference as japply
from repro.kernels.epilogue import pack_args as jpack
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.epilogue import EpilogueSpec

_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrs, dtype="fp32"):
    """The same arrays as JAX and torch inputs of ``dtype`` (both round
    fp32 to bf16 to nearest even, so the inputs are bitwise equal)."""
    return ([jnp.asarray(a, _JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(_TDT[dtype]) for a in arrs])


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ---------------------------------------------------------------- matmul ---

@pytest.mark.parametrize("mnk", [(16, 16, 16), (128, 128, 128),
                                 (100, 60, 36), (256, 512, 128), (1, 128, 7)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_matmul_matches_jax(mnk, dtype):
    m, n, k = mnk
    (ja, jb), (ta, tb) = _both(_arrays(m + n + k, (m, k), (k, n)), dtype)
    want = jops.matmul(ja, jb)
    got = ops.matmul(ta, tb)
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == want.shape
    tol = 3e-2 if dtype == "bf16" else 1e-4
    assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_matmul_mixed_dtypes_match_jax():
    """bf16 @ fp32 is computed in fp32 and cast to a's dtype (bf16)."""
    a, b = _arrays(7, (37, 50), (50, 29))
    want = jops.matmul(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b))
    got = ops.matmul(torch.from_numpy(a).to(torch.bfloat16),
                     torch.from_numpy(b))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert_allclose(_np(got), _np(want), rtol=3e-2, atol=3e-2)


def test_matmul_ref_matches_jax_ref():
    (ja, jb), (ta, tb) = _both(_arrays(3, (33, 65), (65, 17)), "bf16")
    assert_allclose(_np(ref.matmul_ref(ta, tb)), _np(jref.matmul_ref(ja, jb)),
                    rtol=3e-2, atol=3e-2)


# ------------------------------------------------------------- attention ---

@pytest.mark.parametrize("shape", [(1, 2, 128, 64), (2, 4, 100, 32),
                                   (1, 1, 257, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_jax(shape, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays(shape[2], shape, shape, shape))
    want = jops.attention(jq, jk, jv, causal=causal)
    got = ops.attention(tq, tk, tv, causal=causal)
    assert tuple(got.shape) == want.shape
    assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_attention_bf16_matches_jax():
    shape = (1, 2, 64, 64)
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays(0, shape, shape, shape),
                                       "bf16")
    got = ops.attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    assert_allclose(_np(got), _np(jops.attention(jq, jk, jv)), rtol=3e-2,
                    atol=3e-2)


@pytest.mark.parametrize("sq,sk", [(64, 96), (96, 64), (1, 70), (33, 1)])
def test_attention_causal_unequal_lengths_follow_jax_kernel(sq, sk):
    """Top-left causal mask, finite everywhere, as the reference kernel."""
    qs, ks = (1, 2, sq, 16), (1, 2, sk, 16)
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays(sq * sk, qs, ks, ks))
    want = jops.attention(jq, jk, jv, causal=True)
    got = ops.attention(tq, tk, tv, causal=True)
    assert bool(torch.isfinite(got).all())
    assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sq,sk", [(64, 96), (96, 64), (100, 100)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax_ref(sq, sk, causal):
    """The port's oracle copies the reference's: bottom-right causal mask,
    NaN rows where Sq > Sk."""
    qs, ks = (2, 2, sq, 32), (2, 2, sk, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays(sq + sk, qs, ks, ks))
    want = _np(jref.attention_ref(jq, jk, jv, causal=causal))
    got = _np(ops.attention_ref(tq, tk, tv, causal=causal))
    assert np.isnan(got).any() == (causal and sq > sk)
    assert_allclose(got, want, rtol=2e-4, atol=2e-4, equal_nan=True)


def test_attention_and_ref_differ_only_off_square():
    """Sq == Sk: the two masks agree; Sq < Sk: they do not."""
    for (sq, sk), agree in (((48, 48), True), ((32, 80), False)):
        q, k, v = (torch.from_numpy(a) for a in _arrays(
            sq, (1, 2, sq, 16), (1, 2, sk, 16), (1, 2, sk, 16)))
        err = (ops.attention(q, k, v) - ops.attention_ref(q, k, v)).abs()
        assert (err.max().item() < 1e-5) == agree


# ------------------------------------------------------------ conv ops ---

@pytest.mark.parametrize("xs,ws,stride,padding", [
    ((2, 17, 13, 3), (3, 3, 3, 5), 1, "SAME"),
    ((1, 16, 16, 4), (2, 2, 4, 8), 2, "VALID"),
    ((2, 12, 20, 3), (5, 1, 3, 7), 1, "SAME"),
    ((1, 15, 15, 8), (3, 3, 8, 13), 2, 1)])
def test_conv2d_op_matches_jax_ref(xs, ws, stride, padding):
    x, w = _arrays(xs[1] * ws[0], xs, ws)
    want = jops.conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride=stride,
                           padding=padding)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                     padding=padding)
    assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_conv2d_op_epilogue_matches_jax_ref():
    x, w, scale, shift, alpha, res = _arrays(
        11, (2, 9, 10, 6), (3, 3, 6, 8), (8,), (8,), (8,), (2, 9, 10, 8))
    jspec = JSpec(bn=True, prelu=True, residual="pre_act")
    want = japply(jspec, jops.conv2d_ref(jnp.asarray(x), jnp.asarray(w)),
                  jpack(jspec, scale=jnp.asarray(scale),
                        shift=jnp.asarray(shift), alpha=jnp.asarray(alpha),
                        residual=jnp.asarray(res)))
    t = torch.from_numpy
    got = ops.conv2d(t(x), t(w),
                     epilogue=EpilogueSpec(bn=True, prelu=True,
                                           residual="pre_act"),
                     scale=t(scale), shift=t(shift), alpha=t(alpha),
                     residual=t(res))
    assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d,stride", [(2, 1), (4, 1), (3, 2)])
def test_dilated_conv2d_op_matches_jax(d, stride):
    from repro.core.dilated import dilated_conv2d_reference

    x, w = _arrays(d * 10 + stride, (1, 18, 14, 4), (3, 3, 4, 6))
    want = dilated_conv2d_reference(jnp.asarray(x), jnp.asarray(w), d,
                                    stride)
    got = ops.dilated_conv2d(torch.from_numpy(x), torch.from_numpy(w), d,
                             stride=stride)
    assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    if stride == 1:
        assert_allclose(_np(ops.dilated_conv2d_ref(torch.from_numpy(x),
                                                   torch.from_numpy(w), d)),
                        _np(jops.dilated_conv2d_ref(jnp.asarray(x),
                                                    jnp.asarray(w), d)),
                        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,s,p,op", [(3, 2, 1, 1), (4, 2, 2, 0),
                                      (2, 3, 1, 0)])
def test_transposed_conv2d_op_matches_jax_ref(k, s, p, op):
    x, w = _arrays(k * s, (2, 7, 9, 5), (k, k, 5, 6))
    want = jops.transposed_conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                      stride=s, padding=p,
                                      output_padding=op)
    got = ops.transposed_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                stride=s, padding=p, output_padding=op)
    assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------- shape checks ---

_BAD = {
    "conv2d channels": ("conv2d", lambda z: (z(1, 4, 4, 2), z(3, 3, 3, 2)),
                        {}),
    "conv2d rank": ("conv2d", lambda z: (z(4, 4, 2), z(3, 3, 2, 2)), {}),
    "dilated non-square": ("dilated_conv2d",
                           lambda z: (z(1, 8, 8, 2), z(3, 1, 2, 2), 2), {}),
    "transposed channels": ("transposed_conv2d",
                            lambda z: (z(1, 4, 4, 2), z(3, 3, 4, 2)), {}),
    "transposed non-square": ("transposed_conv2d",
                              lambda z: (z(1, 4, 4, 2), z(3, 2, 2, 2)), {}),
    "matmul inner": ("matmul", lambda z: (z(3, 4), z(5, 6)), {}),
    "attention head dim": ("attention", lambda z: (
        z(1, 2, 8, 16), z(1, 2, 8, 32), z(1, 2, 8, 16)), {}),
    "attention kv heads": ("attention", lambda z: (
        z(1, 2, 8, 16), z(1, 2, 8, 16), z(1, 1, 8, 16)), {}),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_ops_shape_checks_match_jax(case):
    name, make, kw = _BAD[case]
    with pytest.raises(ValueError) as jerr:
        getattr(jops, name)(*make(lambda *s: jnp.zeros(s)), **kw)
    with pytest.raises(ValueError) as terr:
        getattr(ops, name)(*make(lambda *s: torch.zeros(s)), **kw)
    assert str(terr.value) == str(jerr.value)


def test_attention_rejects_gqa():
    """q and k with different head counts: the reference cannot take it
    either (its wrapper reshapes k with q's head count)."""
    q, k = torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="head count"):
        ops.attention(q, k, k)


def test_ref_aliases():
    assert ops.matmul_ref is ref.matmul_ref
    assert ops.attention_ref is ref.attention_ref
    assert ops.conv2d_ref is ref.conv2d_ref
    assert ops.dilated_conv2d_ref is ref.dilated_conv2d_ref
    assert ops.transposed_conv2d_ref is ref.transposed_conv2d_ref
