"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc; without them each one skips.  On a
machine with the card (which has no JAX, hence ``--noconftest``)::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

fp32 on both sides with TF32 off; only the summation order differs, so
``max |kernel - plain| <= 1e-4 * max(1, max |plain|)``.
"""

import pytest
import torch

from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.kernels.epilogue import EpilogueSpec

pytestmark = pytest.mark.cuda

_SPECS = [EpilogueSpec(), EpilogueSpec(bn=True, prelu=True),
          EpilogueSpec(bn=True, prelu=True, residual="pre_act"),
          EpilogueSpec(bn=True, residual="post_act")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ops(spec, out_shape, g, dev):
    cout = out_shape[-1]
    kw = {}
    if spec.bn:
        kw.update(scale=torch.randn(cout, generator=g).to(dev),
                  shift=torch.randn(cout, generator=g).to(dev))
    if spec.prelu:
        kw["alpha"] = torch.rand(cout, generator=g).to(dev)
    if spec.residual != "none":
        kw["residual"] = torch.randn(out_shape, generator=g).to(dev)
    return tuple(kw[s] for s in spec.slots)


def _close(got, want):
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("spec", _SPECS, ids=str)
@pytest.mark.parametrize("xs,ws,stride,pads", [
    ((2, 33, 31, 3), (3, 3, 3, 13), 2, ((1, 1), (1, 1))),
    ((2, 16, 16, 64), (2, 2, 64, 16), 2, ((0, 0), (0, 0))),
    ((2, 16, 15, 32), (5, 1, 32, 32), 1, ((2, 2), (0, 0))),
    ((2, 16, 15, 32), (1, 5, 32, 32), 1, ((0, 0), (2, 2))),
    ((3, 9, 10, 128), (1, 1, 128, 32), 1, ((0, 0), (0, 0))),
    ((2, 9, 10, 24), (4, 4, 24, 70), 1, ((1, 2), (1, 2)))])
def test_conv2d_kernel_matches_plain(cuda, xs, ws, stride, pads, spec):
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(xs, generator=g).to(cuda), \
        torch.randn(ws, generator=g).to(cuda)
    oh = kconv.out_extent(xs[1], ws[0], stride, *pads[0])
    ow = kconv.out_extent(xs[2], ws[1], stride, *pads[1])
    eps = _ops(spec, (xs[0], oh, ow, ws[3]), g, cuda)
    got = kconv.conv2d_cuda(x, w, stride, pads, spec, eps)
    torch.cuda.synchronize()
    _close(got, kconv.conv2d_plain(x, w, stride, pads, spec, eps))


@pytest.mark.parametrize("spec", _SPECS, ids=str)
@pytest.mark.parametrize("xs,k,cout,s,p_lo,op", [
    ((2, 16, 16, 16), 3, 16, 2, 1, 1), ((2, 16, 16, 16), 3, 19, 2, 1, 1),
    ((2, 7, 9, 8), 4, 12, 2, 2, 0), ((2, 7, 9, 8), 2, 12, 2, 0, 0),
    ((2, 7, 9, 8), 2, 12, 3, 1, 0), ((1, 5, 6, 4), 5, 70, 3, 2, 2)])
def test_tconv_kernel_matches_plain(cuda, xs, k, cout, s, p_lo, op, spec):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(xs, generator=g).to(cuda)
    w = torch.randn((k, k, xs[3], cout), generator=g).to(cuda)
    oh = (xs[1] - 1) * s + 2 * p_lo + op - k + 2
    ow = (xs[2] - 1) * s + 2 * p_lo + op - k + 2
    eps = _ops(spec, (xs[0], oh, ow, cout), g, cuda)
    got = ktr.tconv_cuda(x, w, s, p_lo, p_lo + op, spec, eps)
    torch.cuda.synchronize()
    _close(got, ktr.tconv_plain(x, w, s, p_lo, p_lo + op, spec, eps))


def test_wrappers_count_launches(cuda):
    x = torch.randn(1, 8, 8, 4, device=cuda)
    w = torch.randn(3, 3, 4, 4, device=cuda)
    n0, t0 = kconv.conv2d.launches, ktr.transposed_conv2d.launches
    kconv.conv2d(x, w)
    ktr.transposed_conv2d(x, w, stride=2)
    assert (kconv.conv2d.launches, ktr.transposed_conv2d.launches) == \
        (n0 + 1, t0 + 1)
