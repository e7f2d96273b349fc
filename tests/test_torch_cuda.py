"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc; without them each one skips.  On a
machine with the card (which has no JAX, hence ``--noconftest``)::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

fp32 on both sides with TF32 off; only the summation order differs, so
``max |kernel - plain| <= 1e-4 * max(1, max |plain|)``.  With bf16 operands
the matmul and attention kernels compute in fp32 like their plain versions
and round once to bf16, where nearly equal sums may land one bf16 step
apart, so the bar there holds at every element:
``|kernel - plain| <= 2**-7 * |plain| + 1e-4 * max(1, max |plain|)``.
bf16 matmul and attention take the tensor-core (``wgmma``) variants where
the shapes allow; the edge shapes below reach them (ragged tiles, K not a
multiple of the 64-deep K step, Sq != Sk, Sq = 1, several heads).  The conv
cases reach every variant of ``conv_plan``: 4- and 16-byte input copies
(Cin 3 and 4), each Cout tile the dense kernel builds (Cout 4, 8, 13, 19,
32 and 70), streamed weights, the phase-batched dilated shapes, and the
transposed kernel's k3 s2 head with Cout 19, k4 s2 p_lo 2, k2 s3 (k < s)
and weights streamed per plane at the largest k of stride 2 (k16, Cout 24
and 32) and at k9 s3, each under every epilogue spec.  The backward cases
mirror ``chip_smoke.py`` phase 7: gradients through the kernels' autograd
Functions against ``backend="torch"`` autograd, per tensor
``max |err| <= 1e-4 * max(1, max |ref|)``.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.kernels.epilogue import EpilogueSpec

pytestmark = pytest.mark.cuda

_SPECS = [EpilogueSpec(), EpilogueSpec(bn=True, prelu=True),
          EpilogueSpec(bn=True, prelu=True, residual="pre_act"),
          EpilogueSpec(bn=True, residual="post_act")]
_ALL_SPECS = [EpilogueSpec(bn=b, prelu=p, residual=r)
              for b in (False, True) for p in (False, True)
              for r in ("none", "pre_act", "post_act")]


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
    assert got.dtype == want.dtype and got.shape == want.shape
    step = 0.0 if want.dtype == torch.float32 else 2.0 ** -7
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    mag = want.abs()
    bar = step * mag + 1e-4 * max(1.0, mag.max().item())
    err = (got - want).abs()
    assert bool((err <= bar).all()), (err / bar).max().item()


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


_SAME3 = ((1, 1), (1, 1))
_PLAN_CASES = [  # label, x shape, w shape, stride, pads, variant
    ("cin3", (2, 17, 19, 3), (3, 3, 3, 16), 1, _SAME3, "scalar-resident"),
    ("cin4", (2, 17, 19, 4), (3, 3, 4, 16), 1, _SAME3, "vec4-resident"),
    ("cout4", (2, 20, 18, 16), (1, 1, 16, 4), 1, ((0, 0), (0, 0)),
     "vec4-resident"),
    ("cout8", (2, 17, 19, 16), (3, 3, 16, 8), 1, _SAME3, "vec4-resident"),
    ("cout13 s2", (2, 33, 31, 3), (3, 3, 3, 13), 2, _SAME3,
     "scalar-resident"),
    ("cout19", (2, 16, 15, 16), (3, 3, 16, 19), 1, _SAME3, "vec4-resident"),
    ("cout70", (2, 9, 10, 12), (3, 3, 12, 70), 1, _SAME3, "vec4-resident"),
    ("streamed", (2, 9, 10, 128), (3, 3, 128, 64), 1, _SAME3,
     "vec4-streamed"),
    ("streamed cin3", (1, 20, 21, 3), (15, 15, 3, 20), 1, ((7, 7), (7, 7)),
     "scalar-streamed"),
    *[(f"phase batch {xs}", xs, (3, 3, 32, 32), 1, _SAME3, "vec4-resident")
      for xs in ((16, 8, 8, 32), (64, 4, 4, 32), (256, 2, 2, 32),
                 (1024, 1, 1, 32))]]


@pytest.mark.parametrize("spec", _ALL_SPECS, ids=str)
@pytest.mark.parametrize("case", _PLAN_CASES, ids=lambda c: c[0])
def test_conv2d_plan_variants_match_plain(cuda, case, spec):
    _, xs, ws, stride, pads, variant = case
    g = torch.Generator().manual_seed(xs[0] + ws[3])
    x, w = torch.randn(xs, generator=g).to(cuda), \
        torch.randn(ws, generator=g).to(cuda)
    oh = kconv.out_extent(xs[1], ws[0], stride, *pads[0])
    ow = kconv.out_extent(xs[2], ws[1], stride, *pads[1])
    eps = _ops(spec, (xs[0], oh, ow, ws[3]), g, cuda)
    assert kconv.conv_plan(xs[3], ws[3], ws[0], ws[1], stride).variant == \
        variant
    before = dict(kconv.conv2d.launches_by_variant)
    got = kconv.conv2d_cuda(x, w, stride, pads, spec, eps)
    torch.cuda.synchronize()
    after = kconv.conv2d.launches_by_variant
    assert {v: after[v] - before[v] for v in after} == \
        {v: int(v == variant) for v in after}
    _close(got, kconv.conv2d_plain(x, w, stride, pads, spec, eps))


@pytest.mark.parametrize("spec", _ALL_SPECS, ids=str)
@pytest.mark.parametrize("xs,k,cout,s,p_lo,op", [
    ((2, 16, 16, 16), 3, 19, 2, 1, 1), ((2, 7, 9, 8), 4, 12, 2, 2, 0),
    ((2, 7, 9, 8), 2, 12, 3, 1, 0), ((1, 6, 5, 3), 3, 5, 2, 1, 1),
    ((1, 6, 5, 4), 3, 4, 2, 1, 1), ((1, 5, 6, 20), 3, 40, 2, 1, 1),
    ((1, 9, 7, 16), 16, 32, 2, 7, 1), ((1, 9, 7, 20), 16, 24, 2, 8, 0),
    ((1, 6, 5, 8), 9, 19, 3, 4, 2)])
def test_tconv_plan_variants_match_plain(cuda, xs, k, cout, s, p_lo, op,
                                         spec):
    g = torch.Generator().manual_seed(xs[3] + cout)
    x = torch.randn(xs, generator=g).to(cuda)
    w = torch.randn((k, k, xs[3], cout), generator=g).to(cuda)
    oh = (xs[1] - 1) * s + 2 * p_lo + op - k + 2
    ow = (xs[2] - 1) * s + 2 * p_lo + op - k + 2
    eps = _ops(spec, (xs[0], oh, ow, cout), g, cuda)
    got = ktr.tconv_cuda(x, w, s, p_lo, p_lo + op, spec, eps)
    torch.cuda.synchronize()
    _close(got, ktr.tconv_plain(x, w, s, p_lo, p_lo + op, spec, eps))


def test_unaligned_input_takes_the_scalar_copies(cuda):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2 * 9 * 10 * 8 + 1, generator=g).to(cuda)[1:].view(
        2, 9, 10, 8)
    w = torch.randn((3, 3, 8, 16), generator=g).to(cuda)
    before = kconv.conv2d.launches_by_variant["scalar-resident"]
    got = kconv.conv2d_cuda(x, w, 1, _SAME3, EpilogueSpec(), ())
    torch.cuda.synchronize()
    assert kconv.conv2d.launches_by_variant["scalar-resident"] == before + 1
    _close(got, kconv.conv2d_plain(x, w, 1, _SAME3, EpilogueSpec(), ()))


def test_wrappers_count_launches(cuda):
    x = torch.randn(1, 8, 8, 4, device=cuda)
    w = torch.randn(3, 3, 4, 4, device=cuda)
    n0, t0 = kconv.conv2d.launches, ktr.transposed_conv2d.launches
    kconv.conv2d(x, w)
    ktr.transposed_conv2d(x, w, stride=2)
    assert (kconv.conv2d.launches, ktr.transposed_conv2d.launches) == \
        (n0 + 1, t0 + 1)


_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("mnk", [(1, 128, 7), (100, 60, 36), (16, 16, 16),
                                 (256, 512, 128), (4097, 33, 65),
                                 (130, 129, 0), (4097, 2056, 2048),
                                 (1, 128, 2048), (300, 200, 64),
                                 (100, 64, 72), (130, 264, 8)])
def test_matmul_kernel_matches_plain(cuda, mnk, dtype):
    m, n, k = mnk
    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randn((m, k), generator=g).to(cuda, dtype)
    b = torch.randn((k, n), generator=g).to(cuda, dtype)
    got = kmm.matmul_cuda(a, b)
    torch.cuda.synchronize()
    _close(got, kmm.matmul_plain(a, b))


@pytest.mark.parametrize("da,db", [(torch.bfloat16, torch.float32),
                                   (torch.float32, torch.bfloat16)])
def test_matmul_kernel_mixed_dtypes(cuda, da, db):
    g = torch.Generator().manual_seed(5)
    a = torch.randn((70, 90), generator=g).to(cuda, da)
    b = torch.randn((90, 130), generator=g).to(cuda, db)
    got = kmm.matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert got.dtype == da
    _close(got, kmm.matmul_plain(a, b))


_ATTN = [  # q shape, kv length, causal
    ((1, 2, 128, 64), 128, True), ((1, 2, 128, 64), 128, False),
    ((2, 4, 100, 32), 100, True), ((2, 4, 100, 32), 100, False),
    ((1, 1, 257, 64), 257, True), ((1, 1, 257, 64), 257, False),
    ((1, 2, 64, 64), 96, True), ((1, 2, 96, 64), 64, True),
    ((2, 2, 1, 64), 70, True), ((1, 3, 77, 16), 77, True),
    ((1, 2, 130, 128), 200, True), ((1, 2, 70, 256), 130, False),
    ((1, 2, 70, 256), 70, True), ((1, 1, 33, 48), 65, True),
    ((2, 3, 300, 64), 300, True), ((2, 3, 300, 64), 300, False),
    ((2, 2, 64, 128), 96, True), ((2, 2, 96, 128), 64, False),
    ((2, 2, 1, 128), 300, True), ((1, 2, 4097, 64), 4097, True),
    ((1, 2, 4097, 128), 200, True), ((1, 2, 200, 128), 4097, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("qs,sk,causal", _ATTN)
def test_flash_attention_kernel_matches_plain(cuda, qs, sk, causal, dtype):
    g = torch.Generator().manual_seed(qs[2] * sk)
    ks = qs[:2] + (sk, qs[3])
    q = torch.randn(qs, generator=g).to(cuda, dtype)
    k = torch.randn(ks, generator=g).to(cuda, dtype)
    v = torch.randn(ks, generator=g).to(cuda, dtype)
    got = kfa.flash_attention_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    _close(got, kfa.attention_plain(q, k, v, causal=causal))


def test_flash_attention_kernel_mixed_dtypes(cuda):
    g = torch.Generator().manual_seed(9)
    q = torch.randn((1, 2, 50, 32), generator=g).to(cuda, torch.bfloat16)
    k = torch.randn((1, 2, 60, 32), generator=g).to(cuda)
    v = torch.randn((1, 2, 60, 32), generator=g).to(cuda, torch.bfloat16)
    got = kfa.flash_attention_cuda(q, k, v, True)
    torch.cuda.synchronize()
    _close(got, kfa.attention_plain(q, k, v))


def test_ops_count_matmul_and_attention_launches(cuda):
    a = torch.randn(64, 32, device=cuda)
    q = torch.randn(1, 2, 40, 16, device=cuda)
    m0, f0 = kmm.matmul.launches, kfa.flash_attention.launches
    ops.matmul(a, a.t())
    ops.attention(q, q, q)
    ops.attention(q, q, q, causal=False)
    torch.cuda.synchronize()
    assert (kmm.matmul.launches, kfa.flash_attention.launches) == \
        (m0 + 1, f0 + 2)


@pytest.mark.parametrize("variant,shapes", [
    ("wgmma", ((256, 128), (128, 264))), ("simt", ((256, 7), (7, 264)))])
def test_matmul_counts_launches_by_variant(cuda, variant, shapes):
    a = torch.randn(shapes[0], device=cuda).bfloat16()
    b = torch.randn(shapes[1], device=cuda).bfloat16()
    assert kmm.matmul_variant(a, b) == variant
    before = dict(kmm.matmul.launches_by_variant)
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    after = kmm.matmul.launches_by_variant
    assert {v: after[v] - before[v] for v in after} == \
        {v: int(v == variant) for v in after}
    _close(got, kmm.matmul_plain(a, b))


@pytest.mark.parametrize("variant,dh", [("wgmma", 128), ("simt", 32)])
def test_attention_counts_launches_by_variant(cuda, variant, dh):
    q, k, v = (torch.randn(1, 2, 150, dh, device=cuda).bfloat16()
               for _ in range(3))
    assert kfa.attention_variant(q, k, v) == variant
    before = dict(kfa.flash_attention.launches_by_variant)
    got = ops.attention(q, k, v)
    torch.cuda.synchronize()
    after = kfa.flash_attention.launches_by_variant
    assert {v: after[v] - before[v] for v in after} == \
        {v: int(v == variant) for v in after}
    _close(got, kfa.attention_plain(q, k, v))


def test_wgmma_variants_refuse_what_tma_cannot_take(cuda):
    """The C entries check alignment themselves: an unaligned base handed
    to the wgmma variant is refused at launch, not read wrongly."""
    a = torch.randn(64 * 64 + 8, device=cuda).bfloat16()[1:4097].view(64, 64)
    b = torch.randn(64, 64, device=cuda).bfloat16()
    out = torch.empty(64, 64, device=cuda, dtype=torch.bfloat16)
    lib, fn = kmm._matmul_fn()
    code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), 64, 64, 64, 1,
              kmm.VARIANTS["wgmma"], torch.cuda.current_stream().cuda_stream)
    assert code != 0
    assert b"invalid argument" in lib.matmul_error_string(code)


# Kernel 3's batched form (the MoE experts): Qwen3-MoE's expert products at
# a prefill's 320 capacity rows and at decode's 1, Llama-4's E = 16 at
# narrow widths, a ragged M, and K = 36, which takes "simt" in bf16 too.
_BATCHED = [(128, 320, 2048, 768), (128, 320, 768, 2048), (128, 1, 2048, 768),
            (128, 1, 768, 2048), (16, 40, 72, 24), (1, 130, 64, 264),
            (3, 130, 36, 40)]   # E, M, K, N


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("emkn", _BATCHED, ids=str)
def test_matmul_batched_matches_plain(cuda, emkn, dtype):
    e, m, k, n = emkn
    g = torch.Generator().manual_seed(e + m + k + n)
    a = torch.randn((e, m, k), generator=g).to(cuda, dtype)
    b = torch.randn((e, k, n), generator=g).to(cuda, dtype)
    want_v = ("wgmma" if dtype == torch.bfloat16 and k % 8 == 0
              and n % 8 == 0 else "simt")
    assert kmm.matmul_variant(a, b) == want_v
    before = (kmm.matmul.launches_batched, kmm.matmul.launches,
              dict(kmm.matmul.launches_by_variant))
    got = kmm.matmul_batched(a, b)
    torch.cuda.synchronize()
    after = kmm.matmul.launches_by_variant
    assert (kmm.matmul.launches_batched, kmm.matmul.launches) == \
        (before[0] + 1, before[1] + 1)
    assert {v: after[v] - before[2][v] for v in after} == \
        {v: int(v == want_v) for v in after}
    _close(got, kmm.matmul_batched_plain(a, b))


@pytest.mark.parametrize("variant", ["simt", "wgmma"])
def test_matmul_batched_writes_no_row_past_m(cuda, variant):
    """M = 70 is no multiple of either variant's tile: each expert's last
    tile holds rows past M, which must not reach the next expert's rows
    (nor, for the last expert, the memory after the output)."""
    e, m, k, n = 4, 70, 64, 64
    g = torch.Generator().manual_seed(70)
    a = torch.randn((e, m, k), generator=g).to(cuda, torch.bfloat16)
    b = torch.randn((e, k, n), generator=g).to(cuda, torch.bfloat16)
    buf = torch.full(((e + 1) * m * n,), float("nan"), device=cuda,
                     dtype=torch.bfloat16)
    lib, fn = kmm._matmul_fn("matmul_batched_fwd")
    code = fn(a.data_ptr(), b.data_ptr(), buf.data_ptr(), e, m, n, k, 1,
              kmm.VARIANTS[variant], torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert code == 0
    _close(buf[:e * m * n].view(e, m, n), kmm.matmul_batched_plain(a, b))
    assert bool(torch.isnan(buf[e * m * n:]).all())


# ------------------------------------------------------------- backward
# The backward edge cases of chip_smoke.py phase 7: gradients through the
# kernels' autograd Functions against ``backend="torch"`` autograd (cuDNN,
# TF32 off), per tensor max |err| <= 1e-4 * max(1, max |ref|).

_TCONV = dict(stride=2, transposed=True, output_padding=1)
_GRAD_CASES = [  # label, conv kwargs, x shape, w shape, kernel launched
    ("k2s2p0", dict(stride=2, padding=0), (2, 32, 30, 16), (2, 2, 16, 32),
     "transposed_conv2d"),
    ("k3s2same", dict(stride=2), (2, 33, 31, 16), (3, 3, 16, 24),
     "transposed_conv2d"),
    ("k4s2p1", dict(stride=2, padding=1), (2, 32, 30, 8), (4, 4, 8, 20),
     "transposed_conv2d"),
    ("5x1", {}, (2, 21, 19, 32), (5, 1, 32, 32), "conv2d"),
    ("1x5", {}, (2, 21, 19, 32), (1, 5, 32, 32), "conv2d"),
    ("tconv_k3s2op1_cout19", _TCONV, (2, 16, 16, 16), (3, 3, 16, 19),
     "conv2d"),
    ("dilated_d2s2", dict(dilation=2, stride=2), (2, 24, 22, 16),
     (3, 3, 16, 16), "conv2d"),
    ("dilated_d2", dict(dilation=2), (2, 25, 23, 16), (3, 3, 16, 16),
     "conv2d"),
    ("dilated_d4", dict(dilation=4), (2, 45, 38, 32), (3, 3, 32, 32),
     "conv2d")]


def _grads_both_backends(cuda, kw, xs, ws, spec, seed):
    from repro_torch.core.decompose import conv2d

    g = torch.Generator().manual_seed(seed)
    # He-scaled weights keep y O(1), so sin' does not amplify the
    # forward's fp32 rounding (as chip_smoke.py phase 7)
    x = torch.randn(xs, generator=g).to(cuda)
    w = torch.randn(ws, generator=g).to(cuda) * (ws[0] * ws[1] * ws[2]) ** -0.5
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        cout = conv2d(x, w, backend="torch", **kw).shape
    ops = {}
    if spec is not None and spec.bn:
        ops["scale"] = torch.randn(cout[-1], generator=g).to(cuda)
        ops["shift"] = torch.randn(cout[-1], generator=g).to(cuda)
    if spec is not None and spec.prelu:
        ops["alpha"] = 0.3 * torch.randn(1 if spec.bn else cout[-1],
                                         generator=g).to(cuda)
    if spec is not None and spec.residual != "none":
        ops["residual"] = torch.randn(cout, generator=g).to(cuda)
    out, launched = {}, {}
    for backend in ("kernels", "torch"):
        prims = [t.detach().requires_grad_() for t in (x, w, *ops.values())]
        y = conv2d(prims[0], prims[1], backend=backend, epilogue=spec,
                   **dict(zip(ops, prims[2:])), **kw)
        before = (kconv.conv2d.launches, ktr.transposed_conv2d.launches)
        out[backend] = torch.autograd.grad(torch.sin(y).sum(), prims)
        torch.cuda.synchronize()
        launched[backend] = {
            "conv2d": kconv.conv2d.launches - before[0],
            "transposed_conv2d": ktr.transposed_conv2d.launches - before[1]}
        out[backend + "_fn"] = type(y.grad_fn).__name__
    return out, launched


def _close_grad(got, want, rtol=1e-4, floor=1.0):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    bar = rtol * max(floor, want.abs().max().item())
    assert (got - want).abs().max().item() <= bar


@pytest.mark.parametrize("case", _GRAD_CASES, ids=lambda c: c[0])
def test_backward_matches_torch_backend(cuda, case):
    label, kw, xs, ws, kernel = case
    out, launched = _grads_both_backends(cuda, kw, xs, ws, None, len(label))
    assert launched["kernels"][kernel] >= 1
    assert launched["torch"] == {"conv2d": 0, "transposed_conv2d": 0}
    if label in ("dilated_d2", "dilated_d4"):
        assert out["kernels_fn"] == "_DilatedFnBackward"
    for got, want in zip(out["kernels"], out["torch"]):
        _close_grad(got, want)


@pytest.mark.parametrize("spec", _ALL_SPECS, ids=str)
@pytest.mark.parametrize("path", ["dense", "transposed"])
def test_epilogue_operand_grads_match_torch_backend(cuda, path, spec):
    kw, xs, ws = (({}, (2, 19, 23, 24), (3, 3, 24, 40)) if path == "dense"
                  else (_TCONV, (2, 9, 11, 16), (3, 3, 16, 20)))
    out, launched = _grads_both_backends(cuda, kw, xs, ws, spec, 7)
    assert launched["kernels"]["conv2d"] >= 1
    assert len(out["kernels"]) == 2 + len(spec.slots)
    for got, want in zip(out["kernels"], out["torch"]):
        _close_grad(got, want)


def test_enet_backward_runs_on_the_kernels(cuda):
    """One ENet training step's backward at 64x64: 165 dense and 4
    transposed launches, every weight gradient, and gradients that match
    the torch backend's per tensor at 1e-4 x max(1, max|ref|) and, since
    the gradients are small, at 2e-3 x max|ref| (chip_smoke.py's
    GRAD_RTOL)."""
    from repro_torch.launch import train_recipes as ttr
    from repro_torch.models.enet import ENet

    torch.backends.cudnn.allow_tf32 = False
    model = ENet(5, device=cuda, generator=torch.Generator().manual_seed(0))
    params = {n: p.detach() for n, p in model.named_parameters()}
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn(2, 64, 64, 3, generator=g).to(cuda),
             "label": torch.randint(0, 5, (2, 64, 64), generator=g).to(cuda)}
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss = ttr.loss_fn("enet")(leaves, batch)
    before = (kconv.conv2d.launches, ktr.transposed_conv2d.launches)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    assert (kconv.conv2d.launches - before[0],
            ktr.transposed_conv2d.launches - before[1]) == (165, 4)
    _, want = ttr.loss_and_grads(ttr.loss_fn("enet", backend="torch"), params,
                                 batch)
    for name, got in zip(leaves, grads):
        _close_grad(got, want[name])
        _close_grad(got, want[name], rtol=2e-3, floor=0.0)


# ------------------------------------------------------------------ bf16
# The bf16 forms of both conv kernels (chip_smoke.py phase 14) against
# their plain versions, which widen to fp32, accumulate and apply the
# epilogue in fp32 and round once, per element at 2^-7 |plain| + 1e-4 x
# max(1, max |plain|) (_close).  The cases reach every bf16 copy width
# (16-byte for Cin % 8 == 0, 8-byte for Cin 4 and 12, plain 2-byte loads
# for Cin 3 and 19 and for unaligned inputs), resident and streamed
# slabs, and odd Cout stores (13, 19).

_BF16_PLAN_CASES = [  # label, x shape, w shape, stride, pads, variant
    ("stem cin3 cout13 s2", (2, 33, 31, 3), (3, 3, 3, 13), 2, _SAME3,
     "bf16-scalar-resident"),
    ("cin4", (2, 17, 19, 4), (3, 3, 4, 16), 1, _SAME3, "bf16-vec4-resident"),
    ("cin12 cout70", (2, 9, 10, 12), (3, 3, 12, 70), 1, _SAME3,
     "bf16-vec4-resident"),
    ("cout4", (2, 20, 18, 16), (1, 1, 16, 4), 1, ((0, 0), (0, 0)),
     "bf16-vec8-resident"),
    ("cout8", (2, 17, 19, 16), (3, 3, 16, 8), 1, _SAME3,
     "bf16-vec8-resident"),
    ("cout19", (2, 16, 15, 16), (3, 3, 16, 19), 1, _SAME3,
     "bf16-vec8-resident"),
    ("head dx cin19 s2 valid", (2, 33, 35, 19), (3, 3, 19, 16), 2,
     ((0, 0), (0, 0)), "bf16-scalar-resident"),
    ("1x1 128->32", (3, 9, 10, 128), (1, 1, 128, 32), 1, ((0, 0), (0, 0)),
     "bf16-vec8-resident"),
    ("5x1", (2, 16, 15, 32), (5, 1, 32, 32), 1, ((2, 2), (0, 0)),
     "bf16-vec8-resident"),
    ("streamed", (2, 9, 10, 128), (3, 3, 128, 64), 1, _SAME3,
     "bf16-vec8-streamed"),
    ("streamed cin4", (1, 14, 13, 4), (11, 11, 4, 64), 1, ((5, 5), (5, 5)),
     "bf16-vec4-streamed"),
    ("streamed cin3", (1, 20, 21, 3), (15, 15, 3, 40), 1, ((7, 7), (7, 7)),
     "bf16-scalar-streamed"),
    *[(f"phase batch {xs}", xs, (3, 3, 32, 32), 1, _SAME3,
       "bf16-vec8-resident")
      for xs in ((16, 8, 8, 32), (64, 4, 4, 32), (1024, 1, 1, 32))]]


def _bf16(spec, eps):
    """Epilogue operands for a bf16 call: the residual in bf16."""
    return tuple(e.bfloat16() if s == "residual" else e
                 for s, e in zip(spec.slots, eps))


@pytest.mark.parametrize("spec", _ALL_SPECS, ids=str)
@pytest.mark.parametrize("case", _BF16_PLAN_CASES, ids=lambda c: c[0])
def test_bf16_conv2d_plan_variants_match_plain(cuda, case, spec):
    _, xs, ws, stride, pads, variant = case
    g = torch.Generator().manual_seed(xs[0] + ws[3] + 11)
    x = torch.randn(xs, generator=g).to(cuda, torch.bfloat16)
    w = torch.randn(ws, generator=g).to(cuda, torch.bfloat16)
    oh = kconv.out_extent(xs[1], ws[0], stride, *pads[0])
    ow = kconv.out_extent(xs[2], ws[1], stride, *pads[1])
    eps = _bf16(spec, _ops(spec, (xs[0], oh, ow, ws[3]), g, cuda))
    assert kconv.conv_plan(xs[3], ws[3], ws[0], ws[1], stride,
                           torch.bfloat16).variant == variant
    before = dict(kconv.conv2d.launches_by_variant)
    got = kconv.conv2d_cuda(x, w, stride, pads, spec, eps)
    torch.cuda.synchronize()
    after = kconv.conv2d.launches_by_variant
    assert {v: after[v] - before[v] for v in after} == \
        {v: int(v == variant) for v in after}
    assert got.dtype == torch.bfloat16
    _close(got, kconv.conv2d_plain(x, w, stride, pads, spec, eps))


@pytest.mark.parametrize("spec", _ALL_SPECS, ids=str)
@pytest.mark.parametrize("xs,k,cout,s,p_lo,op", [
    ((2, 16, 16, 16), 3, 19, 2, 1, 1), ((2, 16, 16, 16), 3, 16, 2, 1, 1),
    ((2, 32, 30, 4), 3, 4, 2, 1, 1), ((2, 7, 9, 8), 4, 12, 2, 2, 0),
    ((2, 7, 9, 8), 2, 12, 3, 1, 0), ((1, 6, 5, 3), 3, 5, 2, 1, 1),
    ((1, 5, 6, 20), 3, 40, 2, 1, 1), ((1, 9, 7, 16), 16, 32, 2, 7, 1),
    ((1, 6, 5, 8), 9, 19, 3, 4, 2)])
def test_bf16_tconv_matches_plain(cuda, xs, k, cout, s, p_lo, op, spec):
    g = torch.Generator().manual_seed(xs[3] + cout + 11)
    x = torch.randn(xs, generator=g).to(cuda, torch.bfloat16)
    w = torch.randn((k, k, xs[3], cout), generator=g).to(cuda,
                                                         torch.bfloat16)
    oh = (xs[1] - 1) * s + 2 * p_lo + op - k + 2
    ow = (xs[2] - 1) * s + 2 * p_lo + op - k + 2
    eps = _bf16(spec, _ops(spec, (xs[0], oh, ow, cout), g, cuda))
    got = ktr.tconv_cuda(x, w, s, p_lo, p_lo + op, spec, eps)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _close(got, ktr.tconv_plain(x, w, s, p_lo, p_lo + op, spec, eps))


@pytest.mark.parametrize("skip,variant", [(1, "bf16-scalar-resident"),
                                          (4, "bf16-vec4-resident")])
def test_bf16_unaligned_input_takes_narrower_copies(cuda, skip, variant):
    """An input 2 (8) bytes past a 16-byte boundary takes plain loads
    (8-byte copies), on both kernels."""
    g = torch.Generator().manual_seed(4)
    flat = torch.randn(2 * 9 * 10 * 16 + skip, generator=g).to(
        cuda, torch.bfloat16)
    x = flat[skip:].view(2, 9, 10, 16)
    w = torch.randn((3, 3, 16, 16), generator=g).to(cuda, torch.bfloat16)
    assert kconv.launch_plan(x, w, 1).variant == variant
    before = kconv.conv2d.launches_by_variant[variant]
    got = kconv.conv2d_cuda(x, w, 1, _SAME3, EpilogueSpec(), ())
    torch.cuda.synchronize()
    assert kconv.conv2d.launches_by_variant[variant] == before + 1
    _close(got, kconv.conv2d_plain(x, w, 1, _SAME3, EpilogueSpec(), ()))
    got = ktr.tconv_cuda(x, w, 2, 1, 2, EpilogueSpec(), ())
    torch.cuda.synchronize()
    _close(got, ktr.tconv_plain(x, w, 2, 1, 2, EpilogueSpec(), ()))


def test_bf16_kernels_refuse_a_plan_they_do_not_build(cuda):
    """conv2d_fwd refuses a copy width the dtype has no form of (8 fp32
    elements) and a dtype code it does not know."""
    x = torch.randn(1, 8, 8, 8, device=cuda)
    w = torch.randn(3, 3, 8, 8, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        orig = kconv.launch_plan
        try:
            kconv.launch_plan = lambda *a: orig(*a)._replace(vec=8)
            kconv.conv2d_cuda(x, w, 1, _SAME3, EpilogueSpec(), ())
        finally:
            kconv.launch_plan = orig


def test_bf16_enet_step_runs_on_the_bf16_kernels(cuda):
    """One bf16 ENet step at 64x64: 86 + 3 forward and 165 + 4 backward
    launches, every conv2d launch on a bf16 form, fp32 gradients on the
    fp32 masters, within 10% relative L2 of the torch backend's bf16
    gradients over all tensors together (a scalar PReLU slope's gradient
    alone is a cancelling sum that bf16 rounding moves by more than that
    on either backend)."""
    from repro_torch.launch import train_recipes as ttr
    from repro_torch.models.enet import ENet

    torch.backends.cudnn.allow_tf32 = False
    model = ENet(5, device=cuda, generator=torch.Generator().manual_seed(0))
    params = {n: p.detach() for n, p in model.named_parameters()}
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn(2, 64, 64, 3, generator=g).to(cuda),
             "label": torch.randint(0, 5, (2, 64, 64), generator=g).to(cuda)}
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    variants = dict(kconv.conv2d.launches_by_variant)
    before = (kconv.conv2d.launches, ktr.transposed_conv2d.launches)
    loss = ttr.loss_fn("enet", compute_dtype="bf16")(leaves, batch)
    mid = (kconv.conv2d.launches, ktr.transposed_conv2d.launches)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    after = (kconv.conv2d.launches, ktr.transposed_conv2d.launches)
    assert (mid[0] - before[0], mid[1] - before[1]) == (86, 3)
    assert (after[0] - mid[0], after[1] - mid[1]) == (165, 4)
    moved = {v: n - variants[v]
             for v, n in kconv.conv2d.launches_by_variant.items()}
    assert sum(moved.values()) == 86 + 165
    assert all(v.startswith("bf16-") for v, n in moved.items() if n)
    _, want = ttr.loss_and_grads(
        ttr.loss_fn("enet", backend="torch", compute_dtype="bf16"), params,
        batch)
    assert all(got.dtype == torch.float32 for got in grads)
    got = torch.cat([t.reshape(-1) for t in grads])
    ref = torch.cat([want[n].reshape(-1) for n in leaves])
    assert ((got - ref).norm() / ref.norm()).item() <= 0.10


# ------------------------------------------- the conv models' geometries
# (ESPNet's class windows, DCGAN's and the U-Net's upsamplers, the Whisper
# frontend's rows), each in fp32 and bf16

_DTYPES_CONV = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", _DTYPES_CONV, ids=str)
@pytest.mark.parametrize("d", [2, 4, 8])
def test_strided_dilated_class_windows_match_reference(cuda, d, dtype):
    """ESPNet's downsampling branches: d = 2, 4, 8 at stride 2 on uneven
    extents, as class windows batched into one strided VALID launch and
    stitched; against cuDNN's dilated conv of the widened operands (TF32
    off), rounded once."""
    from repro_torch.core.dilated import dilated_conv2d_reference
    from repro_torch.kernels.dilated_conv import dilated_conv2d

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(d)
    x = torch.randn((2, 50, 46, 32), generator=g).to(cuda, dtype)
    w = torch.randn((3, 3, 32, 32), generator=g).to(cuda, dtype)
    before = kconv.conv2d.launches
    got = dilated_conv2d(x, w, d, stride=2)
    torch.cuda.synchronize()
    assert kconv.conv2d.launches == before + 1
    assert got.shape == (2, 25, 23, 32)
    _close(got, dilated_conv2d_reference(x.float(), w.float(), d,
                                         stride=2).to(dtype))


@pytest.mark.parametrize("dtype", _DTYPES_CONV, ids=str)
@pytest.mark.parametrize("xs,k,cout,p_lo,spec", [
    ((2, 4, 4, 512), 4, 256, 2, EpilogueSpec(bn=True, prelu=True)),
    ((2, 8, 8, 512), 4, 3, 2, EpilogueSpec()),
    ((2, 4, 4, 1024), 4, 512, 2, EpilogueSpec(bn=True, prelu=True)),
    ((2, 16, 16, 128), 2, 64, 1, EpilogueSpec(prelu=True)),
    ((2, 8, 8, 256), 4, 128, 2, EpilogueSpec(prelu=True))],
    ids=["dcgan k4 512->256", "dcgan head 512->3", "dcgan128 k4 1024->512",
         "unet k2 s2 p1", "unet k4 s2 p2"])
def test_generative_upsamplers_match_plain(cuda, xs, k, cout, p_lo, spec,
                                           dtype):
    """DCGAN's k4 s2 p_lo 2 stages at Cin 512 and 1024 (K loops 32 and 64
    chunks deep) and its Cout-3 head, the U-Net's k2 s2 p1 and k4 s2 p2."""
    g = torch.Generator().manual_seed(xs[3] + cout)
    x = torch.randn(xs, generator=g).to(cuda, dtype)
    w = (torch.randn((k, k, xs[3], cout), generator=g)
         * (k * k * xs[3] / 4) ** -0.5).to(cuda, dtype)
    oh, ow = 2 * xs[1], 2 * xs[2]
    eps = _bf16(spec, _ops(spec, (xs[0], oh, ow, cout), g, cuda)) \
        if dtype == torch.bfloat16 else _ops(spec, (xs[0], oh, ow, cout), g,
                                             cuda)
    got = ktr.tconv_cuda(x, w, 2, p_lo, p_lo, spec, eps)
    torch.cuda.synchronize()
    assert got.shape == (xs[0], oh, ow, cout) and got.dtype == dtype
    _close(got, ktr.tconv_plain(x, w, 2, p_lo, p_lo, spec, eps))


@pytest.mark.parametrize("dtype", _DTYPES_CONV, ids=str)
@pytest.mark.parametrize("stride", [1, 2])
def test_whisper_rows_match_plain(cuda, stride, dtype):
    """An H = 1 row of 3000 frames through a (1, 3) kernel, SAME pads
    (1, 1) along W, at stride 1 and 2."""
    g = torch.Generator().manual_seed(stride)
    x = torch.randn((2, 1, 3000, 80), generator=g).to(cuda, dtype)
    w = (torch.randn((1, 3, 80, 96), generator=g) * 240 ** -0.5).to(cuda,
                                                                  dtype)
    pads = ((0, 0), (1, 1))
    got = kconv.conv2d_cuda(x, w, stride, pads, EpilogueSpec(), ())
    torch.cuda.synchronize()
    assert got.shape == (2, 1, 3000 // stride, 96)
    _close(got, kconv.conv2d_plain(x, w, stride, pads, EpilogueSpec(), ()))


@pytest.mark.parametrize("d", [4, 8])
def test_strided_dilated_grads_match_torch_backend(cuda, d):
    """The class windows' backward (dx through the dense kernel's Function
    on the windows, the stitch by autograd) at d = 4 and 8, stride 2."""
    out, launched = _grads_both_backends(
        cuda, dict(dilation=d, stride=2), (2, 34, 30, 16), (3, 3, 16, 16),
        None, d)
    assert launched["kernels"]["conv2d"] >= 1
    for got, want in zip(out["kernels"], out["torch"]):
        _close_grad(got, want)


def test_lm_rows_do_not_depend_on_the_row_count(cuda):
    """A token's activations through RMSNorm, the matmul kernel and the
    attention kernel are bitwise the same in a 4 x 1024-token prefill call
    and in a call of its 4 rows alone (decode), so the parallel prefill is
    the token loop bit for bit (``chip_smoke.py`` phase 25d)."""
    from repro_torch.models import layers

    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(4, 1024, 2048, generator=g, device=cuda).bfloat16()
    gain = torch.ones(2048, device=cuda, dtype=torch.bfloat16)
    w = (torch.randn(2048, 2048, generator=g, device=cuda)
         * 2048 ** -0.5).bfloat16()
    h = layers.rmsnorm(gain, x)
    y = kmm.matmul_cuda(h.reshape(-1, 2048), w).view(4, 1024, 2048)
    q, k, v = (t.view(4, 1024, 32, 64).transpose(1, 2).contiguous()
               for t in (y, y.flip(1), y.roll(7, 1)))
    att = kfa.flash_attention_cuda(q, k, v, True)
    for t in (0, 1, 127, 128, 555, 1023):
        ht = layers.rmsnorm(gain, x[:, t:t + 1].contiguous())
        assert torch.equal(ht, h[:, t:t + 1])
        yt = kmm.matmul_cuda(ht.reshape(4, 2048), w)
        assert torch.equal(yt, y[:, t])
        at = kfa.flash_attention_cuda(
            q[:, :, t:t + 1].contiguous(), k[:, :, :t + 1].contiguous(),
            v[:, :, :t + 1].contiguous(), False)
        assert torch.equal(at, att[:, :, t:t + 1])


def test_lm_parallel_prefill_is_the_token_loop(cuda):
    """StableLM-2-1.6B's widths, two layers, bf16: one parallel prefill and
    the ``slow=True`` loop give the same token and bitwise the same
    caches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config("stablelm-1.6b").replace(num_layers=2)
    srv = serve.Server(cfg, max_len=80, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (4, 72),
                         generator=torch.Generator().manual_seed(1))
    tok_p, caches_p, _ = srv.prefill(toks.numpy())
    tok_s, caches_s, _ = srv.prefill(toks.numpy(), slow=True)
    assert torch.equal(tok_p, tok_s)
    for a, b in zip(caches_p, caches_s):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_layernorm_rows_do_not_depend_on_the_row_count(cuda):
    """``F.layer_norm`` reduces a row in one order: a 4 x 1024-row call and
    its rows alone agree bit for bit on the card."""
    from repro_torch.models import layers

    g = torch.Generator(cuda).manual_seed(1)
    x = (3 * torch.randn(4, 1024, 2048, generator=g, device=cuda)
         + 1).bfloat16()
    p = {"g": torch.randn(2048, generator=g, device=cuda).bfloat16(),
         "b": torch.randn(2048, generator=g, device=cuda).bfloat16()}
    full = layers.layernorm(p, x)
    for t in (0, 1, 555, 1023):
        assert torch.equal(layers.layernorm(p, x[:, t:t + 1].contiguous()),
                           full[:, t:t + 1])


def test_lm_train_step_launch_counts(cuda):
    """StableLM-2-1.6B's widths, two layers, bf16, remat on, seq 1024 in 2
    microbatches: one ``make_train_step`` step launches
    ``chip_smoke.lm_train_launches`` matmuls and attentions, every one
    ``"wgmma"``, and its loss and gradient norm are within 5% and 10% of
    the torch backend's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init

    cfg = get_config("stablelm-1.6b").replace(num_layers=2)
    params = transformer.init_params(
        torch.Generator(cuda).manual_seed(0), cfg, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 1025),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones(2, 1024, device=cuda)}
    metrics = {}
    for backend in ("torch", "kernels"):
        step = steps.make_train_step(cfg, warmup=2, total_steps=10,
                                     microbatches=2, backend=backend)
        opt = adamw_init(transformer.flatten_params(params))
        for w in (kmm.matmul, kfa.flash_attention):
            w.launches = 0
            w.launches_by_variant = dict.fromkeys(w.launches_by_variant, 0)
        _, new_opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        metrics[backend] = {k: float(v) for k, v in m.items()}
        assert int(new_opt.step) == 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    want = {k: sum(v.values())
            for k, v in chip_smoke.lm_train_launches(cfg, 1024, 2).items()}
    assert kmm.matmul.launches == want["matmul"]
    assert kmm.matmul.launches_by_variant["wgmma"] == want["matmul"]
    assert kfa.flash_attention.launches == want["flash_attention"]
    assert (kfa.flash_attention.launches_by_variant["wgmma"]
            == want["flash_attention"])
    got, ref = metrics["kernels"], metrics["torch"]
    assert abs(got["loss"] - ref["loss"]) <= 0.05 * ref["loss"]
    assert abs(got["grad_norm"] - ref["grad_norm"]) <= 0.1 * ref["grad_norm"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("sq", [1, 448, 1500])
def test_flash_attention_at_whisper_encoder_length(cuda, sq, dtype):
    """Sk = 1500 = 11 x 128 + 92, so the ``wgmma`` form's last K/V tile is
    partial; non-causal, as whisper-small's encoder (Sq 1500), its cross
    attention in training (Sq 448) and at decode (Sq 1) call it."""
    g = torch.Generator().manual_seed(sq)
    q = torch.randn((2, 12, sq, 64), generator=g).to(cuda, dtype)
    k, v = (torch.randn((2, 12, 1500, 64), generator=g).to(cuda, dtype)
            for _ in range(2))
    variant = kfa.attention_variant(q, k, v)
    assert variant == ("wgmma" if dtype == torch.bfloat16 else "simt")
    got = kfa.flash_attention_cuda(q, k, v, False)
    torch.cuda.synchronize()
    _close(got, kfa.attention_plain(q, k, v, causal=False))


@pytest.mark.parametrize("what", ["forward", "dA", "dB"])
def test_matmul_on_the_whisper_head(cuda, what):
    """whisper-small's LM head, (M, 768) @ (768, 51865) in bf16 at M = 8 x
    448 (a training microbatch), and its backward products dA = dC B^T and
    dB = A^T dC: N or K is the odd vocab, so each takes ``"simt"``."""
    g = torch.Generator().manual_seed(7)
    m, d, vocab = 8 * 448, 768, 51865
    shapes = {"forward": ((m, d), (d, vocab)), "dA": ((m, vocab), (vocab, d)),
              "dB": ((d, m), (m, vocab))}[what]
    a, b = (torch.randn(s, generator=g).to(cuda, torch.bfloat16)
            for s in shapes)
    assert kmm.matmul_variant(a, b) == "simt"
    got = kmm.matmul_cuda(a, b)
    torch.cuda.synchronize()
    _close(got, kmm.matmul_plain(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_reduced_encode_and_decode_match_the_cpu(cuda, dtype):
    """The reduced whisper-small config: an encode and three decode steps
    on the card (the kernels) against the same on the CPU (their plain
    versions), fp32 at 1e-4 x max(1, max|cpu|) and bf16 within 5% of
    max|cpu|."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import encdec, transformer

    cfg = get_reduced("whisper-small").replace(dtype=dtype)
    params = encdec.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    flat = transformer.flatten_params(params)
    on = {"cpu": params, "cuda": transformer.unflatten_params(
        {k: t.to(cuda) for k, t in flat.items()}, params)}
    g = torch.Generator().manual_seed(1)
    frames = torch.randn((2, cfg.encoder_ctx, cfg.d_model), generator=g)
    toks = torch.randint(0, cfg.vocab, (2, 3), generator=g,
                         dtype=torch.int32)
    out = {}
    n0 = kmm.matmul.launches
    with torch.no_grad():
        for dev, p in on.items():
            enc = encdec.encode(p, frames.to(dev), cfg)
            caches = encdec.init_caches(cfg, 2, 4, device=dev)
            logits = [enc]
            for i in range(3):
                lg, caches = encdec.decode_step(p, toks[:, i:i + 1].to(dev),
                                                enc, caches, i, cfg)
                logits.append(lg)
            out[dev] = [t.float().cpu() for t in logits]
    torch.cuda.synchronize()
    assert kmm.matmul.launches - n0 == 14 + 3 * 23
    for got, want in zip(out["cuda"], out["cpu"]):
        assert bool(torch.isfinite(got).all())
        top = want.abs().max().item()
        bar = 1e-4 * max(1.0, top) if dtype == "float32" else 0.05 * top
        assert (got - want).abs().max().item() <= bar


# (q shape, window): simt at Gemma-3's dh 256 and at dh 16; wgmma at dh 64
# and 128 with windows of whole tiles, not a tile multiple (100), and 1.
# At S >= 384 and window 100 or 1 some rows of a q tile find none of their
# keys in its first kv tile (the band begins mid-tile or past it), the
# case where the wgmma form must not make -inf - -inf
_WINDOWED = [((1, 2, 700, 256), 1024), ((1, 2, 700, 256), 100),
             ((1, 2, 700, 256), 1), ((2, 3, 300, 16), 37),
             *[((1, 2, 1100, dh), w) for dh in (64, 128)
               for w in (1024, 256, 100, 1)]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("qs,window", _WINDOWED)
def test_flash_attention_band_matches_plain(cuda, qs, window, dtype):
    g = torch.Generator().manual_seed(qs[2] + window)
    q, k, v = (torch.randn(qs, generator=g).to(cuda, dtype)
               for _ in range(3))
    variant = kfa.attention_variant(q, k, v)
    assert variant == ("wgmma" if dtype == torch.bfloat16
                       and qs[3] in (64, 128) else "simt")
    w0 = kfa.flash_attention.launches_windowed
    got = kfa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches_windowed == w0 + 1
    _close(got, kfa.attention_plain(q, k, v, window=window))
    if window >= qs[2]:
        assert torch.equal(got, kfa.flash_attention_cuda(q, k, v, True))


def test_flash_attention_band_with_fewer_queries_than_keys(cuda):
    """Sq < Sk under the top-left mask: every row keeps its own key."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 2, 300, 128), generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn((1, 2, 700, 128), generator=g).to(
        cuda, torch.bfloat16) for _ in range(2))
    got = kfa.flash_attention_cuda(q, k, v, True, 100)
    torch.cuda.synchronize()
    _close(got, kfa.attention_plain(q, k, v, window=100))


def test_flash_attention_band_refuses_what_it_cannot_mask(cuda):
    q = torch.randn((1, 2, 64, 64), device=cuda).bfloat16()
    k = q[:, :, :32].contiguous()
    with pytest.raises(ValueError, match="window"):
        kfa.flash_attention_cuda(q, q, q, False, 16)
    with pytest.raises(ValueError, match="window"):
        kfa.flash_attention_cuda(q, k, k, True, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [16, 64, 256])
def test_gemma_reduced_ring_decode_matches_the_cpu(cuda, dtype, head_dim):
    """The reduced Gemma-3 config (window 16; head dim 16 and 256 on
    ``simt``, 64 on ``wgmma`` in bf16): the cache-free forward of 48
    tokens (5 of 6 attentions windowed) and a 48-step token loop past the
    rings' wrap on the card (the kernels) against the same on the CPU
    (their plain versions): fp32 at 1e-4 x max(1, max|cpu|), bf16 within
    5% of max|cpu|."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer

    cfg = get_reduced("gemma3-12b").replace(dtype=dtype, head_dim=head_dim)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     "cpu")
    flat = transformer.flatten_params(params)
    on = {"cpu": params, "cuda": transformer.unflatten_params(
        {k: t.to(cuda) for k, t in flat.items()}, params)}
    toks = torch.randint(0, cfg.vocab, (2, 48),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    out = {}
    w0 = kfa.flash_attention.launches_windowed
    with torch.no_grad():
        for dev, p in on.items():
            logits = [transformer.forward(p, toks.to(dev), cfg)]
            caches = transformer.init_caches(cfg, 2, 48, device=dev)
            for t in range(48):
                lg, caches = transformer.decode_step(
                    p, toks[:, t:t + 1].to(dev), caches, t, cfg)
                logits.append(lg)
            out[dev] = [t.float().cpu() for t in logits]
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches_windowed - w0 == 5
    for got, want in zip(out["cuda"], out["cpu"]):
        assert bool(torch.isfinite(got).all())
        top = want.abs().max().item()
        bar = 1e-4 * max(1.0, top) if dtype == "float32" else 0.05 * top
        assert (got - want).abs().max().item() <= bar


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_moe_reduced_matches_the_cpu(cuda, arch):
    """The reduced MoE configs in fp32 (the router's 2-D product and the
    experts' batched form on ``"simt"``): a 128-token forward (groups within
    the sequence) and a batch-2 prefill and 4 decode steps (groups across
    the batch) on the card against the same on the CPU, every route equal
    and the logits at 1e-4 x max(1, max|cpu|); 3 batched launches a MoE
    layer."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe, transformer

    cfg = get_reduced(arch).replace(dtype="float32")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     "cpu")
    flat = transformer.flatten_params(params)
    on = {"cpu": params, "cuda": transformer.unflatten_params(
        {k: t.to(cuda) for k, t in flat.items()}, params)}
    toks = torch.randint(0, cfg.vocab, (2, 128),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    out, routes = {}, {}
    orig = moe.route
    b0 = kmm.matmul.launches_batched
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        for dev, p in on.items():
            seen = routes[dev] = []
            mp.setattr(moe, "route", lambda *a, seen=seen, **kw: seen.append(
                orig(*a, **kw)) or seen[-1])
            logits = [transformer.forward(p, toks.to(dev), cfg)]
            caches = transformer.init_caches(cfg, 2, 132, device=dev)
            lg, caches = transformer.decode_step(p, toks.to(dev), caches, 0,
                                                 cfg)
            logits.append(lg)
            for t in range(4):
                lg, caches = transformer.decode_step(
                    p, toks[:, t:t + 1].to(dev), caches, 128 + t, cfg)
                logits.append(lg)
            out[dev] = [t.float().cpu() for t in logits]
    torch.cuda.synchronize()
    assert kmm.matmul.launches_batched - b0 == 6 * 3 * cfg.num_layers
    for got, want in zip(routes["cuda"], routes["cpu"]):
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[3].cpu(), want[3])
    for got, want in zip(out["cuda"], out["cpu"]):
        assert bool(torch.isfinite(got).all())
        bar = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= bar


# Kernel 3's batched backward (``BatchedMatmulFn``, MoE training): dA and dB
# of (E, R, K) @ (E, K, N), each one batched launch.  R = 200 and N = 264
# put a last 64-deep K tile of 8 rows in dB's and dA's contraction (TMA's
# zero fill of each expert's rank-3 map, never the next expert's rows);
# R = 36 takes "simt" for dB in bf16; Qwen3-MoE's gate product at a
# training microbatch's R = 640.
_BATCHED_BWD = [(8, 200, 256, 264), (16, 36, 64, 40), (4, 72, 130, 24),
                (128, 640, 2048, 768)]   # E, R, K, N


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("erkn", _BATCHED_BWD, ids=str)
def test_batched_matmul_fn_backward_matches_plain(cuda, erkn, dtype):
    e, r, k, n = erkn
    g = torch.Generator().manual_seed(e + r + k + n)
    a = torch.randn((e, r, k), generator=g).to(cuda, dtype)
    b = (torch.randn((e, k, n), generator=g) * k ** -0.5).to(cuda, dtype)
    cot = torch.randn((e, r, n), generator=g).to(cuda, dtype)
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    before = (kmm.matmul.launches_batched, kmm.MatmulFn.transposes)
    da, db = torch.autograd.grad(kmm.BatchedMatmulFn.apply(ta, tb),
                                 (ta, tb), cot)
    torch.cuda.synchronize()
    assert (kmm.matmul.launches_batched - before[0],
            kmm.MatmulFn.transposes - before[1]) == (3, 2)
    assert da.dtype == db.dtype == dtype
    _close(da, kmm.matmul_batched_plain(cot, b.transpose(1, 2).contiguous()))
    _close(db, kmm.matmul_batched_plain(a.transpose(1, 2).contiguous(), cot))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_moe_reduced_train_step_matches_the_cpu(cuda, arch):
    """One ``make_train_step`` step (2 microbatches, fp32 AdamW, remat on)
    of the reduced MoE configs in fp32 on the card (kernel 3's ``"simt"``
    forms, the experts' forward and backward batched) against the same step
    on the CPU: every route equal, loss and gradient norm at 1e-5, every
    parameter at 1e-4 x max(1, max|cpu|); 6 batched launches a MoE layer
    and microbatch in the backward, 3 in the forward and 3 in the
    recompute."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import steps
    from repro_torch.models import moe, transformer
    from repro_torch.optim import adamw_init

    cfg = get_reduced(arch).replace(dtype="float32", remat=True)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     "cpu")
    flat = transformer.flatten_params(params)
    toks = torch.randint(0, cfg.vocab, (4, 129),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones(4, 128)}
    out, routes = {}, {}
    orig = moe.route
    b0 = kmm.matmul.launches_batched
    for dev in ("cpu", "cuda"):
        p = transformer.unflatten_params(
            {k: t.to(dev) for k, t in flat.items()}, params)
        step = steps.make_train_step(cfg, warmup=2, total_steps=10,
                                     microbatches=2)
        seen = routes[dev] = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(moe, "route", lambda *a, seen=seen, **kw: seen.append(
                orig(*a, **kw)) or seen[-1])
            new_p, _, m = step(p, adamw_init(transformer.flatten_params(p)),
                               {k: v.to(dev) for k, v in batch.items()})
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {k: t.float().cpu() for k, t in
                     transformer.flatten_params(new_p).items()})
    torch.cuda.synchronize()
    assert kmm.matmul.launches_batched - b0 == 2 * 12 * cfg.num_layers
    assert len(routes["cuda"]) == len(routes["cpu"]) == 4 * cfg.num_layers
    for got, want in zip(routes["cuda"], routes["cpu"]):
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[3].cpu(), want[3])
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    for k in ("loss", "grad_norm"):
        assert abs(mg[k] - mc[k]) <= 1e-5 * abs(mc[k]), k
    for k, want in pc.items():
        assert bool(torch.isfinite(pg[k]).all())
        bar = 1e-4 * max(1.0, want.abs().max().item())
        assert (pg[k] - want).abs().max().item() <= bar, k


# The recurrent mixers' kernel-3 shapes (chip_smoke.py phase 31a):
# xLSTM-1.3B's sLSTM FFN, 2730 wide, which takes bf16 "simt" (N, or K, no
# multiple of 8), at a forward's M and a decode's; its fp32 decode products
# at M = 4 and the sLSTM's recurrent one at M = 1; the gates' fp32 w_if at
# N = 8.  (M, K, N, dtype, variant)
_RECURRENT_MM = [(1024, 2048, 2730, torch.bfloat16, "simt"),
                 (1024, 2730, 2048, torch.bfloat16, "simt"),
                 (4, 2048, 2730, torch.bfloat16, "simt"),
                 (4, 2730, 2048, torch.bfloat16, "simt"),
                 (4, 4096, 4096, torch.float32, "simt"),
                 (4, 2048, 8192, torch.float32, "simt"),
                 (1, 2048, 8192, torch.float32, "simt"),
                 (4, 4096, 8, torch.float32, "simt"),
                 (512, 16384, 544, torch.bfloat16, "wgmma")]


@pytest.mark.parametrize("mknv", _RECURRENT_MM, ids=str)
def test_matmul_at_the_recurrent_mixers_shapes(cuda, mknv):
    m, k, n, dtype, variant = mknv
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randn((m, k), generator=g).to(cuda, dtype)
    b = (torch.randn((k, n), generator=g) * k ** -0.5).to(cuda, dtype)
    assert kmm.matmul_variant(a, b) == variant
    n0 = kmm.matmul.launches_by_variant[variant]
    got = kmm.matmul(a, b)
    torch.cuda.synchronize()
    assert kmm.matmul.launches_by_variant[variant] - n0 == 1
    _close(got, kmm.matmul_plain(a, b))


def _plain_matmul(mp):
    """Kernel 3's plain version in place of its launcher (the same model
    code on the card, without the kernel)."""
    mp.setattr(kmm, "matmul_cuda", kmm.matmul_plain)


def test_jamba_mamba_mixer_at_full_width_matches_plain(cuda):
    """One Mamba mixer of Jamba-1.5-Large at full width (d_model 8192,
    d_inner 16384, bf16): a forward over 1 x 1024 rows (2 scan chunks) and
    4 decode steps at batch 2, each against the same with kernel 3's plain
    version, within 5% of max|plain| (the bf16 output bar); 2 + 2 x 2 and
    4 launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba

    cfg = get_config("jamba-1.5-large-398b")
    g = torch.Generator(cuda).manual_seed(0)
    p = mamba.mamba_init(g, cfg, torch.bfloat16, cuda)
    x = torch.randn((1, 1024, cfg.d_model), generator=g,
                    device=cuda).to(torch.bfloat16)
    xd = torch.randn((2, 4, cfg.d_model), generator=g,
                     device=cuda).to(torch.bfloat16)

    def run():
        cache = mamba.init_mamba_cache(cfg, 2, torch.bfloat16, cuda)
        with torch.no_grad():
            y = mamba.mamba_block(p, x, cfg)[0]
            ys = [mamba.mamba_block(p, xd[:, t:t + 1], cfg, cache=cache)[0]
                  for t in range(4)]
        return [y, torch.cat(ys, dim=1), cache["ssm"]]

    n0 = kmm.matmul.launches
    got = run()
    torch.cuda.synchronize()
    assert kmm.matmul.launches - n0 == 6 + 4 * 4
    with pytest.MonkeyPatch.context() as mp:
        _plain_matmul(mp)
        want = run()
    for gt, wt in zip(got, want):
        assert bool(torch.isfinite(gt).all())
        top = wt.float().abs().max().item()
        assert (gt.float() - wt.float()).abs().max().item() <= 0.05 * top


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_recurrent_reduced_matches_the_cpu(cuda, arch):
    """The reduced xLSTM and Jamba in fp32 (kernel 3's ``"simt"`` forms): a
    forward over (2, 64) tokens (the mLSTM's chunkwise form and Mamba's
    chunked scan at chunks of 16) and 4 steps of the token loop on the
    card against the same on the CPU, the logits at 1e-4 x max(1,
    max|cpu|)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import mamba, transformer, xlstm

    cfg = get_reduced(arch).replace(dtype="float32")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     "cpu")
    flat = transformer.flatten_params(params)
    toks = torch.randint(0, cfg.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    out = {}
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(mamba, "SCAN_CHUNK", 16)
        mp.setattr(xlstm, "M_CHUNK", 16)
        for dev in ("cpu", "cuda"):
            p = transformer.unflatten_params(
                {k: t.to(dev) for k, t in flat.items()}, params)
            logits = [transformer.forward(p, toks.to(dev), cfg)]
            caches = transformer.init_caches(cfg, 2, 4, device=dev)
            for t in range(4):
                lg, caches = transformer.decode_step(
                    p, toks[:, t:t + 1].to(dev), caches, t, cfg)
                logits.append(lg)
            out[dev] = [t.float().cpu() for t in logits]
    torch.cuda.synchronize()
    for got, want in zip(out["cuda"], out["cpu"]):
        assert bool(torch.isfinite(got).all())
        bar = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= bar
