"""The conv kernels' launch plans (``conv_plan``, ``tconv_plan``), on the CPU.

A plan is plain Python: it picks the copy width of the input gather (16
bytes only when Cin % 4 == 0, so that 4 consecutive K rows are 4 channels
of one tap), the Cout tile (which must cover Cout, or be the widest), and
resident or streamed weights (for the transposed conv, by its k).  The tables it mirrors from
``csrc/igemm.cuh`` are read back from the source, so the two cannot drift
apart unseen.
"""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.models.enet import ENet

_IGEMM = (Path(kconv.__file__).resolve().parent / "csrc" / "igemm.cuh"
          ).read_text()

# (cin, cout, kh, kw, stride) of every dense conv of the ENet forward (19
# classes), and (cin, cout, k, s) of its transposed convs
_ENET_CONVS = {
    (3, 13, 3, 3, 2), (16, 16, 2, 2, 2), (16, 16, 3, 3, 1),
    (16, 64, 1, 1, 1), (64, 16, 1, 1, 1), (64, 32, 2, 2, 2),
    (32, 32, 3, 3, 1), (32, 128, 1, 1, 1), (128, 32, 1, 1, 1),
    (32, 32, 5, 1, 1), (32, 32, 1, 5, 1), (128, 16, 1, 1, 1),
    (128, 64, 1, 1, 1), (64, 4, 1, 1, 1), (4, 16, 1, 1, 1),
    (16, 4, 1, 1, 1), (4, 4, 3, 3, 1)}
_ENET_TCONVS = {(16, 16, 3, 2), (4, 4, 3, 2), (16, 19, 3, 2)}


def _check(plan, cin, cout, k_rows):
    bn = kconv.TILES[plan.tile][0]
    assert plan.vec == (4 if cin % 4 == 0 else 1)
    assert bn == plan.bn
    widths = [t[0] for t in kconv.TILES]
    # the narrowest tile that covers Cout, else the widest
    assert bn >= cout or bn == max(widths)
    assert all(w < cout for w in widths if w < bn)
    assert plan.resident == (
        -(-k_rows // kconv.K_STEP) * kconv.K_STEP * bn * 4
        <= kconv.RESIDENT_BYTES)
    assert plan.resident == kconv.slab_fits(k_rows, plan.tile)
    assert plan.variant in kconv.VARIANTS


def test_enet_forward_has_the_listed_convs():
    seen, tseen = set(), set()
    plain, tplain = kconv.conv2d_plain, ktr.tconv_plain

    def rec(x, w, stride, *rest):
        seen.add((x.shape[-1], w.shape[3], w.shape[0], w.shape[1], stride))
        return plain(x, w, stride, *rest)

    def trec(x, w, s, *rest):
        tseen.add((x.shape[-1], w.shape[3], w.shape[0], s))
        return tplain(x, w, s, *rest)

    model = ENet(19, device="cpu", generator=torch.Generator().manual_seed(0))
    try:
        kconv.conv2d_plain, ktr.tconv_plain = rec, trec
        with torch.no_grad():
            model(torch.zeros(1, 64, 64, 3))
    finally:
        kconv.conv2d_plain, ktr.tconv_plain = plain, tplain
    assert seen == _ENET_CONVS
    assert tseen == _ENET_TCONVS


@pytest.mark.parametrize("conv", sorted(_ENET_CONVS), ids=str)
def test_enet_conv_plan(conv):
    cin, cout, kh, kw, stride = conv
    plan = kconv.conv_plan(cin, cout, kh, kw, stride)
    _check(plan, cin, cout, kh * kw * cin)
    assert plan.resident, "every ENet conv keeps its weights resident"
    assert plan.vec == (1 if cin == 3 else 4)


@pytest.mark.parametrize("conv", sorted(_ENET_TCONVS), ids=str)
def test_enet_tconv_plan(conv):
    cin, cout, k, _ = conv
    plan = ktr.tconv_plan(cin, cout, k)
    assert plan.vec == 4 and plan.resident
    assert plan.bn >= cout and plan.bn - cout < 4


@pytest.mark.parametrize("cout,bn", [(4, 4), (13, 16), (16, 16), (19, 20),
                                     (32, 32), (64, 64), (128, 64),
                                     (70, 64)])
def test_cout_tile_wastes_few_lanes(cout, bn):
    assert kconv.conv_plan(16, cout, 1, 1, 1).bn == bn


@pytest.mark.parametrize("cin", range(1, 14))
@pytest.mark.parametrize("k", [1, 3])
def test_small_cin_plans(cin, k):
    plan = kconv.conv_plan(cin, 16, k, k, 1)
    _check(plan, cin, 16, k * k * cin)
    assert plan.variant.startswith("vec4" if cin % 4 == 0 else "scalar")
    tplan = ktr.tconv_plan(cin, 16, k)
    assert tplan.vec == (4 if cin % 4 == 0 else 1)


@pytest.mark.parametrize("conv", [(128, 64, 3, 3, 1), (256, 32, 3, 3, 2),
                                  (64, 64, 5, 5, 1), (3, 64, 15, 15, 1)],
                         ids=str)
def test_large_slabs_stream(conv):
    cin, cout, kh, kw, stride = conv
    plan = kconv.conv_plan(*conv)
    _check(plan, cin, cout, kh * kw * cin)
    assert not plan.resident
    assert plan.variant.endswith("streamed")


def test_conv_plan_takes_only_tiles_the_dense_kernel_builds():
    # csrc/conv2d.cu builds every tile but the one-group 32-wide one
    tiles = {kconv.conv_plan(16, cout, 3, 3, 1).tile for cout in range(1, 140)}
    assert tiles == {i for i, t in enumerate(kconv.TILES)
                     if not (t[0] == 32 and t[4] == 1)}


def test_bad_conv_is_refused():
    with pytest.raises(ValueError):
        kconv.conv_plan(0, 16, 3, 3, 1)


def test_tables_match_the_cuda_source():
    tiles = tuple(tuple(int(v) for v in m) for m in re.findall(
        r"f\(Tile<(\d+), (\d+), (\d+), (\d+), (\d+)>\{\}\)", _IGEMM))
    assert tiles == kconv.TILES
    assert int(re.search(r"kBK = (\d+);", _IGEMM).group(1)) == kconv.K_STEP
    assert int(re.search(r"kResidentBytes = (\d+) \* 1024;", _IGEMM).group(1)
               ) * 1024 == kconv.RESIDENT_BYTES


def test_launches_by_variant_start_at_zero_keys():
    assert set(kconv.conv2d.launches_by_variant) == set(kconv.VARIANTS)


@pytest.mark.parametrize("conv", [(32, 32, 3, 3, 1), (128, 32, 1, 1, 1),
                                  (64, 32, 2, 2, 2), (16, 24, 3, 3, 1)],
                         ids=str)
def test_cout32_plans_split_k(conv):
    plan = kconv.conv_plan(*conv)
    assert plan.tile == kconv.SPLIT_K_TILE
    bn, tn, _, _, ks = kconv.TILES[plan.tile]
    assert (bn, tn, ks) == (32, 8, 4)


@pytest.mark.parametrize("cout", [1, 4, 5, 13, 19, 21, 32, 33, 64, 70, 128])
def test_tconv_plans_take_single_group_tiles(cout):
    bn, tn, _, _, ks = kconv.TILES[ktr.tconv_plan(16, cout, 3).tile]
    assert tn == 4 and ks == 1 and bn <= 32
    assert bn >= min(cout, 32)


@pytest.mark.parametrize("k,cout,resident", [
    (3, 19, True), (3, 32, True), (4, 32, True), (9, 19, False),
    (9, 8, True), (11, 4, True), (16, 4, False), (16, 24, False), (16, 32, False),
    (24, 8, False)])
def test_tconv_weights_stream_when_the_taps_do_not_fit(k, cout, resident):
    plan = ktr.tconv_plan(16, cout, k)
    assert plan.resident == resident
    assert plan.resident == (
        k * k * ktr.CHUNK * plan.bn * 4 <= kconv.RESIDENT_BYTES)


def test_tconv_streamed_buffer_holds_a_row_of_live_taps():
    # the kernel streams whole rows of a plane's live taps, at most
    # MAX_TAPS of them, through a buffer of RESIDENT_BYTES
    widest = max(t[0] for t in kconv.TILES if t[1] == 4 and t[4] == 1
                 and t[0] <= 32)
    assert kconv.RESIDENT_BYTES // (ktr.CHUNK * widest * 4) >= ktr.MAX_TAPS


def test_tconv_tables_match_the_cuda_source():
    src = (Path(ktr.__file__).resolve().parent / "csrc" /
           "transposed_conv.cu").read_text()
    for name, value in (("kMaxStride", ktr.MAX_STRIDE),
                        ("kMaxTaps", ktr.MAX_TAPS), ("kChunk", ktr.CHUNK)):
        assert int(re.search(rf"{name} = (\d+);", src).group(1)) == value
