"""The port's launch-plan table and its policy, on the CPU.

``repro_torch.kernels.autotune`` keys one kernel launch as the reference's
``make_key`` keys a geometry (padding, output padding and the epilogue's
fingerprint canonicalised); its candidates are the plans the two conv
kernels build (no dense tile 4, no transposed tile past 4); the policy's
shared-memory footprint is ``ConvSmem::of`` / ``TconvSmem::of`` worked by
hand below; the default plan is always among the timed ones; the disk
table round-trips; a miss returns the shape's default plan without timing
anything, and ``launch_plan`` takes a table entry's tile and resident flag
but the copy width its operand's address allows.  ``tune`` refuses to run
without a card.  Every test points the table at ``tmp_path``.
"""

import json

import pytest
import torch

from repro_torch.core import enet_spec
from repro_torch.kernels import autotune as at
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import tiling_policy as tp
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.kernels.epilogue import EpilogueSpec

BN_PRE = EpilogueSpec(bn=True, prelu=True, residual="pre_act")


@pytest.fixture(autouse=True)
def table(monkeypatch, tmp_path):
    """An empty plan table under ``tmp_path``, tuning off."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    for var in ("REPRO_TORCH_AUTOTUNE", "REPRO_TORCH_AUTOTUNE_SWEEP"):
        monkeypatch.delenv(var, raising=False)
    at.clear_memory_cache()
    yield tmp_path
    at.clear_memory_cache()


def _no_timing(*a, **k):
    raise AssertionError("the table timed something on a miss")


def _enet_launches():
    """(kind, x_shape, w_shape, stride, padding) of ENet-512's launches at
    batch 4, from the cycle model's layer table: a dilated layer as the
    dense launch on its phase-batched layout."""
    out = []
    for l in enet_spec.enet_512_layers():
        if l.kind == "transposed":
            h = l.h_out // 2
            out.append(("tconv", (4, h, h, l.cin), (3, 3, l.cin, l.cout), 2,
                        None))
        elif l.kind == "dilated":
            d = l.D + 1
            out.append(("dense", (4 * d * d, -(-l.h_out // d),
                                  -(-l.w_out // d), l.cin),
                        (3, 3, l.cin, l.cout), 1, "SAME"))
        else:
            s = 2 if l.kh == 2 else 1
            out.append(("dense", (4, l.h_out * s, l.w_out * s, l.cin),
                        (l.kh, l.kw, l.cin, l.cout), s, "SAME"))
    return out


ENET = _enet_launches()


# ------------------------------------------------------------------ keys --

def test_dense_key_canonicalises_padding():
    x, w = (2, 16, 16, 8), (3, 3, 8, 16)
    same = at.make_key("dense", x, w)
    assert same == at.make_key("dense", x, w, padding="SAME") == \
        at.make_key("dense", x, w, padding=1) == \
        at.make_key("dense", x, w, padding=((1, 1), (1, 1)))
    assert "/p1.1.1.1/op0/" in same
    assert at.make_key("dense", x, w, padding="VALID") == \
        at.make_key("dense", x, w, padding=0)
    assert at.make_key("dense", x, w, padding="VALID") != same
    # SAME of an even kernel is asymmetric
    assert "/p0.1.0.1/" in at.make_key("dense", x, (2, 2, 8, 16))


def test_tconv_key_canonicalises_pads():
    x, w = (2, 8, 8, 16), (3, 3, 16, 4)
    key = at.make_key("tconv", x, w, stride=2)
    assert key == at.make_key("tconv", x, w, stride=2, padding=1,
                              output_padding=1)
    assert "/s2/p1/op1/" in key
    assert at.make_key("tconv", x, (4, 4, 16, 4), stride=2) != \
        at.make_key("tconv", x, (4, 4, 16, 4), stride=2, padding=2,
                    output_padding=0)


def test_key_carries_dtype_and_epilogue_fingerprint():
    x, w = (2, 16, 16, 8), (3, 3, 8, 16)
    fp32 = at.make_key("dense", x, w)
    assert fp32.endswith("/float32/epnone")
    assert at.make_key("dense", x, w, epilogue=EpilogueSpec()) == fp32
    assert at.make_key("dense", x, w, dtype="bf16") == \
        at.make_key("dense", x, w, dtype=torch.bfloat16)
    assert "/bfloat16/" in at.make_key("dense", x, w, dtype="bf16")
    assert at.make_key("dense", x, w, epilogue=BN_PRE).endswith(
        "/epbn1.pr1.res-pre_act")
    with pytest.raises(ValueError):
        at.make_key("dilated", x, w)


# ------------------------------------------------------------ candidates --

@pytest.mark.parametrize("cout", [1, 4, 13, 19, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_candidate_grids_are_what_the_kernels_build(cout, dtype):
    dense = at.candidates("dense", (2, 16, 16, 16), (3, 3, 16, cout),
                          dtype=dtype)
    tconv = at.candidates("tconv", (2, 8, 8, 16), (3, 3, 16, cout),
                          dtype=dtype)
    assert dense and tconv
    assert {p.tile for p in dense} <= set(at.DENSE_TILES)
    assert 4 not in {p.tile for p in dense}
    assert {p.tile for p in tconv} <= {0, 1, 2, 3, 4}
    for p in dense:
        assert tp.builds("dense", p.tile) and p.dtype == dtype
        assert not p.resident or kconv.slab_fits(9 * 16, p.tile, dtype)
    for p in tconv:
        assert tp.builds("tconv", p.tile)
    # the default plan is a candidate
    assert at.default_plan("dense", (2, 16, 16, 16), (3, 3, 16, cout),
                           dtype=dtype) in dense
    assert at.default_plan("tconv", (2, 8, 8, 16), (3, 3, 16, cout),
                           dtype=dtype) in tconv


def test_builds_matches_the_sources():
    assert [t for t in range(7) if tp.builds("dense", t)] == \
        list(at.DENSE_TILES)
    assert [t for t in range(7) if tp.builds("tconv", t)] == \
        list(at.TCONV_TILES)


def test_streamed_only_where_the_slab_does_not_fit():
    big = at.candidates("dense", (1, 8, 8, 512), (3, 3, 512, 256))
    assert big and not any(p.resident for p in big)
    k16 = at.candidates("tconv", (1, 8, 8, 16), (16, 16, 16, 32))
    assert k16 and not any(p.resident for p in k16)


# ------------------------------------------------------------- footprint --

def test_footprint_is_convsmem_worked_by_hand():
    # fp32, tile 5 (BN 64, BM 16*8 = 128, CS 64+4 = 68), K = 3*3*16 = 144:
    # nk 9, ring 4 slots * 128 px * 20 floats * 4 B = 40960 >= staged tile
    # 128 * 68 * 4 = 34816; resident slab 9*16*64*4 = 36864 -> 77824;
    # pixel table 16*128 -> 79872; channel vectors 3*64*4 -> 80640
    p = kconv.ConvPlan(4, 5, True)
    assert tp.footprint_bytes("dense", (4, 32, 32, 16), (3, 3, 16, 64),
                              p) == 80640
    # bf16, tile 0 (BN 4, BM 128*2 = 256, CS 4), K = 16: nk 1, ring 1 slot *
    # 256 * 24 * 2 = 12288 (> staged 4096); streamed slab 16*4*2 = 128 ->
    # 12416; residual tile 256*4*2 = 2048 -> 14464; pixels 4096 -> 18560;
    # vectors 48 -> 18608
    p = kconv.ConvPlan(8, 0, False, torch.bfloat16)
    assert tp.footprint_bytes("dense", (4, 256, 256, 16), (1, 1, 16, 4), p,
                              epilogue=BN_PRE) == 18608
    # fp32, split-K tile 6 (BN 32, BM 128, CS 36), K = 288: ring 40960;
    # streamed 4*16*32*4 = 8192 -> 49152; residual 128*36*4 = 18432 ->
    # 67584; pixels 2048 -> 69632; vectors 384 -> 70016
    p = kconv.ConvPlan(4, 6, False)
    assert tp.footprint_bytes("dense", (4, 64, 64, 32), (3, 3, 32, 32), p,
                              epilogue=BN_PRE) == 70016


def test_footprint_is_tconvsmem_worked_by_hand():
    # ENet's k3 s2 p_lo 1 op 1 upsampler, 64x64x16 -> 128x128x16, fp32
    # tile 2 (BN 16, BM 128, CS 20): plane 64x64, cap 4*128/4 = 128, tbw
    # min(16, 64, 128) = 16, tbh min(64, 128 // 16) = 8; live offsets
    # {0, 0, 1}: span 1.  Input tile (8+1)*(16+1) px * 20 * 4 B = 12240;
    # resident weights 9 taps * 16 * 16 * 4 = 9216 -> 21456; output tile
    # 2*8 * 2*16 * 20 * 4 = 40960 -> 62416; vectors 3*16*4 -> 62608
    p = kconv.ConvPlan(4, 2, True)
    assert tp.footprint_bytes("tconv", (4, 64, 64, 16), (3, 3, 16, 16), p,
                              stride=2) == 62608
    # a resident k16 plan is refused: 256 taps do not fit 48 KB
    assert tp.footprint_bytes("tconv", (1, 8, 8, 16), (16, 16, 16, 32),
                              kconv.ConvPlan(4, 4, True), stride=2,
                              padding=7) is None
    assert tp.footprint_bytes("dense", (1, 8, 8, 16), (3, 3, 16, 32),
                              kconv.ConvPlan(4, 4, True)) is None


def test_rank_refuses_what_cannot_launch():
    x, w = (4, 32, 32, 16), (3, 3, 16, 64)
    plans = [kconv.ConvPlan(4, 4, True), kconv.ConvPlan(4, 5, True),
             kconv.ConvPlan(4, 2, True)]
    small = tp.H100._replace(smem_optin=70_000)
    scores = dict((p, s) for s, p in tp.rank("dense", x, w, plans,
                                             card=small))
    assert scores[plans[0]] == float("inf")            # tile 4: not built
    assert scores[plans[1]] == float("inf")            # 80640 B > 70000
    assert scores[plans[2]] < float("inf")
    assert tp.occupancy("dense", x, w, plans[0]) == (0.0, 0.0)


def test_occupancy_counts_waves_and_waste():
    # 4*32*32 = 4096 pixels / BM 128 = 32 rows x 1 Cout tile of 64 for
    # Cout 48: 32 blocks; 80640+1024 B -> 2 blocks an SM (233472 B), by
    # threads 2048/256 = 8: 264 slots, one wave at 32/264; lanes 48/64
    p = kconv.ConvPlan(4, 5, True)
    wave, use = tp.occupancy("dense", (4, 32, 32, 16), (3, 3, 16, 48), p)
    assert tp.blocks_per_sm(80640, 256) == 2
    assert wave == pytest.approx(32 / 264) and use == pytest.approx(0.75)


@pytest.mark.parametrize("launch", ENET, ids=lambda l: f"{l[0]}{l[1]}{l[2]}")
def test_top_candidates_keep_the_default(launch, monkeypatch):
    kind, x, w, s, pad = launch
    cands = at.candidates(kind, x, w)
    default = at.default_plan(kind, x, w, stride=s)
    kw = dict(stride=s, padding=pad) if kind == "dense" else dict(stride=s)
    for top in (1, 3):
        keep = tp.top_candidates(kind, x, w, cands, top=top,
                                 default_plan=default, **kw)
        assert default in keep and len(keep) <= top + 1
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_SWEEP", "1")
    assert tp.top_candidates(kind, x, w, cands, default_plan=default,
                             **kw) == cands


def test_top_candidates_fall_back_to_the_grid():
    cands = at.candidates("dense", (1, 8, 8, 16), (3, 3, 16, 16))
    # an empty output cannot be scored: the whole grid
    assert tp.top_candidates("dense", (1, 1, 1, 16), (3, 3, 16, 16), cands,
                             padding="VALID") == cands


# ----------------------------------------------------------------- table --

def test_miss_returns_the_default_without_timing(monkeypatch):
    monkeypatch.setattr(at, "time_call", _no_timing)
    monkeypatch.setattr(at, "tune", _no_timing)
    for kind, x, w, s, pad in ENET:
        got = at.get_plan(kind, x, w, stride=s, padding=pad, device="cpu")
        assert got == at.default_plan(kind, x, w, stride=s)
    # tuning switched on still never times a CPU launch
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    at.clear_memory_cache()
    assert at.get_plan("dense", (1, 8, 8, 16), (3, 3, 16, 16),
                       device="cpu") == kconv.conv_plan(16, 16, 3, 3, 1)
    assert at.get_plan("tconv", (1, 8, 8, 16), (3, 3, 16, 19), stride=2,
                       device="cpu") == ktr.tconv_plan(16, 19, 3)


def test_empty_table_gives_every_enet_launch_its_plan(table):
    for kind, x, w, s, pad in ENET:
        xt = torch.zeros(x)
        wt = torch.zeros(w)
        if kind == "dense":
            got = kconv.launch_plan(xt, wt, s, kconv.resolve_pads(
                pad, w[0], w[1]))
            want = kconv.conv_plan(x[-1], w[-1], w[0], w[1], s)
        else:
            got = ktr.launch_plan(xt, wt, s, 1, 2)
            want = ktr.tconv_plan(x[-1], w[-1], w[0])
        assert got == want._replace(vec=kconv.copy_vec(x[-1], xt.dtype,
                                                       xt.data_ptr()))
    assert not list(table.iterdir())        # nothing written


def test_disk_table_round_trips(table):
    x, w = (2, 16, 16, 16), (3, 3, 16, 64)
    plan = kconv.ConvPlan(4, 2, False)
    key = at.make_key("dense", x, w, epilogue=BN_PRE)
    at._persist(key, plan, "cpu")
    path = at.cache_path("cpu")
    assert path.parent == table and path.exists()
    assert "-torch" in path.name and f"-src{at.kernel_sources_hash()}" in \
        path.name
    raw = json.loads(path.read_text())
    assert raw["entries"] == {key: [2, False]}
    at.clear_memory_cache()
    assert at.get_plan("dense", x, w, epilogue=BN_PRE, device="cpu") == plan
    # the entry belongs to its key only
    assert at.get_plan("dense", x, w, device="cpu") == \
        kconv.conv_plan(16, 64, 3, 3, 1)


def test_corrupt_table_is_a_miss(table):
    path = at.cache_path("cpu")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("{not json")
    assert at.get_plan("dense", (1, 8, 8, 16), (3, 3, 16, 16),
                       device="cpu") == kconv.conv_plan(16, 16, 3, 3, 1)


@pytest.mark.parametrize("offset,vec", [(0, 8), (4, 4), (1, 1)])
def test_launch_plan_takes_the_table_but_keeps_the_address_vec(offset, vec):
    """bf16 Cin 8: 16-byte copies on an aligned base, 8-byte ones 8 bytes
    off, one element at a time 2 bytes off; the tile and resident flag are
    the table's either way."""
    base = torch.zeros(1 * 6 * 6 * 8 + 8, dtype=torch.bfloat16)
    x = base[offset:offset + 288].view(1, 6, 6, 8)
    w = torch.zeros(3, 3, 8, 16, dtype=torch.bfloat16)
    key = at.make_key("dense", tuple(x.shape), tuple(w.shape),
                      dtype=torch.bfloat16)
    at._persist(key, kconv.ConvPlan(8, 0, False, torch.bfloat16), "cpu")
    at.clear_memory_cache()
    plan = kconv.launch_plan(x, w, 1, ((1, 1), (1, 1)))
    assert (plan.tile, plan.resident, plan.vec) == (0, False, vec)
    assert kconv.conv_plan(8, 16, 3, 3, 1, torch.bfloat16).tile == 2
    # the transposed launch too
    key = at.make_key("tconv", tuple(x.shape), tuple(w.shape), stride=2,
                      dtype=torch.bfloat16)
    at._persist(key, kconv.ConvPlan(8, 3, False, torch.bfloat16), "cpu")
    at.clear_memory_cache()
    plan = ktr.launch_plan(x, w, 2, 1, 2)
    assert (plan.tile, plan.resident, plan.vec) == (3, False, vec)


def test_tune_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(at, "time_call", _no_timing)
    with pytest.raises(RuntimeError, match="CUDA device"):
        at.tune("dense", (1, 8, 8, 16), (3, 3, 16, 16), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        at.tune("tconv", (1, 8, 8, 16), (3, 3, 16, 16), stride=2)
    assert not at._MEM


def test_switch_names_are_the_ports_own(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    monkeypatch.setenv("REPRO_AUTOTUNE_SWEEP", "1")
    assert not at.autotune_enabled() and not tp.sweep_forced()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "on")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_SWEEP", "true")
    assert at.autotune_enabled() and tp.sweep_forced()


def test_repeated_launch_skips_the_key(monkeypatch):
    """The first lookup of a launch builds its key; a repeat, with the
    pads given as lists or as tuples, reads the plan by its raw arguments
    without building the key again."""
    x, w = (2, 8, 8, 16), (3, 3, 16, 32)
    first = at.get_plan("dense", x, w, padding=[[1, 1], [1, 1]],
                        epilogue=BN_PRE, device="cpu")
    assert first == kconv.conv_plan(16, 32, 3, 3, 1)
    def no_key(*a, **k):
        raise AssertionError("the key was built again")

    monkeypatch.setattr(at, "make_key", no_key)
    assert at.get_plan("dense", x, w, padding=[[1, 1], [1, 1]],
                       epilogue=BN_PRE, device="cpu") == first
    with pytest.raises(AssertionError, match="built again"):  # a new key
        at.get_plan("dense", x, w, padding="VALID", device="cpu")


def test_miss_tunes_only_when_switched_on_and_on_cuda(monkeypatch):
    """``$REPRO_TORCH_AUTOTUNE=1`` sends a CUDA launch's miss to ``tune``
    once, and its plan is what every later launch of the geometry reads; a
    CPU launch never tunes, the switch on or off."""
    tuned = kconv.ConvPlan(4, 5, False)
    calls = []

    def fake_tune(kind, x_shape, w_shape, **kw):
        calls.append((kind, x_shape, kw["device"]))
        return tuned

    monkeypatch.setattr(at, "tune", fake_tune)
    # the table's file is named by the card, which a CPU host cannot ask
    monkeypatch.setattr(at, "device_kind", lambda device=None: "a_card")
    x, w = (1, 8, 8, 16), (3, 3, 16, 16)
    cuda = torch.device("cuda", 0)
    assert at.get_plan("dense", x, w, device=cuda) == \
        kconv.conv_plan(16, 16, 3, 3, 1)        # switch off: the default
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    at.clear_memory_cache()
    assert at.get_plan("dense", x, w, device="cpu") == \
        kconv.conv_plan(16, 16, 3, 3, 1)
    assert not calls
    at.clear_memory_cache()
    for _ in range(3):
        assert at.get_plan("dense", x, w, device=cuda) == tuned
    assert calls == [("dense", x, cuda)]


def test_a_share_takes_the_whole_batchs_plan(table):
    """Inside ``whole_batch_plans(share, whole)`` a launch of ``share``
    rows reads the table's entry of the launch at ``whole`` rows, however
    the table holds the share's own shape; a launch of another batch, and
    every launch outside, keeps its own entry."""
    w = (3, 3, 16, 64)
    whole, share, other = ((n, 16, 16, 16) for n in (5, 2, 3))
    for x, tile in ((whole, 2), (share, 0), (other, 1)):
        at._persist(at.make_key("dense", x, w), kconv.ConvPlan(4, tile, False),
                    "cpu")
    at.clear_memory_cache()

    def tile(x):
        return at.get_plan("dense", x, w, device="cpu").tile

    assert (tile(whole), tile(share), tile(other)) == (2, 0, 1)
    with at.whole_batch_plans(2, 5):
        assert (tile(whole), tile(share), tile(other)) == (2, 2, 1)
        with at.whole_batch_plans(3, 5):
            assert (tile(share), tile(other)) == (0, 2)
    assert (tile(whole), tile(share), tile(other)) == (2, 0, 1)
