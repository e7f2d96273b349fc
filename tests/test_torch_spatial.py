"""Image rows over the model axis on gloo CPU ranks: the halo exchange and
its adjoint, ``shard_conv2d(spatial=True)`` and ``GenServer(spatial=True)``.

One spawn of 4 ranks runs every world of this file (``data_axis.
run_worlds``): the ``(2, 2)`` and ``(1, 4)`` meshes on all four, then the
``(1, 2)`` mesh on ranks 0-1.  Each world exchanges halos on a tiny
tensor (the rows received, what the counter says moved, and the adjoint's
fixed-order sum, bitwise), runs the conv cases (dense s = 1, 2; dilated d
= 2, 4; transposed k = 3, 4 at s = 2; 16 rows, so the rows split, and one
13-row case, whose rows stay whole as the reference's guard resolves them;
the torch backend's band forms too) and drains the reduced denoiser with
its rows split.  The forwards are bitwise the port's unsharded call, ``dx``/``dw`` within 1e-5 x max(1,
max|ref|), and the unsharded call within 1e-5 of the reference's xla
``conv2d``; the drains are bitwise the unmeshed drain, and a ``(2, 2)``
snapshot restored on ``(1, 2)`` finishes bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decompose import conv2d as jconv2d
from repro_torch.core.decompose import band_split
from repro_torch.launch import data_axis
from repro_torch.launch.mesh import launch, make_smoke_mesh
from repro_torch.launch.serve_gen import GenServer, main

_MESHES = {(2, 2): (0, 1, 2, 3), (1, 4): (0, 1, 2, 3), (1, 2): (0, 1)}
_X = (2, 16, 12, 4)
_CASES = [
    ("dense s1", _X, (3, 3, 4, 5), {}),
    ("dense s2", _X, (3, 3, 4, 5), {"stride": 2}),
    ("dilated d2", _X, (3, 3, 4, 5), {"dilation": 2}),
    ("dilated d4", _X, (3, 3, 4, 5), {"dilation": 4}),
    ("transposed k3", _X, (3, 3, 4, 5), {"transposed": True, "stride": 2}),
    ("transposed k4", _X, (4, 4, 4, 5),
     {"transposed": True, "stride": 2, "padding": 2}),
    ("13 rows", (2, 13, 12, 4), (3, 3, 4, 5), {}),
    # the torch backend's band forms (the lanes' degrade rung)
    ("dense s1 torch", _X, (3, 3, 4, 5), {"backend": "torch"}),
    ("dilated d2 torch", _X, (3, 3, 4, 5), {"dilation": 2,
                                            "backend": "torch"}),
    ("transposed k4 torch", _X, (4, 4, 4, 5),
     {"transposed": True, "stride": 2, "padding": 2, "backend": "torch"}),
]
_SPATIAL = [(label, xs, ws, dict(kw, spatial=True))
            for label, xs, ws, kw in _CASES]
_HALO = ((2, 12, 3), 4, 2)      # (N, H, W): at 4 bands the halo above
_GRAD_TOL = 1e-5                # spans two of them
_REF_TOL = 1e-5
_GEN_KW = dict(batch=4, unet_widths=(8, 8), unet_hw=4, dcgan_nz=16,
               dcgan_ngf=4, scan_steps=2)
_REQUESTS = ([("unet_dec", s, 40 + i) for i, s in enumerate((4, 2, 3, 5))]
             + [("dcgan64", 1, 7)])
_SNAP_TICK = 2


def _drain_unmeshed():
    srv = GenServer(device="cpu", **_GEN_KW)
    for wl, steps, seed in _REQUESTS:
        srv.submit(wl, steps=steps, seed=seed)
    return srv.run()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("spatial_snap") / "snap")
    shape, h_lo, h_hi = _HALO
    serve_kw = dict(_GEN_KW, spatial=True)

    def jobs(mesh):
        serve = {"server_kw": serve_kw, "requests": _REQUESTS}
        if mesh == (2, 2):
            serve["snapshot"] = (_SNAP_TICK, snap)
        out = [("halo", {"shape": shape, "h_lo": h_lo, "h_hi": h_hi}),
               ("conv", {"cases": _SPATIAL}), ("serve", serve)]
        if mesh == (1, 2):
            out.append(("serve", {"restore": snap}))
        return out

    order = list(_MESHES)
    ranks = launch(data_axis.run_worlds, 4, device="cpu",
                   args=([(_MESHES[m], jobs(m), m) for m in order],),
                   join=False)
    plain = _drain_unmeshed()
    out = ranks.result()
    return {"plain": plain,
            **{m: [out[r][i] for r in _MESHES[m]]
               for i, m in enumerate(order)}}


def _whole_halo():
    shape, _, _ = _HALO
    return torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape, dtype=np.float32))


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
def test_halo_rows_bytes_and_adjoint(worlds, mesh):
    shape, h_lo, h_hi = _HALO
    whole = _whole_halo()
    m, height = mesh[1], shape[1]
    hb = height // m
    slab_rows = min(h_lo, hb) + min(h_hi, hb)
    res = [rank["halo"] for rank in worlds[mesh]]
    for idx, got in enumerate(res):
        r = idx % m
        lo, hi = max(0, r * hb - h_lo), min(height, (r + 1) * hb + h_hi)
        assert (got["n_lo"], got["n_hi"]) == (r * hb - lo, hi - (r + 1) * hb)
        assert torch.equal(got["ext"], whole[:, lo:hi])
        # the forward's slab: a band's first min(h_hi, hb) and last
        # min(h_lo, hb) rows; the adjoint's: a whole halo's gradient
        for pass_, wire in (("forward", slab_rows), ("adjoint", h_lo + h_hi)):
            st = got[pass_]
            assert st["exchanges"] == 1
            assert st["rows"] == got["n_lo"] + got["n_hi"]
            assert st["wire_rows"] == (m - 1) * wire
        # the gather brings each rank the other ranks' boundary slabs
        assert got["forward"]["bytes"] == ((m - 1) * slab_rows * shape[0]
                                           * shape[2] * 4)
    # the adjoint (one model group): own rows, then the bands above
    # (nearest first), then the bands below, bitwise
    group = res[:m]
    for r in range(m):
        g = [x["cotangent"] for x in group]
        start = [q * hb - group[q]["n_lo"] for q in range(m)]
        want = g[r][:, group[r]["n_lo"]:group[r]["n_lo"] + hb].clone()
        order = list(range(r - 1, -1, -1)) + list(range(r + 1, m))
        for q in order:
            for row in range(r * hb, (r + 1) * hb):
                own_q = q * hb <= row < (q + 1) * hb
                if not own_q and start[q] <= row < start[q] + g[q].shape[1]:
                    want[:, row - r * hb] += g[q][:, row - start[q]]
        assert torch.equal(group[r]["grad"], want), r


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
@pytest.mark.parametrize("label", [c[0] for c in _CASES])
def test_spatial_conv_bitwise_and_grads(worlds, mesh, label):
    lead = worlds[mesh][0]["conv"][label]
    assert lead["equal"], f"{label} on {mesh}: forward != unsharded"
    for g in ("dx", "dw"):
        rel = lead[f"{g}_err"] / max(1.0, lead[f"{g}_scale"])
        assert rel <= _GRAD_TOL, (g, rel)
    for rank in worlds[mesh]:
        got = rank["conv"][label]
        assert got["digest"] == lead["digest"]
        assert got["grad_digests"] == lead["grad_digests"]


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
def test_which_cases_split(worlds, mesh):
    """Every case but the 13-row one splits its rows: each rank launches
    its kernel on band shapes and exchanges halos (a 1x1 reach needs none);
    the 13-row case runs the whole image on every rank, as the
    reference's guard resolves it."""
    m = mesh[1]
    for label, xs, ws, kw in _CASES:
        bands = band_split(xs, ws, m, **kw)
        got = worlds[mesh][0]["conv"][label]
        heights = {shape[1] for _, shape in got["launch_rows"]}
        if label == "13 rows":
            assert isinstance(bands, str) and "do not split" in bands
            assert heights == {13} and got["halos"]["exchanges"] == 0
            continue
        assert not isinstance(bands, str), (label, bands)
        assert got["halos"]["exchanges"] == 1
        if kw.get("backend") == "torch":        # no kernel launches
            assert not heights
            continue
        assert max(heights) < (xs[1] if not kw.get("dilation")
                               else xs[1] // kw["dilation"]), (label, heights)


@pytest.mark.parametrize("label", [c[0] for c in _CASES])
def test_unsharded_call_matches_reference_xla(worlds, label):
    i = [c[0] for c in _CASES].index(label)
    _, xs, ws, kw = _CASES[i]
    rng = np.random.default_rng(i)
    x = rng.standard_normal(xs, dtype=np.float32)
    w = rng.standard_normal(ws, dtype=np.float32)
    kw = {k: v for k, v in kw.items() if k != "backend"}
    want = np.asarray(jconv2d(jnp.asarray(x), jnp.asarray(w), backend="xla",
                              **kw))
    got = worlds[(1, 2)][0]["conv"][label]["ref"].numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= _REF_TOL * scale


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), rid


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
def test_spatial_drain_bitwise_equal_to_unmeshed(worlds, mesh):
    for rank in worlds[mesh]:
        got = rank["serve"]
        _assert_bitwise(got["images"], worlds["plain"])
        assert got["halos"]["exchanges"] > 0
        # the denoiser's launches ran on bands of the 16-row image
        rows = {shape[1] for kind, shape in got["launch_rows"]
                if kind == "conv2d" and shape[2] == 16}
        assert rows and max(rows) < 16


def test_spatial_snapshot_restores_on_another_mesh(worlds):
    for rank in worlds[(1, 2)]:
        got = rank["serve#3"]
        assert got["stats"]["recoveries"] == 1.0
        _assert_bitwise(got["images"], worlds["plain"])


def test_spatial_split_rules():
    """The guard (rows divide by the model extent) and the band's alignment
    with the stride or the dilation decide which convs split."""
    assert isinstance(band_split((1, 16, 8, 4), (3, 3, 4, 4), 4,
                                 dilation=8), str)        # 4-row band, d 8
    assert isinstance(band_split((1, 12, 8, 4), (3, 3, 4, 4), 4,
                                 stride=2), str)          # 3-row band, s 2
    assert isinstance(band_split((1, 16, 8, 4), (3, 3, 4, 4), 2,
                                 dilation=2, stride=2), str)
    b = band_split((1, 64, 8, 4), (3, 3, 4, 4), 4, dilation=16)
    assert (b.h_lo, b.h_hi) == (16, 16) and b.counts == [16] * 4
    b = band_split((1, 16, 8, 4), (4, 4, 4, 4), 2, transposed=True,
                   stride=2, padding=2)
    assert b.out_height == 32 and b.counts == [16, 16]
    assert (b.h_lo, b.h_hi) == (1, 1)
    assert make_smoke_mesh(4).shape == {"data": 2, "model": 2}


def test_cli_spatial_spawns_the_ranks(capfd):
    main(["--smoke", "--device", "cpu", "--devices", "2", "--spatial",
          "--requests", "3", "--scan-steps", "2"])
    out = capfd.readouterr().out
    assert out.count("[serve_gen] 3 requests") == 1    # rank 0 reports
