"""Generative serving over a mesh of gloo CPU ranks, and the failover pool.

A ``GenServer(mesh=)`` on 1, 2 and 4 ranks (each rank runs the scheduler;
a lane's slots split over the data axis) drains the U-Net denoiser and
DCGAN-64 lanes to images bitwise equal on every rank and to the
unmeshed server's.  A drain snapshotted mid-flight on 4 ranks restores
on 2 ranks (and in one unmeshed process) and finishes bitwise equal to
the uninterrupted drain.  The failover drill of ``tests/test_chaos.py``:
three in-process hosts, one killed before it serves, its requests
reassigned, the drain bitwise equal to the no-fault run.  And the CLI's
``--devices``.
"""

import time

import numpy as np
import pytest

from repro_torch.launch import data_axis
from repro_torch.launch.failover import FailoverPool
from repro_torch.launch.mesh import launch
from repro_torch.launch.serve_gen import GenServer, main

_KW = dict(batch=4, unet_widths=(8, 8), unet_hw=4, dcgan_nz=16,
           dcgan_ngf=4, scan_steps=2)
_REQUESTS = ([("unet_dec", s, 40 + i) for i, s in enumerate((4, 2, 3, 5, 1,
                                                            6))]
             + [("dcgan64", 1, 7 + i) for i in range(4)])
_SNAP_TICK = 2


def _drain_unmeshed():
    srv = GenServer(device="cpu", **_KW)
    for wl, steps, seed in _REQUESTS:
        srv.submit(wl, steps=steps, seed=seed)
    return srv.run()


@pytest.fixture(scope="module")
def drains(tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("mesh_snap") / "snap")
    fresh = ("serve", {"server_kw": _KW, "requests": _REQUESTS})
    first = {1: launch(data_axis.run, 1, device="cpu", args=([fresh],),
                       join=False),
             4: launch(data_axis.run, 4, device="cpu",
                       args=([("serve", {"server_kw": _KW,
                                         "requests": _REQUESTS,
                                         "snapshot": (_SNAP_TICK, snap)})],),
                       join=False)}
    plain = _drain_unmeshed()
    out = {n: ranks.result() for n, ranks in first.items()}
    out[2] = launch(data_axis.run, 2, device="cpu",
                    args=([fresh, ("serve", {"restore": snap})],))
    out["plain"], out["snap"] = plain, snap
    return out


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), rid


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_mesh_drain_bitwise_equal_to_one_rank(drains, nd):
    one = drains[1][0]["serve"]["images"]
    _assert_bitwise(one, drains["plain"])
    for rank in drains[nd]:
        got = rank["serve"]
        _assert_bitwise(got["images"], one)
        assert got["stats"]["requests"] == len(_REQUESTS)


def test_snapshot_at_4_ranks_restores_on_2_bitwise(drains):
    want = drains[1][0]["serve"]["images"]
    for rank in drains[2]:
        got = rank["serve#1"]
        assert got["stats"]["recoveries"] == 1.0
        _assert_bitwise(got["images"], want)


def test_meshed_snapshot_restores_unmeshed(drains):
    with pytest.raises(ValueError, match="reshard"):
        GenServer.restore(drains["snap"], device="cpu")
    srv = GenServer.restore(drains["snap"], device="cpu", mesh=None)
    assert srv.mesh is None and srv._tick == _SNAP_TICK
    _assert_bitwise(srv.run(), drains["plain"])


def test_spatial_raises(drains):
    """``spatial=True`` no longer raises: without a mesh it changes
    nothing (the drain is bitwise the plain one), and a snapshot keeps the
    flag, so a restore onto a mesh splits the rows again."""
    srv = GenServer(device="cpu", spatial=True, **_KW)
    assert srv.spatial and srv._snapshot_config()["spatial"]
    for wl, steps, seed in _REQUESTS:
        srv.submit(wl, steps=steps, seed=seed)
    _assert_bitwise(srv.run(), drains["plain"])


_POOL_KW = dict(_KW, batch=3, device="cpu")
_MIX = [("unet_dec", 6, "realtime"), ("unet_dec", 4, "standard"),
        ("unet_dec", 7, "batch"), ("dcgan64", 1, "standard"),
        ("unet_dec", 5, "batch")]


@pytest.fixture(scope="module")
def pool_ref():
    ref = GenServer(**_POOL_KW)
    rids = [ref.submit(wl, steps=s, seed=100 + i, slo=slo)
            for i, (wl, s, slo) in enumerate(_MIX)]
    return rids, ref.run()


def _pool_submit(pool):
    return [pool.submit(wl, steps=s, seed=100 + i, slo=slo)
            for i, (wl, s, slo) in enumerate(_MIX)]


def test_pool_drain_no_fault_bitwise(tmp_path, pool_ref):
    rids, ref = pool_ref
    pool = FailoverPool(str(tmp_path / "hb"), hosts=2, timeout_s=30.0,
                        server_kw=_POOL_KW)
    toks = _pool_submit(pool)
    out = pool.drain()
    assert pool.stats()["dead_hosts"] == 0 and not pool.failovers
    _assert_bitwise({rids[i]: out[t] for i, t in enumerate(toks)}, ref)


def test_heartbeat_failover_drain_bitwise(tmp_path, pool_ref):
    rids, ref = pool_ref
    pool = FailoverPool(str(tmp_path / "hb"), hosts=3, timeout_s=0.1,
                        server_kw=_POOL_KW)
    toks = _pool_submit(pool)
    victim = 1
    owned = [t for t, (h, _) in pool._where.items() if h == victim]
    assert owned
    pool.kill_host(victim)
    time.sleep(0.15)                        # let the last beat go stale
    out = pool.drain()
    st = pool.stats()
    assert st["dead_hosts"] == 1 and st["completed"] == len(_MIX)
    assert {t for t, _, _ in pool.failovers} == set(owned)
    assert all(frm == victim and to != victim
               for _, frm, to in pool.failovers)
    _assert_bitwise({rids[i]: out[t] for i, t in enumerate(toks)}, ref)


def test_pool_drain_stall_raises(tmp_path):
    pool = FailoverPool(str(tmp_path / "hb"), hosts=1, timeout_s=30.0,
                        server_kw=_POOL_KW)
    pool.submit("unet_dec", steps=2, seed=1)
    pool.kill_host(0)
    with pytest.raises(RuntimeError, match="stalled"):
        pool.drain(max_idle_s=0.2)
    with pytest.raises(ValueError, match="hosts"):
        FailoverPool(str(tmp_path / "hb2"), hosts=0)


def test_cli_spawns_the_ranks(capfd):
    main(["--smoke", "--device", "cpu", "--devices", "2", "--requests",
          "3", "--scan-steps", "2"])
    out = capfd.readouterr().out
    assert out.count("[serve_gen] 3 requests") == 1    # rank 0 reports
