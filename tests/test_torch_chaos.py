"""Chaos drills of the port's generative server (DESIGN.md §11), on the CPU.

The counterparts of ``tests/test_chaos.py``'s serving drills for
``repro_torch.launch.serve_gen.GenServer``: a drain killed at an early, a
mid and the last tick and restored from its snapshots finishes bit for bit
as the uninterrupted drain; a sparse snapshot cadence replays the lost
ticks; a persistent ``"kernels"`` fault walks the retry ladder and degrades
the lane to ``"torch"``; a transient fault is absorbed by one retry; an
error that is not the fault plane's propagates without a retry; a
NaN-poisoned slot is re-run from its seed; the watchdog sheds the lowest
class; snapshots carry custom parameters and a bf16 lane's state; and a
restore without a snapshot raises.  Widths (8, 8), 16x16 images, DCGAN
nz 16 and ngf 4, weights from the port's seeded init.
"""

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.distributed.fault_tolerance import (FailureInjector, Fault,
                                                     StragglerWatchdog,
                                                     failure_faults)
from repro_torch.launch.serve_gen import GenServer
from repro_torch.models import unet_decoder

_KW = dict(batch=3, unet_widths=(8, 8), unet_hw=4, dcgan_nz=16, dcgan_ngf=4,
           scan_steps=2, device="cpu")

#: (workload, steps, slo): mixed budgets and classes and a DCGAN request,
#: so a snapshot holds every kind of scheduler state
_MIX = [("unet_dec", 6, "realtime"), ("unet_dec", 4, "standard"),
        ("unet_dec", 7, "batch"), ("dcgan64", 1, "standard"),
        ("unet_dec", 5, "batch")]


def _submit_mix(server):
    return [server.submit(wl, steps=s, seed=100 + i, slo=slo)
            for i, (wl, s, slo) in enumerate(_MIX)]


def _assert_bitwise_equal(imgs, ref_imgs):
    assert sorted(imgs) == sorted(ref_imgs)
    for rid in ref_imgs:
        assert np.array_equal(imgs[rid], ref_imgs[rid]), rid


@pytest.fixture(scope="module")
def clean():
    """The uninterrupted drain of ``_MIX``: (images, ticks)."""
    ref = GenServer(**_KW)
    _submit_mix(ref)
    return ref.run(), ref._tick


def _killed(tmp_path, name, kill_tick, every=1, **kw):
    d = str(tmp_path / name)
    server = GenServer(snapshot_dir=d, snapshot_every=every,
                       faults=failure_faults(kill_at=kill_tick),
                       **dict(_KW, **kw))
    _submit_mix(server)
    with pytest.raises(RuntimeError, match="injected server kill"):
        server.run()
    return d


@pytest.mark.parametrize("where", ["early", "mid", "last"])
def test_kill_restore_is_bitwise(tmp_path, clean, where):
    ref_imgs, ticks = clean
    assert ticks >= 3
    kill_tick = {"early": 1, "mid": ticks // 2, "last": ticks - 1}[where]
    restored = GenServer.restore(_killed(tmp_path, where, kill_tick))
    assert restored._tick == kill_tick
    _assert_bitwise_equal(restored.run(), ref_imgs)
    st = restored.stats()
    assert st["recoveries"] >= 1 and st["snapshots"] >= kill_tick
    assert st["degraded"] == st["retries"] == 0


def test_sparse_snapshots_replay_lost_ticks(tmp_path, clean):
    """With ``snapshot_every=2`` and an odd kill tick the newest snapshot
    is older than the crash: the restored drain replays the lost ticks,
    requests completed in between included, to the same images."""
    ref_imgs, ticks = clean
    kill_tick = ticks - 1 if (ticks - 1) % 2 else ticks - 2
    restored = GenServer.restore(_killed(tmp_path, "sparse", kill_tick,
                                         every=2))
    assert restored._tick < kill_tick
    _assert_bitwise_equal(restored.run(), ref_imgs)


def test_restore_without_snapshot_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        GenServer.restore(str(tmp_path / "empty"))


def test_snapshot_roundtrips_custom_params(tmp_path):
    """Lane parameters travel in the snapshot: a server built with its own
    denoiser tree restores to the same samples without being handed it."""
    tree = _as_numpy(unet_decoder.init_denoiser_params(
        torch.Generator().manual_seed(7), widths=(8, 8), device="cpu"))
    ref = GenServer(params={"unet_dec": tree}, **_KW)
    rid = ref.submit("unet_dec", steps=4, seed=3)
    ref_img = ref.run()[rid]
    assert not np.array_equal(ref_img, _default_sample())
    d = str(tmp_path / "p")
    server = GenServer(params={"unet_dec": tree}, snapshot_dir=d,
                       snapshot_every=1, faults=failure_faults(kill_at=1),
                       **_KW)
    assert server.submit("unet_dec", steps=4, seed=3) == rid
    with pytest.raises(RuntimeError, match="injected server kill"):
        server.run()
    restored = GenServer.restore(d)        # no params= handed over
    assert np.array_equal(restored.run()[rid], ref_img)


def _as_numpy(tree):
    return {k: _as_numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _default_sample():
    srv = GenServer(**_KW)
    rid = srv.submit("unet_dec", steps=4, seed=3)
    return srv.run()[rid]


def test_snapshot_keys_and_bf16_state(tmp_path):
    """The snapshot's arrays: ``param:{wl}:{i:05d}`` leaves in the sorted
    order of their dotted names, ``lane:{wl}:x`` in the lane dtype (a bf16
    lane's state round-trips as bf16), ``done:{rid:08d}`` results; and a
    restored bf16 drain finishes bit for bit."""
    kw = dict(_KW, compute_dtype="bf16")
    ref = GenServer(**kw)
    _submit_mix(ref)
    ref_imgs = ref.run()
    d = _killed(tmp_path, "bf16", 2, compute_dtype="bf16")
    arrays, meta = ckpt.load_flat(d, ckpt.latest_step(d))
    x = arrays["lane:unet_dec:x"]
    assert isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
    lane = GenServer(**kw)._lane("unet_dec")
    names = sorted(lane.param_leaves())
    for i, n in enumerate(names):
        np.testing.assert_array_equal(arrays[f"param:unet_dec:{i:05d}"],
                                      lane.param_leaves()[n].numpy())
    assert f"param:unet_dec:{len(names):05d}" not in arrays
    assert meta["config"]["compute_dtype"] == "bfloat16"
    assert any(k.startswith("done:") for k in arrays)
    restored = GenServer.restore(d)
    assert restored._lanes["unet_dec"].x.dtype == torch.bfloat16
    _assert_bitwise_equal(restored.run(), ref_imgs)


# ---------------------------------------------------- degradation + retry ---

def test_persistent_kernels_fault_degrades_lane_to_torch():
    """A persistent ``"kernels"`` dispatch failure degrades the lane to
    ``"torch"`` and the drain finishes, bit for bit as a clean torch-backend
    drain (the fault fired before any kernels dispatch)."""
    server = GenServer(faults=failure_faults(backend_broken="kernels"),
                       max_retries=1, retry_backoff_s=1e-4, **_KW)
    rids = [server.submit("unet_dec", steps=4, seed=i) for i in range(3)]
    imgs = server.run()
    st = server.stats()
    assert sorted(imgs) == rids
    assert st["degraded"] == 1 and st["retries"] == 1
    assert server._lanes["unet_dec"].backend == "torch"
    clean = GenServer(backend="torch", **_KW)
    for i in range(3):
        clean.submit("unet_dec", steps=4, seed=i)
    _assert_bitwise_equal(imgs, clean.run())


def test_transient_fault_retries_and_recovers(clean):
    inj = FailureInjector(faults=[Fault(at=1, kind="raise")])
    server = GenServer(faults=inj, retry_backoff_s=1e-4, **_KW)
    _submit_mix(server)
    imgs = server.run()
    st = server.stats()
    assert st["retries"] == 1 and st["recoveries"] == 1
    assert st["degraded"] == 0
    _assert_bitwise_equal(imgs, clean[0])


def test_torch_lane_exhausting_retries_propagates():
    """No rung below ``"torch"``: a persistent fault there surfaces after
    the retry budget."""
    inj = FailureInjector(faults=[Fault(at=None, kind="raise", once=False)])
    server = GenServer(faults=inj, max_retries=2, retry_backoff_s=1e-4,
                       **_KW)
    server.submit("unet_dec", steps=2, seed=0)
    with pytest.raises(RuntimeError, match="injected torch dispatch failure"):
        server.run()
    st = server.stats()
    assert st["retries"] == 4 and st["degraded"] == 1


def test_real_dispatch_error_propagates_without_retry(monkeypatch):
    """Only the fault plane's errors walk the ladder: any other failure of
    a kernels dispatch (a kernel that does not build or launch) propagates
    at once, with no retry and no degraded lane."""
    from repro_torch.launch import serve_gen

    def broken(self):
        raise RuntimeError("conv kernel failed to launch")

    monkeypatch.setattr(serve_gen._DiffusionLane, "tick", broken)
    server = GenServer(retry_backoff_s=1e-4, **_KW)
    server.submit("unet_dec", steps=2, seed=0)
    with pytest.raises(RuntimeError, match="failed to launch"):
        server.run()
    st = server.stats()
    assert st["retries"] == 0 and st["degraded"] == 0
    assert server._lanes["unet_dec"].backend == "kernels"


# ------------------------------------------------------------- corruption ---

@pytest.mark.parametrize("workload", ["unet_dec", "dcgan64"])
def test_corrupt_slot_requeued_and_rerun_bitwise(workload):
    inj = FailureInjector(faults=[Fault(at=1 if workload == "unet_dec"
                                        else 0, kind="corrupt", slot=0)])
    server = GenServer(faults=inj, **_KW)
    rid = server.submit(workload, steps=4, seed=7)
    imgs = server.run()
    req = server.request(rid)
    assert req.requeues == 1 and req.status == "done"
    assert server.stats()["recoveries"] == 1
    clean = GenServer(**_KW)
    crid = clean.submit(workload, steps=4, seed=7)
    assert np.array_equal(imgs[rid], clean.run()[crid])


def test_corrupt_slot_exhausting_requeues_is_terminal():
    inj = FailureInjector(
        faults=[Fault(at=None, kind="corrupt", slot=0, once=False)])
    server = GenServer(faults=inj, max_requeues=1, **dict(_KW, batch=1))
    rid = server.submit("unet_dec", steps=3, seed=0)
    assert server.run() == {}
    req = server.request(rid)
    assert req.status == "corrupt" and req.result is None
    assert req.requeues == 1 and server.stats()["corrupt"] == 1


# ------------------------------------------------------ stuck-tick ladder ---

def test_watchdog_sheds_batch_class_first():
    inj = FailureInjector(faults=[Fault(at=t, kind="slow", seconds=0.25)
                                  for t in range(3, 9)])
    wd = StragglerWatchdog(alpha=1.0, threshold=3.0, warmup=1)
    server = GenServer(faults=inj, watchdog=wd, stuck_shed_after=2,
                       **dict(_KW, batch=2))
    rids = [server.submit("unet_dec", steps=8, seed=i,
                          slo="standard" if i < 4 else "batch")
            for i in range(6)]
    imgs = server.run()
    assert server.stats()["shed"] == 2.0
    assert all(server.request(r).status == "done" for r in rids[:4])
    assert all(server.request(r).status == "shed" for r in rids[4:])
    assert sorted(imgs) == rids[:4]


def test_auto_snapshot_cadence_and_gc(tmp_path):
    d = str(tmp_path / "cad")
    server = GenServer(snapshot_dir=d, snapshot_every=2, snapshot_keep=2,
                       **_KW)
    _submit_mix(server)
    server.run()
    assert server.stats()["snapshots"] == server._tick // 2
    steps = ckpt.all_steps(d)
    assert len(steps) <= 2 and steps[-1] <= server._tick


def _fault_script(ft, broken):
    """What a fault plane does over a fixed script of queries."""
    out = []
    inj = ft.failure_faults(kill_at=3, backend_broken=broken)
    out += [len(inj.take(t, kind="kill")) for t in (2, 3, 3)]
    out += [len(inj.take(t, kind="raise", backend=b)) for t in range(3)
            for b in (broken, "other", None)]
    inj = ft.FailureInjector({4}, faults=[
        ft.Fault(at=2, kind="slow", seconds=0.5),
        ft.Fault(at=None, kind="corrupt", target="dcgan64", slot=3),
        ft.Fault(at=1, kind="raise", target="unet_dec", once=False)])
    out += [inj.sleep_faults(2), inj.sleep_faults(2)]
    out += [[f.slot for f in inj.take(t, kind="corrupt", target=w)]
            for t in (0, 1) for w in ("unet_dec", "dcgan64", None)]
    out += [len(inj.take(1, kind="raise", target=w))
            for w in ("dcgan64", "unet_dec", "unet_dec")]
    with pytest.raises(RuntimeError, match="injected node failure"):
        inj.maybe_fail(4)
    inj.maybe_fail(4)                       # consumed
    with pytest.raises(ValueError, match="unknown fault kind"):
        ft.Fault(at=0, kind="explode")
    wd = ft.StragglerWatchdog(alpha=0.5, threshold=2.0, warmup=2)
    out += [wd.observe(i, dt) for i, dt in
            enumerate([1.0, 1.5, 5.0, 1.0, 2.9, 9.0])]
    return out + [wd.flagged]


def test_fault_plane_matches_reference():
    """The fault plane consumes as the reference's does (its backend names
    are the port's): once faults fire once, persistent ones while their
    target and backend match; the watchdog flags the same ticks."""
    from repro.distributed import fault_tolerance as jft
    from repro_torch.distributed import fault_tolerance as tft

    assert _fault_script(tft, "kernels") == _fault_script(jft, "pallas")
