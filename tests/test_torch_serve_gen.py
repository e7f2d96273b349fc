"""The port's generative serving path against the JAX reference.

``repro_torch.launch.serve_gen.GenServer`` (``device="cpu"``, both
backends) is held to ``repro.launch.serve_gen.GenServer(backend="xla")``
on the same requests: the reference's denoiser and DCGAN trees carried
across (``params=``), one numpy noise draw handed to both packages'
``init_noise``, widths (8, 8) from a 4x4 mid-block (16x16 images), DCGAN
nz 16 and ngf 4.  A drain must give the same statuses, admission and
completion ticks, dispatch and substep counts, and images within
1e-5 x max(1, max|ref|) (the reference's cross-backend bar,
``tests/test_serve_gen.py``).  Also: the DDIM step builders against
``repro.launch.steps``, the K-step dispatch against K single steps (bit for
bit), the served samples against the port's unbatched loop, the scheduler
(SLO priority, aging, shedding with one stub calibration handed to both,
cancel, timeout, autoscale), ``gen_spec`` and the CLI.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_espnet import perturb

import repro.launch.serve_gen as jsg
import repro_torch.launch.serve_gen as tsg
from repro.core import cycle_model as jcm
from repro.core import gen_spec as jgen
from repro.launch import steps as jsteps
from repro.models import dcgan as jdcgan
from repro.models import unet_decoder as jud
from repro_torch.core import gen_spec as tgen
from repro_torch.launch import steps as tsteps
from repro_torch.models.common import to_device

_WIDTHS, _HW = (8, 8), 4
_SIZE = _HW * 2 ** len(_WIDTHS)          # 16x16 images
_NZ, _NGF = 16, 4
_BAR = 1e-5                              # x max(1, max|ref|)
_BACKENDS = ("kernels", "torch")


def _noise(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_noise():
    """Both packages draw x_T and z from one numpy generator."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsg, "init_noise", lambda s, sh: jnp.asarray(_noise(s, sh)))
        mp.setattr(tsg, "init_noise",
                   lambda s, sh: torch.from_numpy(_noise(s, sh)))
        yield


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(0)
    den = perturb(jax.tree_util.tree_map(np.asarray, jud.init_denoiser_params(
        jax.random.PRNGKey(0), widths=_WIDTHS)), rng)
    gan = perturb(jax.tree_util.tree_map(np.asarray, jdcgan.init_params(
        jax.random.PRNGKey(1), size=64, nz=_NZ, ngf=_NGF)), rng,
        slopes=())
    return {"unet_dec": den, "dcgan64": gan}


class StubCalibration:
    """One calibration handed to both packages: a linear price of each
    layer's MACs, and a fixed dispatch overhead."""

    def predict_layers(self, layers, backend, dtype="float32"):
        return sum(self._us(l) for l in layers) + 5.0

    def predict_layers_split(self, layers, backend):
        return sum(self._us(l) for l in layers), 5.0

    @staticmethod
    def _us(l):
        return 1e-6 * l.h_out * l.w_out * l.cin * l.cout * l.kh * l.kw


def _servers(trees, backend, **kw):
    """(reference server on xla, port server on ``backend``), one config."""
    kw = dict(dict(batch=3, unet_widths=_WIDTHS, unet_hw=_HW, dcgan_nz=_NZ,
                   dcgan_ngf=_NGF, params=trees), **kw)
    return (jsg.GenServer(backend="xla", **kw),
            tsg.GenServer(backend=backend, device="cpu", **kw))


def _img_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _assert_same_drain(ref, port, n):
    """Every request of rid < n: status, ticks and image; and the counts."""
    for rid in range(n):
        r, p = ref.request(rid), port.request(rid)
        assert (p.status, p.admit_tick, p.done_tick, p.steps) == \
            (r.status, r.admit_tick, r.done_tick, r.steps), rid
        if r.status == "done":
            assert p.result.shape == r.result.shape
            assert _img_err(p.result, r.result) <= _BAR, rid
        else:
            assert p.result is None
    rs, ps = ref.stats(), port.stats()
    for key in ("requests", "ticks", "device_steps", "substeps", "cancelled",
                "timeout", "shed", "corrupt", "mean_wait_ticks",
                "max_wait_ticks"):
        assert ps[key] == rs[key], key


# ---------------------------------------------------------------- steps ---

def test_ddim_timesteps_match_reference():
    for s in (1, 2, 7, 10, 25, 50, 1000):
        np.testing.assert_array_equal(tsteps.ddim_timesteps(s),
                                      jsteps.ddim_timesteps(s))
    assert tsteps.ddim_timesteps(5, t_max=100)[0] == 99
    for bad in (0, 1001):
        with pytest.raises(ValueError):
            tsteps.ddim_timesteps(bad)


def test_ddim_alpha_bar_matches_reference():
    """Not bitwise: XLA's CPU ``linspace`` and ``cumprod`` round in another
    order than torch's (the reference's own table is 7.5e-7 relative off
    the correctly rounded one); the port's fp32 table reads 3.0e-7 off the
    reference's, held at 5e-7."""
    want = np.asarray(jsteps.ddim_alpha_bar(), np.float64)
    got = tsteps.ddim_alpha_bar()
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tsteps.DDIM_T_MAX == jsteps.DDIM_T_MAX
    assert np.max(np.abs(got.numpy() - want) / want) <= 5e-7


@pytest.fixture(scope="module")
def step_case(trees):
    """A 4-slot batch at mixed timesteps, two slots inactive, one landing
    on x0, and the reference's step on it."""
    x = _noise(3, (4, _SIZE, _SIZE, 3))
    batch = {"t": np.array([999, 500, 400, 10], np.int32),
             "t_next": np.array([750, 250, 200, -1], np.int32),
             "active": np.array([True, False, True, True])}
    want = np.asarray(jax.jit(jsteps.make_gen_step())(
        trees["unet_dec"], jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in batch.items()}))
    return x, batch, want


@pytest.mark.parametrize("backend", _BACKENDS)
def test_gen_step_matches_reference(trees, step_case, backend):
    x, batch, want = step_case
    step = tsteps.make_gen_step(backend=backend)
    xt = torch.from_numpy(x.copy())
    with torch.no_grad():
        got = step(to_device(trees["unet_dec"], "cpu"), xt,
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _img_err(got.numpy(), want) <= _BAR
    np.testing.assert_array_equal(got[1].numpy(), x[1])   # frozen slot
    np.testing.assert_array_equal(xt.numpy(), x)          # x not modified


def test_scan_step_is_k_single_steps_bitwise(trees):
    """K=3 in one dispatch == three single-step dispatches, bit for bit,
    including a slot whose trajectory tail is padding."""
    params = to_device(trees["unet_dec"], "cpu")
    x = torch.from_numpy(_noise(9, (2, _SIZE, _SIZE, 3)))
    t = torch.tensor([[999, 500, 250], [999, 0, 0]])
    t_next = torch.tensor([[500, 250, 0], [-1, -1, -1]])
    act = torch.tensor([[True, True, True], [True, False, False]])
    one = tsteps.make_gen_step()
    with torch.no_grad():
        y_scan = tsteps.make_gen_scan_step(3)(
            params, x, {"t": t, "t_next": t_next, "active": act})
        y = x
        for j in range(3):
            y = one(params, y, {"t": t[:, j], "t_next": t_next[:, j],
                                "active": act[:, j]})
    assert torch.equal(y_scan, y)
    with pytest.raises(ValueError):
        tsteps.make_gen_scan_step(0)


def test_bf16_step_keeps_dtype_and_frozen_slot(trees, step_case):
    """The fp32 DDIM update is cast back: a bf16 lane stays bf16, an
    inactive slot bit-identical, and the active ones within the
    reference's 5%-of-range bf16 bar of its bf16 step."""
    x, batch, _ = step_case
    xb = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        got = tsteps.make_gen_step(compute_dtype="bf16")(
            to_device(trees["unet_dec"], "cpu"), xb,
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[1], xb[1])
    want = np.asarray(jax.jit(jsteps.make_gen_step(compute_dtype="bf16"))(
        trees["unet_dec"], jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v) for k, v in batch.items()}), np.float32)
    top = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= 0.05 * top
    with pytest.raises(NotImplementedError):
        tsteps.make_gen_step(compute_dtype="fp16")


# -------------------------------------------------------- served drains ---

_MIX = [("unet_dec", 4), ("unet_dec", 2), ("dcgan64", 1), ("unet_dec", 5),
        ("unet_dec", 1), ("unet_dec", 3), ("dcgan64", 1), ("unet_dec", 2),
        ("unet_dec", 4)]


def _submit_mix(server):
    return [server.submit(wl, steps=s, seed=10 + i)
            for i, (wl, s) in enumerate(_MIX)]


@pytest.fixture(scope="module")
def ref_mix(trees):
    ref, _ = _servers(trees, "torch", scan_steps=2)
    _submit_mix(ref)
    ref.run()
    return ref


@pytest.mark.parametrize("backend", _BACKENDS)
def test_mixed_drain_matches_reference(trees, ref_mix, backend):
    """Mixed step budgets through 3 slots, K=2, with a DCGAN lane beside
    the diffusion lane: same statuses, ticks, counts, and images."""
    _, port = _servers(trees, backend, scan_steps=2)
    assert _submit_mix(port) == list(range(len(_MIX)))
    images = port.run()
    assert sorted(images) == list(range(len(_MIX)))
    _assert_same_drain(ref_mix, port, len(_MIX))
    assert images[2].shape == (64, 64, 3) and images[0].shape == \
        (_SIZE, _SIZE, 3)


@pytest.mark.parametrize("backend", _BACKENDS)
def test_served_matches_unbatched_loop(trees, backend):
    """Served at batch 3 and K=3 against the port's unbatched loop at
    batch 1, one step a dispatch: a stated bar, not bitwise (the timestep
    MLP's matmul may round by batch)."""
    _, port = _servers(trees, backend, scan_steps=3)
    steps = [4, 2, 5, 3]
    rids = [port.submit("unet_dec", steps=s, seed=20 + i)
            for i, s in enumerate(steps)]
    images = port.run()
    params = to_device(trees["unet_dec"], "cpu")
    for rid, s in zip(rids, steps):
        ref = tsg.reference_sample(params, steps=s, seed=20 + rid,
                                   image_size=_SIZE, backend=backend,
                                   device="cpu")
        assert _img_err(images[rid], ref) <= _BAR


def test_reference_sample_matches_reference(trees):
    want = jsg.reference_sample(trees["unet_dec"], steps=3, seed=5,
                                image_size=_SIZE)
    got = tsg.reference_sample(to_device(trees["unet_dec"], "cpu"), steps=3,
                               seed=5, image_size=_SIZE, device="cpu")
    assert got.dtype == np.float32 and _img_err(got, want) <= _BAR


@pytest.mark.parametrize("backend", _BACKENDS)
def test_fused_scan_bitwise_against_single_steps(trees, backend):
    """K=3 serving is bit-identical to K=1 at one batch size, in fewer
    dispatches with the same substeps."""
    steps = [4, 2, 3, 5]
    imgs, stats = {}, {}
    for k in (3, 1):
        _, port = _servers(trees, backend, batch=2, scan_steps=k)
        rids = [port.submit("unet_dec", steps=s, seed=30 + i)
                for i, s in enumerate(steps)]
        out = port.run()
        imgs[k], stats[k] = [out[r] for r in rids], port.stats()
    for a, b in zip(imgs[3], imgs[1]):
        np.testing.assert_array_equal(a, b)
    assert stats[3]["device_steps"] < stats[1]["device_steps"]
    assert stats[3]["substeps"] == stats[1]["substeps"] == sum(steps)


def test_deterministic_and_seed_sensitive(trees):
    runs = []
    for _ in range(2):
        _, port = _servers(trees, "kernels", batch=2, scan_steps=2)
        rids = [port.submit("unet_dec", steps=s, seed=sd)
                for s, sd in [(4, 11), (2, 12), (4, 14)]]
        out = port.run()
        runs.append([out[r] for r in rids])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0][0], runs[0][2])


def test_dcgan_lane_matches_reference(trees):
    """Single shot: 5 latents through 2 slots in 3 ticks; ``steps`` forced
    to 1; images as the reference's."""
    ref, port = _servers(trees, "kernels", batch=2)
    for srv in (ref, port):
        for i in range(4):
            srv.submit("dcgan64", seed=40 + i)
        srv.submit("dcgan64", seed=40, steps=99)
        srv.run()
    _assert_same_drain(ref, port, 5)
    assert port.request(4).steps == 1
    np.testing.assert_array_equal(port.request(4).result,
                                  port.request(0).result)
    lane = port._lanes["dcgan64"]
    assert lane.device_steps == 3 and lane.seen_sizes == {2}


# ----------------------------------------------------------- scheduling ---

def _drive_slo(srv):
    a = srv.submit("unet_dec", steps=2, seed=0, slo="batch")
    srv.submit("unet_dec", steps=1, seed=1, slo="batch")
    c = srv.submit("unet_dec", steps=1, seed=2, slo="realtime")
    srv.submit("unet_dec", steps=1, seed=3, slo="realtime")
    for _ in range(3):          # c, d, then a (two steps) admitted
        srv.step()
    srv.submit("unet_dec", steps=1, seed=4, slo="realtime")
    srv.run()
    return a, c


@pytest.mark.parametrize("backend", _BACKENDS)
def test_slo_priority_and_aging_match_reference(trees, backend):
    """Realtime overtakes earlier batch-class requests, FIFO within a
    class, and with ``starvation_ticks=3`` the aged batch request b beats
    a fresh realtime arrival: the same admission order as the
    reference."""
    ref, port = _servers(trees, backend, batch=1, starvation_ticks=3)
    a, c = _drive_slo(ref)
    _drive_slo(port)
    _assert_same_drain(ref, port, 5)
    assert port.request(c).admit_tick < port.request(a).admit_tick
    assert port.request(1).admit_tick < port.request(4).admit_tick  # aged


def test_shedding_matches_reference(trees):
    """With one stub calibration: a request whose estimate exceeds its
    deadline budget is shed at admission, with its estimate stamped; the
    others complete."""
    ref, port = _servers(trees, "kernels", batch=2,
                         calibration=StubCalibration())
    for srv, mod in ((ref, jsg), (port, tsg)):
        srv.submit("unet_dec", steps=4, seed=0,
                   slo=mod.SLOClass("tight", 0, target_us=1e-3))
        srv.submit("unet_dec", steps=2, seed=1)
        srv.submit("dcgan64", seed=2, slo="realtime")
        srv.run()
    _assert_same_drain(ref, port, 3)
    assert port.request(0).status == "shed" and port.stats()["shed"] == 1
    for rid in range(3):
        assert port.request(rid).est_us == pytest.approx(
            ref.request(rid).est_us, rel=1e-12)


def test_admission_estimate_prices_the_served_geometry(trees):
    calib = StubCalibration()
    ref, port = _servers(trees, "kernels", calibration=calib)
    for wl, steps in (("unet_dec", 3), ("dcgan64", 1)):
        assert port.admission_estimate(wl, steps) == pytest.approx(
            ref.admission_estimate(wl, steps), rel=1e-12)
    canon = calib.predict_layers(tgen.GEN_WORKLOADS["unet_dec"](), "kernels")
    assert port.admission_estimate("unet_dec", 1) != pytest.approx(canon)
    assert _servers(trees, "kernels")[1].admission_estimate(
        "unet_dec", 3) is None


def test_choose_scan_steps_matches_reference():
    calib = StubCalibration()
    layers = (tgen.GEN_WORKLOADS["unet_dec"](),
              jgen.GEN_WORKLOADS["unet_dec"]())
    assert tsg.choose_scan_steps(None, layers[0]) == \
        jsg.choose_scan_steps(None, layers[1]) == tsg.DEFAULT_SCAN_STEPS
    compute, dispatch = calib.predict_layers_split(layers[0], "kernels")
    for target in (1e9, dispatch + 2.5 * compute, 0.0):
        for batch in (1, 3):
            assert tsg.choose_scan_steps(
                calib, layers[0], batch=batch, target_tick_us=target) == \
                jsg.choose_scan_steps(calib, layers[1], batch=batch,
                                      target_tick_us=target)
    with pytest.raises(ValueError):
        tsg.choose_scan_steps(calib, layers[0], max_scan=0)


def _drive_cancel_timeout(srv):
    active = srv.submit("unet_dec", steps=6, seed=0)
    queued = srv.submit("unet_dec", steps=2, seed=1)
    srv.step()
    assert srv.cancel(queued) and srv.cancel(active)
    assert not srv.cancel(active)
    srv.submit("unet_dec", steps=3, seed=42)
    srv.submit("unet_dec", steps=50, seed=3, timeout_ticks=3)   # in flight
    srv.submit("unet_dec", steps=1, seed=4, timeout_ticks=2)    # queued
    srv.submit("unet_dec", steps=2, seed=5)
    srv.run()


@pytest.mark.parametrize("backend", _BACKENDS)
def test_cancel_and_timeout_match_reference(trees, backend):
    ref, port = _servers(trees, backend, batch=1)
    _drive_cancel_timeout(ref)
    _drive_cancel_timeout(port)
    _assert_same_drain(ref, port, 6)
    assert [port.request(r).status for r in range(6)] == [
        "cancelled", "cancelled", "done", "timeout", "timeout", "done"]


def _drive_autoscale(srv):
    for i, s in enumerate([4, 3, 2, 5, 3]):
        srv.submit("unet_dec", steps=s, seed=50 + i)
    sizes = []
    while srv._pending or any(l.busy for l in srv._lanes.values()):
        srv.step()
        sizes.append(srv._lanes["unet_dec"].batch)
    for _ in range(3):
        srv.step()
        sizes.append(srv._lanes["unet_dec"].batch)
    return sizes


@pytest.mark.parametrize("backend", _BACKENDS)
def test_autoscale_trajectory_matches_reference(trees, backend):
    kw = dict(batch=1, scan_steps=2, autoscale=True, max_batch=4,
              shrink_patience=1)
    ref, port = _servers(trees, backend, **kw)
    sizes = _drive_autoscale(ref)
    assert _drive_autoscale(port) == sizes
    assert max(sizes) > 1 and sizes[-1] < max(sizes)
    _assert_same_drain(ref, port, 5)
    assert port._lanes["unet_dec"].seen_sizes <= set(sizes)


def test_stats_leave_cold_ticks_out(trees):
    _, port = _servers(trees, "kernels", batch=1)
    for i in range(3):
        port.submit("unet_dec", steps=2, seed=i)
    port.run()
    st = port.stats()
    cold = [t for t in port._tick_log if t[4]]
    assert len(cold) == 1 and port._tick_log[0][4]     # the first tick only
    assert 0 < st["warm_wall_s"] < st["wall_s"]
    assert st["warm_steps_per_s"] > 0
    assert st["latency_p99_s"] >= st["latency_p50_s"] > 0
    assert st["degraded"] == st["retries"] == 0


def test_np_percentile_matches_reference():
    for vals in ([], [7.0], [1.0, 2.0, 3.0, 4.0], [0.3, 5.0, 1.1, 9.4, 2.2]):
        for p in (0.0, 50.0, 99.0, 100.0):
            assert tsg.np_percentile(vals, p) == jcm.np_percentile(vals, p)


def test_rejects_unknown_workload_slo_backend_and_scan(trees):
    _, port = _servers(trees, "kernels")
    with pytest.raises(ValueError, match="unknown workload"):
        port.submit("vae", steps=3)
    with pytest.raises(ValueError, match="unknown SLO class"):
        port.submit("unet_dec", steps=1, slo="platinum")
    with pytest.raises(ValueError, match="unknown backend"):
        tsg.GenServer(backend="xla", device="cpu")
    with pytest.raises(ValueError, match="scan_steps"):
        tsg.GenServer(scan_steps=0, device="cpu")
    with pytest.raises(NotImplementedError, match="fp16"):
        tsg.GenServer(compute_dtype="fp16", device="cpu")


def test_bf16_lane_state_stays_bf16(trees):
    """A bf16 lane keeps its image state bf16 across ticks; its samples
    are finite and within the reference's 5%-of-range bar of the
    reference's bf16 drain."""
    ref, port = _servers(trees, "kernels", batch=2, scan_steps=2,
                         compute_dtype="bf16")
    for srv in (ref, port):
        for i, s in enumerate([3, 2, 4]):
            srv.submit("unet_dec", steps=s, seed=60 + i)
        srv.step()
    assert port._lanes["unet_dec"].x.dtype == torch.bfloat16
    ref.run()
    port.run()
    for rid in range(3):
        got, want = port.request(rid).result, np.asarray(
            ref.request(rid).result, np.float32)
        assert got.dtype == np.float32 and np.isfinite(got).all()
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


# ------------------------------------------------------ tables and CLI ---

def test_gen_spec_tables_match_reference():
    assert tgen.UNET_WIDTHS == jgen.UNET_WIDTHS
    assert tgen.UNET_UP_KERNELS == jgen.UNET_UP_KERNELS
    assert sorted(tgen.GEN_WORKLOADS) == sorted(jgen.GEN_WORKLOADS)
    tables = [(tgen.GEN_WORKLOADS[n](), jgen.GEN_WORKLOADS[n]())
              for n in tgen.GEN_WORKLOADS]
    tables.append((tgen.unet_decoder_layers(_WIDTHS, hw=_HW),
                   jgen.unet_decoder_layers(_WIDTHS, hw=_HW)))
    tables.append((tgen.dcgan_layers(128, nz=_NZ, ngf=_NGF),
                   jgen.dcgan_layers(128, nz=_NZ, ngf=_NGF)))
    for got, want in tables:
        assert [dataclasses.astuple(l) for l in got] == \
            [dataclasses.astuple(l) for l in want]
    with pytest.raises(ValueError):
        tgen.dcgan_layers(32)


@pytest.mark.parametrize("args", [
    [], ["--workload", "dcgan64", "--dtype", "bf16", "--backend", "torch",
         "--autoscale", "--requests", "5", "--batch", "2"]])
def test_cli_smoke_on_cpu(capsys, args):
    tsg.main(["--smoke", "--device", "cpu"] + args)
    out = capsys.readouterr().out
    assert "[serve_gen] " in out and "img/s" in out and "image shape" in out
