"""The port's calibration layer against the JAX reference.

``repro_torch.core.calibrate`` fits modeled cycles to measured times as
``repro.core.calibrate`` does.  On one numpy-drawn sample set (seeded) the
closed-form fits agree to 1e-12 relative, for every key and through the
degenerate cases (one sample, one abscissa, a negative intercept or
slope); ``layer_of``, ``modeled_cycles`` and ``tile_scores`` equal the
reference's exactly on ``default_cases``; the payloads cross-load both ways
through the backend-name map (``xla`` <-> ``torch``, ``pallas`` <->
``kernels``); and a port ``GenServer`` on the CPU with a calibration
fitted from the same samples stamps the same ``est_us`` (1e-12 relative)
and picks the same ``scan_steps="auto"`` depth as the reference's on the
mapped backend.  A capture on CPU tensors lands under a ``cpu`` key.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.launch.serve_gen as jsg
import repro_torch.launch.serve_gen as tsg
from repro.core import calibrate as jcal
from repro_torch.core import calibrate as tcal
from repro_torch.kernels.util import time_call

_RTOL = 1e-12
#: the reference's backend -> the port's, as the payload map renames them
_PAIRS = [("xla", "torch"), ("pallas", "kernels")]


def _draw(seed, backend, n=24):
    """(cycles, us) pairs per engine kind and dtype: an affine law plus
    noise, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for kind in jcal.KINDS:
        for dtype in ("float32", "bfloat16"):
            a, b = rng.uniform(1e-4, 5e-3), rng.uniform(2.0, 40.0)
            for i in range(n):
                cycles = float(rng.uniform(1e3, 5e6))
                us = float(a * cycles + b + rng.normal(0.0, 3.0))
                out.append((kind, backend, dtype, f"{kind}/{i}", cycles,
                            max(us, 1.0)))
    return out


def _samples(mod, rows):
    return [mod.Sample(kind, backend, "cpu", name, cycles, us, dtype=dtype)
            for kind, backend, dtype, name, cycles, us in rows]


def _close(a, b):
    return abs(a - b) <= _RTOL * max(abs(a), abs(b), 1e-300)


def _same_coeffs(t, j):
    assert t.n == j.n
    assert _close(t.a_us_per_cycle, j.a_us_per_cycle)
    assert _close(t.b_us, j.b_us)


@pytest.mark.parametrize("pairs", [
    [(1e4, 12.0)],                                  # one sample
    [(5e3, 9.0), (5e3, 11.0)],                      # one abscissa
    [(1e3, 100.0), (1e6, 50.0), (2e6, 10.0)],       # falling: slope < 0
    [(1e3, 1.0), (1e6, 900.0), (2e6, 2100.0)],      # intercept < 0
    [(1e3, 10.0), (1e5, 60.0), (5e5, 260.0), (2e6, 1010.0)],
])
def test_fit_one_matches_reference(pairs):
    _same_coeffs(tcal._fit_one(pairs), jcal._fit_one(pairs))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_one_on_drawn_pairs(seed):
    rng = np.random.default_rng(100 + seed)
    pairs = [(float(c), float(0.002 * c + 15 + rng.normal(0, 4)))
             for c in rng.uniform(1e3, 1e6, 30)]
    _same_coeffs(tcal._fit_one(pairs), jcal._fit_one(pairs))
    with pytest.raises(ValueError):
        tcal._fit_one([])


@pytest.mark.parametrize("ref_backend,port_backend", _PAIRS)
def test_calibration_fit_matches_reference(ref_backend, port_backend):
    jc = jcal.Calibration.fit(_samples(jcal, _draw(0, ref_backend)))
    tc = tcal.Calibration.fit(_samples(tcal, _draw(0, port_backend)))
    assert len(tc.coeffs) == len(jc.coeffs) == 6
    for key, co in jc.coeffs.items():
        _same_coeffs(tc.coeffs[key.replace(ref_backend, port_backend)], co)
    samples_t = _samples(tcal, _draw(0, port_backend))
    samples_j = _samples(jcal, _draw(0, ref_backend))
    rep_t, rep_j = tc.error_report(samples_t), jc.error_report(samples_j)
    for key, e in rep_j.items():
        got = rep_t[key.replace(ref_backend, port_backend)]
        assert got["mape_pct"] == pytest.approx(e["mape_pct"], abs=0.011)
        assert len(got["samples"]) == len(e["samples"])


def test_predictions_match_reference():
    jc = jcal.Calibration.fit(_samples(jcal, _draw(1, "xla")))
    tc = tcal.Calibration.fit(_samples(tcal, _draw(1, "torch")))
    from repro.core import gen_spec as jgen
    from repro_torch.core import gen_spec as tgen

    for dtype in ("float32", "bfloat16", "float16"):
        for kind in tcal.KINDS:
            assert _close(
                tc.predict(kind, 12345.0, backend="torch", dtype=dtype),
                jc.predict(kind, 12345.0, backend="xla", dtype=dtype))
        for jt, tt in ((jgen.dcgan_layers(64), tgen.dcgan_layers(64)),
                       (jgen.unet_decoder_layers(),
                        tgen.unet_decoder_layers())):
            assert _close(tc.predict_layers(tt, backend="torch", dtype=dtype),
                          jc.predict_layers(jt, backend="xla", dtype=dtype))
            for a, b in zip(tc.predict_layers_split(tt, backend="torch",
                                                    dtype=dtype),
                            jc.predict_layers_split(jt, backend="xla",
                                                    dtype=dtype)):
                assert _close(a, b)
    assert tc.predict("dense", 1.0, backend="kernels") is None
    assert tc.predict_layers(tgen.dcgan_layers(64), backend="kernels") is None


@pytest.mark.parametrize("smoke", [True, False])
def test_cases_layers_and_cycles_match_reference(smoke):
    jcases, tcases = jcal.default_cases(smoke), tcal.default_cases(smoke)
    assert [dataclasses.astuple(c) for c in tcases] == \
        [dataclasses.astuple(c) for c in jcases]
    for jc, tc in zip(jcases, tcases):
        for dtype in ("float32", "bfloat16"):
            jc2 = dataclasses.replace(jc, dtype=dtype)
            tc2 = dataclasses.replace(tc, dtype=dtype)
            assert tc2.name == jc2.name
            assert dataclasses.astuple(tcal.layer_of(tc2)) == \
                dataclasses.astuple(jcal.layer_of(jc2))
            assert tcal.modeled_cycles(tc2) == jcal.modeled_cycles(jc2)


@pytest.mark.parametrize("smoke", [True, False])
def test_tile_scores_match_reference(smoke):
    jc = jcal.Calibration.fit(_samples(jcal, _draw(2, "xla")))
    tc = tcal.Calibration.fit(_samples(tcal, _draw(2, "torch")))
    cands = [(th, tc_) for th in (4, 8, 16, 32) for tc_ in (4, 8, 16, 64)]
    for case in tcal.default_cases(smoke):
        layer = tcal.layer_of(case)
        cyc = tcal.modeled_cycles(case)
        for calib in (None, "fit"):
            got = tcal.tile_scores(
                layer.h_out, layer.cout, cands, kind=case.kind,
                backend="torch", base_cycles=cyc,
                calibration=tc if calib else None, dtype="bfloat16")
            want = jcal.tile_scores(
                layer.h_out, layer.cout, cands, kind=case.kind,
                backend="xla", base_cycles=cyc,
                calibration=jc if calib else None, dtype="bfloat16")
            assert [c for _, c in got] == [c for _, c in want]
            for (a, _), (b, _) in zip(got, want):
                assert _close(a, b)


def test_payloads_cross_load_both_ways(tmp_path):
    jc = jcal.Calibration.fit(_samples(jcal, _draw(3, "xla")
                                       + _draw(4, "pallas")))
    # the reference's payload loads in the port under the port's names
    tc = tcal.Calibration.from_payload(jc.to_payload())
    assert {k.split("/")[1] for k in tc.coeffs} == {"torch", "kernels"}
    for key, co in jc.coeffs.items():
        b = key.split("/")[1]
        _same_coeffs(tc.coeffs[key.replace(b, tcal.BACKEND_NAMES[b])], co)
    # and back: the port's file, mapped, loads in the reference
    path = tmp_path / "port.json"
    tc.save(path)
    payload = json.loads(path.read_text())
    assert payload["schema"] == jc.to_payload()["schema"]
    back = jcal.Calibration.from_payload(
        tcal.map_backends(payload, to="reference"))
    assert set(back.coeffs) == set(jc.coeffs)
    for key, co in jc.coeffs.items():
        _same_coeffs(back.coeffs[key], co)
    # a schema-1 key (no dtype) maps to fp32 in both
    old = {"coeffs": {"dense/xla/cpu": {"a_us_per_cycle": 0.5, "b_us": 2.0,
                                        "n": 3}}}
    assert list(tcal.Calibration.from_payload(old).coeffs) == \
        ["dense/torch/cpu/float32"]
    with pytest.raises(ValueError):
        tcal.map_backends(payload, to="jax")
    assert tcal.Calibration.load(path).coeffs == tc.coeffs


def test_default_cache_path_and_device_kind(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION_CACHE", str(tmp_path))
    assert tcal.default_cache_path() == tmp_path / "cpu-v1.json"
    assert tcal._device_kind("cpu") == tcal._device_kind(None) == "cpu"
    assert tcal.key_of("tconv", "kernels") == "tconv/kernels/cpu/float32"
    with pytest.raises(ValueError):
        tcal.key_of("conv", "torch")
    monkeypatch.delenv("REPRO_TORCH_CALIBRATION_CACHE")
    assert "repro-torch-calibration" in str(tcal.default_cache_path())


def test_capture_on_cpu_keys_the_cpu():
    """A CPU capture times the plain versions and says so in its key."""
    cases = [tcal.CaptureCase("dense", (1, 6, 6, 4), (3, 3, 4, 4)),
             tcal.CaptureCase("dilated", (1, 8, 8, 4), (3, 3, 4, 4),
                              dilation=2),
             tcal.CaptureCase("tconv", (1, 4, 4, 4), (3, 3, 4, 4), stride=2)]
    samples = tcal.capture_samples(backends=("kernels", "torch"), iters=1,
                                   cases=cases, device="cpu")
    assert len(samples) == 6
    assert {s.key.split("/")[2] for s in samples} == {"cpu"}
    assert all(s.us > 0 and s.cycles > 0 for s in samples)
    fit = tcal.Calibration.fit(samples)
    assert len(fit.coeffs) == 6 and all(
        c.a_us_per_cycle >= 0 for c in fit.coeffs.values())


def test_time_call_on_cpu_is_a_best_of():
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2

    t = time_call(fn, torch.ones(3), iters=4, warmup=2)
    assert len(calls) == 6 and 0 <= t < 1.0


def _gen_kw():
    return dict(batch=3, unet_widths=(8, 8), unet_hw=4, dcgan_nz=16,
                dcgan_ngf=4, scan_steps="auto")


@pytest.mark.parametrize("ref_backend,port_backend", _PAIRS)
@pytest.mark.parametrize("seed", [5, 6])
def test_genserver_estimates_match_reference(ref_backend, port_backend,
                                             seed):
    """The same samples fitted in each package: the same admission
    estimate on every workload and step budget, the same auto depth."""
    jc = jcal.Calibration.fit(_samples(jcal, _draw(seed, ref_backend)))
    tc = tcal.Calibration.fit(_samples(tcal, _draw(seed, port_backend)))
    ref = jsg.GenServer(backend=ref_backend, calibration=jc, **_gen_kw())
    port = tsg.GenServer(backend=port_backend, device="cpu", calibration=tc,
                         **_gen_kw())
    for workload in ("unet_dec", "dcgan64", "dcgan128"):
        for steps in (1, 4, 25):
            a = port.admission_estimate(workload, steps)
            b = ref.admission_estimate(workload, steps)
            assert a is not None and _close(a, b), (workload, steps)
    k = port._lane_scan_steps("unet_dec")
    assert k == ref._lane_scan_steps("unet_dec")
    assert 1 <= k <= tsg.MAX_SCAN_STEPS
    rp = port.submit("unet_dec", steps=7, seed=1)
    rr = ref.submit("unet_dec", steps=7, seed=1)
    assert _close(port.request(rp).est_us, ref.request(rr).est_us)


@pytest.mark.parametrize("target", [2e3, 5e4, 1e6])
def test_choose_scan_steps_matches_reference(target):
    jc = jcal.Calibration.fit(_samples(jcal, _draw(7, "xla")))
    tc = tcal.Calibration.fit(_samples(tcal, _draw(7, "torch")))
    from repro.core import gen_spec as jgen
    from repro_torch.core import gen_spec as tgen

    for batch in (1, 8):
        assert tsg.choose_scan_steps(
            tc, tgen.unet_decoder_layers(), backend="torch", batch=batch,
            target_tick_us=target) == jsg.choose_scan_steps(
            jc, jgen.unet_decoder_layers(), backend="xla", batch=batch,
            target_tick_us=target)


@pytest.mark.parametrize("calibrated", [False, True])
def test_cli_serves_with_the_cached_calibration(monkeypatch, tmp_path,
                                                capsys, calibrated):
    """The CLI loads ``default_cache_path()`` when a capture left one
    there, and prints the cycle model's ``serve_report`` after the drain
    (with the calibrated host estimate when it has a fit)."""
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION_CACHE", str(tmp_path))
    if calibrated:
        tcal.Calibration.fit(_samples(tcal, _draw(8, "kernels"))).save(
            tcal.default_cache_path())
    tsg.main(["--smoke", "--device", "cpu", "--requests", "3",
              "--steps", "4,2"])
    out = capsys.readouterr().out
    assert "[serve_gen] cycle model (unet_dec, canonical widths, 4 " \
        "steps/sample" in out
    assert ("calibrated host estimate" in out) == calibrated
