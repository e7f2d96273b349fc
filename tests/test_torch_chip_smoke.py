"""The kernel-vs-plain bar of ``chip_smoke.py``, on the CPU.

``Smoke.compare`` holds each kernel's output to its plain version on the
card.  Here it is handed CPU tensors: a result that differs only by one
bf16 rounding step must pass, and attention with one kv tile dropped (the
fault a causal tile walk can make) must fail, at the length and layout of
the StableLM-width call (4096 tokens, dh 64, 64-key tiles) cut to one head.
With one tile dropped for the last q tile the error stays under a bar of
1e-2 x max(1, max|plain|), so a bf16 bar that scales with the largest value
could not see it.
"""

import functools
import importlib.util
import inspect
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

_S, _H, _DH, _TILE = 4096, 1, 64, 64


@pytest.fixture
def smoke():
    sm = chip_smoke.Smoke.__new__(chip_smoke.Smoke)
    sm.torch, sm.report, sm.worst = torch, {"checks": []}, {"k": 0.0}
    return sm


@pytest.fixture(scope="module")
def qkv():
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(1, _H, _S, _DH, generator=g).bfloat16()
                 for _ in range(3))


def _attention(q, k, v, extra_mask=None):
    """Causal attention in fp64, cast to bf16; ``extra_mask`` (Sq, Sk)
    hides more keys."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * _DH ** -0.5
    i = torch.arange(_S)[:, None]
    j = torch.arange(_S)[None, :]
    mask = i < j if extra_mask is None else (i < j) | extra_mask(i, j)
    p = torch.exp(s.masked_fill(mask, kfa.NEG_INF)
                  - s.masked_fill(mask, kfa.NEG_INF).amax(-1, keepdim=True))
    p = p.masked_fill(mask, 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.double())
    return (o / p.sum(-1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("direction", [1, -1])
def test_bf16_bar_passes_one_rounding_step(smoke, direction):
    g = torch.Generator().manual_seed(1)
    want = (torch.randn(64, 256, generator=g) * 3).bfloat16()
    bits = want.view(torch.int16)
    got = torch.where(torch.rand(64, 256, generator=g) < 0.5,
                      bits + direction, bits).view(torch.bfloat16)
    assert bool((got != want).any())
    err, _, _ = smoke.compare("one step", "k", got, want, quiet=True)
    assert err > 0
    assert smoke.report["checks"][-1]["err_over_bar"] <= 1.0


def test_bf16_bar_passes_attention_in_another_order(smoke, qkv):
    plain = kfa.attention_plain(*qkv)
    smoke.compare("fp64 order", "k", _attention(*qkv), plain, quiet=True)


@pytest.mark.parametrize("drop", [
    pytest.param(lambda i, j: (i >= _S - _TILE) & (j >= 10 * _TILE)
                 & (j < 11 * _TILE), id="tile10_last_q_tile"),
    pytest.param(lambda i, j: (i >= _S // 2) & (j >= (i // _TILE - 1) * _TILE)
                 & (j < (i // _TILE) * _TILE), id="below_diagonal_late_rows"),
])
def test_bf16_bar_catches_dropped_kv_tile(smoke, qkv, drop):
    plain = kfa.attention_plain(*qkv)
    with pytest.raises(RuntimeError, match="x its bar"):
        smoke.compare("dropped tile", "k", _attention(*qkv, drop), plain,
                      quiet=True)


def test_bf16_bar_catches_one_percent_scale_error(smoke, qkv):
    plain = kfa.attention_plain(*qkv)
    with pytest.raises(RuntimeError, match="x its bar"):
        smoke.compare("x1.01", "k", (plain.double() * 1.01).bfloat16(),
                      plain, quiet=True)


def test_fp32_bar_is_relative_to_the_largest_value(smoke):
    want = torch.tensor([4.0, 0.5])
    smoke.compare("in", "k", want + torch.tensor([3.9e-4, 0.0]), want,
                  quiet=True)
    with pytest.raises(RuntimeError, match="x its bar"):
        smoke.compare("out", "k", want + torch.tensor([0.0, 4.1e-4]), want,
                      quiet=True)


# ------------------------------------------- phase 32 rehearsed on the CPU

_ENTRY_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def _route_to_cuda(a, b):
    """``kernels.matmul.matmul``'s body for the rehearsal: every call
    through ``matmul_cuda`` (its globals are the module's), CPU tensors
    too."""
    return matmul_cuda(a.contiguous(), b.contiguous())  # noqa: F821


def test_phase_32_rehearses_on_the_cpu(monkeypatch):
    """Phase 32's wiring (``Smoke.run_rec_training``: 32a's backward shapes,
    32b's xLSTM step, witness and times, 32c's Jamba mixer) at the reduced
    configurations on the CPU: a counted stand-in for kernel 3 (its plain
    arithmetic, counted by variant on ``matmul``'s own counters), the
    ``torch.cuda`` calls stubbed, the timers and profiler stubbed.  Every
    gate of the phase runs (launches by part and variant against the
    oracles, calls against their plain versions, the backends' gradients,
    the steps, the fp32 witness), and the kernels line gets phase 32's
    kernel-3 entries, each with every key of the line."""
    from repro_torch import configs
    from repro_torch.kernels import matmul as kmm
    from repro_torch.models import mamba, xlstm

    mm = torch.matmul      # unwrapped: the phase counts torch.matmul calls

    def fake_cuda(a, b):
        assert a.is_contiguous() and b.is_contiguous()
        if a.dtype != b.dtype:
            return fake_cuda(a.float(), b.float()).to(a.dtype)
        variant = kmm.matmul_variant(a, b)
        kmm.matmul.launches += 1
        kmm.matmul.launches_by_variant[variant] += 1
        return mm(a.float(), b.float()).to(a.dtype)

    smoke = chip_smoke.Smoke(torch)
    smoke.dev = torch.device("cpu")
    monkeypatch.setattr(kmm, "matmul_cuda", fake_cuda)
    monkeypatch.setattr(kmm.matmul, "__code__", _route_to_cuda.__code__)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(smoke, "device_ms", lambda fn, reps=10, rounds=3: 1.0)
    monkeypatch.setattr(smoke, "profile_device",
                        lambda *a, **k: {"device_ms": None})
    monkeypatch.setattr(configs, "get_config",
                        lambda a: configs.get_reduced(a).replace(remat=True))
    monkeypatch.setattr(mamba, "SCAN_CHUNK", 8)
    monkeypatch.setattr(xlstm, "M_CHUNK", 16)
    for name, value in (("XL_TRAIN_SEQ", 64), ("XL_WITNESS_SHORT", 16),
                        ("XL_WITNESS_SEQ", 32),
                        ("XL_REPLAY_SEQ", 32),
                        ("XL_TRAIN_PROFILE_SEQ", 16), ("JM_SEQ", 32),
                        ("REC_TRAIN_CALLS", [
                            ("r_gates", 1, 64, 256, "fp32"),
                            ("w_if", 48, 128, 8, "fp32"),
                            ("ff_up", 48, 64, 85, "bf16")])):
        monkeypatch.setattr(chip_smoke, name, value)
    entries = smoke.run_rec_training()
    rep = smoke.report["rec_train"]
    assert len(rep["backward"]["timed"]) == 6
    names = {e["name"] for e in entries}
    assert names == {
        f"matmul ({chip_smoke.XL_NAME} (2 layers) train step forward)",
        f"matmul ({chip_smoke.XL_NAME} (2 layers) train step backward)",
        f"matmul ({chip_smoke.JM_NAME} trained forward)",
        f"matmul ({chip_smoke.JM_NAME} trained backward)"}
    for e in entries:
        assert set(e) == _ENTRY_KEYS and e["launches"] > 0
        assert e["source"].endswith("csrc/matmul.cu")
        assert e["replaces"] == "src/repro/kernels/matmul.py:51"
    xl = rep[chip_smoke.XL_NAME]
    assert [(seq, w["gate"]) for seq, w in xl["fp32_witness"].items()] == [
        (16, "max |err|"), (32, "relative L2")]
    assert all(w["worst"][1] <= 1.0 for w in xl["fp32_witness"].values())
    assert len(xl["steps"]["walls_ms"]["kernels"]) == 3
    jm = rep[chip_smoke.JM_NAME]
    assert jm["launches"]["by_part"]["matmul"] == {
        "forward": 2 + 2 * 4, "recompute": 2 * 4, "backward": 2 * 10}
    assert "run_rec_training" in inspect.getsource(chip_smoke.Smoke.run)


# ------------------------------------------- phase 33 rehearsed on the CPU

def _counted(plain, wrapper):
    """A stand-in for a conv launcher: the plain version, counted on its
    wrapper's counters, taking the launcher's ``plan=``."""
    def launch(*args, plan=None):
        wrapper.launches += 1
        return plain(*args)
    return launch


def test_phase_33_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """Phase 33's wiring (``Smoke.run_data_axis``: the plan-bits gate, 4
    gloo ranks on the CPU running 33a's convs, 33b's ENet steps and 33c's
    drains and restore, 33d's failover pool, the kernels line's entries),
    and phases 34 and 35 in the same spawn, at small shapes (phase 35 at
    the reduced StableLM), the plan table under ``tmp_path``.  In this process
    counted plain versions stand in for the conv launchers (they take no
    plan, so no geometry has a plan that moves its bits); the ranks run the wrappers' plain versions, whose
    launches no counter sees (the counters count CUDA launches), so the
    phase's launch gates are the only ones that may miss here.  Every
    other gate holds: bitwise forwards, gradients, steps and drains, the
    bf16 wire's bars, the failover drain."""
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import transposed_conv as ktr
    from repro_torch.models import common
    from repro_torch.models import unet_decoder as ud

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.setattr(common, "resolve_device", lambda device=None:
                        torch.device("cpu" if device is None else device))
    monkeypatch.setattr(kconv, "conv2d_cuda",
                        _counted(kconv.conv2d_plain, kconv.conv2d))
    monkeypatch.setattr(ktr, "tconv_cuda",
                        _counted(ktr.tconv_plain, ktr.transposed_conv2d))
    # the wrappers launch through the (patched) launchers on the CPU too
    monkeypatch.setattr(kconv, "_conv2d_raw",
                        lambda *a: kconv.conv2d_cuda(*a))
    monkeypatch.setattr(ktr, "_tconv_raw", lambda *a: ktr.tconv_cuda(*a))
    monkeypatch.setattr(ud, "init_denoiser_params", functools.partial(
        ud.init_denoiser_params, widths=(8, 8)))
    # phase 34's replays of kernels 3 and 4 run their plain versions too
    monkeypatch.setattr(kmm, "matmul_cuda",
                        _counted(kmm.matmul_plain, kmm.matmul))
    monkeypatch.setattr(kfa, "flash_attention_cuda", _counted(
        lambda q, k, v, causal, window=0: kfa.attention_plain(
            q, k, v, causal=causal, window=window), kfa.flash_attention))
    for name, value in (
            ("HW", 16), ("DA_TRAIN_BATCH", 4), ("DA_SHARDS", 4),
            ("DCGAN_NZ", 16), ("DCGAN_NGF", 4), ("DA_HB_TIMEOUT", 0.3),
            ("DA_SERVE_KW", {"batch": 4, "scan_steps": 2,
                             "unet_widths": (8, 8), "unet_hw": 4,
                             "dcgan_nz": 16, "dcgan_ngf": 4}),
            ("DA_CASES", (
                [("3x3", (5, 12, 12, 4), (3, 3, 4, 4), {})]
                + [(f"dilated d={d}", (5, 12, 12, 4), (3, 3, 4, 4),
                    {"dilation": d}) for d in (2, 4)]
                + [("transposed", (5, 6, 6, 4), (3, 3, 4, 3),
                    {"transposed": True, "stride": 2,
                     "output_padding": 1})])),
            # phase 34, in the same spawn, at small shapes
            ("MA_CASES", (
                [("3x3", (2, 16, 12, 4), (3, 3, 4, 4), {"spatial": True})]
                + [(f"dilated d={d}", (2, 16, 12, 4), (3, 3, 4, 4),
                    {"dilation": d, "spatial": True}) for d in (2, 4)]
                + [("transposed", (2, 8, 6, 4), (3, 3, 4, 3),
                    {"transposed": True, "stride": 2, "output_padding": 1,
                     "spatial": True})])),
            ("MA_SERVE_KW", {"batch": 4, "scan_steps": 2, "spatial": True,
                             "unet_widths": (8, 8), "unet_hw": 4,
                             "dcgan_nz": 16, "dcgan_ngf": 4}),
            ("MA_LM_REDUCED", True), ("MA_LM_PROMPT", 8),
            ("MA_LM_DECODE", 2),
            # phase 35, in the same spawn, at the reduced config
            ("TA_REDUCED", True), ("TA_SEQ", 32), ("TA_WITNESS_SEQ", 16)):
        monkeypatch.setattr(chip_smoke, name, value)
    smoke = chip_smoke.Smoke(torch)
    smoke.dev = torch.device("cpu")
    missed = []
    monkeypatch.setattr(smoke, "gate33",
                        lambda ok, what: ok or missed.append(what))
    monkeypatch.setattr(smoke, "gate34",
                        lambda ok, what: ok or missed.append(what))
    monkeypatch.setattr(smoke, "gate35",
                        lambda ok, what: ok or missed.append(what))
    monkeypatch.setattr(smoke, "device_ms", lambda fn, reps=10, rounds=3: 1.0)
    smoke.report["phase_seconds"] = {}
    entries = smoke.run_data_axis()
    assert missed and all("launches" in m or "never launched" in m
                          for m in missed), missed
    assert {e["name"] for e in entries} == {
        "conv2d (phase 33)", "transposed_conv2d (phase 33)",
        "conv2d (phase 34, every rank's row band)",
        "transposed_conv2d (phase 34, every rank's row band)",
        "matmul (phase 34c, every rank's heads)",
        "flash_attention (phase 34c, every rank's heads)",
        "matmul (phase 35, every rank's blocks)",
        "flash_attention (phase 35, every rank's heads)"}
    for e in entries:
        assert set(e) == _ENTRY_KEYS
    rep = smoke.report["data_axis"]
    assert rep["plan_table"]["runs"] > 0 and rep["plan_table"]["entries"]
    assert rep["train"]["bf16_params_moved"] > 0
    assert rep["serve"]["images"] == len(chip_smoke.DA_SERVE_STEPS) + \
        chip_smoke.DA_GAN_REQUESTS
    assert "run_data_axis" in inspect.getsource(chip_smoke.Smoke.run)
    ma = smoke.report["model_axis"]
    assert set(ma["lm"]) == {str(m) for m in chip_smoke.MA_MESHES}
    assert ma["serve"]["images"] == len(chip_smoke.MA_SERVE_STEPS) + 1
    ta = smoke.report["train_axis"]
    assert {str(m) for m in chip_smoke.TA_MESHES} <= set(ta)
    for m in chip_smoke.TA_MESHES:
        assert len(ta[str(m)]["metrics"]) == chip_smoke.TA_STEPS
        assert ta[str(m)]["collective_calls"] > 0
    assert ta["checkpoint"]["bitwise"]
    assert ta["fp32_witness"]["worst_grad"][1][1] <= chip_smoke.TA_FP32_GRAD
    assert "35 (in 33's spawn)" in smoke.report["phase_seconds"]
