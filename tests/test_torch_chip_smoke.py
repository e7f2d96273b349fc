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

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_attention as kfa

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
