"""The bf16 tensor-core (``wgmma``) variants of the matmul and attention
kernels, on the CPU: which variant each wrapper picks, and why the
attention kernel splits P in two bf16 terms.

Run here with ``PYTHONPATH=src python -m pytest -q tests/test_torch_wgmma.py``;
nothing is launched.  The kernels themselves are held to their plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

The numerics test emulates the attention kernel's arithmetic in torch:
QK^T of bf16 values with fp32 sums (each bf16 x bf16 product is exact in
fp32), the online softmax over 128-key tiles with fp32 P, l summed from
the fp32 P, and O += P_hi V + P_lo V with ``P_hi = bf16(P)`` and ``P_lo =
bf16(P - P_hi)``.  At the layout of the StableLM-2-1.6B call (4096 tokens,
dh 64, causal) cut to 2 heads, that passes ``chip_smoke.Smoke.compare``'s
bf16 bar against the plain version, and the same arithmetic with P rounded
once to bf16 fails it.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

bf16, f32 = torch.bfloat16, torch.float32


def _unaligned(shape, dtype):
    """A contiguous tensor whose data pointer is 2 bytes past a 16-byte
    boundary (an offset view of a larger buffer)."""
    n = int(np.prod(shape))
    base = torch.empty(n + 8, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    view = base[1:n + 1].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


# ------------------------------------------------------- variant choice ---

@pytest.mark.parametrize("mkn", [(4096, 2048, 2048), (4096, 2048, 5632),
                                 (4096, 5632, 2048), (4097, 2048, 2056),
                                 (1, 2048, 128), (300, 64, 200),
                                 (100, 72, 64)])
def test_matmul_picks_wgmma_for_bf16(mkn):
    m, k, n = mkn
    a, b = torch.empty(m, k, dtype=bf16), torch.empty(k, n, dtype=bf16)
    assert kmm.matmul_variant(a, b) == "wgmma"


@pytest.mark.parametrize("case", ["k7", "n33", "k0", "fp32", "bf16_fp32",
                                  "fp32_bf16", "unaligned_a",
                                  "unaligned_b"])
def test_matmul_picks_simt(case):
    m, k, n = 64, 64, 64
    da = db = bf16
    if case == "k7":
        k = 7
    elif case == "n33":
        n = 33
    elif case == "k0":
        k = 0
    elif case == "fp32":
        da = db = f32
    elif case == "bf16_fp32":
        db = f32
    elif case == "fp32_bf16":
        da = f32
    a = (_unaligned((m, k), da) if case == "unaligned_a"
         else torch.empty(m, k, dtype=da))
    b = (_unaligned((k, n), db) if case == "unaligned_b"
         else torch.empty(k, n, dtype=db))
    assert kmm.matmul_variant(a, b) == "simt"


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("shape", [(1, 32, 4096, 4096), (2, 3, 300, 200),
                                   (1, 2, 1, 70)])
def test_attention_picks_wgmma_for_bf16(dh, shape):
    b, h, sq, sk = shape
    q = torch.empty(b, h, sq, dh, dtype=bf16)
    k, v = (torch.empty(b, h, sk, dh, dtype=bf16) for _ in range(2))
    assert kfa.attention_variant(q, k, v) == "wgmma"


@pytest.mark.parametrize("case", ["dh16", "dh32", "dh256", "fp32",
                                  "mixed", "unaligned_v"])
def test_attention_picks_simt(case):
    dh, dt, dv = 64, bf16, bf16
    if case.startswith("dh"):
        dh = int(case[2:])
    elif case == "fp32":
        dt = dv = f32
    elif case == "mixed":
        dv = f32
    q = torch.empty(1, 2, 40, dh, dtype=dt)
    k = torch.empty(1, 2, 50, dh, dtype=dt)
    v = (_unaligned((1, 2, 50, dh), dv) if case == "unaligned_v"
         else torch.empty(1, 2, 50, dh, dtype=dv))
    assert kfa.attention_variant(q, k, v) == "simt"


def test_wrappers_count_launches_by_variant():
    assert kmm.matmul.launches_by_variant.keys() == {"wgmma", "simt"}
    assert kfa.flash_attention.launches_by_variant.keys() == {"wgmma",
                                                              "simt"}
    assert set(kmm.VARIANTS) == set(kfa.VARIANTS) == {"wgmma", "simt"}


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    """On the CPU the wrappers run their plain versions: no launch, no
    variant counted, whatever variant the operands would take."""
    before = (kmm.matmul.launches, dict(kmm.matmul.launches_by_variant),
              kfa.flash_attention.launches,
              dict(kfa.flash_attention.launches_by_variant))
    a = torch.randn(64, 64).to(bf16)
    q = torch.randn(1, 2, 16, 64).to(bf16)
    assert kmm.matmul_variant(a, a) == "wgmma"
    assert kfa.attention_variant(q, q, q) == "wgmma"
    torch.testing.assert_close(kmm.matmul(a, a), kmm.matmul_plain(a, a))
    torch.testing.assert_close(kfa.flash_attention(q, q, q),
                               kfa.attention_plain(q, q, q))
    assert before == (kmm.matmul.launches,
                      dict(kmm.matmul.launches_by_variant),
                      kfa.flash_attention.launches,
                      dict(kfa.flash_attention.launches_by_variant))


# ----------------------------------------------------------- numerics ---

_S, _H, _DH, _TILE = 4096, 2, 64, 128


def _emulate(q, k, v, split):
    """The wgmma attention kernel's arithmetic, causal (top-left), in torch:
    fp32 sums of exact bf16 products, online softmax over 128-key tiles
    with fp32 P, l from the fp32 P, and P @ V with P as two bf16 terms
    (``split``) or one."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sq, sk, dh = q.shape[2], k.shape[2], q.shape[3]
    q_pos = torch.arange(sq)[:, None]
    m = torch.full(q.shape[:3] + (1,), kfa.NEG_INF)
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(q.shape[:3] + (dh,))
    for k0 in range(0, sk, _TILE):
        kt, vt = kf[:, :, k0:k0 + _TILE], vf[:, :, k0:k0 + _TILE]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * dh ** -0.5
        k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        s = s.masked_fill(q_pos < k_pos, kfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.to(bf16).float()
        acc = acc * alpha + p_hi @ vt
        if split:
            acc = acc + (p - p_hi).to(bf16).float() @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@pytest.fixture(scope="module")
def causal_call():
    """bf16 q, k, v at the StableLM call's layout cut to 2 heads, drawn
    with numpy from a seed, and the plain version's output."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, _H, _S, _DH), dtype=np.float32)).to(bf16) for _ in range(3))
    return q, k, v, kfa.attention_plain(q, k, v, causal=True)


@pytest.fixture
def smoke():
    sm = chip_smoke.Smoke.__new__(chip_smoke.Smoke)
    sm.torch, sm.report, sm.worst = torch, {"checks": []}, {"k": 0.0}
    return sm


def test_split_p_passes_the_bf16_bar(smoke, causal_call):
    q, k, v, plain = causal_call
    smoke.compare("P_hi + P_lo", "k", _emulate(q, k, v, split=True), plain,
                  quiet=True)
    assert smoke.report["checks"][-1]["err_over_bar"] <= 1.0


def test_p_rounded_once_fails_the_bf16_bar(smoke, causal_call):
    q, k, v, plain = causal_call
    with pytest.raises(RuntimeError, match="x its bar"):
        smoke.compare("bf16(P)", "k", _emulate(q, k, v, split=False), plain,
                      quiet=True)


def test_split_p_is_exact_to_16_bits():
    """P_hi + P_lo carries P to about 2^-16 of its value: the split's
    residual error is far under one bf16 step."""
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.random(100_000, dtype=np.float32))
    p_hi = p.to(bf16).float()
    p_lo = (p - p_hi).to(bf16).float()
    rel = ((p_hi + p_lo - p).abs() / p).max().item()
    assert rel <= 2.0 ** -16
    assert ((p_hi - p).abs() / p).max().item() > 2.0 ** -10


# ----------------------------------------------------- ptxas resources ---

_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN5repro28flash_attention_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro28flash_attention_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiifi
    56 bytes stack frame, 68 bytes spill stores, 72 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 56 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN5repro22flash_attention_kernelIfLi4EEEvPKT_S3_S3_PS1_llifi' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro22flash_attention_kernelIfLi4EEEvPKT_S3_S3_PS1_llifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers
"""


def test_resource_usage_reads_the_ptxas_report(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    assert build.resource_usage("flash_attention") == {}
    build.library_path("flash_attention").with_suffix(".log").write_text(
        _PTXAS_LOG)
    assert build.resource_usage("flash_attention") == {
        "flash_attention_wgmma_kernel<128>": {
            "registers": 168, "stack": 56, "spill_stores": 68,
            "spill_loads": 72},
        "flash_attention_kernel<float, 4>": {
            "registers": 90, "stack": 0, "spill_stores": 0,
            "spill_loads": 0}}


@pytest.mark.parametrize("mangled,name", [
    ("_ZN5repro19matmul_wgmma_kernelE14CUtensorMap_stS0_P13__nv_bfloat16iii",
     "matmul_wgmma_kernel"),
    ("_ZN5repro13matmul_kernelI13__nv_bfloat16EEvPKT_S4_PS2_lll",
     "matmul_kernel<bf16>"),
    ("_ZN5repro28flash_attention_wgmma_kernelILi64EEEv14CUtensorMap_st",
     "flash_attention_wgmma_kernel<64>"),
    ("_ZN5repro13conv2d_kernelINS_4TileILi32ELi32ELi4EEELi4ELb1EEEvNS_7ConvGe"
     "oEPKfS5_PfNS_8EpilogueE", "conv2d_kernel<Tile<32, 32, 4>, 4, true>"),
    ("_ZN5repro12tconv_kernelINS_4TileILi20ELi32ELi4EEELi1EEEvNS_8TconvGeoEPK"
     "fS5_PfNS_8EpilogueE", "tconv_kernel<Tile<20, 32, 4>, 1>"),
    ("_Z6kernelv", "_Z6kernelv")])
def test_kernel_name_demangles_the_ports_kernels(mangled, name):
    from repro_torch.kernels import build
    assert build.kernel_name(mangled) == name


def test_build_asks_ptxas_for_its_report():
    from repro_torch.kernels import build
    cmd = build.nvcc_command("nvcc", Path("a.cu"), Path("a.so"))
    assert cmd[cmd.index("-Xptxas") + 1] == "-v"
