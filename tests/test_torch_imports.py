"""Boundaries of the port: no JAX, no ``repro``, CUDA unless asked for CPU.

``src/repro_torch`` and ``chip_smoke.py`` must import neither ``jax`` nor
anything of the JAX package ``repro``; the port keeps its own copies.  Its
entry points run on CUDA unless the caller passes ``device="cpu"``, and
raise (never fall back to the CPU) when there is no card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.kernels import transposed_conv as ktr
from repro_torch.kernels.epilogue import NO_EPILOGUE
from repro_torch.kernels.util import canon_dtype, resolve_device
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as lm_serve
from repro_torch.launch import train as lm_train
from repro_torch.launch import data_axis, serve_gen
from repro_torch.launch.mesh import launch
from repro_torch.models import encdec, transformer, unet_decoder, whisper
from repro_torch.models.dcgan import DCGAN
from repro_torch.models.enet import ENet
from repro_torch.models.espnet import ESPNet

_ROOT = Path(__file__).resolve().parents[1]
_PORT = _ROOT / "src" / "repro_torch"
_FILES = sorted(_PORT.rglob("*.py")) + [_ROOT / "chip_smoke.py"]


def test_walk_covers_every_package():
    packages = {p.parent.name for p in _FILES if p.name == "__init__.py"}
    assert {"checkpoint", "configs", "core", "distributed", "kernels",
            "launch", "models", "optim", "data"} <= packages
    assert _PORT / "launch" / "serve_gen.py" in _FILES
    for mod in ("models/config.py", "models/layers.py",
                "models/attention.py", "models/transformer.py",
                "models/encdec.py", "models/moe.py",
                "launch/serve.py", "configs/stablelm_1_6b.py",
                "launch/train.py", "data/pipeline.py",
                "launch/mesh.py", "launch/shapes.py", "launch/failover.py",
                "launch/data_axis.py", "distributed/sharding.py",
                "distributed/compression.py",
                "distributed/collectives.py"):
        assert _PORT / mod in _FILES


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _FILES,
                         ids=lambda p: str(p.relative_to(_ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == []


def test_ast_check_catches_forbidden_imports():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.dilated")
    assert not _forbidden("repro_torch.core") and not _forbidden("jaxtyping_x")


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.core.decompose, "
            "repro_torch.models.enet, repro_torch.models.espnet, "
            "repro_torch.models.dcgan, repro_torch.models.unet_decoder, "
            "repro_torch.models.whisper, repro_torch.kernels.build, "
            "repro_torch.kernels.ref, repro_torch.kernels.ops, "
            "repro_torch.kernels.matmul, repro_torch.kernels.flash_attention, "
            "repro_torch.core.adjoints, repro_torch.optim, repro_torch.data, "
            "repro_torch.launch.train_recipes, "
            "repro_torch.launch.train_enet, repro_torch.launch.steps, "
            "repro_torch.launch.serve_gen, repro_torch.core.gen_spec, "
            "repro_torch.core.enet_spec, repro_torch.core.espnet_spec, "
            "repro_torch.core.cycle_model, repro_torch.core.calibrate, "
            "repro_torch.kernels.tiling_policy, repro_torch.kernels.autotune, "
            "repro_torch.checkpoint, repro_torch.distributed, "
            "repro_torch.configs, repro_torch.models.config, "
            "repro_torch.models.layers, repro_torch.models.attention, "
            "repro_torch.models.transformer, repro_torch.models.encdec, "
            "repro_torch.models.moe, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.data.pipeline, "
            "repro_torch.checkpoint.ckpt, "
            "repro_torch.distributed.fault_tolerance, "
            "repro_torch.distributed.sharding, "
            "repro_torch.distributed.compression, "
            "repro_torch.distributed.collectives, "
            "repro_torch.launch.mesh, repro_torch.launch.shapes, "
            "repro_torch.launch.failover, repro_torch.launch.data_axis; "
            "import repro_torch.configs as c; "
            "[c.get_config(a) for a in c.ARCH_IDS]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENet(4, generator=g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENet(4, device="cuda", generator=g)
    for build in (lambda: ESPNet(4, generator=g),
                  lambda: DCGAN(64, nz=4, ngf=1, generator=g),
                  lambda: unet_decoder.init_params(g, widths=(8, 8)),
                  lambda: unet_decoder.init_denoiser_params(g, widths=(8,)),
                  lambda: whisper.init_frontend_params(g, 4, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    for serve in (lambda: serve_gen.GenServer(),
                  lambda: serve_gen.GenServer(device="cuda", batch=1),
                  lambda: serve_gen.main(["--smoke"]),
                  lambda: serve_gen.main(["--smoke", "--devices", "2"]),
                  lambda: launch(data_axis.run, 2, args=([],)),
                  lambda: serve_gen.reference_sample({}, steps=1, seed=0,
                                                     image_size=4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve()
    lm = get_reduced("stablelm-1.6b")
    wh = get_reduced("whisper-small")
    mo = get_reduced("qwen3-moe-30b-a3b")
    for build in (lambda: encdec.init_params(g, wh),
                  lambda: lm_serve.Server(mo, generator=g),
                  lambda: transformer.init_params(g, mo),
                  lambda: lm_serve.main(["--arch", "qwen3-moe-30b-a3b",
                                         "--reduced"]),
                  lambda: encdec.init_caches(wh, 1, 8),
                  lambda: lm_serve.Server(wh, generator=g),
                  lambda: lm_serve.main(["--arch", "whisper-small",
                                         "--reduced"]),
                  lambda: lm_train.train(wh, steps=1, global_batch=1,
                                         seq_len=4),
                  lambda: lm_serve.Server(lm),
                  lambda: lm_serve.Server(lm, device="cuda", generator=g),
                  lambda: lm_serve.main(["--arch", "stablelm-1.6b",
                                         "--reduced"]),
                  lambda: transformer.init_params(g, lm),
                  lambda: transformer.init_caches(lm, 1, 8),
                  lambda: lm_train.train(lm, steps=1, global_batch=1,
                                         seq_len=4),
                  lambda: lm_train.main(["--arch", "stablelm-1.6b",
                                         "--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_kernel_launchers_take_only_cuda_tensors():
    x, w = torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kconv.conv2d_cuda(x, w, 1, ((1, 1), (1, 1)), NO_EPILOGUE, ())
    with pytest.raises(ValueError, match="CUDA tensor"):
        ktr.tconv_cuda(x, w, 2, 1, 2, NO_EPILOGUE, ())


def test_kernel_wrappers_check_operands():
    x, w = torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 2)
    with pytest.raises(NotImplementedError, match="fp32 only"):
        kconv.conv2d(x.double(), w.double())
    with pytest.raises(ValueError, match="channels"):
        kconv.conv2d(x, torch.zeros(3, 3, 3, 2))
    with pytest.raises(ValueError, match="NHWC"):
        ktr.transposed_conv2d(x[0], w)
    with pytest.raises(ValueError, match="square"):
        ktr.transposed_conv2d(x, torch.zeros(3, 2, 2, 2))
    # the conv wrappers differentiate: a gradient request builds a graph
    # through their autograd Functions instead of raising
    y = kconv.conv2d(x.requires_grad_(), w)
    assert y.grad_fn is not None and y.requires_grad


def test_canon_dtype_is_fp32_only():
    # the name predates the bf16 slice: fp32 and bf16 are ported, fp16 is
    # the one dtype still refused
    assert canon_dtype(None) is None
    assert canon_dtype("fp32") is torch.float32
    assert canon_dtype(torch.float32) is torch.float32
    assert canon_dtype("bf16") is canon_dtype(torch.bfloat16) is torch.bfloat16
    for d in ("fp16", torch.float16):
        with pytest.raises(NotImplementedError, match="fp16 is still to port"):
            canon_dtype(d)
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        canon_dtype("int8")


def test_tconv_schedule_array_layout():
    arr = list(ktr.schedule_array(3, 2, 1))
    row = 1 + 2 * ktr.MAX_TAPS
    assert arr[0:3] == [1, 1, 0]            # even parity: centre tap, off 0
    assert arr[row:row + 5] == [2, 0, 0, 2, 1]
    with pytest.raises(ValueError, match="stride"):
        ktr.schedule_array(3, 9, 1)


def test_build_command_targets_sm90a():
    cmd = build.nvcc_command("nvcc", Path("a.cu"), Path("a.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-O3", "-shared", "-Xcompiler", "-fPIC"} <= set(cmd)
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists()


def test_library_path_tracks_sources(monkeypatch, tmp_path):
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("conv2d")
    with open(tmp_path / "epilogue.cuh", "a") as f:
        f.write("\n// edited\n")
    assert build.library_path("conv2d") != before
    before = build.library_path("matmul")
    with open(tmp_path / "element.cuh", "a") as f:
        f.write("\n// edited\n")
    assert build.library_path("matmul") != before
    with pytest.raises(ValueError, match="unknown kernel"):
        build.library_path("softmax")


def test_kernels_lists_all_four():
    assert build.KERNELS == ("conv2d", "transposed_conv", "matmul",
                             "flash_attention")


@pytest.mark.parametrize("name", ["matmul", "flash_attention"])
def test_new_kernels_raise_without_nvcc(monkeypatch, tmp_path, name):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load(name)


def test_new_launchers_take_only_cuda_tensors():
    a = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kmm.matmul_cuda(a, a)
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kfa.flash_attention_cuda(q, q, q, True)


def test_new_wrappers_never_fall_back(monkeypatch):
    """A tensor that is not on the CPU never reaches a plain version: with
    no card, a CUDA request raises, and other devices are refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.matmul(m, m)
    q = torch.zeros(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.attention(q, q, q)
    with pytest.raises(ValueError, match="different devices"):
        kmm.matmul(torch.zeros(4, 4), m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_new_wrappers_check_operands():
    a = torch.zeros(4, 4)
    with pytest.raises(TypeError, match="not supported"):
        kmm.matmul(a.double(), a.double())
    with pytest.raises(TypeError, match="not supported"):
        kmm.matmul(a.half(), a.half())
    with pytest.raises(ValueError, match="M, K"):
        kmm.matmul(torch.zeros(2, 4, 4), a)
    with pytest.raises(NotImplementedError, match="forward only"):
        kmm.matmul(a.requires_grad_(), torch.zeros(4, 4))
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="head dim"):
        kfa.flash_attention(torch.zeros(1, 1, 2, 300),
                            torch.zeros(1, 1, 2, 300),
                            torch.zeros(1, 1, 2, 300))
    with pytest.raises(ValueError, match="no keys"):
        kfa.flash_attention(q, q[:, :, :0], q[:, :, :0])
    with pytest.raises(ValueError, match="lengths differ"):
        kfa.flash_attention(q, q, q[:, :, :2])
    with pytest.raises(TypeError, match="not supported"):
        kfa.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="not supported"):
        kfa.flash_attention(q.half(), q.half(), q.half())
