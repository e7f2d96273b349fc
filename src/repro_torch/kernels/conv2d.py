"""Dense 2-D convolution: the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/conv2d.py::_conv_kernel``
(launched by ``_conv2d_raw``, ``pallas_call`` at ``conv2d.py:195``).  The
kernel (``csrc/conv2d.cu``) is one implicit GEMM in fp32 on the CUDA cores:
M = output pixels, N = Cout, K = kh*kw*Cin, with the weight slab of each
Cout tile staged in shared memory, inputs read under bounds masks (so
padding is implicit) and the fused epilogue (``csrc/epilogue.cuh``) applied
in registers before an NHWC store.  It carries every dense conv of ENet and,
through :mod:`repro_torch.kernels.dilated_conv`, every dilated conv.

Bound on the H100: device-memory bytes (3.35 TB/s) for the thin 1x1
projections that dominate ENet, fp32 CUDA-core FMAs (67 TFLOP/s) for the
wide 3x3 layers.  Against the bytes, the epilogue is fused, so each output
is written once and BN/PReLU/residual cost no extra pass; against the
FMAs, each thread reuses its staged operands over a 4 x TN register tile.
This first version is simple and right: over the ENet-512 batch-4 forward
it takes 2.38 ms against a 0.447 ms bound (H100 80GB HBM3, 700 W;
PERF.md).

:func:`conv2d` takes its plain version, :func:`conv2d_plain` (a tap sum of
``torch.matmul``), only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.  ``conv2d.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.nhwc import Pads
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import (NO_EPILOGUE, EpilogueSpec,
                                          apply_reference, kernel_operands,
                                          operand_ptrs, pack_args,
                                          residual_code)


def resolve_pads(padding, kh: int, kw: int) -> Pads:
    """``"SAME"`` (asymmetric for even extents), ``"VALID"``, a symmetric
    int, or explicit per-dim ``((top, bottom), (left, right))`` pads."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    if padding == "SAME":
        return (((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    (pt, pb), (pl, pr) = padding
    return ((int(pt), int(pb)), (int(pl), int(pr)))


def out_extent(size: int, k: int, stride: int, lo: int, hi: int) -> int:
    return (size + lo + hi - k) // stride + 1


def check_operands(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    """Raise on what the kernels and their plain versions do not take."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{what}: x must be NHWC and w HWIO, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[-1] != w.shape[2]:
        raise ValueError(f"{what}: x has {x.shape[-1]} channels, w expects "
                         f"{w.shape[2]}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise NotImplementedError(
            f"{what}: the port is fp32 only until the bf16 slice of "
            f"ROADMAP.md, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"{what}: x on {x.device} but w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            f"{what}: the port's kernels are forward only; gradients are "
            f"the ENet-backward slice of ROADMAP.md (run under "
            f"torch.no_grad())")


def require_cuda(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    """The launch-side checks: a kernel takes contiguous CUDA tensors."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x must be a CUDA tensor, got {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: x and w must be contiguous")


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding="SAME", epilogue: EpilogueSpec | None = None,
           scale=None, shift=None, alpha=None,
           residual=None) -> torch.Tensor:
    """Dense convolution, NHWC x HWIO -> NHWC, with a fused epilogue.

    Args:
      x: (N, H, W, Cin) fp32.  w: (kh, kw, Cin, Cout) fp32, rectangular ok.
      stride: spatial stride >= 1.
      padding: "SAME", "VALID", a symmetric int, or per-dim
        ``((top, bottom), (left, right))`` pads.
      epilogue: optional :class:`EpilogueSpec` with matching
        ``scale``/``shift``/``alpha``/``residual`` operands.
    """
    spec = NO_EPILOGUE if epilogue is None else epilogue
    eps = pack_args(spec, scale=scale, shift=shift, alpha=alpha,
                    residual=residual)
    check_operands(x, w, "conv2d")
    if stride < 1:
        raise ValueError(f"conv2d: stride must be >= 1, got {stride}")
    pads = resolve_pads(padding, w.shape[0], w.shape[1])
    if x.device.type == "cpu":
        return conv2d_plain(x, w, stride, pads, spec, eps)
    return conv2d_cuda(x.contiguous(), w.contiguous(), stride, pads, spec,
                       eps)


conv2d.launches = 0


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads,
                 spec: EpilogueSpec, eps: tuple) -> torch.Tensor:
    """Plain version: the conv as a sum of kh*kw shifted ``torch.matmul``
    taps into an fp32 accumulator, then :func:`apply_reference`."""
    n, h, w_in, cin = x.shape
    kh, kw, _, cout = w.shape
    (pt, pb), (pl, pr) = pads
    s = stride
    oh, ow = out_extent(h, kh, s, pt, pb), out_extent(w_in, kw, s, pl, pr)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"conv2d: empty output {oh}x{ow}")
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    acc = x.new_zeros((n * oh * ow, cout))
    for dy in range(kh):
        for dx in range(kw):
            rows = xp[:, dy: dy + s * (oh - 1) + 1: s,
                      dx: dx + s * (ow - 1) + 1: s, :]
            acc += torch.matmul(rows.reshape(-1, cin), w[dy, dx])
    return apply_reference(spec, acc.reshape(n, oh, ow, cout), eps)


def _conv2d_fn():
    lib = build.load("conv2d")
    fn = lib.conv2d_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.conv2d_error_string.argtypes = [ctypes.c_int]
        lib.conv2d_error_string.restype = ctypes.c_char_p
    return lib, fn


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads,
                spec: EpilogueSpec, eps: tuple) -> torch.Tensor:
    """Launch ``csrc/conv2d.cu`` on PyTorch's current stream."""
    require_cuda(x, w, "conv2d_cuda")
    n, h, w_in, cin = x.shape
    kh, kw, _, cout = w.shape
    (pt, pb), (pl, pr) = pads
    oh = out_extent(h, kh, stride, pt, pb)
    ow = out_extent(w_in, kw, stride, pl, pr)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"conv2d: empty output {oh}x{ow}")
    out = torch.empty((n, oh, ow, cout), device=x.device, dtype=x.dtype)
    ops = kernel_operands(spec, eps, tuple(out.shape), x.device)
    lib, fn = _conv2d_fn()
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  *operand_ptrs(ops), n, h, w_in, cin, oh, ow, cout, kh, kw,
                  stride, pt, pl, int(spec.bn), int(spec.prelu),
                  residual_code(spec),
                  torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "conv2d", lib.conv2d_error_string)
    conv2d.launches += 1
    return out


__all__ = ["conv2d", "conv2d_plain", "conv2d_cuda", "resolve_pads",
           "out_extent", "check_operands", "require_cuda"]
