"""Dense matmul: the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/matmul.py::_mm_kernel``
(launched by ``matmul``, ``pallas_call`` at ``matmul.py:51``).  The kernel
(``csrc/matmul.cu``) computes (M, K) @ (K, N) with fp32 accumulation on the
CUDA cores: one block per 128 x 128 output tile, K walked in steps of 16
through shared memory, an 8 x 8 register tile per thread, every access
masked against M, N and K (no padded copies, unlike the reference's
wrapper), output in ``a.dtype``.  Operands may be fp32 or bf16, each
converted to fp32 as it is loaded.  Mixed operand types are computed in
fp32 and cast to ``a.dtype``, as the reference's
``dot_general(preferred_element_type=f32)`` does: the launcher upcasts both
to fp32 and casts the fp32 result, which gives the same bits as converting
on load and keeps one kernel instance per type.

Bound on the H100: FMAs, 67 TFLOP/s on the CUDA cores for fp32; for bf16
the card could run the same work on its tensor cores at 989 TFLOP/s, which
this first version does not use (``wgmma`` tiles are later work).
PERF.md has its times at StableLM-2-1.6B's projection and MLP shapes.

:func:`matmul` takes its plain version, :func:`matmul_plain` (fp32
``torch.matmul``), only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.  ``matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.util import check_device, dtype_code


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in ``a.dtype``, fp32 accumulation."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: need (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    dtype_code(a, "matmul")
    dtype_code(b, "matmul")
    check_device("matmul", a, b)
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    return matmul_cuda(a.contiguous(), b.contiguous())


matmul.launches = 0


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 ``torch.matmul``, cast to ``a.dtype``."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _matmul_fn():
    lib = build.load("matmul")
    fn = lib.matmul_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.matmul_error_string.argtypes = [ctypes.c_int]
        lib.matmul_error_string.restype = ctypes.c_char_p
    return lib, fn


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/matmul.cu`` on PyTorch's current stream."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul_cuda: a and b must be CUDA tensors on one "
                         f"device, got {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cuda: a and b must be contiguous")
    if a.dtype != b.dtype:
        return matmul_cuda(a.float(), b.float()).to(a.dtype)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    if m == 0 or n == 0:
        return out
    lib, fn = _matmul_fn()
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                  dtype_code(a, "matmul_cuda"),
                  torch.cuda.current_stream(a.device).cuda_stream)
    build.check(code, "matmul", lib.matmul_error_string)
    matmul.launches += 1
    return out


__all__ = ["matmul", "matmul_plain", "matmul_cuda"]
