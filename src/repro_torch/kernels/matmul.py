"""Dense matmul, 2-D and batched: the CUDA kernel and its plain PyTorch
versions.

Replaces the TPU kernel ``src/repro/kernels/matmul.py::_mm_kernel``
(launched by ``matmul``, ``pallas_call`` at ``matmul.py:51``).  The kernel
(``csrc/matmul.cu``) computes (M, K) @ (K, N) with fp32 accumulation and
output in ``a.dtype``, with no padded copies (the reference's wrapper pads
to whole 128^3 tiles).  It has two variants, and :func:`matmul_variant`
picks one from the operands' dtype, shape and alignment alone:

* ``"wgmma"``, for bf16 @ bf16 with K and N multiples of 8 (K > 0) and
  16-byte aligned bases (what TMA needs): Hopper's tensor cores.  128 x 256
  output tiles, TMA loads through a 4-stage ring of shared memory, two
  consumer warpgroups issuing ``wgmma`` with fp32 accumulators in
  registers, C written back by TMA stores.  Bound on the H100: the 989
  TFLOP/s of the bf16 tensor cores.
* ``"simt"``, for everything else (fp32, K = 7, N = 33, unaligned views):
  fp32 FMAs on the CUDA cores, 128 x 128 tiles, an 8 x 8 register tile per
  thread, every access masked against M, N and K.  Bound: the 67 TFLOP/s
  of the CUDA cores (no TF32, which would break the 1e-4 fp32 bar).

This is a dispatch by shape, not a fallback: a failed launch raises.  Mixed
operand types are computed in fp32 and cast to ``a.dtype``, as the
reference's ``dot_general(preferred_element_type=f32)`` does: the launcher
upcasts both to fp32 (so they take ``"simt"``) and casts the fp32 result.
PERF.md has the times at StableLM-2-1.6B's projection and MLP shapes.

:func:`matmul` takes its plain version, :func:`matmul_plain` (fp32
``torch.matmul``), only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.  ``matmul.launches`` counts kernel launches and
``matmul.launches_by_variant`` splits them by variant.

:class:`MatmulFn` makes the product differentiable (LM training).  The
reference's Pallas matmul has no VJP of its own: JAX differentiates the
product it stands for, so ``dA = dC @ B^T`` and ``dB = A^T @ dC``.  The
backward computes both through :func:`matmul`, so on the card they are
kernel 3 again (bf16 operands with K and N multiples of 8 take
``"wgmma"``), and on the CPU its plain version.  The kernel reads row-major
operands only, so ``B^T`` and ``A^T`` are contiguous copies
(``MatmulFn.transposes`` counts them; a kernel that reads a transposed
operand in place is a later lever, ROADMAP.md).

:class:`BatchedMatmulFn` does the same for the batched form (MoE
training): ``dA[e] = dC[e] @ B[e]^T`` and ``dB[e] = A[e]^T @ dC[e]``, each
one :func:`matmul_batched` launch over every expert, on contiguous
per-expert transposes (counted in ``MatmulFn.transposes`` too).  In ``dB``
the contraction runs over the capacity rows R, so a K tile past R reads
TMA's zeros of that expert's rank-3 map, never the next expert's rows.
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
matmul.launches_by_variant = {"wgmma": 0, "simt": 0}
#: the batched form's launches (counted in ``launches`` too)
matmul.launches_batched = 0

#: the kernel variants, by their C code (``csrc/matmul.cu``)
VARIANTS = {"simt": 0, "wgmma": 1}


def matmul_variant(a: torch.Tensor, b: torch.Tensor) -> str:
    """The variant :func:`matmul_cuda` (or :func:`matmul_batched_cuda`)
    launches for ``a @ b``: ``"wgmma"`` for bf16 operands with K and N
    multiples of 8 (K > 0) and 16-byte aligned bases, else ``"simt"``.
    Reads dtypes, shapes and data pointers only; launches nothing.  A
    batched operand's per-expert slices are then aligned too (K and N
    multiples of 8 make every slice a multiple of 16 bytes)."""
    k, n = b.shape[-2:]
    if (a.dtype == b.dtype == torch.bfloat16 and k > 0 and k % 8 == 0
            and n % 8 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0):
        return "wgmma"
    return "simt"


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 ``torch.matmul``, cast to ``a.dtype``."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _matmul_fn(entry: str = "matmul_fwd"):
    """The library and its C entry ``entry`` (``matmul_fwd``, or
    ``matmul_batched_fwd``, which takes E before M, N and K)."""
    lib = build.load("matmul")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        dims = 4 if entry == "matmul_batched_fwd" else 3
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * dims
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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
    variant = matmul_variant(a, b)
    lib, fn = _matmul_fn()
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                  dtype_code(a, "matmul_cuda"), VARIANTS[variant],
                  torch.cuda.current_stream(a.device).cuda_stream)
    build.check(code, f"matmul ({variant})", lib.matmul_error_string)
    matmul.launches += 1
    matmul.launches_by_variant[variant] += 1
    return out


def matmul_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> (E, M, N) in ``a.dtype``, fp32
    accumulation: ``out[e] = a[e] @ b[e]``, one launch."""
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != b.shape[1]):
        raise ValueError(f"matmul_batched: need (E, M, K) @ (E, K, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    dtype_code(a, "matmul_batched")
    dtype_code(b, "matmul_batched")
    check_device("matmul_batched", a, b)
    if a.device.type == "cpu":
        return matmul_batched_plain(a, b)
    return matmul_batched_cuda(a.contiguous(), b.contiguous())


def matmul_batched_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 ``torch.bmm``, cast to ``a.dtype``."""
    return torch.bmm(a.float(), b.float()).to(a.dtype)


def matmul_batched_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/matmul.cu``'s batched form on PyTorch's current
    stream."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul_batched_cuda: a and b must be CUDA tensors "
                         f"on one device, got {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_batched_cuda: a and b must be contiguous")
    if a.dtype != b.dtype:
        return matmul_batched_cuda(a.float(), b.float()).to(a.dtype)
    e, m, k = a.shape
    n = b.shape[2]
    out = torch.empty((e, m, n), device=a.device, dtype=a.dtype)
    if e == 0 or m == 0 or n == 0:
        return out
    variant = matmul_variant(a, b)
    lib, fn = _matmul_fn("matmul_batched_fwd")
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), e, m, n, k,
                  dtype_code(a, "matmul_batched_cuda"), VARIANTS[variant],
                  torch.cuda.current_stream(a.device).cuda_stream)
    build.check(code, f"matmul_batched ({variant})", lib.matmul_error_string)
    matmul.launches += 1
    matmul.launches_by_variant[variant] += 1
    matmul.launches_batched += 1
    return out


class MatmulFn(torch.autograd.Function):
    """``a @ b`` under autograd: the forward is :func:`matmul`, the backward
    two more :func:`matmul` calls on contiguous transposes.  Each gradient
    is in its operand's dtype, as the products' outputs are."""

    transposes = 0

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = matmul(g, _transposed(b)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = matmul(_transposed(a), g).to(b.dtype)
        return da, db


class BatchedMatmulFn(torch.autograd.Function):
    """``a @ b`` of the batched form under autograd, ``a`` (E, M, K) and
    ``b`` (E, K, N): the forward is :func:`matmul_batched`, the backward
    one more :func:`matmul_batched` launch for each gradient, over every
    expert, on contiguous per-expert transposes.  Each gradient is in its
    operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul_batched(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = matmul_batched(g, _transposed(b)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = matmul_batched(_transposed(a), g).to(b.dtype)
        return da, db


def _transposed(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` with its last two axes swapped (``t.T``
    of a matrix, each expert's transpose of a batched operand), counted in
    ``MatmulFn.transposes``."""
    MatmulFn.transposes += 1
    return t.transpose(-2, -1).contiguous()


__all__ = ["matmul", "matmul_plain", "matmul_cuda", "matmul_variant",
           "matmul_batched", "matmul_batched_plain", "matmul_batched_cuda",
           "MatmulFn", "BatchedMatmulFn", "VARIANTS"]
