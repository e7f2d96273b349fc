"""Decomposed transposed convolution: the CUDA kernel and its plain version.

Replaces the TPU kernel ``src/repro/kernels/transposed_conv.py::_tconv_kernel``
(launched by ``_tconv_raw``, ``pallas_call`` at ``transposed_conv.py:235``).
A stride-``s`` transposed conv splits into ``s*s`` parity sub-convolutions
whose live taps come from :func:`parity_schedule` (paper §II-C, Fig. 6).
As the TPU kernel does, one block of the kernel (``csrc/transposed_conv.cu``)
takes one input tile and all ``s*s`` parity planes of it: the tile (with its
halo) and the weights are staged once in shared memory by asynchronous
copies (the weights per plane instead when a large ``k`` does not fit, see
:func:`tconv_plan`), each plane walks only its own live taps (MACs issued =
nonzero MACs), and the planes' results meet in an interleaved output tile in shared
memory, which leaves as contiguous NHWC rows through the fused epilogue in
16-byte stores (the all-zero planes of ``k < s`` get the epilogue too).  No
stride-``s`` scatter, plane buffer or de-interleave pass.  As the Pallas
kernel does, it takes fp32 or bf16 operands, accumulates in fp32 and
returns the input dtype, rounded once after the epilogue.

Bound on the H100: device-memory bytes for ENet's decoder (Cin 4..16).
The 19-class head moves 97 MB, mostly its fp32 output, and its 1.4 GFLOP
alone take nearly three quarters of that time at the CUDA cores' 67
TFLOP/s, so its Cout tile is 20 wide (:func:`tconv_plan`); bf16 halves the
bytes.  PERF.md has the times.

Stride 1 is a plain padded conv and routes to the dense kernel
(:func:`repro_torch.kernels.conv2d.conv2d`), as the reference leaves it to a
plain conv.  :func:`transposed_conv2d` takes its plain version,
:func:`tconv_plain` (per-parity live-tap ``torch.matmul`` sums from the same
schedule), only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises.  ``transposed_conv2d.launches`` counts kernel launches.

Gradients (the port of ``_tconv_vjp`` and ``_tconv_ep_vjp``): under
autograd the wrapper applies :class:`_TconvFn` or :class:`_TconvEpFn`.
dx is a strided VALID dense conv of the padded cotangent on kernel 1
(``adjoints.tconv_dx``), dw ``adjoints.tconv_dw``, both in the primal
dtypes; the fused epilogue's backward recomputes the conv without it.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.core import adjoints
from repro_torch.kernels import build
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels.epilogue import (NO_EPILOGUE, EpilogueSpec,
                                          apply_reference, kernel_operands,
                                          operand_ptrs, pack_args,
                                          residual_code)
from repro_torch.kernels.util import DTYPE_CODES

#: the kernel's fixed schedule arrays and input channels staged at a time
#: (csrc/transposed_conv.cu)
MAX_STRIDE = 8
MAX_TAPS = 8
CHUNK = 16


def parity_schedule(k: int, s: int, p_lo: int) -> list[list[tuple[int, int]]]:
    """Per-parity tap schedule for one spatial dim (paper §II-C, Fig. 6).

    Output ``y = s*b + r`` reads kernel tap ``t`` iff
    ``(t - p_lo + r) % s == 0``, from input index ``b + off`` with
    ``off = (r + t - p_lo) // s``.  Returns ``[(t, off), ...]`` per parity
    ``r``; a list is empty when no tap hits that parity (``k < s``).
    """
    return [
        [(t, (r + t - p_lo) // s) for t in range(k) if (t - p_lo + r) % s == 0]
        for r in range(s)
    ]


def transposed_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2,
                      padding: int | None = None, output_padding: int = 1,
                      epilogue: EpilogueSpec | None = None, scale=None,
                      shift=None, alpha=None,
                      residual=None) -> torch.Tensor:
    """Fused decomposed transposed conv for square ``k`` and any stride.

    Args:
      x: (N, H, W, Cin) fp32 or bf16.   w: (k, k, Cin, Cout) of x's dtype.
      stride: upsampling factor ``s >= 1``.
      padding: low-side pad ``p_lo`` of the zero-inserted input;
        ``None`` -> ``(k-1)//2``.
      output_padding: extra high-side size (``p_hi = p_lo + it``).
      epilogue: optional :class:`EpilogueSpec` with matching operands.
    Returns:
      (N, OH, OW, Cout) of x's dtype, with ``OH = (H-1)*s + p_lo + p_hi -
      k + 2``.
    """
    kconv.check_operands(x, w, "transposed_conv2d", residual)
    k = w.shape[0]
    if w.shape[1] != k:
        raise ValueError(f"square kernels only, got {k}x{w.shape[1]}")
    p_lo = (k - 1) // 2 if padding is None else padding
    p_hi = p_lo + output_padding
    spec = NO_EPILOGUE if epilogue is None else epilogue
    if stride == 1:
        return kconv.conv2d(x, w, padding=((p_lo, p_hi), (p_lo, p_hi)),
                            epilogue=epilogue, scale=scale, shift=shift,
                            alpha=alpha, residual=residual)
    if stride < 1:
        raise ValueError(f"transposed_conv2d: stride must be >= 1, "
                         f"got {stride}")
    eps = pack_args(spec, scale=scale, shift=shift, alpha=alpha,
                    residual=residual)
    if not kconv.wants_grad(x, w, *eps):
        return _tconv_raw(x, w, stride, p_lo, p_hi, spec, eps)
    if spec.empty:
        return _TconvFn.apply(x, w, stride, p_lo, p_hi)
    return _TconvEpFn.apply(x, w, spec, stride, p_lo, p_hi,
                            *kconv.tensor_operands(spec, eps, x.device))


transposed_conv2d.launches = 0


def _tconv_raw(x, w, s, p_lo, p_hi, spec, eps):
    """One forward: the plain version on the CPU, else the kernel."""
    if x.device.type == "cpu":
        return tconv_plain(x, w, s, p_lo, p_hi, spec, eps)
    return tconv_cuda(x.contiguous(), w.contiguous(), s, p_lo, p_hi, spec,
                      eps)


class _TconvFn(torch.autograd.Function):
    """Epilogue-free transposed conv (stride > 1); the port of
    ``_tconv_vjp``.  dx is ``adjoints.tconv_dx`` on the dense kernel
    (strided, VALID), dw ``adjoints.tconv_dw``."""

    @staticmethod
    def forward(ctx, x, w, s, p_lo, p_hi):
        ctx.save_for_backward(x, w)
        ctx.conf = (s, p_lo, p_hi)
        return _tconv_raw(x, w, s, p_lo, p_hi, NO_EPILOGUE, ())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s, p_lo, p_hi = ctx.conf
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = adjoints.tconv_dx(
                g, w, s, p_lo, p_hi,
                lambda gp, wf, st: kconv.conv2d(gp, wf, stride=st,
                                                padding="VALID")).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = adjoints.tconv_dw(x, g, w.shape[0], s, p_lo,
                                   p_hi).to(w.dtype)
        return dx, dw, None, None, None


class _TconvEpFn(torch.autograd.Function):
    """Transposed conv with a fused epilogue; the port of
    ``_tconv_ep_vjp``: the backward recomputes through :class:`_TconvFn`
    (``adjoints.fused_epilogue_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, spec, s, p_lo, p_hi, *eps):
        ctx.save_for_backward(x, w, *eps)
        ctx.conf = (spec, s, p_lo, p_hi)
        return _tconv_raw(x, w, s, p_lo, p_hi, spec, eps)

    @staticmethod
    def backward(ctx, g):
        x, w, *eps = ctx.saved_tensors
        spec, s, p_lo, p_hi = ctx.conf
        needs = ctx.needs_input_grad
        grads = adjoints.fused_epilogue_bwd(
            lambda xx, ww: _TconvFn.apply(xx, ww, s, p_lo, p_hi), spec, x, w,
            eps, g, needs[:2] + needs[6:])
        return (*grads[:2], None, None, None, None, *grads[2:])


def tconv_plan(cin: int, cout: int, k: int,
               dtype: torch.dtype = torch.float32) -> kconv.ConvPlan:
    """The variant of ``csrc/transposed_conv.cu`` for a (k, k, cin, cout)
    kernel: the widest copy of the input whose channel run divides ``cin``
    (``kconv.copy_vec``; in fp32 16 bytes when ``cin % 4 == 0``), the
    narrowest Cout tile covering ``cout`` (32 wide past 32, so the staged
    output tile stays small), and the weights of all ``k*k`` taps of a
    16-channel chunk resident when they fit ``RESIDENT_BYTES`` at the
    dtype's size, else streamed per parity plane."""
    tile = kconv.cout_tile(cout, widest=32)
    slab = k * k * CHUNK * kconv.TILES[tile][0] * dtype.itemsize
    return kconv.ConvPlan(vec=kconv.copy_vec(cin, dtype), tile=tile,
                          resident=slab <= kconv.RESIDENT_BYTES, dtype=dtype)


def launch_plan(x: torch.Tensor, w: torch.Tensor, s: int = 2,
                p_lo: int | None = None, p_hi: int | None = None,
                spec: EpilogueSpec | None = None) -> kconv.ConvPlan:
    """The plan of a launch: the tile and resident flag of the plan table
    (``autotune.get_plan``: a tuned plan, else :func:`tconv_plan`'s), with
    the widest copy the input's address allows.  The stride, pads
    (default ``(k-1)//2`` and one more) and ``spec`` complete the table's
    key."""
    from repro_torch.kernels import autotune

    k = w.shape[0]
    p_lo = (k - 1) // 2 if p_lo is None else p_lo
    p_hi = p_lo + 1 if p_hi is None else p_hi
    plan = autotune.get_plan("tconv", tuple(x.shape), tuple(w.shape),
                             stride=s, dtype=x.dtype, padding=p_lo,
                             output_padding=p_hi - p_lo, epilogue=spec,
                             device=x.device)
    return plan._replace(vec=kconv.copy_vec(x.shape[-1], x.dtype,
                                            x.data_ptr()))


def _out_hw(x: torch.Tensor, k: int, s: int, p_lo: int,
            p_hi: int) -> tuple[int, int]:
    h, w_in = x.shape[1], x.shape[2]
    oh = (h - 1) * s + p_lo + p_hi - k + 2
    ow = (w_in - 1) * s + p_lo + p_hi - k + 2
    if oh <= 0 or ow <= 0:
        raise ValueError(f"degenerate output {oh}x{ow} for input {h}x{w_in}")
    return oh, ow


def tconv_plain(x: torch.Tensor, w: torch.Tensor, s: int, p_lo: int,
                p_hi: int, spec: EpilogueSpec, eps: tuple) -> torch.Tensor:
    """Plain version, with the kernel's arithmetic: per parity plane, the
    sum of its live taps as ``torch.matmul`` products of operands widened to
    fp32, in fp32, interleaved, then :func:`apply_reference` on the fp32
    planes (which also covers the zero planes of ``k < s``), rounded once
    to ``x.dtype``."""
    n, h, w_in, cin = x.shape
    k, _, _, cout = w.shape
    oh, ow = _out_hw(x, k, s, p_lo, p_hi)
    sched = parity_schedule(k, s, p_lo)
    offs = [o for taps in sched for _, o in taps]
    shift = max(0, -min(offs, default=0))
    hb, wb = math.ceil(oh / s), math.ceil(ow / s)
    # pad so that every block index b reads rows b + off + shift in bounds
    pad_b = max(0, hb + max(offs, default=0) + shift - (h + shift))
    pad_r = max(0, wb + max(offs, default=0) + shift - (w_in + shift))
    xp = F.pad(x, (0, 0, shift, pad_r, shift, pad_b)).float()
    out = xp.new_zeros((n, oh, ow, cout))
    for ry, rtaps in enumerate(sched):
        nyr = len(range(ry, oh, s))
        for rx, ctaps in enumerate(sched):
            nxr = len(range(rx, ow, s))
            if nyr == 0 or nxr == 0 or not rtaps or not ctaps:
                continue
            acc = xp.new_zeros((n * nyr * nxr, cout))
            for ty, oy in rtaps:
                for tx, ox in ctaps:
                    rows = xp[:, oy + shift: oy + shift + nyr,
                              ox + shift: ox + shift + nxr, :]
                    acc += torch.matmul(rows.reshape(-1, cin),
                                        w[ty, tx].float())
            out[:, ry::s, rx::s, :] = acc.reshape(n, nyr, nxr, cout)
    return apply_reference(spec, out, eps).to(x.dtype)


def schedule_array(k: int, s: int, p_lo: int) -> ctypes.Array:
    """The schedule in the kernel's layout: per parity, a count then
    ``MAX_TAPS`` (tap, offset) pairs."""
    if not 2 <= s <= MAX_STRIDE:
        raise ValueError(f"tconv kernel takes stride 2..{MAX_STRIDE}, got {s}")
    row = 1 + 2 * MAX_TAPS
    flat = [0] * (s * row)
    for r, taps in enumerate(parity_schedule(k, s, p_lo)):
        if len(taps) > MAX_TAPS:
            raise ValueError(f"{len(taps)} live taps per parity exceed the "
                             f"kernel's {MAX_TAPS} (k={k}, s={s})")
        flat[r * row] = len(taps)
        for j, (t, off) in enumerate(taps):
            flat[r * row + 1 + 2 * j] = t
            flat[r * row + 2 + 2 * j] = off
    return (ctypes.c_int * len(flat))(*flat)


def _tconv_fn():
    lib = build.load("transposed_conv")
    fn = lib.tconv_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.tconv_error_string.argtypes = [ctypes.c_int]
        lib.tconv_error_string.restype = ctypes.c_char_p
        lib.tconv_smem_bytes.argtypes = ([ctypes.c_int] * 4
                                         + [ctypes.c_void_p]
                                         + [ctypes.c_int] * 3)
        lib.tconv_smem_bytes.restype = ctypes.c_int
    return lib, fn


def kernel_smem_bytes(oh: int, ow: int, k: int, s: int, p_lo: int,
                      plan: kconv.ConvPlan) -> int:
    """The dynamic shared memory ``csrc/transposed_conv.cu`` asks for with
    ``plan`` on an (oh, ow) output of a k x k, stride-``s`` conv with low
    pad ``p_lo`` (``tconv_smem_bytes``), or -1 for a plan it refuses; needs
    the built library, not a card."""
    lib, _ = _tconv_fn()
    sched = schedule_array(k, s, p_lo)
    return lib.tconv_smem_bytes(oh, ow, k, s, sched,
                                DTYPE_CODES[plan.dtype], plan.tile,
                                int(plan.resident))


def tconv_cuda(x: torch.Tensor, w: torch.Tensor, s: int, p_lo: int,
               p_hi: int, spec: EpilogueSpec, eps: tuple,
               plan: kconv.ConvPlan | None = None) -> torch.Tensor:
    """Launch ``csrc/transposed_conv.cu`` on PyTorch's current stream, in
    x's dtype, with :func:`launch_plan`'s variant (or ``plan``, as the
    autotune sweep times each candidate)."""
    dt = kconv.require_cuda(x, w, "tconv_cuda")
    n, h, w_in, cin = x.shape
    k, _, _, cout = w.shape
    oh, ow = _out_hw(x, k, s, p_lo, p_hi)
    sched = schedule_array(k, s, p_lo)
    out = torch.empty((n, oh, ow, cout), device=x.device, dtype=x.dtype)
    ops = kernel_operands(spec, eps, tuple(out.shape), x.device, x.dtype)
    if plan is None:
        plan = launch_plan(x, w, s, p_lo, p_hi, spec)
    lib, fn = _tconv_fn()
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  *operand_ptrs(ops), n, h, w_in, cin, oh, ow, cout, k, s,
                  sched, int(spec.bn), int(spec.prelu), residual_code(spec),
                  dt, plan.vec, plan.tile, int(plan.resident),
                  torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "transposed_conv2d", lib.tconv_error_string)
    transposed_conv2d.launches += 1
    return out


__all__ = ["parity_schedule", "transposed_conv2d", "tconv_plain",
           "tconv_cuda", "tconv_plan", "launch_plan", "schedule_array",
           "kernel_smem_bytes"]
