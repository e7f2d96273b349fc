"""Dense 2-D convolution: the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/conv2d.py::_conv_kernel``
(launched by ``_conv2d_raw``, ``pallas_call`` at ``conv2d.py:195``).  The
kernel (``csrc/conv2d.cu`` on ``csrc/igemm.cuh``) is one implicit GEMM on
the CUDA cores: M = output pixels, N = Cout, K = kh*kw*Cin walked
tap-major, inputs gathered under bounds masks (so padding is implicit) by
asynchronous copies through a 4-stage ring, the Cout tile's weight slab
resident in shared memory, and the fused epilogue (``csrc/epilogue.cuh``)
applied as the tile leaves through shared memory in 16-byte stores.  It
carries every dense conv of ENet and, through
:mod:`repro_torch.kernels.dilated_conv`, every dilated conv.  As the Pallas
kernel does, it takes fp32 or bf16 x and w (a residual of their dtype),
accumulates in fp32, applies the epilogue in fp32 and returns their dtype,
rounded once; the bf16 form stages bf16 in shared memory and widens it as
the FMAs read it.

Bound on the H100.  ENet's convs are thin (Cin, Cout 3..128): a forward's
dense convs do 14.5 GFLOP, 0.217 ms at the 67 TFLOP/s of the CUDA cores,
against 0.447 ms of bytes at 3.35 TB/s.  Layer by layer, the 1x1
projections (the 128->64 one as much by its FMAs), the k2 s2 downsamples,
the stem and the decoder's 3x3 4->4 are bound by device-memory bytes; the
3x3 (dense and dilated), 5x1 and 1x5 layers at Cin 16-32 are bound by
their FMAs.  So the design keeps loads in flight, stores wide and
FMAs fed from float4 shared reads, and the epilogue is fused, so each
output is written once.  No TF32: it would break the 1e-4 fp32 bar (3xTF32
for the FMA-bound layers is in ROADMAP.md).  bf16 halves the bytes of the
first group; its FMAs stay on the CUDA cores in fp32 (a tensor-core bf16
form is a ROADMAP.md lever).

:func:`conv_plan` picks a launch's variant from the layer's shape and dtype:
the copy width (the widest of ``COPY_BYTES`` whose channel run divides
Cin), the Cout tile (4, 8, 16, 20, 32 or 64 wide) and resident or streamed
weights.  :func:`conv2d` takes
its plain version, :func:`conv2d_plain` (a tap sum of ``torch.matmul``),
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.  ``conv2d.launches`` counts kernel launches and
``conv2d.launches_by_variant`` splits them by :attr:`ConvPlan.variant`,
whose name carries the dtype (``vec4-resident``, ``bf16-vec8-resident``).
PERF.md has each ENet layer's time beside its bound.

Gradients (the port of ``_conv2d_vjp`` and ``_conv2d_ep_vjp``, DESIGN.md
§6): under autograd :func:`conv2d` applies :class:`_Conv2dFn` or, with an
epilogue, :class:`_Conv2dEpFn`, whose backward recomputes the conv without
its epilogue and differentiates the epilogue elementwise.  dx re-enters
the kernels (:func:`conv2d_dx`), dw is ``adjoints.dense_conv_dw``; both come
back in the primal dtypes, as the reference's VJPs cast them.  With no
gradient requested the wrapper launches exactly as in serving.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import adjoints, nhwc
from repro_torch.core.nhwc import Pads
from repro_torch.core.transposed import zero_insert_input
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import (NO_EPILOGUE, EpilogueSpec,
                                          apply_reference, kernel_operands,
                                          operand_ptrs, pack_args,
                                          residual_code)
from repro_torch.kernels.util import DTYPE_CODES, dtype_code


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


def check_operands(x: torch.Tensor, w: torch.Tensor, what: str,
                   residual: torch.Tensor | None = None) -> None:
    """Raise on what the kernels and their plain versions do not take: x
    and w (and a residual) of one dtype, fp32 or bf16, on one device."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{what}: x must be NHWC and w HWIO, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[-1] != w.shape[2]:
        raise ValueError(f"{what}: x has {x.shape[-1]} channels, w expects "
                         f"{w.shape[2]}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise NotImplementedError(
            f"{what}: the kernels take fp32 only or bf16 only operands (x "
            f"and w of one dtype; fp16 is still to port, ROADMAP.md), got "
            f"{x.dtype} and {w.dtype}")
    if residual is not None and residual.dtype != x.dtype:
        raise ValueError(f"{what}: the residual must be {x.dtype} like x, "
                         f"got {residual.dtype}")
    if x.device != w.device:
        raise ValueError(f"{what}: x on {x.device} but w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def require_cuda(x: torch.Tensor, w: torch.Tensor, what: str) -> int:
    """The launch-side checks: a kernel takes contiguous CUDA tensors of
    one dtype.  Returns the kernels' code of that dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x must be a CUDA tensor, got {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: x and w must be contiguous")
    if w.dtype != x.dtype:
        raise ValueError(f"{what}: x is {x.dtype} but w {w.dtype}")
    return dtype_code(x, what)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding="SAME", epilogue: EpilogueSpec | None = None,
           scale=None, shift=None, alpha=None,
           residual=None) -> torch.Tensor:
    """Dense convolution, NHWC x HWIO -> NHWC, with a fused epilogue.

    Args:
      x: (N, H, W, Cin) fp32 or bf16.  w: (kh, kw, Cin, Cout) of x's dtype,
        rectangular ok.  The output has x's dtype; a bf16 one is rounded
        once from the fp32 accumulator after the epilogue.
      stride: spatial stride >= 1.
      padding: "SAME", "VALID", a symmetric int, or per-dim
        ``((top, bottom), (left, right))`` pads.
      epilogue: optional :class:`EpilogueSpec` with matching
        ``scale``/``shift``/``alpha``/``residual`` operands.
    """
    spec = NO_EPILOGUE if epilogue is None else epilogue
    eps = pack_args(spec, scale=scale, shift=shift, alpha=alpha,
                    residual=residual)
    check_operands(x, w, "conv2d", residual)
    if stride < 1:
        raise ValueError(f"conv2d: stride must be >= 1, got {stride}")
    pads = resolve_pads(padding, w.shape[0], w.shape[1])
    if not wants_grad(x, w, *eps):
        return _conv2d_raw(x, w, stride, pads, spec, eps)
    if spec.empty:
        return _Conv2dFn.apply(x, w, stride, pads)
    return _Conv2dEpFn.apply(x, w, spec, stride, pads,
                             *tensor_operands(spec, eps, x.device))


conv2d.launches = 0


def wants_grad(*ts) -> bool:
    """Whether autograd will ask for a gradient of any of ``ts``."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def tensor_operands(spec: EpilogueSpec, eps: tuple,
                    device: torch.device) -> tuple:
    """Epilogue operands as tensors, so a ``Function`` can save them: the
    channel operands fp32 (a Python scalar slope becomes a 0-d tensor), the
    residual in its own dtype (the output's)."""
    return tuple(e if name == "residual"
                 else torch.as_tensor(e, dtype=torch.float32, device=device)
                 for name, e in zip(spec.slots, eps))


def _conv2d_raw(x, w, stride, pads, spec, eps):
    """One forward: the plain version on the CPU, else the kernel."""
    if x.device.type == "cpu":
        return conv2d_plain(x, w, stride, pads, spec, eps)
    return conv2d_cuda(x.contiguous(), w.contiguous(), stride, pads, spec,
                       eps)


def conv2d_dx(g: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads,
              h: int, w_in: int) -> torch.Tensor:
    """Input-gradient of :func:`conv2d`, the port of ``_conv2d_bwd``.

    A square kernel with equal low pads ``p <= k - 1`` goes through
    ``adjoints.dense_conv_dx`` on the transposed engine: kernel 2 at
    stride > 1, which routes stride 1 to the dense kernel.  Other pads and
    rectangular kernels (ENet's 5x1/1x5) at stride 1 are the dense kernel
    at the explicit pads of the reference's ``_dx_lax``; at stride > 1
    they compose plain torch ops, as the reference falls back to a lax
    conv.
    """
    from repro_torch.kernels.transposed_conv import transposed_conv2d

    kh, kw = w.shape[0], w.shape[1]
    (pt, _), (pl, _) = pads
    if kh == kw and pt == pl and kh - 1 - pt >= 0:
        def tconv_fn(gg, wf, s, p_lo, op):
            return transposed_conv2d(gg, wf, stride=s, padding=p_lo,
                                     output_padding=op)

        return adjoints.dense_conv_dx(g, w, stride, pt, h, w_in, tconv_fn)
    hg, wg = g.shape[1], g.shape[2]
    lo_h, hi_h = kh - 1 - pt, h - (hg - 1) * stride - 1 + pt
    lo_w, hi_w = kw - 1 - pl, w_in - (wg - 1) * stride - 1 + pl
    wf = adjoints.flip_io(w)
    if stride > 1:
        return nhwc.conv(zero_insert_input(g, stride), wf, 1,
                         ((lo_h, hi_h), (lo_w, hi_w)))
    # negative pads crop the cotangent first; the kernel pads implicitly
    gc = adjoints._pad_to(g, min(lo_h, 0), min(hi_h, 0), min(lo_w, 0),
                          min(hi_w, 0))
    return conv2d(gc, wf, padding=((max(lo_h, 0), max(hi_h, 0)),
                                   (max(lo_w, 0), max(hi_w, 0))))


class _Conv2dFn(torch.autograd.Function):
    """Epilogue-free dense conv; the port of ``_conv2d_vjp``.  Saves
    (x, w); dx by :func:`conv2d_dx` (skipped when x needs none, as for the
    stem), dw by ``adjoints.dense_conv_dw``."""

    @staticmethod
    def forward(ctx, x, w, stride, pads):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pads)
        return _conv2d_raw(x, w, stride, pads, NO_EPILOGUE, ())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pads = ctx.conf
        (pt, _), (pl, _) = pads
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_dx(g, w, stride, pads, x.shape[1],
                           x.shape[2]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = adjoints.dense_conv_dw(x, g, w.shape[0], w.shape[1], stride,
                                        pt, pl).to(w.dtype)
        return dx, dw, None, None


class _Conv2dEpFn(torch.autograd.Function):
    """Dense conv with a fused epilogue; the port of ``_conv2d_ep_vjp``.
    Saves (x, w, *eps); the backward recomputes the conv through
    :class:`_Conv2dFn` (``adjoints.fused_epilogue_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, spec, stride, pads, *eps):
        ctx.save_for_backward(x, w, *eps)
        ctx.conf = (spec, stride, pads)
        return _conv2d_raw(x, w, stride, pads, spec, eps)

    @staticmethod
    def backward(ctx, g):
        x, w, *eps = ctx.saved_tensors
        spec, stride, pads = ctx.conf
        needs = ctx.needs_input_grad
        grads = adjoints.fused_epilogue_bwd(
            lambda xx, ww: _Conv2dFn.apply(xx, ww, stride, pads), spec, x, w,
            eps, g, needs[:2] + needs[5:])
        return (*grads[:2], None, None, None, *grads[2:])


#: the kernel's tiles by C id (``csrc/igemm.cuh::dispatch_tile``): Cout
#: width BN, couts per thread TN, thread rows TY, pixels per thread TM and
#: K groups KS (split K inside the block); BM = TY * TM pixels a block.
TILES = ((4, 4, 128, 2, 1), (8, 4, 64, 4, 1), (16, 4, 64, 2, 1),
         (20, 4, 32, 4, 1), (32, 4, 32, 4, 1), (64, 4, 16, 8, 1),
         (32, 8, 16, 8, 4))
#: the tiles of one K group and 4 couts a thread, narrowest first: every
#: Cout width of the transposed conv, and of conv_plan but 32
PLAN_TILES = (0, 1, 2, 3, 4, 5)
#: conv_plan's tile for a Cout tile 32 wide: 8 x 8 register tiles in 4 K
#: groups, faster than tile 4 on all of ENet's Cout-32 convs (PERF.md §6);
#: ``csrc/conv2d.cu`` builds no dense kernel of tile 4
SPLIT_K_TILE = 6
#: K rows per pipeline stage (``kBK``)
K_STEP = 16
#: weight slabs up to this size stay in shared memory (``kResidentBytes``)
RESIDENT_BYTES = 48 * 1024
#: the copy widths of the input gather, in bytes, widest first, by dtype
#: (``csrc/igemm.cuh::dispatch_vec``): ``cp.async`` of 16 bytes, of 8 (bf16
#: Cin 4) or 4 (fp32), and one bf16 element by a plain load (cp.async has
#: no 2-byte form)
COPY_BYTES = {torch.float32: (16, 4), torch.bfloat16: (16, 8, 2)}
VARIANTS = ("vec4-resident", "vec4-streamed", "scalar-resident",
            "scalar-streamed", "bf16-vec8-resident", "bf16-vec8-streamed",
            "bf16-vec4-resident", "bf16-vec4-streamed",
            "bf16-scalar-resident", "bf16-scalar-streamed")
conv2d.launches_by_variant = dict.fromkeys(VARIANTS, 0)


class ConvPlan(NamedTuple):
    """How ``csrc/conv2d.cu`` (or ``transposed_conv.cu``) runs one conv."""

    vec: int        # elements per copy of x (COPY_BYTES): 4 or 1 fp32,
    #                 8, 4 or 1 bf16
    tile: int       # index into TILES
    resident: bool  # the Cout tile's weight slab stays in shared memory
    dtype: torch.dtype = torch.float32

    @property
    def bn(self) -> int:
        """Couts per block."""
        return TILES[self.tile][0]

    @property
    def variant(self) -> str:
        kind = "" if self.dtype == torch.float32 else "bf16-"
        copy = "scalar" if self.vec == 1 else f"vec{self.vec}"
        return f"{kind}{copy}-{'resident' if self.resident else 'streamed'}"


def cout_tile(cout: int, widest: int = 64) -> int:
    """The narrowest tile (index into TILES) at least ``cout`` wide, or the
    widest allowed one when none is (then Cout takes several tiles)."""
    fits = [i for i in PLAN_TILES if TILES[i][0] <= widest]
    for i in fits:
        if TILES[i][0] >= cout:
            return i
    return fits[-1]


def copy_vec(cin: int, dtype: torch.dtype = torch.float32,
             address: int = 0) -> int:
    """Elements per copy of the input gather: the widest of
    ``COPY_BYTES[dtype]`` whose run of channels divides ``cin`` (a group of
    K rows is then channels of one tap) and whose bytes divide ``address``
    (the input's base pointer, when known)."""
    for nbytes in COPY_BYTES[dtype]:
        if cin % (nbytes // dtype.itemsize) == 0 and address % nbytes == 0:
            return nbytes // dtype.itemsize
    raise ValueError(f"no copy of {dtype} fits Cin {cin} at address "
                     f"{address:#x}")


def conv_plan(cin: int, cout: int, kh: int, kw: int, stride: int,
              dtype: torch.dtype = torch.float32) -> ConvPlan:
    """The variant of ``csrc/conv2d.cu`` for a (kh, kw, cin, cout) conv.

    The widest copy of the input whose channel run divides ``cin``
    (:func:`copy_vec`: in fp32 16 bytes when ``cin % 4 == 0``, else 4; in
    bf16 16 bytes when ``cin % 8 == 0``, 8 when ``cin % 4 == 0``, else one
    element); the narrowest Cout tile that covers ``cout`` (64 wide past
    64; a 32-wide one splits K over 4 thread groups, ``SPLIT_K_TILE``); the
    weight slab resident when its ``ceil(K / 16) * 16`` rows of the tile fit
    ``RESIDENT_BYTES`` at the dtype's size.  The stride changes the
    gather's addresses, not the plan.
    """
    if min(cin, cout, kh, kw, stride) < 1:
        raise ValueError(f"conv_plan: bad conv ({kh}, {kw}, {cin}, {cout}) "
                         f"stride {stride}")
    tile = cout_tile(cout)
    if TILES[tile][0] == TILES[SPLIT_K_TILE][0]:
        tile = SPLIT_K_TILE
    return ConvPlan(vec=copy_vec(cin, dtype), tile=tile,
                    resident=slab_fits(kh * kw * cin, tile, dtype),
                    dtype=dtype)


def launch_plan(x: torch.Tensor, w: torch.Tensor, stride: int,
                pads=None, spec: EpilogueSpec | None = None) -> ConvPlan:
    """The plan of a launch: the tile and resident flag of the plan table
    (``autotune.get_plan``: a tuned plan, else :func:`conv_plan`'s), with
    the widest copy the input's address allows.  ``pads`` (default SAME)
    and ``spec`` complete the table's key."""
    from repro_torch.kernels import autotune

    plan = autotune.get_plan("dense", tuple(x.shape), tuple(w.shape),
                             stride=stride, dtype=x.dtype, padding=pads,
                             epilogue=spec, device=x.device)
    return plan._replace(vec=copy_vec(x.shape[-1], x.dtype, x.data_ptr()))


def slab_fits(k: int, tile: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the weight slab of ``k`` K rows (rounded up to whole
    stages) and one Cout tile of ``tile`` fits ``RESIDENT_BYTES``."""
    return (-(-k // K_STEP) * K_STEP * TILES[tile][0] * dtype.itemsize
            <= RESIDENT_BYTES)


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads,
                 spec: EpilogueSpec, eps: tuple) -> torch.Tensor:
    """Plain version, with the kernel's arithmetic: the conv as a sum of
    kh*kw shifted ``torch.matmul`` taps, widened to fp32, into an fp32
    accumulator, then :func:`apply_reference` on it in fp32, rounded once to
    ``x.dtype``."""
    n, h, w_in, cin = x.shape
    kh, kw, _, cout = w.shape
    (pt, pb), (pl, pr) = pads
    s = stride
    oh, ow = out_extent(h, kh, s, pt, pb), out_extent(w_in, kw, s, pl, pr)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"conv2d: empty output {oh}x{ow}")
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)).float()
    acc = xp.new_zeros((n * oh * ow, cout))
    for dy in range(kh):
        for dx in range(kw):
            rows = xp[:, dy: dy + s * (oh - 1) + 1: s,
                      dx: dx + s * (ow - 1) + 1: s, :]
            acc += torch.matmul(rows.reshape(-1, cin), w[dy, dx].float())
    return apply_reference(spec, acc.reshape(n, oh, ow, cout),
                           eps).to(x.dtype)


def _conv2d_fn():
    lib = build.load("conv2d")
    fn = lib.conv2d_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 19
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.conv2d_error_string.argtypes = [ctypes.c_int]
        lib.conv2d_error_string.restype = ctypes.c_char_p
        lib.conv2d_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.conv2d_smem_bytes.restype = ctypes.c_int
    return lib, fn


def kernel_smem_bytes(k_rows: int, plan: ConvPlan, residual: bool) -> int:
    """The dynamic shared memory ``csrc/conv2d.cu`` asks for with ``plan``
    on K = ``k_rows`` rows (``conv2d_smem_bytes``), or -1 for a tile it
    does not build; needs the built library, not a card."""
    lib, _ = _conv2d_fn()
    return lib.conv2d_smem_bytes(k_rows, DTYPE_CODES[plan.dtype], plan.tile,
                                 int(plan.resident), int(residual))


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads,
                spec: EpilogueSpec, eps: tuple,
                plan: ConvPlan | None = None) -> torch.Tensor:
    """Launch ``csrc/conv2d.cu`` on PyTorch's current stream, in x's dtype,
    with :func:`launch_plan`'s variant (or ``plan``, as the autotune sweep
    times each candidate)."""
    dt = require_cuda(x, w, "conv2d_cuda")
    n, h, w_in, cin = x.shape
    kh, kw, _, cout = w.shape
    (pt, pb), (pl, pr) = pads
    oh = out_extent(h, kh, stride, pt, pb)
    ow = out_extent(w_in, kw, stride, pl, pr)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"conv2d: empty output {oh}x{ow}")
    out = torch.empty((n, oh, ow, cout), device=x.device, dtype=x.dtype)
    ops = kernel_operands(spec, eps, tuple(out.shape), x.device, x.dtype)
    if plan is None:
        plan = launch_plan(x, w, stride, pads, spec)
    lib, fn = _conv2d_fn()
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  *operand_ptrs(ops), n, h, w_in, cin, oh, ow, cout, kh, kw,
                  stride, pt, pl, int(spec.bn), int(spec.prelu),
                  residual_code(spec), dt, plan.vec, plan.tile,
                  int(plan.resident),
                  torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, f"conv2d ({plan.variant})", lib.conv2d_error_string)
    conv2d.launches += 1
    conv2d.launches_by_variant[plan.variant] += 1
    return out


__all__ = ["conv2d", "conv2d_plain", "conv2d_cuda", "conv2d_dx", "conv_plan",
           "launch_plan", "kernel_smem_bytes", "copy_vec", "ConvPlan", "cout_tile", "slab_fits",
           "TILES", "VARIANTS", "COPY_BYTES",
           "resolve_pads", "out_extent", "check_operands", "require_cuda",
           "wants_grad", "tensor_operands"]
