"""Decomposed dilated convolution on the dense CUDA kernel (paper §II-B).

The port of ``repro.kernels.dilated_conv``: layout code around kernel 1
(:mod:`repro_torch.kernels.conv2d`), with no kernel of its own.  At stride 1
the ``d**2`` phase blocks are stacked on the batch axis by a pure layout
transform, ONE dense SAME conv runs all of them, and the outputs interleave
back.  The per-channel epilogue ops commute with that relabeling and the
residual rides the same transform, so BN, PReLU and the residual add all
run inside the dense kernel.  The layout transforms keep the dtype, so a
bf16 conv stays bf16 through them.

Gradients follow the reference: an odd-k conv with no epilogue takes
:class:`_DilatedFn` (dx is the same dilated conv of the cotangent with the
flipped kernel, dw a tap correlation at step ``d``, both returned in the
primal dtypes); fused epilogues and
even k differentiate by composition through the dense kernel's Functions
on the phase-batched layout (all of ENet's dilated convs), and the
strided class windows through its epilogue-free Function.

``stride > 1`` uses the output-class schedule
(:func:`repro_torch.core.dilated.stride_class_schedule`): the class windows
batch into one strided VALID dense conv, and the epilogue runs after the
stitch, as in the reference (its class windows have uneven output extents).

``group=`` (a ``torch.distributed`` group: the data axis, DESIGN.md §13)
splits the folded phase batch (or the batched class windows) over its
ranks: rank r runs kernel 1 on its contiguous share, and the shares are
gathered in fold order before the stitch.  Under autograd that path
differentiates by composition (each rank's gradients cover its share).
"""

from __future__ import annotations

import torch

from repro_torch.core import adjoints
from repro_torch.core.dilated import (_batch_to_phase,
                                      _dilated_strided_decomposed,
                                      _phase_to_batch)
from repro_torch.distributed.collectives import map_rows
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels.epilogue import (NO_EPILOGUE, EpilogueSpec,
                                          apply_reference, pack_args)


def dilated_conv2d(x, w, dilation: int, *, stride: int = 1,
                   epilogue: EpilogueSpec | None = None, scale=None,
                   shift=None, alpha=None, residual=None, group=None):
    """SAME dilated convolution via phase decomposition + the dense kernel.

    Args:
      x: (N, H, W, Cin).   w: (k, k, Cin, Cout) compact kernel.
      dilation: step ``d = D + 1``.
      stride: output stride ``s`` (output extent ``ceil(H/s)``).
      epilogue: optional :class:`EpilogueSpec` with matching operands.
      group: a process group whose ranks split the folded batch.
    Returns:
      (N, ceil(H/s), ceil(W/s), Cout).
    """
    d, s = dilation, stride
    spec = NO_EPILOGUE if epilogue is None else epilogue
    eps = pack_args(spec, scale=scale, shift=shift, alpha=alpha,
                    residual=residual)
    ep_kw = dict(zip(spec.slots, eps))
    if d == 1:
        if group is not None:
            raise ValueError("group= splits the phase-batched layout only")
        return kconv.conv2d(x, w, stride=s, padding="SAME", epilogue=epilogue,
                            **ep_kw)
    if s != 1:
        def conv_fn(xb, wt, sb):
            return kconv.conv2d(xb, wt, stride=sb, padding="VALID")

        y = _dilated_strided_decomposed(x, w, d, s, "batched", conv_fn,
                                        group=group)
        return apply_reference(spec, y, eps)
    if (group is None and spec.empty and w.shape[0] % 2
            and kconv.wants_grad(x, w)):
        return _DilatedFn.apply(x, w, d)
    # fused epilogues and even k differentiate by composition through the
    # dense kernel's Functions: the symmetry adjoint of _DilatedFn assumes
    # odd-k symmetric SAME pads, and the epilogue's gradient needs the
    # recompute of the dense epilogue Function
    return _dilated_impl(x, w, d, spec, ep_kw, group)


def _dilated_impl(x, w, d: int, spec: EpilogueSpec = NO_EPILOGUE,
                  ep_kw: dict | None = None, group=None):
    """Stride 1: phases on the batch axis, one dense SAME conv (over this
    rank's share of the fold, with ``group``), stitch."""
    ep_kw = dict(ep_kw or {})
    n, h, w_in, _ = x.shape
    xb, _, _ = _phase_to_batch(x, d)
    # the pad-up rows of the residual land in the cropped region
    res = ep_kw.pop("residual", None)
    res = None if res is None else _phase_to_batch(res, d)[0]

    def conv(xs, rs):
        kw = ep_kw if rs is None else {**ep_kw, "residual": rs}
        return kconv.conv2d(xs, w, padding="SAME",
                            epilogue=None if spec.empty else spec, **kw)

    yb = map_rows(conv, xb, res, group=group)
    return _batch_to_phase(yb, d, n, h, w_in)


class _DilatedFn(torch.autograd.Function):
    """Odd-k, epilogue-free, stride-1 dilated conv; the port of
    ``_dilated_vjp``.  dx re-enters the phase-batched engine with the
    flipped kernel (``adjoints.dilated_conv_dx``); dw gathers taps at step
    ``d`` (``adjoints.dilated_conv_dw``)."""

    @staticmethod
    def forward(ctx, x, w, d):
        ctx.save_for_backward(x, w)
        ctx.d = d
        return _dilated_impl(x, w, d)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = adjoints.dilated_conv_dx(g, w, ctx.d,
                                          _dilated_impl).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = adjoints.dilated_conv_dw(x, g, w.shape[0], ctx.d).to(w.dtype)
        return dx, dw, None


__all__ = ["dilated_conv2d"]
