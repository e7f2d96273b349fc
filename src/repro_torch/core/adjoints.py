"""Adjoint (VJP) pieces of the decomposition engine, in PyTorch.

The port of ``repro.core.adjoints`` (DESIGN.md §6).  The paper's symmetry
also governs gradients:

* the input-gradient of a **strided dense** conv is a transposed conv
  (stride ``s``, flipped and IO-transposed kernel): the weight-decomposition
  engine, kernel 2;
* the input-gradient of a **transposed** conv is a strided dense conv: the
  dense engine, kernel 1;
* the input-gradient of a **dilated** conv (stride 1, odd ``k``) is the same
  dilated conv with the flipped kernel: the input-decomposition engine;
* every **weight-gradient** is a tap-gather correlation: ``k**2`` strided
  slices, each contracted in one ``torch.matmul`` with fp32 accumulation,
  never reading an inserted zero.  The reference leaves these products to
  XLA outside any Pallas kernel, so the port leaves them to ``torch.matmul``.
  The result is fp32 whatever the operands' dtype (the reference's
  ``preferred_element_type=jnp.float32``); the callers cast it once to the
  weight's dtype.

The kernel wrappers' ``torch.autograd.Function`` classes
(:mod:`repro_torch.kernels.conv2d`, ``transposed_conv``, ``dilated_conv``)
are built from these; the torch backend differentiates natively.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.epilogue import apply_reference


def flip_io(w: torch.Tensor) -> torch.Tensor:
    """Spatially flip an HWIO kernel and swap its in/out channels.

    ``flip_io(w)[ky, kx, co, ci] == w[kh-1-ky, kw-1-kx, ci, co]``: the kernel
    of every input-gradient convolution.
    """
    return torch.flip(w, (0, 1)).transpose(2, 3)


def tap_correlation(a: torch.Tensor, b: torch.Tensor, kh: int, kw: int, *,
                    stride: int = 1, tap_step: int = 1) -> torch.Tensor:
    """Tap-gather correlation: the weight-gradient form.

    ``T[ty, tx, ca, cb] = sum_{n,oy,ox} a[n,oy,ox,ca] *
    b[n, stride*oy + tap_step*ty, stride*ox + tap_step*tx, cb]``.

    Each tap is one strided slice of ``b`` contracted against ``a`` as a
    ``(Ca, N*OH*OW) @ (N*OH*OW, Cb)`` product in fp32.  bf16 operands are
    widened to fp32 first (exact), so the product and its split-K partial
    sums are fp32 as the reference's ``preferred_element_type`` asks: a bf16
    ``torch.matmul`` would return bf16 and may reduce its partials in
    reduced precision.  The fp32 products run as the caller set TF32
    (off by default; nothing here flips a global flag).  ``b`` must be
    pre-padded so every index is in range.  Returns fp32.
    """
    n, oh, ow, ca = a.shape
    cb = b.shape[-1]
    at = a.reshape(n * oh * ow, ca).float().t()
    rows = []
    for ty in range(kh):
        cols = []
        for tx in range(kw):
            y0, x0 = tap_step * ty, tap_step * tx
            bs = b[:, y0: y0 + stride * (oh - 1) + 1: stride,
                   x0: x0 + stride * (ow - 1) + 1: stride, :]
            cols.append(torch.matmul(at,
                                     bs.reshape(n * oh * ow, cb).float()))
        rows.append(torch.stack(cols))
    return torch.stack(rows)  # (kh, kw, Ca, Cb)


def _pad_to(x: torch.Tensor, lo_h: int, hi_h: int, lo_w: int,
            hi_w: int) -> torch.Tensor:
    """Pad (positive) or crop (negative) the spatial dims of an NHWC tensor."""
    x = x[:, max(-lo_h, 0): x.shape[1] - max(-hi_h, 0),
          max(-lo_w, 0): x.shape[2] - max(-hi_w, 0), :]
    pads = (0, 0, max(lo_w, 0), max(hi_w, 0), max(lo_h, 0), max(hi_h, 0))
    return F.pad(x, pads) if any(pads) else x


# ---------------------------------------------------------------------------
# dense convolution  y = conv(x, w; stride s, pads (pl, ph) per dim)
# ---------------------------------------------------------------------------

def dense_conv_dx(g: torch.Tensor, w: torch.Tensor, stride: int, p_lo: int,
                  h: int, w_in: int, tconv_fn) -> torch.Tensor:
    """Input-gradient of a strided dense conv: a transposed convolution.

    The weight-decomposition engine on the cotangent with the flipped
    kernel, low pad ``k-1-p_lo``, and the output padding that recovers
    ``(h, w_in)``; extra high-side rows (gradients of the forward's zero
    pad) are cropped.  ``tconv_fn(g, wf, stride, padding, output_padding)``
    is the transposed engine of the active backend.
    """
    k = w.shape[0]
    hg, wg = g.shape[1], g.shape[2]
    op_h = h - (hg - 1) * stride - k + 2 * p_lo
    op_w = w_in - (wg - 1) * stride - k + 2 * p_lo
    op = max(0, op_h, op_w)
    dx = tconv_fn(g, flip_io(w), stride, k - 1 - p_lo, op)
    return dx[:, :h, :w_in, :]


def dense_conv_dw(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                  stride: int, p_lo_h: int, p_lo_w: int) -> torch.Tensor:
    """Weight-gradient of a dense conv: ``kh*kw`` strided tap gathers of x."""
    _, h, w_in, _ = x.shape
    _, oh, ow, _ = g.shape
    need_h = (kh - 1) + stride * (oh - 1) + 1
    need_w = (kw - 1) + stride * (ow - 1) + 1
    xp = _pad_to(x, p_lo_h, need_h - h - p_lo_h, p_lo_w,
                 need_w - w_in - p_lo_w)
    t = tap_correlation(g, xp, kh, kw, stride=stride)   # (kh, kw, Cout, Cin)
    return t.transpose(2, 3)


# ---------------------------------------------------------------------------
# transposed convolution  y = tconv(x, w; stride s, pads (p_lo, p_hi))
# ---------------------------------------------------------------------------

def _tconv_grad_pad(g: torch.Tensor, k: int, p_lo: int,
                    p_hi: int) -> torch.Tensor:
    """Pad the tconv cotangent to ``(k-1-p_lo, k-1-p_hi)`` per spatial dim
    (negative amounts crop)."""
    return _pad_to(g, k - 1 - p_lo, k - 1 - p_hi, k - 1 - p_lo, k - 1 - p_hi)


def tconv_dx(g: torch.Tensor, w: torch.Tensor, stride: int, p_lo: int,
             p_hi: int, conv_fn) -> torch.Tensor:
    """Input-gradient of a transposed conv: a strided dense convolution.

    The dense engine at stride ``s`` over the padded cotangent with the
    flipped kernel; the output extent is the forward input's.
    ``conv_fn(gp, wf, stride)`` is a VALID strided dense conv of the active
    backend.
    """
    k = w.shape[0]
    return conv_fn(_tconv_grad_pad(g, k, p_lo, p_hi), flip_io(w), stride)


def tconv_dw(x: torch.Tensor, g: torch.Tensor, k: int, stride: int,
             p_lo: int, p_hi: int) -> torch.Tensor:
    """Weight-gradient of a transposed conv: tap gathers of the cotangent,
    in flipped tap order."""
    gp = _tconv_grad_pad(g, k, p_lo, p_hi)
    t = tap_correlation(x, gp, k, k, stride=stride)     # (k, k, Cin, Cout)
    return torch.flip(t, (0, 1))


# ---------------------------------------------------------------------------
# dilated convolution  y = conv(x, w; dilation d, SAME, stride 1)
# ---------------------------------------------------------------------------

def dilated_conv_dx(g: torch.Tensor, w: torch.Tensor, dilation: int,
                    dilated_fn) -> torch.Tensor:
    """Input-gradient of a SAME dilated conv (odd ``k``): the same dilated
    conv of the cotangent with the flipped kernel.  ``dilated_fn(g, wf, d)``
    is the dilated engine of the active backend."""
    return dilated_fn(g, flip_io(w), dilation)


def dilated_conv_dw(x: torch.Tensor, g: torch.Tensor, k: int,
                    dilation: int) -> torch.Tensor:
    """Weight-gradient of a SAME dilated conv: tap gathers at step ``d``
    (each tap reads one phase block)."""
    d = dilation
    p = d * (k - 1) // 2
    xp = _pad_to(x, p, p, p, p)
    t = tap_correlation(g, xp, k, k, tap_step=d)        # (k, k, Cout, Cin)
    return t.transpose(2, 3)


# ---------------------------------------------------------------------------
# fused epilogues (DESIGN.md §7)
# ---------------------------------------------------------------------------

def fused_epilogue_bwd(conv_apply, spec, x, w, eps, g, needs):
    """Backward of a fused conv+epilogue by adjoint re-entry.

    Differentiates ``apply_reference(spec, conv_apply(x, w), eps)``:
    ``conv_apply`` is the epilogue-free kernel ``Function``, so the
    pre-epilogue output is recomputed here (saving it from the forward
    would write it to device memory a second time, the traffic the fusion
    removes) and its cotangent re-enters the §6 adjoints, while the
    BN/PReLU/residual gradients are elementwise fp32 ops.

    ``needs`` flags which of ``(x, w, *eps)`` want a gradient.  Returns
    ``(dx, dw, *deps)``, ``None`` where not needed, each in its primal's
    dtype.  With bf16 x and w the recompute runs the bf16 kernel and the
    epilogue's arithmetic stays fp32 (:func:`apply_reference` widens and
    rounds back), as the reference's ``jax.vjp`` of the same composition.
    """
    with torch.enable_grad():
        prims = [t.detach().requires_grad_(bool(n))
                 for t, n in zip((x, w, *eps), needs)]
        y = apply_reference(spec, conv_apply(prims[0], prims[1]),
                            tuple(prims[2:]))
        wanted = [t for t, n in zip(prims, needs) if n]
        grads = iter(torch.autograd.grad(y, wanted, g))
    return tuple(next(grads) if n else None for n in needs)


__all__ = [
    "flip_io", "tap_correlation", "dense_conv_dx", "dense_conv_dw",
    "tconv_dx", "tconv_dw", "dilated_conv_dx", "dilated_conv_dw",
    "fused_epilogue_bwd",
]
