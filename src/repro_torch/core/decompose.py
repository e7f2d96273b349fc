"""Unified entry point for the paper's decomposition technique, in PyTorch.

The port of ``repro.core.decompose.conv2d``.  It dispatches to dense,
dilated or transposed execution with the decomposition applied:

* ``backend="kernels"`` (the default, the counterpart of ``"pallas"``) runs
  the hand-written CUDA kernels of :mod:`repro_torch.kernels` on CUDA
  tensors — the dense conv kernel for dense and (phase-batched) dilated
  convs, the parity-plane kernel for transposed convs — with BN, PReLU and
  the residual add fused as an epilogue.  On CPU tensors the same wrappers
  run their plain PyTorch versions.
* ``backend="torch"`` (the counterpart of ``"xla"``) composes plain
  ``F.conv2d`` calls with the same decompositions and applies the epilogue
  after the conv (:func:`repro_torch.kernels.epilogue.apply_reference`).

The device follows the tensors.  The counterpart of the reference's
autotuned tiling (its ``_resolve_tiles``) sits at each kernel launch: the
launch plan (Cout tile, resident or streamed weights) comes from the plan
table of :mod:`repro_torch.kernels.autotune` (``conv2d.launch_plan``,
``transposed_conv.launch_plan``), and from the shape alone on a miss; the
backward passes' launches are keyed the same way.  The reference's
TPU-only knobs are not here: the tile overrides ``th``/``tc`` and
``interpret``.  The reference's ``phase_sharding`` becomes ``group=``, a
``torch.distributed`` group over the data axis (DESIGN.md §13): the
phase-batched dilated engine splits its folded ``d*d*N`` batch over the
group's ranks (a batch smaller than the ranks spreads its phases over
them), and every other form runs on this rank's share of the batch rows
(for a transposed conv, every parity plane of those rows, as the
reference's constraint on each parity's input batch); the shares are
gathered in order, so every rank ends with the whole output
(:func:`split_kind`).  Gradients flow through both backends: the torch backend
differentiates natively (it is the card-side oracle of the kernels'
gradients), and the kernel wrappers' ``torch.autograd.Function`` classes
re-enter the same two kernels through the adjoints of
:mod:`repro_torch.core.adjoints` (DESIGN.md §6).  ``compute_dtype`` casts to
fp32 or bf16 as the reference does (DESIGN.md §12).
"""

from __future__ import annotations

import torch

from repro_torch.core import dilated as _dil
from repro_torch.core import nhwc
from repro_torch.core import transposed as _tr
from repro_torch.distributed.collectives import map_rows
from repro_torch.kernels.conv2d import conv2d as kernel_conv2d
from repro_torch.kernels.dilated_conv import dilated_conv2d
from repro_torch.kernels.epilogue import (NO_EPILOGUE, EpilogueSpec,
                                          apply_reference, pack_args)
from repro_torch.kernels.transposed_conv import transposed_conv2d
from repro_torch.kernels.util import canon_dtype

BACKENDS = ("kernels", "torch")


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    dilation: int = 1,
    transposed: bool = False,
    padding: int | None = None,
    output_padding: int = 0,
    decomposed: bool = True,
    strategy: str = "batched",
    backend: str = "kernels",
    epilogue: EpilogueSpec | None = None,
    scale=None,
    shift=None,
    alpha=None,
    residual=None,
    compute_dtype=None,
    group=None,
) -> torch.Tensor:
    """General 2-D convolution with the paper's decomposition applied.

    Args:
      x: (N, H, W, Cin) input.
      w: (kh, kw, Cin, Cout) compact kernel; rectangular ``kh != kw`` for
        plain dense convs.
      stride: forward-conv stride, or upsampling factor when ``transposed``.
      dilation: dilation step ``d = D + 1`` (forward conv only).
      transposed: run a transposed (fractionally-strided) convolution.
      padding: ``None`` -> SAME for forward conv, ``(k-1)//2`` for transposed.
      output_padding: transposed-conv extra size on the high side.
      decomposed: apply the paper's decomposition (False -> the naive
        zero-laden execution, plain torch only).
      strategy: 'batched' or 'ragged' for the dilated path ('ragged' is
        torch-backend only).
      backend: 'kernels' (CUDA kernels) or 'torch' (plain ``F.conv2d``).
      epilogue: optional fused BN/PReLU/residual epilogue spec with matching
        ``scale``/``shift``/``alpha``/``residual`` operands.
      compute_dtype: mixed-precision opt-in (DESIGN.md §12): ``None`` keeps
        the input dtype; a dtype or alias (``"bf16"``, ``"fp32"``) casts
        ``x``/``w``/``residual`` to it before dispatch, and the output comes
        back in it.  The epilogue's channel operands (scale/shift/alpha)
        stay fp32.  The kernels accumulate in fp32, apply the epilogue in
        fp32 and round once; the torch backend rounds the conv output to the
        compute dtype and again after the fp32 epilogue, as the reference's
        xla path does.  fp16 raises (still to port).
      group: a ``torch.distributed`` group whose ranks split the work (see
        the module docstring); every rank passes the same operands and gets
        the whole output.  Under autograd each rank's gradients cover its
        share (:func:`repro_torch.distributed.sharding.shard_conv2d` reduces
        them).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    cd = canon_dtype(compute_dtype)
    if cd is not None:
        x, w, residual = (t if t is None or t.dtype == cd else t.to(cd)
                          for t in (x, w, residual))
    if group is not None and split_kind(
            dilation=dilation, transposed=transposed, decomposed=decomposed,
            strategy=strategy) == "rows":
        kw = dict(stride=stride, dilation=dilation, transposed=transposed,
                  padding=padding, output_padding=output_padding,
                  decomposed=decomposed, strategy=strategy, backend=backend,
                  epilogue=epilogue, scale=scale, shift=shift, alpha=alpha)
        return map_rows(lambda xs, rs: conv2d(xs, w, residual=rs, **kw),
                        x, residual, group=group)
    if backend == "kernels" and not decomposed:
        # the kernels ARE the decomposition; the naive zero-laden baseline
        # only exists as composed plain convs
        raise ValueError("naive execution has no kernel; use backend='torch'")
    spec = NO_EPILOGUE if epilogue is None else epilogue
    eps = pack_args(spec, scale=scale, shift=shift, alpha=alpha,
                    residual=residual)
    ep_kw = dict(zip(spec.slots, eps))
    kh, kw = w.shape[0], w.shape[1]
    if transposed:
        if dilation != 1:
            raise ValueError("dilated transposed convolution is not supported")
        if kh != kw:
            raise ValueError("transposed convolution requires square kernels")
        p = (kh - 1) // 2 if padding is None else padding
        if backend == "kernels":
            return transposed_conv2d(x, w, stride=stride, padding=p,
                                     output_padding=output_padding,
                                     epilogue=epilogue, **ep_kw)
        if decomposed:
            y = _tr.transposed_conv2d_decomposed(x, w, stride, p,
                                                 output_padding)
        else:
            y = _tr.transposed_conv2d_naive(x, w, stride, p, output_padding)
        return apply_reference(spec, y, eps)
    if dilation > 1:
        if kh != kw:
            raise ValueError("dilated convolution requires square kernels")
        if backend == "kernels":
            if strategy != "batched":
                raise ValueError(f"the kernel dilated path is phase-batched "
                                 f"only, got {strategy!r}")
            return dilated_conv2d(x, w, dilation, stride=stride,
                                  epilogue=epilogue, group=group, **ep_kw)
        if decomposed:
            y = _dil.dilated_conv2d_decomposed(x, w, dilation,
                                               strategy=strategy,
                                               stride=stride, group=group)
        else:
            y = _dil.dilated_conv2d_naive(x, w, dilation, stride=stride)
        return apply_reference(spec, y, eps)
    # plain dense conv (stride >= 1, rectangular kernels welcome)
    if backend == "kernels":
        return kernel_conv2d(x, w, stride=stride,
                             padding="SAME" if padding is None else padding,
                             epilogue=epilogue, **ep_kw)
    if padding is None:     # SAME, asymmetric for even extents
        pads = (((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2))
    else:
        pads = ((padding, padding), (padding, padding))
    return apply_reference(spec, nhwc.conv(x, w, stride, pads), eps)


def split_kind(*, dilation: int = 1, transposed: bool = False,
               decomposed: bool = True, strategy: str = "batched",
               **_) -> str:
    """What :func:`conv2d` with ``group=`` splits over the ranks:
    ``"phase"``, the phase-batched dilated engine's folded batch, or
    ``"rows"``, the batch rows around the whole call."""
    if (not transposed and dilation > 1 and decomposed
            and strategy == "batched"):
        return "phase"
    return "rows"


__all__ = ["conv2d", "split_kind", "BACKENDS"]
