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
(:func:`split_kind`).  ``rows=`` is the model axis of an image
(DESIGN.md §13): a group over whose ranks the image's rows split in equal
bands; ``x`` is this rank's band, and :func:`conv2d` returns this rank's
band of the output, from its rows and their halos (exchanged by
:func:`repro_torch.distributed.collectives.exchange_halos`), with the
conv's padding only on an image edge (:func:`band_split` says how a conv
splits, or why its rows stay whole).  Gradients flow through both
backends: the torch backend differentiates natively (it is the card-side oracle of the kernels'
gradients), and the kernel wrappers' ``torch.autograd.Function`` classes
re-enter the same two kernels through the adjoints of
:mod:`repro_torch.core.adjoints` (DESIGN.md §6).  ``compute_dtype`` casts to
fp32 or bf16 as the reference does (DESIGN.md §12).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import dilated as _dil
from repro_torch.core import nhwc
from repro_torch.core import transposed as _tr
from repro_torch.distributed.collectives import (exchange_halos, group_rank,
                                                 group_size, map_rows)
from repro_torch.kernels.conv2d import conv2d as kernel_conv2d
from repro_torch.kernels.conv2d import out_extent, resolve_pads
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
    rows=None,
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
      rows: a ``torch.distributed`` group over whose ranks the image's rows
        split in equal bands: ``x`` (and ``residual``) are this rank's band
        of them, and the result is this rank's band of the output
        (:func:`band_split`; a conv whose rows do not split raises).
        Under autograd the halos' gradients go back to their owners.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    cd = canon_dtype(compute_dtype)
    if cd is not None:
        x, w, residual = (t if t is None or t.dtype == cd else t.to(cd)
                          for t in (x, w, residual))
    if rows is not None and group_size(rows) > 1:
        return _band_conv(x, w, rows, group, dict(
            stride=stride, dilation=dilation, transposed=transposed,
            padding=padding, output_padding=output_padding,
            decomposed=decomposed, strategy=strategy, backend=backend),
            dict(epilogue=epilogue, scale=scale, shift=shift, alpha=alpha,
                 residual=residual))
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


@dataclass(frozen=True)
class Bands:
    """How a conv's rows split over ``ranks`` equal input bands of an
    image of ``height`` rows: rank ``r`` computes output rows
    ``out_rows[r]`` from input rows ``in_rows[r]`` (its band and the halo
    rows ``h_lo`` above and ``h_hi`` below it, at most, cut at the image's
    edges).  ``form`` is ``"dense"``, ``"dilated"`` (the phase-batched
    decomposition inside each band) or ``"tconv"``."""

    form: str
    height: int
    out_height: int
    out_rows: tuple
    in_rows: tuple
    h_lo: int
    h_hi: int

    @property
    def counts(self) -> list[int]:
        """Each rank's output rows."""
        return [o1 - o0 for o0, o1 in self.out_rows]


def band_split(x_shape: tuple, w_shape: tuple, ranks: int, *,
               stride: int = 1, dilation: int = 1, transposed: bool = False,
               padding: int | None = None, output_padding: int = 0,
               decomposed: bool = True, strategy: str = "batched", **_
               ) -> Bands | str:
    """How :func:`conv2d` with ``rows=`` over ``ranks`` bands splits a conv
    of ``x_shape`` (the whole image) by ``w_shape``: a :class:`Bands`, or
    the reason its rows stay whole (a string).

    * dense, stride ``s``, pads ``(pt, pb)``: each band must start on a
      multiple of ``s`` (``hb % s == 0``); band ``r`` owns output rows
      ``[r*hb/s, (r+1)*hb/s)`` (the last band also any past them) and
      reads ``pt`` rows above its band and ``kh - s - pt`` below;
    * dilated (the phase-batched engine, stride 1): ``d`` must divide the
      band (``hb % d == 0``) so that it folds into its own ``d*d`` phase
      blocks; the halo is ``d*(k-1)/2`` rows a side.  The strided
      (class-window) and ragged forms stay whole;
    * transposed, stride ``s``: band ``r`` owns output rows
      ``[s*r*hb, s*(r+1)*hb)`` and reads the rows its parity taps reach
      (:func:`repro_torch.core.transposed.band_inputs`).
    """
    height = x_shape[1]
    kh = w_shape[0]
    if ranks <= 1:
        return "one band"
    if height % ranks:
        return f"{height} rows do not split over {ranks} bands"
    if not decomposed:
        return "the naive zero-laden form runs whole"
    hb = height // ranks
    bands = [(r * hb, (r + 1) * hb) for r in range(ranks)]
    if transposed:
        if dilation != 1 or kh != w_shape[1]:
            return "not a transposed conv the engine runs"
        s, p_lo = stride, (kh - 1) // 2 if padding is None else padding
        p_hi = p_lo + output_padding
        if s == 1:
            pads = ((p_lo, p_hi), (p_lo, p_hi))
            return _dense_bands(height, kh, 1, pads, bands)
        oh = _tr.out_size(height, s, kh, p_lo, p_hi)
        outs = [(s * r0, s * r1) for r0, r1 in bands]
        outs[-1] = (outs[-1][0], oh)
        if outs[-1][0] >= oh:
            return f"the last band has no output rows ({oh} in all)"
        ins = [_tr.band_inputs(o0, o1, height, kh, s, p_lo, p_hi)
               for o0, o1 in outs]
        return _bands("tconv", height, oh, outs, ins, bands)
    if dilation > 1:
        if strategy != "batched":
            return f"the {strategy} dilated form runs whole"
        if stride != 1:
            return "a strided dilated conv (class windows) runs whole"
        if hb % dilation:
            return f"d = {dilation} does not divide the {hb}-row band"
        ins = [_dil.band_inputs(r0, r1, height, kh, dilation)
               for r0, r1 in bands]
        return _bands("dilated", height, height, bands, ins, bands)
    pads = resolve_pads("SAME" if padding is None else padding, kh,
                        w_shape[1])
    return _dense_bands(height, kh, stride, pads, bands)


def _dense_bands(height, kh, s, pads, bands):
    if (bands[1][0]) % s:
        return f"stride {s} does not divide the {bands[1][0]}-row band"
    (pt, pb), _ = pads
    oh = out_extent(height, kh, s, pt, pb)
    outs = [(r0 // s, r1 // s) for r0, r1 in bands]
    outs[-1] = (outs[-1][0], oh)
    if outs[-1][0] >= oh or any(o1 > oh for _, o1 in outs):
        return f"the bands' output rows do not cover {oh} rows"
    ins = [(max(0, s * o0 - pt), min(height, s * (o1 - 1) - pt + kh))
           for o0, o1 in outs]
    return _bands("dense", height, oh, outs, ins, bands)


def _bands(form, height, oh, outs, ins, bands):
    return Bands(form, height, oh, tuple(outs), tuple(ins),
                 max(r0 - i0 for (r0, _), (i0, _) in zip(bands, ins)),
                 max(0, max(i1 - r1 for (_, r1), (_, i1) in zip(bands, ins))))


def _band_conv(x, w, rows, group, kw: dict, ep: dict) -> torch.Tensor:
    """This rank's output band (:func:`conv2d` with ``rows=``)."""
    ranks = group_size(rows)
    whole = (x.shape[0], x.shape[1] * ranks, *x.shape[2:])
    bands = band_split(whole, tuple(w.shape), ranks, **kw)
    if isinstance(bands, str):
        raise ValueError(f"conv2d(rows=): {bands}")
    res = ep.pop("residual")
    if group is not None and split_kind(**kw) == "rows":
        # the batch rows over the data axes first, as the unbanded call:
        # the ranks of a band group hold one share, and exchange its rows
        return map_rows(lambda xs, rs: _banded(
            xs, w, rows, bands, None, kw, dict(ep, residual=rs)),
            x, res, group=group)
    return _banded(x, w, rows, bands, group, kw, dict(ep, residual=res))


def _banded(x, w, rows, bands, group, kw, ep):
    """The band's input rows (its own and the halos it receives), then
    its conv."""
    r, hb = group_rank(rows), x.shape[1]
    i0, i1 = bands.in_rows[r]
    ext, n_lo, _ = exchange_halos(x, bands.h_lo, bands.h_hi, rows)
    start = r * hb - n_lo                # image row of ext's first row
    return _band_form(ext[:, i0 - start:i1 - start], w, bands, r, group,
                      kw, ep)


def _band_form(xl, w, bands, r, group, kw, ep):
    """One band's conv on its input rows ``xl``, on the kernels (each
    launch taking the whole image's plan) or on plain torch ops."""
    from repro_torch.kernels import autotune

    (o0, o1), (i0, i1) = bands.out_rows[r], bands.in_rows[r]
    kh, k_w = w.shape[0], w.shape[1]
    backend, spec = kw["backend"], ep["epilogue"] or NO_EPILOGUE
    eps = pack_args(spec, scale=ep["scale"], shift=ep["shift"],
                    alpha=ep["alpha"], residual=ep["residual"])
    ep_kw = dict(zip(spec.slots, eps))
    height, tail = bands.height, tuple(xl.shape[2:])
    if bands.form == "tconv":
        # the same transposed conv over the band's input rows: its output
        # row j is the image's row j + s*i0; the rows past the band's are
        # cropped, and the epilogue (per element) is fused as unbanded
        s = kw["stride"]
        p_lo = (kh - 1) // 2 if kw["padding"] is None else kw["padding"]
        op = kw["output_padding"]
        lo, n = o0 - s * i0, o1 - o0
        if backend == "torch":
            y = _tr.transposed_conv2d_decomposed(xl, w, s, p_lo, op)
            return apply_reference(spec, y[:, lo:lo + n], eps)
        res = ep_kw.get("residual")
        if res is not None:
            full = res.new_zeros((res.shape[0], _tr.out_size(
                i1 - i0, s, kh, p_lo, p_lo + op), *res.shape[2:]))
            full[:, lo:lo + n] = res
            ep_kw["residual"] = full
        with autotune.whole_image_plans("tconv", xl.shape[1:], p_lo,
                                        (height, *tail), p_lo):
            y = transposed_conv2d(xl, w, stride=s, padding=p_lo,
                                  output_padding=op, epilogue=None if
                                  spec.empty else spec, **ep_kw)
        return y[:, lo:lo + n]
    if bands.form == "dilated":
        d = kw["dilation"]
        p = _dil.same_pad(kh)
        whole_pads = ((p, p), (p, p))
        wp = -(-tail[0] // d)
        res = ep_kw.pop("residual", None)
        res_b = None if res is None else _dil._phase_to_batch(res, d)[0]

        def phase_conv(xb, pads):
            def conv(xs, rs):
                kw_ = ep_kw if rs is None else {**ep_kw, "residual": rs}
                if backend == "kernels":
                    with autotune.whole_image_plans(
                            "dense", xs.shape[1:], pads,
                            (height // d, wp, tail[-1]), whole_pads):
                        return kernel_conv2d(
                            xs, w, padding=pads, epilogue=None if
                            spec.empty else spec, **kw_)
                y = nhwc.conv(xs, w, 1, pads)
                return apply_reference(spec, y, pack_args(
                    spec, scale=ep["scale"], shift=ep["shift"],
                    alpha=ep["alpha"], residual=rs))
            return map_rows(conv, xb, res_b, group=group)

        return _dil.dilated_band(xl, w, d, o0, o1, i0, i1, phase_conv)
    s = kw["stride"]
    if kw["transposed"]:             # stride 1: a plain padded conv
        p_lo = (kh - 1) // 2 if kw["padding"] is None else kw["padding"]
        p_hi = p_lo + kw["output_padding"]
        whole_pads = ((p_lo, p_hi), (p_lo, p_hi))
    else:
        whole_pads = resolve_pads("SAME" if kw["padding"] is None
                                  else kw["padding"], kh, k_w)
    (pt, pb), (pl, pr) = whole_pads
    pads = ((max(0, pt - s * o0), max(0, s * (o1 - 1) - pt + kh - height)),
            (pl, pr))
    if backend == "kernels":
        with autotune.whole_image_plans("dense", xl.shape[1:], pads,
                                        (height, *tail), whole_pads):
            return kernel_conv2d(xl, w, stride=s, padding=pads,
                                 epilogue=None if spec.empty else spec,
                                 **ep_kw)
    return apply_reference(spec, nhwc.conv(xl, w, s, pads), eps)


__all__ = ["conv2d", "split_kind", "band_split", "Bands", "BACKENDS"]
