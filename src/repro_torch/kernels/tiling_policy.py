"""Analytic launch-plan policy for the port's two conv kernels on Hopper.

The Hopper counterpart of ``repro.kernels.tiling_policy``.  The autotuner
(:mod:`repro_torch.kernels.autotune`) could time every plan of a geometry;
this module scores the plans from the kernels' own arithmetic instead, so
only the top few (plus the shape's default plan) are timed.  A candidate is
a :class:`~repro_torch.kernels.conv2d.ConvPlan`: a Cout tile of
``conv2d.TILES`` and resident or streamed weights (the copy width ``vec``
follows the operand's address at launch and is not tuned).

The reference's model does not transfer: it budgets a TPU core's VMEM and
scores the 128-lane MXU's occupancy.  Here:

* **Footprint** — the dynamic shared memory the launch asks for, mirrored
  byte for byte from the kernels: ``ConvSmem::of`` (``csrc/igemm.cuh``) for
  kernel 1 (a ring of ``min(nk, kStages)`` stages, the resident or ringed
  weight slab, the residual tile, the pixel table, the epilogue's channel
  vectors) and ``TconvSmem::of`` with ``plan_tconv_geo``
  (``csrc/transposed_conv.cu``) for kernel 2 (the input tile with its halo,
  the weight buffer, the interleaved output tile, the channel vectors).  A
  plan the kernel refuses (dense tile 4, which ``conv2d.cu`` does not
  build; a resident transposed plan whose taps do not fit) has no
  footprint, and a plan over the card's per-block opt-in limit cannot
  launch: both score ``inf``.  ``chip_smoke.py`` phase 24a holds
  :func:`footprint_bytes` to the sizes the kernels export
  (``conv2d_smem_bytes``, ``tconv_smem_bytes``).
* **Occupancy** — two terms in place of the MXU's: *wave quantisation*
  (the grid's blocks against the SMs times the blocks an SM holds at once,
  limited by shared memory and threads) and *tile waste* (idle pixel slots
  of the last block row and idle Cout lanes of the last Cout tile).
* **Register-tile feed** — a thread's 4-deep K slice costs ``TM + TN``
  float4 shared reads for ``4 TM TN`` FMAs (``csrc/igemm.cuh``), so a
  small register tile starves the FMAs on shared-memory reads: the feed is
  ``TM TN / (TM + TN)`` relative to the 8 x 8 tile's.
* **Per-block cost** — the reference's calibrated weight
  (:func:`_cell_weight`, unchanged) per wave of blocks.

``score = 1 / (tile_use * wave_efficiency * feed) + cell_w * waves``
(lower is better).  :func:`top_candidates` keeps the top ``k`` plus the default plan
and falls back to the whole grid when the geometry cannot be scored or
``$REPRO_TORCH_AUTOTUNE_SWEEP`` forces the sweep.  The SM count and limits
come from the card (:func:`card_of`); CPU tests pass :data:`H100`.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import transposed_conv as ktr

_KINDS = ("dense", "tconv")

#: elements per staged pixel of a stage (``kAStride``) and of a transposed
#: conv's input tile (``kChunkStride``), by element size: whole 16-byte
#: quads, an odd number of them
_ASTRIDE = {4: kconv.K_STEP + 4, 2: kconv.K_STEP + 8}
_CHUNK_STRIDE = {4: ktr.CHUNK + 4, 2: ktr.CHUNK + 8}
#: depth of kernel 1's ring (``kStages``)
_STAGES = 4
#: shared memory the card reserves per resident block
_SMEM_RESERVED_PER_BLOCK = 1024


class Card(NamedTuple):
    """What bounds the blocks an SM holds: its SM count and limits."""

    sms: int
    smem_per_sm: int        # bytes of shared memory an SM gives blocks
    smem_optin: int         # bytes one block may opt in to
    threads_per_sm: int
    blocks_per_sm: int


#: the H100 SXM (NVIDIA's data sheet; the hopper-kernels table): 132 SMs,
#: 228 KB of shared memory an SM, 227 KB a block
H100 = Card(sms=132, smem_per_sm=233472, smem_optin=232448,
            threads_per_sm=2048, blocks_per_sm=32)


def card_of(device=None) -> Card:
    """The :class:`Card` of a CUDA device, from its properties (the 32
    resident blocks an SM takes are Hopper's; PyTorch does not report
    them)."""
    p = torch.cuda.get_device_properties(device)
    return Card(sms=p.multi_processor_count,
                smem_per_sm=p.shared_memory_per_multiprocessor,
                smem_optin=p.shared_memory_per_block_optin,
                threads_per_sm=p.max_threads_per_multi_processor,
                blocks_per_sm=H100.blocks_per_sm)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _tile(plan: kconv.ConvPlan):
    """(BN, TN, TY, TM, KS, BM, threads, CS) of a plan's tile."""
    bn, tn, ty, tm, ks = kconv.TILES[plan.tile]
    cs = bn if (bn // 4) % 2 else bn + 4
    return bn, tn, ty, tm, ks, ty * tm, (bn // tn) * ty * ks, cs


def builds(kind: str, tile: int) -> bool:
    """Whether the kernel of ``kind`` builds an instance of ``tile``: the
    dense kernel every tile but the one-group 32-wide one, the transposed
    kernel the one-group tiles of 4-wide register tiles up to 32 couts."""
    bn, tn, _, _, ks = kconv.TILES[tile]
    if kind == "dense":
        return not (bn == 32 and ks == 1)
    return tn == 4 and ks == 1 and bn <= 32


class Geometry(NamedTuple):
    """One launch of a conv kernel, as the plan sees it."""

    kind: str
    n: int
    h: int
    w: int
    cin: int
    cout: int
    kh: int
    kw: int
    stride: int
    pads: tuple             # dense ((top, bottom), (left, right)); tconv
    #                         (p_lo, p_hi)
    oh: int
    ow: int
    residual: bool

    @property
    def k_rows(self) -> int:
        return self.kh * self.kw * self.cin


def geometry(kind: str, x_shape, w_shape, *, stride: int = 1, padding=None,
             output_padding: int | None = None, epilogue=None) -> Geometry:
    """The launch of ``kind`` (``"dense"``: kernel 1, ``"tconv"``: kernel 2
    at stride >= 2) on these shapes.  Dense ``padding`` is the wrapper's
    (``None`` is ``"SAME"``); a transposed conv's is ``p_lo`` (``None`` is
    ``(k-1)//2``) with ``p_hi = p_lo + output_padding`` (``None`` is 1)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; known: {_KINDS}")
    n, h, w_in, cin = x_shape
    kh, kw, _, cout = w_shape
    residual = epilogue is not None and epilogue.residual != "none"
    if kind == "dense":
        pads = kconv.resolve_pads("SAME" if padding is None else padding,
                                  kh, kw)
        (pt, pb), (pl, pr) = pads
        oh = kconv.out_extent(h, kh, stride, pt, pb)
        ow = kconv.out_extent(w_in, kw, stride, pl, pr)
    else:
        if kh != kw or stride < 2:
            raise ValueError(f"kernel 2 takes square kernels at stride >= 2, "
                             f"got {kh}x{kw} stride {stride}")
        p_lo = (kh - 1) // 2 if padding is None else padding
        p_hi = p_lo + (1 if output_padding is None else output_padding)
        pads = (p_lo, p_hi)
        oh = (h - 1) * stride + p_lo + p_hi - kh + 2
        ow = (w_in - 1) * stride + p_lo + p_hi - kw + 2
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty output {oh}x{ow}")
    return Geometry(kind, n, h, w_in, cin, cout, kh, kw, stride, pads, oh,
                    ow, residual)


def _tconv_blocks(g: Geometry, plan: kconv.ConvPlan):
    """``plan_tconv_geo``: (tbh, tbw, tiles_h, tiles_w, wtaps, span), or
    None for a resident plan whose k*k taps of a chunk do not fit."""
    bn, _, _, _, _, bm, _, _ = _tile(plan)
    k, s = g.kh, g.stride
    tap_bytes = ktr.CHUNK * bn * plan.dtype.itemsize
    if plan.resident and k * k * tap_bytes > kconv.RESIDENT_BYTES:
        return None
    wtaps = k * k if plan.resident else min(k * k, kconv.RESIDENT_BYTES
                                            // tap_bytes)
    hb, wb = -(-g.oh // s), -(-g.ow // s)
    cap = max(1, 4 * bm // (s * s))
    tbw = min(16, wb, cap)
    tbh = max(1, min(hb, min(bm, cap) // tbw))
    offs = [o for taps in ktr.parity_schedule(k, s, g.pads[0])
            for _, o in taps]
    span = max(offs) - min(offs) if offs else 0
    return tbh, tbw, -(-hb // tbh), -(-wb // tbw), wtaps, span


def footprint_bytes(kind: str, x_shape, w_shape, plan: kconv.ConvPlan, *,
                    stride: int = 1, padding=None,
                    output_padding: int | None = None,
                    epilogue=None) -> int | None:
    """Dynamic shared memory (bytes) that ``plan`` asks for on this launch,
    or None for a plan the kernel refuses.  Kernel 1 mirrors
    ``ConvSmem::of``, kernel 2 ``plan_tconv_geo`` and ``TconvSmem::of``."""
    g = geometry(kind, x_shape, w_shape, stride=stride, padding=padding,
                 output_padding=output_padding, epilogue=epilogue)
    return _footprint(g, plan)


def _footprint(g: Geometry, plan: kconv.ConvPlan) -> int | None:
    if not builds(g.kind, plan.tile):
        return None
    es = plan.dtype.itemsize
    bn, _, _, _, _, bm, _, cs = _tile(plan)
    if g.kind == "dense":
        nk = -(-g.k_rows // kconv.K_STEP)
        slots = min(nk, _STAGES)
        ring = slots * bm * _ASTRIDE[es] * es
        b = _align16(max(ring, bm * cs * 4))
        r = b + _align16((nk if plan.resident else slots) * kconv.K_STEP
                         * bn * es)
        pix = r + (_align16(bm * cs * es) if g.residual else 0)
        return pix + 16 * bm + 3 * bn * 4
    blocks = _tconv_blocks(g, plan)
    if blocks is None:
        return None
    tbh, tbw, _, _, wtaps, span = blocks
    s = g.stride
    ws = _align16((tbh + span) * (tbw + span) * _CHUNK_STRIDE[es] * es)
    ot = ws + _align16(wtaps * ktr.CHUNK * bn * es)
    return ot + s * tbh * s * tbw * cs * 4 + 3 * bn * 4


def _grid(g: Geometry, plan: kconv.ConvPlan):
    """(blocks, threads a block, pixel-slot share in use, Cout-lane share
    in use) of a plan's launch."""
    bn, _, _, _, _, bm, threads, _ = _tile(plan)
    ctiles = -(-g.cout // bn)
    lanes = g.cout / (ctiles * bn)
    if g.kind == "dense":
        m = g.n * g.oh * g.ow
        mtiles = -(-m // bm)
        return mtiles * ctiles, threads, m / (mtiles * bm), lanes
    tbh, tbw, tiles_h, tiles_w, _, _ = _tconv_blocks(g, plan)
    s = g.stride
    hb, wb = -(-g.oh // s), -(-g.ow // s)
    used = (hb * wb) / (tiles_h * tbh * tiles_w * tbw)
    return g.n * tiles_h * tiles_w * ctiles, threads, used, lanes


def feed(plan: kconv.ConvPlan) -> float:
    """FMAs per shared-memory read of the plan's register tile, relative to
    the 8 x 8 tile's: ``TM TN / (TM + TN) / 4``."""
    _, tn, _, tm, _ = kconv.TILES[plan.tile]
    return tm * tn / (tm + tn) / 4.0


def blocks_per_sm(smem: int, threads: int, card: Card = H100) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes an SM holds."""
    by_smem = card.smem_per_sm // (smem + _SMEM_RESERVED_PER_BLOCK)
    return max(0, min(card.blocks_per_sm, card.threads_per_sm // threads,
                      by_smem))


def occupancy(kind: str, x_shape, w_shape, plan: kconv.ConvPlan, *,
              stride: int = 1, padding=None,
              output_padding: int | None = None, epilogue=None,
              card: Card = H100) -> tuple[float, float]:
    """(wave efficiency, tile use) of a plan: the grid's blocks over the
    block slots of the waves it takes, and the share of pixel slots and
    Cout lanes doing real work.  Both are 0 for a plan that cannot run."""
    g = geometry(kind, x_shape, w_shape, stride=stride, padding=padding,
                 output_padding=output_padding, epilogue=epilogue)
    return _occupancy(g, plan, card)[:2]


def _occupancy(g: Geometry, plan: kconv.ConvPlan, card: Card):
    """(wave efficiency, tile use, waves)."""
    smem = _footprint(g, plan)
    if smem is None or smem > card.smem_optin:
        return 0.0, 0.0, math.inf
    blocks, threads, pixels, lanes = _grid(g, plan)
    per_sm = blocks_per_sm(smem, threads, card)
    if per_sm < 1:
        return 0.0, 0.0, math.inf
    slots = card.sms * per_sm
    waves = -(-blocks // slots)
    return blocks / (waves * slots), pixels * lanes, waves


def _cell_weight(kind: str, backend: str, base_cycles, calibration,
                 dtype) -> float:
    """Per-grid-cell overhead weight; calibrated when a fit is available."""
    cell_w = 1e-3
    if calibration is not None and base_cycles:
        from repro_torch.core.calibrate import key_of

        co = calibration.coeffs.get(
            key_of(kind, backend, dtype=str(dtype).removeprefix("torch.")))
        if co is None:      # fall back to the fp32 fit of the same engine
            co = calibration.coeffs.get(key_of(kind, backend))
        if co is not None and co.a_us_per_cycle > 0:
            compute_us = co.a_us_per_cycle * base_cycles
            if compute_us > 0:
                cell_w = co.b_us / compute_us
    return cell_w


def rank(kind: str, x_shape, w_shape, cands, *, stride: int = 1,
         padding=None, output_padding: int | None = None,
         dtype=torch.float32, epilogue=None, backend: str = "kernels",
         base_cycles: float | None = None, calibration=None,
         card: Card = H100) -> list[tuple[float, kconv.ConvPlan]]:
    """Score every candidate plan; ``(score, plan)`` ascending.

    ``score = 1 / (tile_use * wave_efficiency * feed) + cell_w * waves``,
    ``inf`` for a plan the kernel refuses or whose footprint exceeds the
    card's opt-in limit.  Ties keep candidate order (the sweep's determinism rule).
    """
    g = geometry(kind, x_shape, w_shape, stride=stride, padding=padding,
                 output_padding=output_padding, epilogue=epilogue)
    cell_w = _cell_weight(kind, backend, base_cycles, calibration, dtype)
    scored = []
    for i, plan in enumerate(cands):
        wave, use, waves = _occupancy(g, plan, card)
        score = (1.0 / (use * wave * feed(plan)) + cell_w * waves
                 if wave > 0 else math.inf)
        scored.append((score, i, plan))
    scored.sort(key=lambda t: (t[0], t[1]))
    return [(s, p) for s, _, p in scored]


def sweep_forced() -> bool:
    """``$REPRO_TORCH_AUTOTUNE_SWEEP=1`` disables the policy (every
    candidate is timed)."""
    return os.environ.get("REPRO_TORCH_AUTOTUNE_SWEEP", "").lower() in (
        "1", "true", "on")


def top_candidates(kind: str, x_shape, w_shape, cands, *, top: int = 3,
                   default_plan: kconv.ConvPlan | None = None,
                   **rank_kw) -> list[kconv.ConvPlan]:
    """The candidates worth timing: the top ``top`` finite scores plus
    ``default_plan``, in candidate order.

    Returns the whole list (the exhaustive sweep) when the sweep is forced
    through the environment, the geometry cannot be scored, or no plan
    scores finite — never a smaller search than the default plan alone.
    """
    if sweep_forced():
        return list(cands)
    try:
        ranked = rank(kind, x_shape, w_shape, cands, **rank_kw)
    except (ValueError, ZeroDivisionError):
        return list(cands)      # unmodelable geometry: fall back to the sweep
    keep = [p for s, p in ranked[:top] if math.isfinite(s)]
    if not keep:
        return list(cands)
    if default_plan is not None and default_plan in cands \
            and default_plan not in keep:
        keep.append(default_plan)
    return [p for p in cands if p in keep]


__all__ = ["Card", "H100", "card_of", "Geometry", "geometry", "builds",
           "footprint_bytes", "occupancy", "feed", "blocks_per_sm", "rank",
           "top_candidates", "sweep_forced"]
