"""Cycle-accurate model of the paper's accelerator (VWA [16] + decomposition),
the port's copy of ``repro.core.cycle_model``.

It models the paper's 168-MAC array at 500 MHz, not the H100: none of its
cycles, milliseconds or images/s is a time of the card.  The port's
:mod:`repro_torch.core.calibrate` maps its cycles onto times measured on
the card.

Array: ``B`` PE blocks, each an ``n x 3`` MAC array — 168 MACs total at
500 MHz (Table I: 168 GOPS peak).  We use ``(n, B) = (7, 8)``: ``B`` must
divide ENet's power-of-two channel counts for the near-ideal dilated
efficiencies the paper reports, and ``n = 7`` reproduces the ~9 %-vs-8 %
general-convolution overhead of Fig. 10.

Modeled execution (assumptions documented inline; see DESIGN.md §2):

* ideal dense   = all MACs incl. zeros, no array constraints (paper's Fig. 10
                  baseline) -> cycles = MACs / 168.
* ideal sparse  = in-bounds nonzero MACs only -> cycles = MACs / 168.
* our work:
  - general convolutions: output columns scheduled per weight column; the
    column vector packs ``kh`` taps x ``cin`` channels in groups of 3; output
    rows tiled by ``n`` (ceil) — the utilization gap the paper reports
    ("utilization of our work is not full in the general convolutions").
  - decomposed dilated: phase blocks of a column class stream back-to-back
    (Fig. 8), so no row-tiling loss; left/right boundary columns use 2 of 3
    weight columns (the paper's boundary trick); top/bottom pad rows issue a
    full 3-tap column with one wasted tap — the only loss, growing with D
    exactly as the paper's 83–98 % efficiency band.
  - decomposed transposed: all ``k**2`` sub-kernel taps are assigned across
    the ``3*B`` weight ports and share the input broadcast (Fig. 9), packing
    ``k*k x cin`` tap-channel pairs in groups of ``3*B``; rows tiled by ``n``
    on the *input* ("marginal loss due to the tiled input", Fig. 12).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.enet_spec import ConvLayer

MACS_PER_CYCLE = 168
FREQ_HZ = 500e6
N_ROWS = 7     # n: MAC rows per PE block
N_BLOCKS = 8   # B: PE blocks (7 * 3 * 8 = 168 MACs)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _dilated_eff_k(l: ConvLayer) -> int:
    """Zero-inserted kernel footprint ``d*(k-1)+1`` (``2D+3`` for k=3)."""
    return (l.D + 1) * (l.kh - 1) + 1


def tconv_pads(l: ConvLayer) -> tuple[int, int]:
    """Resolve a transposed layer's ``(p_lo, p_hi)`` zero-insert pads.

    ``padding=None`` means the framework default ``(k-1)//2`` (every
    ENet/ESPNet layer); generative decoders record explicit pads — DCGAN's
    k=4/s=2 chains use ``p_lo=2`` with ``output_padding=0`` (the PyTorch
    ``ConvTranspose2d(k=4, s=2, p=1)`` geometry), U-Net's k=2/s=2 upsample
    ``p_lo=1`` — so the costing must not assume ``(k-1)//2``.

    Square kernels only, like the executable engine (``decompose.conv2d``
    rejects ``kh != kw`` transposed convs): a single ``p_lo`` cannot
    describe a rectangular kernel's per-dimension pads.
    """
    if l.kh != l.kw:
        raise ValueError(
            f"transposed layers are square-kernel only, got {l.kh}x{l.kw}")
    p_lo = (l.kh - 1) // 2 if l.padding is None else l.padding
    return p_lo, p_lo + l.output_padding


def tconv_input_size(l: ConvLayer) -> tuple[int, int]:
    """Invert the transposed output-size relation to the input extent.

    ``oh = (h_in - 1)*s + p_lo + p_hi - k + 2`` with ``(p_lo, p_hi)`` from
    :func:`tconv_pads` — the general (k, s, padding) form; reduces to
    ``h_out // s`` for the ENet case (k=3, s=2, output_padding=1) and for
    DCGAN's (k=4, s=2, p_lo=2, output_padding=0).
    """
    s = l.stride
    p_lo, p_hi = tconv_pads(l)

    def inv(out: int, k: int) -> int:
        return (out - p_lo - p_hi + k - 2) // s + 1

    return inv(l.h_out, l.kh), inv(l.w_out, l.kw)


# ---------------------------------------------------------------------------
# MAC counts (architecture-independent)
# ---------------------------------------------------------------------------

def ideal_dense_macs(l: ConvLayer) -> int:
    """All MACs including zero operands (paper's Fig. 10 baseline)."""
    if l.kind == "dilated":
        ke = _dilated_eff_k(l)
        return l.h_out * l.w_out * l.cin * l.cout * ke * ke
    # dense conv and transposed-over-zero-inserted-input both issue kh*kw
    # taps per output pixel.
    return l.h_out * l.w_out * l.cin * l.cout * l.kh * l.kw


def _dilated_live_taps_dim(in_len: int, out_len: int, d: int, s: int,
                           p: int, k: int) -> int:
    """Exact in-bounds tap count along one dim via the output-class schedule
    (the same one the engine executes — see repro_torch.core.dilated)."""
    from repro_torch.core.dilated import stride_class_schedule

    _, sb, sched = stride_class_schedule(d, s, p, out_len)
    total = 0
    for r, m0, n_out in sched:
        blk = _ceil(max(in_len - r, 0), d)
        for u in range(n_out):
            total += sum(1 for t in range(k) if 0 <= m0 + sb * u + t < blk)
    return total


def ideal_sparse_macs(l: ConvLayer) -> int:
    """Nonzero AND in-bounds MACs only (paper's ideal sparse)."""
    if l.kind == "dilated":
        d, k = l.D + 1, l.kh
        if l.stride == 1:
            # sum over phase blocks of SAME-conv in-bounds taps:
            # sum_i (k*Hb_i - (k-1)) = k*H - (k-1)*d  (separable in H and W)
            return ((k * l.h_out - (k - 1) * d) * (k * l.w_out - (k - 1) * d)
                    * l.cin * l.cout)
        # strided: exact count over the output-class schedule; input extent
        # is s*h_out (SAME output = ceil(H/s); we model the divisible case).
        s = l.stride
        p = (d * (k - 1)) // 2
        live_r = _dilated_live_taps_dim(s * l.h_out, l.h_out, d, s, p, k)
        live_c = _dilated_live_taps_dim(s * l.w_out, l.w_out, d, s, p, l.kw)
        return live_r * live_c * l.cin * l.cout
    if l.kind == "transposed":
        s = l.stride
        h_in, w_in = tconv_input_size(l)
        p_lo, _ = tconv_pads(l)
        total = 0
        for ry in range(s):
            # parities with no live tap (possible when k < s) are identically
            # zero conv planes: they contribute no MACs at all
            taps_r = [t for t in range(l.kh) if (t - p_lo + ry) % s == 0]
            n_y = len(range(ry, l.h_out, s))
            live_r = sum(
                1
                for b in range(n_y)
                for t in taps_r
                if 0 <= b + (ry + t - p_lo) // s < h_in
            )
            for rx in range(s):
                taps_c = [t for t in range(l.kw) if (t - p_lo + rx) % s == 0]
                n_x = len(range(rx, l.w_out, s))
                live_c = sum(
                    1
                    for b in range(n_x)
                    for t in taps_c
                    if 0 <= b + (rx + t - p_lo) // s < w_in
                )
                total += live_r * live_c
        return total * l.cin * l.cout
    # dense conv: in-bounds taps of a SAME/strided conv — the paper counts
    # "all MACs needed in the convolution"; boundary deficit is negligible
    # and general convs are never compared against ideal sparse.
    return l.h_out * l.w_out * l.cin * l.cout * l.kh * l.kw


# ---------------------------------------------------------------------------
# Cycle counts on the modeled array
# ---------------------------------------------------------------------------

def cycles_ideal_dense(l: ConvLayer) -> float:
    return ideal_dense_macs(l) / MACS_PER_CYCLE


def cycles_ideal_sparse(l: ConvLayer) -> float:
    return ideal_sparse_macs(l) / MACS_PER_CYCLE


def cycles_our_general(l: ConvLayer, n: int = N_ROWS, b: int = N_BLOCKS) -> int:
    """Dense convolution on the array (naive path for any layer kind)."""
    if l.kind == "dilated":
        kh = kw = _dilated_eff_k(l)
        h_out, w_out = l.h_out, l.w_out
    elif l.kind == "transposed":
        kh, kw = l.kh, l.kw
        h_out, w_out = l.h_out, l.w_out  # dense over the zero-inserted input
    else:
        kh, kw = l.kh, l.kw
        h_out, w_out = l.h_out, l.w_out
    col_cycles = kw * _ceil(kh * l.cin, 3)
    return _ceil(h_out, n) * w_out * _ceil(l.cout, b) * col_cycles


def cycles_our_decomposed(l: ConvLayer, n: int = N_ROWS, b: int = N_BLOCKS) -> int:
    """Decomposed execution (the paper's method) of a layer on the array."""
    if l.kind == "dilated":
        d, s, k = l.D + 1, l.stride, l.kw
        # Column classes j (q = d/gcd(s,d) of them, q = d when s = 1): each
        # has ceil((W-j)/q) output columns; boundary columns drop (k-1) of
        # the k weight columns across the class -> sum_j (k*Wb_j - (k-1))
        # column-ops (= 3W - 2d for the paper's k=3, s=1 case).  Phase
        # blocks stream, so rows cost H/n tiles amortized (ceil once per
        # layer); each weight-column op packs kh taps x cin channels in
        # groups of 3.
        q = d // math.gcd(s, d)
        col_ops = sum(k * len(range(j, l.w_out, q)) - (k - 1) for j in range(q))
        row_tiles = l.h_out / n  # streamed: quantization amortized per layer
        return math.ceil(
            row_tiles * col_ops * _ceil(l.kh * l.cin, 3) * _ceil(l.cout, b))
    if l.kind == "transposed":
        h_in, w_in = tconv_input_size(l)
        taps = l.kh * l.kw
        # all sub-kernel taps x cin x cout packed across the 3*B weight
        # ports, sharing the input column broadcast (Fig. 9); input rows tile
        # by n ("marginal loss due to the tiled input").
        port_cycles = _ceil(taps * l.cin * l.cout, 3 * b)
        return _ceil(h_in, n) * w_in * port_cycles
    return cycles_our_general(l, n, b)


# ---------------------------------------------------------------------------
# Aggregation (drives Figs. 10/11/12 + Table I benchmarks)
# ---------------------------------------------------------------------------

@dataclass
class GroupStats:
    macs_dense: int = 0
    macs_sparse: int = 0
    cycles_dense: float = 0.0
    cycles_sparse: float = 0.0
    cycles_ours: float = 0.0


def summarize(layers: list[ConvLayer]) -> dict[str, GroupStats]:
    groups: dict[str, GroupStats] = {
        "general": GroupStats(), "dilated": GroupStats(),
        "transposed": GroupStats(), "total": GroupStats(),
    }
    for l in layers:
        g = groups[l.group]
        md, ms = ideal_dense_macs(l), ideal_sparse_macs(l)
        ours = cycles_our_decomposed(l)
        for tgt in (g, groups["total"]):
            tgt.macs_dense += md
            tgt.macs_sparse += ms
            tgt.cycles_dense += md / MACS_PER_CYCLE
            tgt.cycles_sparse += ms / MACS_PER_CYCLE
            tgt.cycles_ours += ours
    return groups


def _group_speedup(gs: GroupStats) -> float:
    """Dense/ours cycle ratio of one layer group; 1.0 for an absent group.

    Generative workloads are not full-mix: DCGAN has no dilated layers at
    all, so the per-group ratios must not divide by an empty group's zero
    cycle count.
    """
    return gs.cycles_dense / gs.cycles_ours if gs.cycles_ours else 1.0


#: neutral report for an empty (or zero-cycle) layer list: no work means no
#: speedup claim — ratios are 1.0, shares/cycles/throughput are 0.  Guarded
#: here rather than at call sites so ``serve_report``/``training_report`` and
#: ad-hoc callers (e.g. admission control on a not-yet-populated lane) never
#: trip a ``ZeroDivisionError``.
_EMPTY_REPORT = {
    "total_macs_dense": 0, "ideal_dense_cycles": 0.0, "our_cycles": 0.0,
    "overall_speedup": 1.0, "cycle_reduction_pct": 0.0, "naive_cycles": 0.0,
    "speedup_vs_naive": 1.0, "cycle_reduction_vs_naive_pct": 0.0,
    "share_dilated_pct": 0.0, "share_transposed_pct": 0.0,
    "share_general_pct": 0.0, "ours_dilated_pct": 0.0,
    "ours_transposed_pct": 0.0, "ours_general_pct": 0.0,
    "dilated_speedup": 1.0, "transposed_speedup": 1.0,
    "peak_gops": MACS_PER_CYCLE * 2 * FREQ_HZ / 1e9, "effective_gops": 0.0,
}


def report(layers: list[ConvLayer]) -> dict[str, float]:
    """The paper's headline numbers, computed from the model."""
    g = summarize(layers)
    tot = g["total"]
    if not tot.cycles_dense or not tot.cycles_ours:
        return dict(_EMPTY_REPORT)
    naive = float(sum(cycles_our_general(l) for l in layers))
    out = {
        "total_macs_dense": tot.macs_dense,
        "ideal_dense_cycles": tot.cycles_dense,
        "our_cycles": tot.cycles_ours,
        "overall_speedup": tot.cycles_dense / tot.cycles_ours,
        "cycle_reduction_pct": 100.0 * (1 - tot.cycles_ours / tot.cycles_dense),
        # the same array running the zero-laden dense schedule (utilization
        # losses included) — "a naive execution" in the abstract's sense
        "naive_cycles": naive,
        "speedup_vs_naive": naive / tot.cycles_ours,
        "cycle_reduction_vs_naive_pct": 100.0 * (1 - tot.cycles_ours / naive),
        # shares of the ideal-dense baseline (paper: 85 / 7 / 8)
        "share_dilated_pct": 100.0 * g["dilated"].cycles_dense / tot.cycles_dense,
        "share_transposed_pct": 100.0 * g["transposed"].cycles_dense / tot.cycles_dense,
        "share_general_pct": 100.0 * g["general"].cycles_dense / tot.cycles_dense,
        # our-work shares of the same baseline (paper: 2 / 2 / 9)
        "ours_dilated_pct": 100.0 * g["dilated"].cycles_ours / tot.cycles_dense,
        "ours_transposed_pct": 100.0 * g["transposed"].cycles_ours / tot.cycles_dense,
        "ours_general_pct": 100.0 * g["general"].cycles_ours / tot.cycles_dense,
        "dilated_speedup": _group_speedup(g["dilated"]),
        "transposed_speedup": _group_speedup(g["transposed"]),
        # throughput (Table I): peak = 168 MACs * 2 ops * 500 MHz
        "peak_gops": MACS_PER_CYCLE * 2 * FREQ_HZ / 1e9,
        "effective_gops": (tot.macs_dense * 2) / (tot.cycles_ours / FREQ_HZ) / 1e9,
    }
    return out


def serve_report(layers: list[ConvLayer], *, steps: int = 1,
                 batch: int = 1, scan_steps: int = 1,
                 steps_list: list[int] | None = None, calibration=None,
                 backend: str = "kernels", devices: int = 1,
                 snapshot_every: int = 0) -> dict[str, float]:
    """Steady-state serving cost of an iterative sampler on the array.

    One served image costs ``steps`` full passes over the workload's layer
    table (a DDIM trajectory re-runs the same geometry at every timestep;
    ``steps=1`` is single-shot GAN generation).  Assumptions (DESIGN.md §9):
    the array executes one MAC stream, so a device batch of ``B`` requests
    multiplies *latency* by ``B`` while steady-state throughput is
    batch-invariant — batching exists to amortise host scheduling and weight
    fetches, not MACs — and scheduling overhead between steps is not
    modeled.  The decomposed-vs-naive throughput ratio therefore equals the
    per-pass ``report()['speedup_vs_naive']`` exactly
    (``tests/test_torch_cycle_model.py`` pins it).

    ``scan_steps`` is the fused-dispatch depth ``K`` of the serving loop
    (``repro_torch.launch.steps.make_gen_scan_step``): the array cycles are unchanged
    (the same MACs stream either way), but the *host* pays one dispatch per
    ``ceil(steps / K)`` instead of one per step — reported as
    ``dispatches_per_image`` and amortised into the calibrated keys.

    ``calibration`` (a :class:`repro_torch.core.calibrate.Calibration`) adds
    host-grounded keys next to the 500 MHz array numbers:
    ``calibrated_us_per_image`` / ``calibrated_images_per_s`` predict THIS
    host's wall time on ``backend`` as ``steps x compute + dispatches x
    per-pass dispatch overhead`` (``Calibration.predict_layers_split``);
    omitted when the calibration lacks a fitted key for some layer kind.

    ``steps_list`` (a mixed per-request step-budget set) adds the
    latency-percentile keys ``latency_p50_ms`` / ``latency_p99_ms`` from
    :func:`serve_percentiles` — the deterministic continuous-batching drain
    model of DESIGN.md §9.

    ``snapshot_every`` (the serving loop's snapshot cadence, DESIGN.md §11)
    adds the worst-case recovery cost: a crash lands just before the next
    snapshot, so recovery replays ``snapshot_every`` full ticks — each one
    fused dispatch of ``batch x scan_steps`` passes.  Reported as
    ``recovery_ticks_worst`` / ``recovery_ms_worst`` (array cycles) and,
    with a calibration, ``calibrated_recovery_us_worst`` (this host's wall
    time, dispatch overhead included).

    ``devices`` models mesh data parallelism over the request batch / the
    decomposition's phase-parity axis (DESIGN.md §13): the sub-problems are
    independent, so ``devices`` arrays stream MACs concurrently with no
    collective on the serve path — per-device compute divides by
    ``devices`` (throughput and batch-drain latency scale linearly), while
    host dispatch overhead is paid once per fused dispatch regardless.
    """
    if steps < 1 or batch < 1 or scan_steps < 1:
        raise ValueError(
            f"steps/batch/scan_steps must be >= 1, got "
            f"{steps}/{batch}/{scan_steps}")
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    dispatches = float(_ceil(steps, scan_steps))
    base = report(layers)
    ours = base["our_cycles"] * steps
    naive = base["naive_cycles"] * steps
    if not ours or not naive:
        # empty layer table (e.g. admission estimate for an unknown/empty
        # workload): zero cost, neutral ratio — not a ZeroDivisionError
        return {
            "steps": float(steps), "batch": float(batch),
            "scan_steps": float(scan_steps), "devices": float(devices),
            "dispatches_per_image": dispatches,
            "cycles_per_image_ours": 0.0, "cycles_per_image_naive": 0.0,
            "latency_ms_ours": 0.0, "latency_ms_naive": 0.0,
            "images_per_s_ours": 0.0, "images_per_s_naive": 0.0,
            "serve_speedup_vs_naive": 1.0,
        }
    out = {
        "steps": float(steps),
        "batch": float(batch),
        "scan_steps": float(scan_steps),
        "devices": float(devices),
        "dispatches_per_image": dispatches,
        "cycles_per_image_ours": ours,
        "cycles_per_image_naive": naive,
        "latency_ms_ours": 1e3 * batch * ours / FREQ_HZ / devices,
        "latency_ms_naive": 1e3 * batch * naive / FREQ_HZ / devices,
        "images_per_s_ours": devices * FREQ_HZ / ours,
        "images_per_s_naive": devices * FREQ_HZ / naive,
        "serve_speedup_vs_naive": naive / ours,
    }
    if snapshot_every > 0:
        # worst case: the crash lands one tick short of the next snapshot,
        # so snapshot_every ticks of batch x scan_steps passes replay
        tick_cycles = batch * scan_steps * base["our_cycles"] / devices
        out["recovery_ticks_worst"] = float(snapshot_every)
        out["recovery_ms_worst"] = 1e3 * snapshot_every * tick_cycles / FREQ_HZ
    if calibration is not None:
        split = calibration.predict_layers_split(layers, backend=backend)
        if split is not None:
            compute_us, dispatch_us = split
            us = steps * compute_us / devices + dispatches * dispatch_us
            out["calibrated_us_per_image"] = us
            out["calibrated_images_per_s"] = 1e6 / us if us else 0.0
            if snapshot_every > 0:
                tick_us = (batch * scan_steps * compute_us / devices
                           + dispatch_us)
                out["calibrated_recovery_us_worst"] = snapshot_every * tick_us
    if steps_list:
        pct = serve_percentiles(layers, steps_list, batch=batch,
                                scan_steps=scan_steps, devices=devices,
                                calibration=calibration, backend=backend)
        out["latency_p50_ms"] = pct["latency_p50_ms"]
        out["latency_p99_ms"] = pct["latency_p99_ms"]
    return out


def serve_percentiles(layers: list[ConvLayer], steps_list: list[int], *,
                      batch: int = 1, scan_steps: int = 1, calibration=None,
                      backend: str = "kernels", devices: int = 1,
                      pcts: tuple[float, ...] = (50.0, 99.0)
                      ) -> dict[str, float]:
    """Latency percentiles of a mixed-step request drain (DESIGN.md §9).

    The serving loop is deterministic given the request set, so the
    percentile model *is* the schedule: ``len(steps_list)`` requests are all
    present at t=0, admitted FIFO into ``batch`` slots, and every scheduler
    tick advances each occupied slot by up to ``scan_steps`` trajectory
    steps in one fused dispatch.  A dispatch streams ``batch x scan_steps``
    full passes over the layer table through the array (padded substeps and
    idle slots stream too — the compiled step's shape does not shrink), so
    every tick costs the same ``batch * scan_steps * pass_cycles``.  A
    request's latency is its completion tick's end time; percentiles are
    taken over the request set (numpy linear interpolation).

    With a ``calibration``, tick wall time is modeled as ``batch x
    scan_steps x compute_us + dispatch_us`` (one fused dispatch pays the
    per-pass dispatch overhead once) and calibrated-us percentile keys ride
    along.
    """
    if batch < 1 or scan_steps < 1:
        raise ValueError(
            f"batch/scan_steps must be >= 1, got {batch}/{scan_steps}")
    if not steps_list or min(steps_list) < 1:
        raise ValueError(f"steps_list must be non-empty positive budgets, "
                         f"got {steps_list}")
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    pass_cycles = float(sum(cycles_our_decomposed(l) for l in layers))
    tick_cycles = batch * scan_steps * pass_cycles / devices
    split = (calibration.predict_layers_split(layers, backend=backend)
             if calibration is not None else None)
    tick_us = (batch * scan_steps * split[0] / devices + split[1]
               if split is not None else None)

    pending = list(steps_list)          # FIFO: remaining-step budgets
    slots: list[int] = []               # remaining steps of occupied slots
    done_ticks: list[int] = []          # completion tick per request, FIFO
    tick = 0
    while pending or slots:
        while pending and len(slots) < batch:
            slots.append(pending.pop(0))
        tick += 1
        nxt = []
        for rem in slots:
            rem -= scan_steps
            if rem > 0:
                nxt.append(rem)
            else:
                done_ticks.append(tick)
        slots = nxt
    lat_ms = [1e3 * t * tick_cycles / FREQ_HZ for t in done_ticks]
    out: dict[str, float] = {
        "requests": float(len(steps_list)),
        "ticks": float(tick),
        "dispatches": float(tick),
    }
    for p in pcts:
        key = f"p{p:g}"
        out[f"latency_{key}_ms"] = float(np_percentile(lat_ms, p))
        if tick_us is not None:
            out[f"calibrated_latency_{key}_us"] = float(
                np_percentile([t * tick_us for t in done_ticks], p))
    return out


def np_percentile(values: list[float], p: float) -> float:
    """Linear-interpolated percentile without importing numpy at module
    scope (the cycle model stays dependency-light; numpy is already a repo
    dependency everywhere this is called)."""
    xs = sorted(values)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def efficiency_vs_sparse(l: ConvLayer) -> float:
    """Per-layer efficiency of our work vs the ideal sparse case."""
    return cycles_ideal_sparse(l) / cycles_our_decomposed(l)


# paper Fig. 10: ENet's ideal-dense cycle shares per layer group
PAPER_FIG10_MIX = {"dilated": 85.0, "transposed": 7.0, "general": 8.0}


def headline(layers: list[ConvLayer],
             mix: dict[str, float] = PAPER_FIG10_MIX) -> dict[str, float]:
    """The abstract's headline numbers: ~8.2x speedup, ~87.8% cycle cut.

    The overall aggregate depends on layer-inventory bookkeeping the paper
    does not fully specify (skip projections, decoder widths), so the pinned
    reproduction normalizes the *measured per-group cycle ratios* by the
    paper's own reported workload mix (Fig. 10: dilated 85 / transposed 7 /
    general 8).  This isolates what the model actually claims — how well
    each convolution class executes — from how many MACs each class
    contributes, and recovers the abstract's numbers within tolerance
    (pinned in ``tests/test_paper_figures.py``).
    """
    g = summarize(layers)
    ratios = {k: g[k].cycles_ours / g[k].cycles_dense
              for k in ("dilated", "transposed", "general") if g[k].cycles_dense}
    ours = sum(mix[k] * ratios[k] for k in ratios)
    baseline = sum(mix[k] for k in ratios)
    return {
        "speedup": baseline / ours,
        "cycle_reduction_pct": 100.0 * (1 - ours / baseline),
        "group_ratios": ratios,
    }


# ---------------------------------------------------------------------------
# Training-cost extension (beyond-paper; EcoFlow's observation): the backward
# pass is itself made of dilated/transposed convolutions, so the same
# decomposition accelerates it.  See DESIGN.md §6.
# ---------------------------------------------------------------------------

def adjoint_layer(l: ConvLayer) -> ConvLayer:
    """The layer class of ``dL/dx`` — the adjoint symmetry as a spec map.

    * strided **transposed** layer -> strided dense conv at the input extent
      (downsampling is the adjoint of upsampling);
    * **dilated** layer -> dilated layer, same step, channels swapped (kept
      at the forward geometry: the adjoint issues exactly one MAC per
      forward MAC, so the class-streamed schedule costs the same);
    * strided general **conv** (``stride`` recorded, e.g. ESPNet's d=1
      pyramid branches) -> transposed layer at the input extent — the other
      side of the first rule;
    * stride-1 general **conv** -> general conv, channels swapped.
    """
    if l.kind == "transposed":
        h_in, w_in = tconv_input_size(l)
        return ConvLayer(f"{l.name}.dx", "conv", h_in, w_in, l.cout, l.cin,
                         l.kh, l.kw)
    if l.kind == "dilated":
        return ConvLayer(f"{l.name}.dx", "dilated", l.h_out, l.w_out,
                         l.cout, l.cin, l.kh, l.kw, D=l.D, stride=l.stride,
                         group="dilated")
    if l.stride > 1:
        return ConvLayer(f"{l.name}.dx", "transposed", l.stride * l.h_out,
                         l.stride * l.w_out, l.cout, l.cin, l.kh, l.kw,
                         stride=l.stride, group="transposed")
    return ConvLayer(f"{l.name}.dx", "conv", l.h_out, l.w_out, l.cout, l.cin,
                     l.kh, l.kw)


def wgrad_contention(l: ConvLayer, n: int = N_ROWS, b: int = N_BLOCKS) -> float:
    """Port-contention multiplier of the tap-gather weight-gradient pass.

    ``dL/dw`` *accumulates into* the weight ports instead of holding static
    weights in them, which costs three array constraints the old full-rate
    model ignored (each factor is >= 1; 1.0 means no loss):

    * **tap packing** — a PE block's 3 weight ports hold 3 tap-accumulators
      for the duration of a reduction, so the gather streams the shared
      input broadcast in ``ceil(taps/3)`` port groups rather than packing
      ``taps x cin x cout`` across all ``3*B`` ports at once (the forward
      transposed trick of Fig. 9 is unavailable: an accumulator cannot move
      ports mid-reduction).  Dense/dilated layers pack their column vector
      ``kh x cin`` in groups of 3 exactly like the forward schedule.
    * **cout tiling** — output-channel gradient blocks tile across the ``B``
      PE blocks (ceil loss when ``cout % B != 0``).

    No row-tiling term: in ``dL/dw`` the spatial positions are the
    *contraction* dimension (the output is the ``k x k x cin x cout`` weight
    block, not a row-tiled image), so the gather streams rows contiguously —
    the forward schedules' ``ceil(H/n)`` output-tiling loss has no analogue.
    """
    cout_tile = _ceil(l.cout, b) * b / l.cout
    if l.kind == "transposed":
        taps = l.kh * l.kw
        tap_pack = _ceil(taps, 3) * 3 / taps
    else:
        col = l.kh * l.cin
        tap_pack = _ceil(col, 3) * 3 / col
    return tap_pack * cout_tile


def cycles_wgrad(l: ConvLayer) -> float:
    """Cycles of ``dL/dw``: tap-gather correlations on the array.

    Each nonzero forward MAC contributes exactly one weight-gradient MAC,
    gathered phase-contiguously (no inserted zeros) — but the gather does
    NOT sustain the full 168-MAC rate: the explicit
    :func:`wgrad_contention` term models the port/tiling losses of
    accumulating into the weight ports (the old model assumed full array
    rate, which overstated the training-side win).
    """
    return ideal_sparse_macs(l) / MACS_PER_CYCLE * wgrad_contention(l)


def training_report(layers: list[ConvLayer]) -> dict[str, float]:
    """Forward + backward cycle model (the EcoFlow setting).

    Backward = input-gradient pass (each layer costed as its adjoint layer,
    executed decomposed) + weight-gradient pass (tap-gather correlations with
    the explicit :func:`wgrad_contention` port term).  The naive baseline
    executes the same adjoints with zero-laden dense schedules
    (``cycles_our_general``) and the weight gradients over the zero-inserted
    geometry (``ideal_dense_macs``).

    An empty (or zero-cycle) layer list returns zero cycles and neutral 1.0
    speedups rather than raising ``ZeroDivisionError`` — same policy as
    ``report()``'s absent-group guard.
    """
    fwd_ours = sum(cycles_our_decomposed(l) for l in layers)
    fwd_naive = sum(cycles_our_general(l) for l in layers)
    if not fwd_ours or not fwd_naive:
        return {
            "fwd_cycles": 0.0, "bwd_cycles": 0.0, "train_cycles": 0.0,
            "fwd_speedup_vs_naive": 1.0, "bwd_speedup_vs_naive": 1.0,
            "train_speedup_vs_naive": 1.0,
        }
    adj = [adjoint_layer(l) for l in layers]
    bwd_ours = (sum(cycles_our_decomposed(a) for a in adj)
                + sum(cycles_wgrad(l) for l in layers))
    bwd_naive = (sum(cycles_our_general(a) for a in adj)
                 + sum(ideal_dense_macs(l) / MACS_PER_CYCLE for l in layers))
    return {
        "fwd_cycles": fwd_ours,
        "bwd_cycles": bwd_ours,
        "train_cycles": fwd_ours + bwd_ours,
        "fwd_speedup_vs_naive": fwd_naive / fwd_ours,
        "bwd_speedup_vs_naive": bwd_naive / bwd_ours,
        "train_speedup_vs_naive": (fwd_naive + bwd_naive) / (fwd_ours + bwd_ours),
    }
