"""Calibration layer: modeled cycles -> measured time on this host, the
port of ``repro.core.calibrate`` (DESIGN.md §10).

The cycle model (:mod:`repro_torch.core.cycle_model`) counts cycles on the
paper's 168-MAC array.  This module grounds it: it times single dispatches
of the port's engine (:func:`repro_torch.core.decompose.conv2d`, best of N
through :func:`repro_torch.kernels.util.time_call`), pairs each time with
the modeled cycle count of the same geometry, and fits a least-squares
affine map

    ``us_measured ~= a * cycles_modeled + b``

per ``(engine kind, backend, device kind, dtype)`` key.  ``a`` is the
host's microseconds per modeled cycle, ``b`` the fixed cost of one
dispatch.  The backends are the port's, ``"kernels"`` and ``"torch"``;
the device kind is the card's name (``torch.cuda.get_device_name``,
sanitised) or ``"cpu"``, so a capture of ``"kernels"`` on CPU tensors,
which times the kernels' plain versions, lands under its own ``cpu`` key
and never passes for the card's.

The payload's JSON layout is the reference's, so each package loads the
other's file: :func:`map_backends` renames the backend segment of every
key (``"xla"`` <-> ``"torch"``, ``"pallas"`` <-> ``"kernels"``), and
:meth:`Calibration.from_payload` applies it, so a reference payload loads
under the port's names.

Consumers:

* ``repro_torch.kernels.tiling_policy`` / ``autotune`` — the fitted
  ``b / (a * cycles)`` weights the per-wave term of the plan score
  (``autotune.tune(calibration=...)``);
* ``repro_torch.launch.serve_gen.GenServer`` — ``predict_layers()`` turns a
  workload's layer table into a calibrated admission estimate and
  ``predict_layers_split()`` picks ``scan_steps="auto"``;
* ``cycle_model.serve_report(..., calibration=...)`` — calibrated latency
  keys next to the 500 MHz array numbers.

The fit is closed-form (no scipy).
"""

from __future__ import annotations

import json
import math
import os
import pathlib
from dataclasses import asdict, dataclass

import numpy as np
import torch

from repro_torch.core import cycle_model as cm
from repro_torch.core.enet_spec import ConvLayer
from repro_torch.kernels.util import device_kind as _device_kind

#: engine kinds (the reference's)
KINDS = ("dense", "dilated", "tconv")

#: the reference's backend names -> the port's
BACKEND_NAMES = {"xla": "torch", "pallas": "kernels"}

#: ``ConvLayer.kind`` -> engine kind, for costing layer tables
KIND_OF_LAYER = {"conv": "dense", "dilated": "dilated", "transposed": "tconv"}


def map_backends(payload: dict, to: str = "port") -> dict:
    """A calibration payload with the backend segment of every key renamed
    between the two packages: ``to="port"`` maps the reference's
    ``"xla"``/``"pallas"`` to ``"torch"``/``"kernels"``, ``to="reference"``
    the reverse.  Other names and every other field pass unchanged; the
    layout is the reference's ``to_payload()``.  :meth:`Calibration.
    from_payload` applies it, so a reference payload loads here; pass a
    port payload through ``to="reference"`` before the reference loads it.
    """
    if to == "port":
        names = BACKEND_NAMES
    elif to == "reference":
        names = {v: k for k, v in BACKEND_NAMES.items()}
    else:
        raise ValueError(f"to must be 'port' or 'reference', got {to!r}")
    coeffs = {}
    for key, v in payload.get("coeffs", {}).items():
        parts = key.split("/")
        if len(parts) >= 2:
            parts[1] = names.get(parts[1], parts[1])
        coeffs["/".join(parts)] = v
    return {**payload, "coeffs": coeffs}


def key_of(kind: str, backend: str, device_kind: str | None = None,
           dtype: str = "float32") -> str:
    """Canonical calibration key ``kind/backend/device_kind/dtype``."""
    if kind not in KINDS:
        raise ValueError(f"unknown engine kind {kind!r}; known: {KINDS}")
    return f"{kind}/{backend}/{device_kind or _device_kind()}/{dtype}"


@dataclass(frozen=True)
class Sample:
    """One (modeled cycles, measured wall time) observation."""
    kind: str           # dense | dilated | tconv
    backend: str        # kernels | torch
    device_kind: str
    name: str           # geometry tag, e.g. "dense/32x32x16->32/k3s1"
    cycles: float       # modeled cycles (cycle_model costing of the geometry)
    us: float           # measured microseconds (blocking, best-of-N)
    dtype: str = "float32"      # compute dtype the measurement ran in

    @property
    def key(self) -> str:
        return key_of(self.kind, self.backend, self.device_kind, self.dtype)


@dataclass
class Coeffs:
    """Affine fit ``us = a * cycles + b`` for one key."""
    a_us_per_cycle: float
    b_us: float
    n: int              # samples the fit saw

    def predict(self, cycles: float) -> float:
        return self.a_us_per_cycle * cycles + self.b_us


def _fit_one(pairs: list[tuple[float, float]]) -> Coeffs:
    """Closed-form least squares on (cycles, us) pairs.

    Degenerate cases are resolved toward physical sanity: a single sample
    (or a single distinct abscissa) fits a pure slope through the origin;
    negative intercepts (tiny-op noise) are clamped to 0 and the slope
    refit; the slope itself is clamped >= 0.
    """
    n = len(pairs)
    if n == 0:
        raise ValueError("cannot fit a calibration on zero samples")
    sx = sum(c for c, _ in pairs)
    sy = sum(u for _, u in pairs)
    sxx = sum(c * c for c, _ in pairs)
    sxy = sum(c * u for c, u in pairs)
    denom = n * sxx - sx * sx
    if n == 1 or abs(denom) < 1e-12 * max(sxx, 1.0):
        a = (sy / sx) if sx else 0.0
        return Coeffs(max(a, 0.0), 0.0, n)
    a = (n * sxy - sx * sy) / denom
    b = (sy - a * sx) / n
    if b < 0.0 or a < 0.0:
        # refit through the origin — a negative dispatch overhead (or a
        # negative rate) is measurement noise, not physics
        a = (sxy / sxx) if sxx else 0.0
        return Coeffs(max(a, 0.0), 0.0, n)
    return Coeffs(a, b, n)


class Calibration:
    """Fitted cycles->us maps, one :class:`Coeffs` per key."""

    def __init__(self, coeffs: dict[str, Coeffs] | None = None):
        self.coeffs: dict[str, Coeffs] = dict(coeffs or {})

    # ------------------------------------------------------------- fitting --
    @classmethod
    def fit(cls, samples: list[Sample]) -> "Calibration":
        by_key: dict[str, list[tuple[float, float]]] = {}
        for s in samples:
            by_key.setdefault(s.key, []).append((s.cycles, s.us))
        return cls({k: _fit_one(v) for k, v in sorted(by_key.items())})

    # ---------------------------------------------------------- prediction --
    def _coeffs_for(self, kind: str, backend: str,
                    device_kind: str | None, dtype: str):
        """Fit for a key, falling back to the fp32 fit when a non-fp32
        dtype is unfitted — fp32 wall is an upper bound for bf16, so the
        fallback is a conservative estimate rather than "no estimate"."""
        co = self.coeffs.get(key_of(kind, backend, device_kind, dtype))
        if co is None and dtype != "float32":
            co = self.coeffs.get(key_of(kind, backend, device_kind))
        return co

    def predict(self, kind: str, cycles: float, *, backend: str = "kernels",
                device_kind: str | None = None,
                dtype: str = "float32") -> float | None:
        """Predicted wall microseconds, or ``None`` if the key is unfitted."""
        co = self._coeffs_for(kind, backend, device_kind, dtype)
        return None if co is None else co.predict(cycles)

    def predict_layers(self, layers: list[ConvLayer], *,
                       backend: str = "kernels",
                       device_kind: str | None = None,
                       dtype: str = "float32") -> float | None:
        """Calibrated microseconds for one pass over a layer table.

        Sums per-layer predictions (each layer is one engine dispatch, so
        each pays its key's ``b_us`` overhead).  Returns ``None`` if any
        layer's kind has no fitted coefficients — a partial estimate would
        silently undercount.
        """
        split = self.predict_layers_split(layers, backend=backend,
                                          device_kind=device_kind,
                                          dtype=dtype)
        return None if split is None else split[0] + split[1]

    def predict_layers_split(self, layers: list[ConvLayer], *,
                             backend: str = "kernels",
                             device_kind: str | None = None,
                             dtype: str = "float32"
                             ) -> tuple[float, float] | None:
        """``(compute_us, dispatch_us)`` for one pass over a layer table.

        ``compute_us`` is the fitted-slope part (``a * cycles`` per layer) —
        it scales with every pass; ``dispatch_us`` is the summed per-layer
        fixed overhead (``b_us`` per engine dispatch) — a ``K``-step fused
        scan pays it once per *dispatch*, not once per step, which is what
        ``cycle_model.serve_report(scan_steps=...)`` amortises.  Same
        coverage gate as :meth:`predict_layers`: ``None`` when any layer's
        kind has no fitted coefficients.
        """
        compute = dispatch = 0.0
        for l in layers:
            co = self._coeffs_for(KIND_OF_LAYER[l.kind], backend,
                                  device_kind, dtype)
            if co is None:
                return None
            compute += co.a_us_per_cycle * cm.cycles_our_decomposed(l)
            dispatch += co.b_us
        return compute, dispatch

    # ------------------------------------------------------ error reports --
    def error_report(self, samples: list[Sample]) -> dict[str, dict]:
        """Prediction-error table per key: the calibrated-model residuals.

        ``err_pct = 100 * (predicted - measured) / measured`` per sample;
        ``mape_pct`` is the mean absolute of those — the headline number the
        perf gate tracks over revisions.
        """
        out: dict[str, dict] = {}
        for s in samples:
            co = self.coeffs.get(s.key)
            if co is None:
                continue
            pred = co.predict(s.cycles)
            err_pct = 100.0 * (pred - s.us) / s.us if s.us else 0.0
            e = out.setdefault(s.key, {
                "a_us_per_cycle": co.a_us_per_cycle, "b_us": co.b_us,
                "n": co.n, "samples": [],
            })
            e["samples"].append({
                "name": s.name, "cycles": s.cycles,
                "us": round(s.us, 3), "pred_us": round(pred, 3),
                "err_pct": round(err_pct, 2),
            })
        for e in out.values():
            errs = [abs(r["err_pct"]) for r in e["samples"]]
            e["mape_pct"] = round(sum(errs) / len(errs), 2) if errs else 0.0
            e["max_abs_err_pct"] = round(max(errs), 2) if errs else 0.0
        return out

    # --------------------------------------------------------- persistence --
    def to_payload(self) -> dict:
        return {"schema": 2,
                "coeffs": {k: asdict(v) for k, v in sorted(self.coeffs.items())}}

    @classmethod
    def from_payload(cls, payload: dict) -> "Calibration":
        """Load a payload of either package (backend names through
        :func:`map_backends`); schema-1 keys (no dtype segment) map to fp32.

        Pre-dtype caches were fitted exclusively on fp32 captures, so
        ``kind/backend/device`` upgrades losslessly to
        ``kind/backend/device/float32``.
        """
        coeffs = {}
        for k, v in map_backends(payload, "port").get("coeffs", {}).items():
            if k.count("/") == 2:       # schema 1: dtype segment missing
                k = f"{k}/float32"
            coeffs[k] = Coeffs(**v)
        return cls(coeffs)

    def save(self, path: str | pathlib.Path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.to_payload(), indent=1))
        tmp.replace(p)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "Calibration":
        return cls.from_payload(json.loads(pathlib.Path(path).read_text()))


def default_cache_path() -> pathlib.Path:
    """On-disk home of the host's calibration table (mirrors autotune's):
    ``$REPRO_TORCH_CALIBRATION_CACHE`` or ``~/.cache/repro-torch-calibration``,
    one file per device kind.  The names are the port's own, so the two
    packages never read each other's table by accident."""
    base = os.environ.get("REPRO_TORCH_CALIBRATION_CACHE")
    root = pathlib.Path(base) if base else (
        pathlib.Path.home() / ".cache" / "repro-torch-calibration")
    return root / f"{_device_kind()}-v1.json"


# ---------------------------------------------------------------------------
# Capture: run geometries through the real engines, timed + modeled
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CaptureCase:
    """One geometry to measure: enough to build both the executable call and
    the :class:`ConvLayer` the cycle model costs."""
    kind: str
    x_shape: tuple      # (N, H, W, Cin)
    w_shape: tuple      # (kh, kw, Cin, Cout)
    stride: int = 1
    dilation: int = 1
    output_padding: int = 1     # tconv only
    dtype: str = "float32"      # compute dtype the engines run in

    @property
    def name(self) -> str:
        n, h, w, cin = self.x_shape
        kh, kw, _, cout = self.w_shape
        tag = "" if self.dtype == "float32" else f"/{self.dtype}"
        return (f"{self.kind}/{n}x{h}x{w}x{cin}->{cout}"
                f"/k{kh}s{self.stride}d{self.dilation}{tag}")


def layer_of(case: CaptureCase) -> ConvLayer:
    """The :class:`ConvLayer` whose modeled cycles match one capture case."""
    n, h, w, cin = case.x_shape
    kh, kw, _, cout = case.w_shape
    if case.kind == "dense":
        ho, wo = -(-h // case.stride), -(-w // case.stride)
        return ConvLayer(case.name, "conv", ho, wo, cin, cout, kh, kw,
                         stride=case.stride)
    if case.kind == "dilated":
        ho, wo = -(-h // case.stride), -(-w // case.stride)
        return ConvLayer(case.name, "dilated", ho, wo, cin, cout, kh, kw,
                         D=case.dilation - 1, stride=case.stride,
                         group="dilated")
    from repro_torch.core import transposed as tr

    p_lo = (kh - 1) // 2
    ho = tr.out_size(h, case.stride, kh, p_lo, p_lo + case.output_padding)
    wo = tr.out_size(w, case.stride, kw, p_lo, p_lo + case.output_padding)
    return ConvLayer(case.name, "transposed", ho, wo, cin, cout, kh, kw,
                     stride=case.stride, group="transposed",
                     output_padding=case.output_padding, padding=p_lo)


def modeled_cycles(case: CaptureCase) -> float:
    """Modeled decomposed cycles of one case (batch scales linearly)."""
    return case.x_shape[0] * cm.cycles_our_decomposed(layer_of(case))


def default_cases(smoke: bool = True) -> list[CaptureCase]:
    """The capture sweep: a few sizes per engine kind so each key's fit sees
    a spread of cycle counts (slope + intercept need >= 2 abscissae)."""
    if smoke:
        hws = (16, 32, 48)      # 3 abscissae: the affine fit has residuals
    else:
        hws = (16, 32, 64, 96, 128)
    cases = []
    for hw in hws:
        c = 16
        cases.append(CaptureCase("dense", (1, hw, hw, c), (3, 3, c, c)))
        cases.append(CaptureCase("dilated", (1, hw, hw, c), (3, 3, c, c),
                                 dilation=4))
        cases.append(CaptureCase("tconv", (1, hw, hw, c), (3, 3, c, c),
                                 stride=2))
    return cases


def measure_case(case: CaptureCase, *, backend: str = "torch",
                 iters: int = 3, device="cuda") -> float:
    """Best-of-``iters`` microseconds of one engine dispatch
    (:func:`repro_torch.core.decompose.conv2d`) on ``device``.

    The operands are drawn with numpy from seed 0.  On a card the timer
    brackets the dispatch with CUDA events (host enqueue and device work,
    :func:`repro_torch.kernels.util.time_call`); on the CPU it times the
    plain versions, which is what a CPU capture's ``cpu`` key says.
    """
    from repro_torch.core.decompose import conv2d
    from repro_torch.kernels.util import canon_dtype, time_call

    rng = np.random.default_rng(0)
    dt = canon_dtype(case.dtype)
    x, w = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(device=device, dtype=dt) for s in (case.x_shape, case.w_shape))
    tconv = case.kind == "tconv"

    def call():
        with torch.no_grad():
            return conv2d(x, w, stride=case.stride, dilation=case.dilation,
                          transposed=tconv,
                          output_padding=case.output_padding if tconv else 0,
                          backend=backend)

    return time_call(call, iters=iters, device=device) * 1e6


def capture_samples(*, smoke: bool = True,
                    backends: tuple[str, ...] = ("torch",), iters: int = 3,
                    cases: list[CaptureCase] | None = None,
                    dtypes: tuple[str, ...] = ("float32",),
                    device="cuda") -> list[Sample]:
    """Time the capture sweep on ``device``; returns fit-ready samples.

    Each backend and each dtype of ``dtypes`` re-times the sweep and lands
    under its own key, whose device kind is ``device``'s
    (:func:`_device_kind`): a CPU capture is a ``cpu`` key, never the
    card's.
    """
    from dataclasses import replace

    dev = _device_kind(device)
    cases = default_cases(smoke) if cases is None else cases
    out = []
    for backend in backends:
        for dtype in dtypes:
            for case in cases:
                case = replace(case, dtype=dtype)
                us = measure_case(case, backend=backend, iters=iters,
                                  device=device)
                out.append(Sample(case.kind, backend, dev, case.name,
                                  modeled_cycles(case), us, dtype=dtype))
    return out


def capture_and_fit(*, smoke: bool = True,
                    backends: tuple[str, ...] = ("torch",), iters: int = 3,
                    dtypes: tuple[str, ...] = ("float32", "bfloat16"),
                    device="cuda") -> dict:
    """Capture, fit and report prediction errors in one payload (the
    reference's ``calibration`` section), fp32 and bf16 by default."""
    samples = capture_samples(smoke=smoke, backends=backends, iters=iters,
                              dtypes=dtypes, device=device)
    calib = Calibration.fit(samples)
    return {
        "device_kind": _device_kind(device),
        "smoke": smoke,
        "fit": calib.to_payload(),
        "errors": calib.error_report(samples),
    }


# ---------------------------------------------------------------------------
# Tile-candidate scoring: the reference's legacy prune score over (th, tc)
# tiles, kept so both packages score a tile grid alike; the port's autotune
# ranks its plans with repro_torch.kernels.tiling_policy instead
# ---------------------------------------------------------------------------

def tile_scores(h_out: int, cout: int, cands: list[tuple[int, int]],
                *, kind: str = "dense", backend: str = "kernels",
                base_cycles: float | None = None,
                calibration: "Calibration | None" = None,
                dtype: str = "float32"
                ) -> list[tuple[float, tuple[int, int]]]:
    """Model-driven score per ``(th, tc)`` candidate (lower is better).

    The analytic part is tile-quantization waste: a ``(th, tc)`` grid pads
    the output to ``ceil(h_out/th)*th x ceil(cout/tc)*tc``, so the padded
    fraction is the work multiplier.  When a :class:`Calibration` knows this
    ``(kind, backend)`` key, its fitted per-call overhead ``b_us`` (relative
    to the modeled compute time ``a * cycles``) weights a per-grid-cell
    launch term — small tiles mean more cells, and on hosts where dispatch
    overhead dominates the calibrated score prunes them; without a fit the
    cell term uses a conservative constant weight.

    Returns ``(score, cand)`` sorted ascending, ties keeping candidate
    order (same determinism rule as the sweep itself).
    """
    cell_w = 1e-3
    if calibration is not None and base_cycles:
        co = calibration.coeffs.get(key_of(kind, backend, dtype=dtype))
        if co is None:      # fall back to the fp32 fit of the same engine
            co = calibration.coeffs.get(key_of(kind, backend))
        if co is not None and co.a_us_per_cycle > 0:
            compute_us = co.a_us_per_cycle * base_cycles
            if compute_us > 0:
                cell_w = co.b_us / compute_us
    scored = []
    for i, (th, tc) in enumerate(cands):
        pad = (math.ceil(h_out / th) * th / h_out) * \
              (math.ceil(cout / tc) * tc / cout)
        cells = math.ceil(h_out / th) * math.ceil(cout / tc)
        scored.append((pad + cell_w * cells, i, (th, tc)))
    scored.sort(key=lambda t: (t[0], t[1]))
    return [(s, c) for s, _, c in scored]


__all__ = [
    "KINDS", "KIND_OF_LAYER", "BACKEND_NAMES", "map_backends", "Sample",
    "Coeffs", "Calibration",
    "CaptureCase", "key_of", "layer_of", "modeled_cycles", "default_cases",
    "measure_case", "capture_samples", "capture_and_fit", "tile_scores",
    "default_cache_path",
]
