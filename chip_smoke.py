#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then:

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the kernels and prints the build time;
3. holds each kernel against its plain PyTorch version on the card: at every
   conv call of an ENet-512 batch-4 forward (recorded from the forward
   itself) and at edge cases (stride-2 stem, k2 s2, 5x1/1x5, SAME-even,
   every epilogue spec, d = 2, 4, 8, 16, transposed k4/k2/k<s);
4. serves one batch of 4 segmentation requests through ENet (19 classes,
   512x512, seeded random weights) with ``backend="kernels"``, checks the
   launch counters show every conv went through the two kernels, and holds
   the logits against the same module's ``backend="torch"`` output;
5. times the forward, each kernel per forward, the kernels' plain versions,
   one PyTorch library call per kernel (the yardstick), and the naive
   zero-laden forward;
6. prints the ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

It exits non-zero, with no result line, without a CUDA device or outside a
checkout of the repository.  Everything is fp32 with TF32 off.  The full
per-call results go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (at the 700 W limit)
PEAK_FP32_FLOPS = 67e12        # CUDA cores, no tensor cores
PEAK_BYTES_S = 3.35e12         # HBM3

SEED = 0
BATCH, HW, CLASSES = 4, 512, 19
# kernel vs plain: max |kernel - plain| <= TOL * max(1, max |plain|).  Both
# are fp32 with fp32 accumulation; only the summation order differs.
TOL = 1e-4
# ENet forward, kernels vs torch backend (cuDNN, TF32 off): relative L2
REL_L2_TOL = 1e-4
LAUNCHES_PER_FORWARD = {"conv2d": 86, "transposed_conv2d": 3}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    return Smoke(torch).run()


class Smoke:
    def __init__(self, torch):
        from repro_torch.kernels import build
        from repro_torch.kernels import conv2d as kconv
        from repro_torch.kernels import transposed_conv as ktr

        self.torch = torch
        self.build = build
        self.kconv = kconv
        self.ktr = ktr
        self.dev = torch.device("cuda", 0)
        # name -> (kernel launcher, plain version, counted wrapper)
        self.kernels = {
            "conv2d": (kconv.conv2d_cuda, kconv.conv2d_plain, kconv.conv2d),
            "transposed_conv2d": (ktr.tconv_cuda, ktr.tconv_plain,
                                  ktr.transposed_conv2d),
        }
        self.report = {"checks": [], "calls": []}
        self.worst = {name: 0.0 for name in self.kernels}

    # ---------------------------------------------------------------- utils
    def rand(self, g, *shape):
        return self.torch.randn(shape, generator=g).to(self.dev)

    def compare(self, label, name, got, want, quiet=False):
        """Hold a kernel's output against its plain version; raise on a
        miss.  Returns (max abs err, max rel err, tolerance)."""
        torch = self.torch
        if got.shape != want.shape:
            raise RuntimeError(f"{label}: shape {tuple(got.shape)} != "
                               f"{tuple(want.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{label}: non-finite kernel output")
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        rel, tol = err / scale, TOL * scale
        ok = err <= tol
        self.report["checks"].append({"label": label, "kernel": name,
                                      "max_abs_err": err, "max_rel_err": rel,
                                      "tol": tol, "ok": ok})
        self.worst[name] = max(self.worst[name], err)
        if not quiet:
            log(f"  {label}: max abs {err:.2e} rel {rel:.2e} tol {tol:.2e}")
        if not ok:
            raise RuntimeError(f"{label}: max abs err {err:.3e} > {tol:.3e}")
        return err, rel, tol

    @contextlib.contextmanager
    def recording(self, calls):
        """Record every kernel launch's arguments as (name, args)."""
        kconv, ktr = self.kconv, self.ktr
        orig = (kconv.conv2d_cuda, ktr.tconv_cuda)

        def rec(name, fn):
            def wrapper(*args):
                calls.append((name, args))
                return fn(*args)
            return wrapper

        kconv.conv2d_cuda = rec("conv2d", orig[0])
        ktr.tconv_cuda = rec("transposed_conv2d", orig[1])
        try:
            yield
        finally:
            kconv.conv2d_cuda, ktr.tconv_cuda = orig

    def device_ms(self, fn, reps=10, rounds=3):
        """Median device time of one ``fn()``, in ms.

        A spin kernel holds the stream while the host enqueues ``reps``
        calls, so the events bracket back-to-back device work and not the
        host's launch latency.
        """
        torch = self.torch
        fn()
        fn()
        times = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times)

    def wall_ms(self, fn, reps=10):
        """Median wall time of ``fn()`` ending in a synchronize, in ms."""
        torch = self.torch
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    # -------------------------------------------------------------- phases
    def run(self) -> int:
        torch = self.torch
        card = card_line()
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

        t0 = time.perf_counter()
        libs = self.build.build()
        log(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")

        model, x = self.make_model()
        calls = self.phase_kernels(model, x)
        y = self.phase_main(model, x)
        kernels_line, times = self.phase_times(model, x, calls)
        self.report.update(times)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
                  "w") as f:
            json.dump({"card": card, **self.report}, f, indent=1)
        log(f"class maps: {tuple(y.argmax(-1).shape)}")
        log(card)
        log(json.dumps(kernels_line))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    def make_model(self):
        """ENet-512 (19 classes) with seeded random weights.  BN scales and
        shifts and the PReLU slopes are drawn too: at init every closing BN
        scale is zero and would hide each bottleneck's conv chain."""
        torch = self.torch
        from repro_torch.models.enet import ENet

        g = torch.Generator().manual_seed(SEED)
        model = ENet(CLASSES, generator=g)
        with torch.no_grad():
            for name, p in model.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if name.endswith(".g"):
                    k = 0.4 if ".bn3." in name else 1.0
                    p.copy_(k * (0.5 + 0.5 * torch.rand(p.shape, generator=g)))
                elif name.endswith(".b"):
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))
                elif leaf in ("a1", "a2", "a3"):
                    p.copy_(0.1 + 0.3 * torch.rand(p.shape, generator=g))
        x = self.rand(g, BATCH, HW, HW, 3)
        return model, x

    def phase_kernels(self, model, x):
        torch = self.torch
        from repro_torch.core.dilated import dilated_conv2d_reference
        from repro_torch.kernels.dilated_conv import dilated_conv2d
        from repro_torch.kernels.epilogue import (EpilogueSpec,
                                                  apply_reference)

        log("phase 3: kernel vs plain version on the card "
            f"(tol {TOL} x max(1, max|plain|))")
        calls = []
        with torch.no_grad(), self.recording(calls):
            model(x)
        torch.cuda.synchronize()
        seen = {}
        for i, (name, args) in enumerate(calls):
            kern, plain, _ = self.kernels[name]
            key = (name, self.geometry(name, args))
            seen.setdefault(key, []).append(self.compare(
                f"enet call {i}", name, kern(*args), plain(*args),
                quiet=True))
        for (name, geo), errs in seen.items():
            log(f"  {name} {geo} x{len(errs)}: max abs "
                f"{max(e[0] for e in errs):.2e} rel "
                f"{max(e[1] for e in errs):.2e} tol "
                f"{min(e[2] for e in errs):.2e}")
        log(f"  {len(calls)} ENet calls, {len(seen)} distinct geometries: ok")

        g = torch.Generator().manual_seed(SEED + 1)
        specs = [EpilogueSpec(bn=b, prelu=p, residual=r)
                 for b in (False, True) for p in (False, True)
                 for r in ("none", "pre_act", "post_act")]

        def ep_args(spec, out_shape):
            cout = out_shape[-1]
            kw = {}
            if spec.bn:
                kw.update(scale=self.rand(g, cout), shift=self.rand(g, cout))
            if spec.prelu:
                kw["alpha"] = self.rand(g, cout if cout % 2 else 1)
            if spec.residual != "none":
                kw["residual"] = self.rand(g, *out_shape)
            return tuple(kw[s] for s in spec.slots)

        kconv, ktr = self.kconv, self.ktr
        dense = [  # label, x shape, w shape, stride, pads
            ("stem Cin3 Cout13 s2", (2, 37, 41, 3), (3, 3, 3, 13), 2,
             ((1, 1), (1, 1))),
            ("k2 s2 p0", (2, 32, 30, 16), (2, 2, 16, 32), 2,
             ((0, 0), (0, 0))),
            ("5x1 SAME", (2, 21, 19, 32), (5, 1, 32, 32), 1,
             ((2, 2), (0, 0))),
            ("1x5 SAME", (2, 21, 19, 32), (1, 5, 32, 32), 1,
             ((0, 0), (2, 2))),
            ("k2 SAME-even", (2, 15, 17, 8), (2, 2, 8, 24), 1,
             ((0, 1), (0, 1))),
            ("k4 SAME-even s2", (2, 15, 17, 8), (4, 4, 8, 70), 2,
             ((1, 2), (1, 2))),
        ]
        for label, xs, ws, s, pads in dense:
            xx, ww = self.rand(g, *xs), self.rand(g, *ws)
            self.compare(label, "conv2d",
                         kconv.conv2d(xx, ww, stride=s, padding=pads),
                         kconv.conv2d_plain(xx, ww, s, pads,
                                            EpilogueSpec(), ()))
        xx, ww = self.rand(g, 2, 19, 23, 24), self.rand(g, 3, 3, 24, 40)
        for spec in specs:
            eps = ep_args(spec, (2, 19, 23, 40))
            self.compare(f"epilogue {spec}", "conv2d",
                         kconv.conv2d_cuda(xx, ww, 1, ((1, 1), (1, 1)), spec,
                                           eps),
                         kconv.conv2d_plain(xx, ww, 1, ((1, 1), (1, 1)), spec,
                                            eps))
        spec = EpilogueSpec(bn=True, prelu=True, residual="pre_act")
        for d in (2, 4, 8, 16):
            xx, ww = self.rand(g, 2, 45, 38, 32), self.rand(g, 3, 3, 32, 32)
            eps = ep_args(spec, (2, 45, 38, 32))
            kw = dict(zip(spec.slots, eps))
            self.compare(f"dilated d={d}", "conv2d",
                         dilated_conv2d(xx, ww, d, epilogue=spec, **kw),
                         apply_reference(spec, dilated_conv2d_reference(
                             xx, ww, d), eps))
        tconv = [  # label, x shape, k, s, p_lo, output_padding, cin, cout
            ("k4 s2 p_lo2", (2, 13, 11), 4, 2, 2, 0, 16, 24),
            ("k2 s2 p_lo0", (2, 13, 11), 2, 2, 0, 0, 16, 24),
            ("k2 s3 k<s + epilogue", (2, 9, 7), 2, 3, 1, 0, 8, 12),
        ]
        for label, (n, h, w_), k, s, p_lo, op, cin, cout in tconv:
            xx, ww = self.rand(g, n, h, w_, cin), self.rand(g, k, k, cin, cout)
            sp = (EpilogueSpec(bn=True, residual="post_act") if "k<s" in label
                  else EpilogueSpec())
            oh, ow = (h - 1) * s + 2 * p_lo + op - k + 2, \
                (w_ - 1) * s + 2 * p_lo + op - k + 2
            eps = ep_args(sp, (n, oh, ow, cout))
            self.compare(label, "transposed_conv2d",
                         ktr.tconv_cuda(xx, ww, s, p_lo, p_lo + op, sp, eps),
                         ktr.tconv_plain(xx, ww, s, p_lo, p_lo + op, sp, eps))
        worst = {k: float(f"{v:.3e}") for k, v in self.worst.items()}
        log(f"  all ok; worst max abs err {json.dumps(worst)}")
        return calls

    def phase_main(self, model, x):
        torch = self.torch
        log("phase 4: ENet-512 forward, batch 4, backend=kernels")
        for _, _, wrapper in self.kernels.values():
            wrapper.launches = 0
        with torch.no_grad():
            y = model(x)
        torch.cuda.synchronize()
        self.launches = {name: wrapper.launches
                         for name, (_, _, wrapper) in self.kernels.items()}
        log(f"  launches per forward: {self.launches}")
        if self.launches != LAUNCHES_PER_FORWARD:
            raise RuntimeError(f"launch counts {self.launches} != "
                               f"{LAUNCHES_PER_FORWARD}")
        if tuple(y.shape) != (BATCH, HW, HW, CLASSES):
            raise RuntimeError(f"logits shape {tuple(y.shape)}")
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError("non-finite logits")
        with torch.no_grad():
            y_torch = model(x, backend="torch")
            y_naive = model(x, decomposed=False, backend="torch")
        for label, ref in (("torch backend", y_torch),
                           ("naive zero-laden", y_naive)):
            rel = ((y - ref).norm() / ref.norm()).item()
            self.report["checks"].append({"label": f"enet vs {label}",
                                          "rel_l2": rel, "tol": REL_L2_TOL})
            log(f"  kernels vs {label}: rel L2 {rel:.3e} (tol {REL_L2_TOL})")
            if not rel <= REL_L2_TOL:
                raise RuntimeError(f"ENet kernels vs {label}: rel L2 {rel}")
        log(f"  logits {tuple(y.shape)}, max |y| {y.abs().max().item():.3f}")
        return y

    def phase_times(self, model, x, calls):
        torch = self.torch
        log("phase 5: times (fp32, TF32 off)")
        times = {}
        with torch.no_grad():
            for label, kw in (("kernels", {}),
                              ("torch", {"backend": "torch"}),
                              ("naive", {"backend": "torch",
                                         "decomposed": False})):
                ms = self.wall_ms(lambda: model(x, **kw))
                times[f"forward_{label}_ms"] = ms
                log(f"  ENet forward {label}: {ms:.3f} ms/batch, "
                    f"{BATCH / ms * 1e3:.1f} images/s")
        times["naive_over_kernels"] = (times["forward_naive_ms"]
                                       / times["forward_kernels_ms"])
        times["profile"] = self.profile_forward(model, x,
                                                times["forward_kernels_ms"])
        per = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0, "bytes": 0, "flops": 0}
               for name in self.kernels}
        with torch.no_grad():
            for i, (name, args) in enumerate(calls):
                kern, plain, _ = self.kernels[name]
                lib = self.library_call(name, args)
                flops, nbytes = self.work(name, args)
                row = {"kernel": name, "geometry": self.geometry(name, args),
                       "ms": self.device_ms(lambda: kern(*args)),
                       "plain_ms": self.device_ms(lambda: plain(*args),
                                                  reps=3),
                       "library_ms": self.device_ms(lib),
                       "flops": flops, "bytes": nbytes,
                       "bound_ms": 1e3 * max(flops / PEAK_FP32_FLOPS,
                                             nbytes / PEAK_BYTES_S)}
                self.report["calls"].append(row)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "flops", "bytes"):
                    per[name][key] += row[key]
        sources = {
            "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
                       "src/repro/kernels/conv2d.py:195"),
            "transposed_conv2d": (
                "src/repro_torch/kernels/csrc/transposed_conv.cu",
                "src/repro/kernels/transposed_conv.py:235"),
        }
        entries = []
        for name, p in per.items():
            log(f"  {name}: {p['ms']:.3f} ms/forward over "
                f"{self.launches[name]} launches; bound {p['bound_ms']:.3f} "
                f"ms ({p['flops'] / 1e9:.2f} GFLOP, {p['bytes'] / 1e6:.1f} MB)"
                f"; plain {p['plain_ms']:.3f} ms; library "
                f"{p['library_ms']:.3f} ms")
            flops_bound = p["flops"] / PEAK_FP32_FLOPS
            entries.append({
                "name": name, "route": "cuda", "source": sources[name][0],
                "replaces": sources[name][1],
                "launches": self.launches[name],
                "max_abs_err": self.worst[name], "ms": p["ms"],
                "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                "bound_by": ("operations"
                             if flops_bound >= p["bytes"] / PEAK_BYTES_S
                             else "bytes"),
                "library_ms": p["library_ms"]})
            times[f"{name}_per_forward"] = p
        return {"kernels": entries}, times

    def profile_forward(self, model, x, wall_ms):
        """Device time of one kernels-backend forward by kernel name
        (``torch.profiler``), and the device's busy share of the forward's
        wall time measured without the profiler."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        with torch.no_grad():
            model(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model(x)
                torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                rows.append((us / 1e3, e.count, e.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        if not rows:
            log("  profiler: no device time recorded (busy share not "
                "measured)")
            return {"device_ms": None}
        log(f"  profiler: device busy {busy:.3f} ms of a {wall_ms:.3f} ms "
            f"forward ({100 * busy / wall_ms:.1f}%); top device time:")
        for ms, count, key in rows[:10]:
            log(f"    {ms:8.3f} ms  x{count:<4d} {key[:90]}")
        return {"device_ms": busy, "busy_share": busy / wall_ms,
                "top": [{"ms": ms, "count": c, "name": k}
                        for ms, c, k in rows[:25]]}

    # --------------------------------------------------- per-call helpers
    def geometry(self, name, args):
        x, w = args[0], args[1]
        spec = args[-2]
        if name == "conv2d":
            return (f"x{tuple(x.shape)} w{tuple(w.shape)} s{args[2]} "
                    f"pads{args[3]} ep({int(spec.bn)}{int(spec.prelu)}"
                    f"{spec.residual})")
        return (f"x{tuple(x.shape)} w{tuple(w.shape)} s{args[2]} "
                f"p({args[3]},{args[4]}) ep({int(spec.bn)}{int(spec.prelu)}"
                f"{spec.residual})")

    def work(self, name, args):
        """(flops of the nonzero MACs, bytes each operand moves once)."""
        x, w, spec, eps = args[0], args[1], args[-2], args[-1]
        n, h, w_in, cin = x.shape
        cout = w.shape[-1]
        if name == "conv2d":
            s, ((pt, pb), (pl, pr)) = args[2], args[3]

            def live(size, k, lo, hi):
                out = (size + lo + hi - k) // s + 1
                return sum(1 for o in range(out) for t in range(k)
                           if 0 <= o * s - lo + t < size), out

            ly, oh = live(h, w.shape[0], pt, pb)
            lx, ow = live(w_in, w.shape[1], pl, pr)
        else:
            s, p_lo, p_hi = args[2], args[3], args[4]
            k = w.shape[0]
            sched = self.ktr.parity_schedule(k, s, p_lo)

            def live(size):
                out = (size - 1) * s + p_lo + p_hi - k + 2
                return sum(1 for o in range(out) for _, off in sched[o % s]
                           if 0 <= o // s + off < size), out

            ly, oh = live(h)
            lx, ow = live(w_in)
        macs = n * ly * lx * cin * cout
        out_numel = n * oh * ow * cout
        ep_numel = sum(out_numel if s_ == "residual" else cout
                       for s_ in spec.slots)
        nbytes = 4 * (x.numel() + w.numel() + out_numel + ep_numel)
        return 2 * macs, nbytes

    def library_call(self, name, args):
        """One PyTorch call computing the same conv (without the fused
        epilogue): ``F.conv2d`` / ``F.conv_transpose2d`` on channels-last
        tensors, TF32 off.  Timed here only; the port never calls it."""
        torch = self.torch
        F = torch.nn.functional
        x, w = args[0], args[1]
        xc = x.permute(0, 3, 1, 2)                       # channels-last view
        if name == "conv2d":
            s, ((pt, pb), (pl, pr)) = args[2], args[3]
            if (pt, pl) != (pb, pr):
                xc = F.pad(xc, (pl, pr, pt, pb)).contiguous(
                    memory_format=torch.channels_last)
                pt = pl = 0
            wc = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            return lambda: F.conv2d(xc, wc, stride=s, padding=(pt, pl))
        s, p_lo, p_hi = args[2], args[3], args[4]
        k = w.shape[0]
        wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv_transpose2d(xc, wt, stride=s,
                                          padding=k - 1 - p_lo,
                                          output_padding=p_hi - p_lo)


if __name__ == "__main__":
    sys.exit(main())
