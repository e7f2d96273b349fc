#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then:

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the kernels and prints the build time and each kernel's
   registers and spills (ptxas);
3. holds each kernel against its plain PyTorch version on the card: at every
   conv call of an ENet-512 batch-4 forward (recorded from the forward
   itself) and at edge cases (stride-2 stem, k2 s2, 5x1/1x5, SAME-even,
   Cin 3 and 4, Cout 4, 8 and 19, a weight slab too large to stay
   resident, every epilogue spec, d = 2, 4, 8, 16, transposed k3 Cout
   19/k4/k2/k<s and k16 with its weights streamed per plane);
4. serves one batch of 4 segmentation requests through ENet (19 classes,
   512x512, seeded random weights) with ``backend="kernels"``, checks the
   launch counters show every conv went through the two kernels (and the
   conv2d launches by variant), and holds the logits against the same
   module's ``backend="torch"`` output;
5. times the forward, each kernel per forward, the kernels' plain versions,
   one PyTorch library call per kernel (the yardstick), and the naive
   zero-laden forward, and prints a table per conv geometry (calls, ms,
   bound and what bounds it, x bound, library ms, launch plan) with the
   geometry furthest from its bound;
6. holds the matmul and flash-attention kernels against their plain
   versions at edge cases (ragged M/N/K, K not a multiple of the 64-deep
   K step, Sq != Sk both ways, Sq = 1, lengths 300 and 4097, B*H > 1, head
   dims 16 to 256, fp32, bf16 and mixed operand types), each through the
   variant its wrapper picks (bf16 ``wgmma`` on the tensor cores, else
   ``simt`` on the CUDA cores);
7. drives the kernel entry points ``repro_torch.kernels.ops`` at the widths
   of StableLM-2-1.6B (hf:stabilityai/stablelm-2-1_6b; d_model 2048, 32
   heads of 64, MHA, d_ff 5632) on one 4096-token prefill at batch 1, in
   fp32 and in bf16: the q/k/v projections, causal attention, the output
   projection and the gated MLP, with seeded random weights.  It checks
   that the launch counters show every call went through a kernel, the
   bf16 layer's on the ``wgmma`` variants and the fp32 layer's on
   ``simt``, and holds each call against its plain version;
8. times each of those calls: the kernel, its plain version and the library
   yardstick (``torch.matmul`` in the input dtype, TF32 off;
   ``F.scaled_dot_product_attention(is_causal=True)``);
9. prints the ``{"kernels": [...]}`` line (all four kernels) and, last,
   ``{"ok": true, "device": {...}}``.

It exits non-zero, with no result line, without a CUDA device or outside a
checkout of the repository, or if any phase fails.  Phases 1-5 are fp32
with TF32 off.  The full per-call results go to
``chiprun_out/chip_smoke.json``.
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
PEAK_BF16_FLOPS = 989e12       # tensor cores, dense
PEAK_BYTES_S = 3.35e12         # HBM3

SEED = 0
BATCH, HW, CLASSES = 4, 512, 19
# kernel vs plain, fp32 outputs: max |kernel - plain| <= TOL * max(1,
# max |plain|).  Both are fp32 with fp32 accumulation; only the summation
# order differs.
TOL = 1e-4
# bf16 outputs, at every element: |kernel - plain| <= BF16_STEP * |plain| +
# TOL * max(1, max |plain|).  Both sides compute in fp32 (sums in another
# order: the TOL term) and round once to bf16, where two nearly equal values
# may land one bf16 step apart: at most 2^-7 of the value.
BF16_STEP = 2.0 ** -7
# ENet forward, kernels vs torch backend (cuDNN, TF32 off): relative L2
REL_L2_TOL = 1e-4
LAUNCHES_PER_FORWARD = {"conv2d": 86, "transposed_conv2d": 3,
                        "matmul": 0, "flash_attention": 0}
# the conv2d variants of one forward: the stem (Cin 3) takes the 4-byte
# copies, every other conv the 16-byte ones; every weight slab is resident
CONV_VARIANTS_PER_FORWARD = {"vec4-resident": 85, "vec4-streamed": 0,
                             "scalar-resident": 1, "scalar-streamed": 0}
# StableLM-2-1.6B (src/repro/configs/stablelm_1_6b.py): one layer's kernel
# calls on a 4096-token prefill at batch 1, its published context length
LM_D, LM_HEADS, LM_FF, LM_SEQ = 2048, 32, 5632, 4096
LM_HEAD_DIM = LM_D // LM_HEADS
LAUNCHES_PER_LM_LAYER = {"conv2d": 0, "transposed_conv2d": 0, "matmul": 7,
                         "flash_attention": 1}
# the variant every matmul and attention launch of the layer takes, by dtype
LM_VARIANT = {"torch.float32": "simt", "torch.bfloat16": "wgmma"}
SOURCES = {  # kernel -> (CUDA source, the TPU kernel's pallas_call)
    "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:195"),
    "transposed_conv2d": ("src/repro_torch/kernels/csrc/transposed_conv.cu",
                          "src/repro/kernels/transposed_conv.py:235"),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:51"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
}


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
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import matmul as kmm
        from repro_torch.kernels import transposed_conv as ktr

        self.torch = torch
        self.build = build
        self.kconv = kconv
        self.ktr = ktr
        self.kmm = kmm
        self.kfa = kfa
        self.dev = torch.device("cuda", 0)
        # name -> (kernel launcher, plain version, counted wrapper)
        self.kernels = {
            "conv2d": (kconv.conv2d_cuda, kconv.conv2d_plain, kconv.conv2d),
            "transposed_conv2d": (ktr.tconv_cuda, ktr.tconv_plain,
                                  ktr.transposed_conv2d),
        }
        # every kernel's counted wrapper, by kernel name
        self.counters = {"conv2d": kconv.conv2d,
                         "transposed_conv2d": ktr.transposed_conv2d,
                         "matmul": kmm.matmul,
                         "flash_attention": kfa.flash_attention}
        self.report = {"checks": [], "calls": [], "lm_calls": []}
        self.worst = {name: 0.0 for name in self.counters}

    # ---------------------------------------------------------------- utils
    def rand(self, g, *shape):
        return self.torch.randn(shape, generator=g).to(self.dev)

    def compare(self, label, name, got, want, quiet=False):
        """Hold a kernel's output against its plain version; raise on a
        miss.  Returns (max abs err, max rel err, tolerance).

        fp32 outputs: max |err| <= TOL * max(1, max|plain|).  bf16 outputs:
        |err| <= BF16_STEP * |plain| + TOL * max(1, max|plain|) at every
        element; the tolerance reported is that bar at an element of mean
        size, beside mean|plain|.  "err/bar" is the worst element's error
        over its bar, at most 1 when the check passes."""
        torch = self.torch
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"{label}: {tuple(got.shape)} {got.dtype} != "
                               f"{tuple(want.shape)} {want.dtype}")
        fp32 = want.dtype == torch.float32
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{label}: non-finite kernel output")
        diff, mag = (got - want).abs(), want.abs()
        err, mean = diff.max().item(), mag.mean().item()
        scale = max(1.0, mag.max().item())
        if fp32:
            tol = TOL * scale
            worst = err / tol
        else:
            tol = BF16_STEP * mean + TOL * scale
            worst = (diff / (BF16_STEP * mag + TOL * scale)).max().item()
        rel, ok = err / scale, worst <= 1.0
        self.report["checks"].append({
            "label": label, "kernel": name, "max_abs_err": err,
            "max_rel_err": rel, "tol": tol, "err_over_bar": worst,
            "mean_abs_plain": mean, "ok": ok})
        self.worst[name] = max(self.worst[name], err)
        if not quiet:
            log(f"  {label}: max abs {err:.2e} rel {rel:.2e} err/bar "
                f"{worst:.3f} tol {tol:.2e} mean|plain| {mean:.2e}")
        if not ok:
            raise RuntimeError(f"{label}: error {worst:.3f} x its bar (max "
                               f"abs err {err:.3e}, tol {tol:.3e})")
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

    def reset_counts(self):
        for wrapper in self.counters.values():
            wrapper.launches = 0
            by_variant = getattr(wrapper, "launches_by_variant", {})
            for variant in by_variant:
                by_variant[variant] = 0

    def read_counts(self):
        return {name: w.launches for name, w in self.counters.items()}

    def read_variants(self):
        """Launches by variant of the kernels that have variants."""
        return {name: dict(w.launches_by_variant)
                for name, w in self.counters.items()
                if hasattr(w, "launches_by_variant")}

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
        self.report["resources"] = {}
        for name in libs:
            for fn, use in self.build.resource_usage(name).items():
                self.report["resources"][fn] = use
                log(f"  {fn}: {use.get('registers')} registers, "
                    f"{use.get('spill_stores')} B spill stores, "
                    f"{use.get('spill_loads')} B spill loads (ptxas)")

        model, x = self.make_model()
        calls = self.phase_kernels(model, x)
        y = self.phase_main(model, x)
        kernels_line, times = self.phase_times(model, x, calls)
        self.report.update(times)
        del model, x, calls
        torch.cuda.empty_cache()

        self.phase_lm_kernels()
        lm_calls = self.phase_lm_main()
        kernels_line["kernels"] += self.phase_lm_times(lm_calls)
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
            ("Cin4 3x3 (16-byte copies)", (2, 17, 19, 4), (3, 3, 4, 16), 1,
             ((1, 1), (1, 1))),
            ("Cout4 1x1", (2, 20, 18, 16), (1, 1, 16, 4), 1,
             ((0, 0), (0, 0))),
            ("Cout8 3x3", (2, 17, 19, 16), (3, 3, 16, 8), 1,
             ((1, 1), (1, 1))),
            ("Cout19 3x3", (2, 16, 15, 16), (3, 3, 16, 19), 1,
             ((1, 1), (1, 1))),
            ("3x3 128->64, streamed slab", (2, 9, 10, 128),
             (3, 3, 128, 64), 1, ((1, 1), (1, 1))),
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
            ("k3 s2 op1 Cout19", (2, 16, 16), 3, 2, 1, 1, 16, 19),
            ("k4 s2 p_lo2", (2, 13, 11), 4, 2, 2, 0, 16, 24),
            ("k2 s2 p_lo0", (2, 13, 11), 2, 2, 0, 0, 16, 24),
            ("k2 s3 k<s + epilogue", (2, 9, 7), 2, 3, 1, 0, 8, 12),
            ("k16 s2 Cout32, streamed taps", (2, 11, 9), 16, 2, 7, 1, 16,
             32),
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
        worst = {k: float(f"{self.worst[k]:.3e}") for k in self.kernels}
        log(f"  all ok; worst max abs err {json.dumps(worst)}")
        return calls

    def phase_main(self, model, x):
        torch = self.torch
        log("phase 4: ENet-512 forward, batch 4, backend=kernels")
        self.reset_counts()
        with torch.no_grad():
            y = model(x)
        torch.cuda.synchronize()
        self.launches = self.read_counts()
        variants = self.read_variants()["conv2d"]
        log(f"  launches per forward: {self.launches}; conv2d by variant "
            f"{variants}")
        if self.launches != LAUNCHES_PER_FORWARD:
            raise RuntimeError(f"launch counts {self.launches} != "
                               f"{LAUNCHES_PER_FORWARD}")
        if variants != CONV_VARIANTS_PER_FORWARD:
            raise RuntimeError(f"conv2d launches by variant {variants} != "
                               f"{CONV_VARIANTS_PER_FORWARD}")
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
                       "variant": self.variant(name, args),
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
        entries = []
        for name, p in per.items():
            log(f"  {name}: {p['ms']:.3f} ms/forward over "
                f"{self.launches[name]} launches; bound {p['bound_ms']:.3f} "
                f"ms ({p['flops'] / 1e9:.2f} GFLOP, {p['bytes'] / 1e6:.1f} MB)"
                f"; plain {p['plain_ms']:.3f} ms; library "
                f"{p['library_ms']:.3f} ms")
            flops_bound = p["flops"] / PEAK_FP32_FLOPS
            entries.append({
                "name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1],
                "launches": self.launches[name],
                "max_abs_err": self.worst[name], "ms": p["ms"],
                "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                "bound_by": ("operations"
                             if flops_bound >= p["bytes"] / PEAK_BYTES_S
                             else "bytes"),
                "library_ms": p["library_ms"]})
            times[f"{name}_per_forward"] = p
        times["geometries"] = self.geometry_table(self.report["calls"])
        return {"kernels": entries}, times

    def geometry_table(self, rows):
        """Per-geometry sums of the timed calls, logged as a table: calls,
        device ms, bound ms and what bounds it, x bound, library ms and the
        launch plan; then the geometry furthest from its bound."""
        groups = {}
        for r in rows:
            g = groups.setdefault((r["kernel"], r["geometry"]), {
                "kernel": r["kernel"], "geometry": r["geometry"],
                "variant": r["variant"], "calls": 0, "ms": 0.0,
                "bound_ms": 0.0, "library_ms": 0.0, "flops": 0,
                "bytes": 0})
            g["calls"] += 1
            for k in ("ms", "bound_ms", "library_ms", "flops", "bytes"):
                g[k] += r[k]
        table = sorted(groups.values(), key=lambda g: -g["ms"])
        log("  per geometry (sums over a forward's calls; device ms):")
        log(f"    {'kernel':18s} {'calls':>5s} {'ms':>7s} {'bound':>7s} "
            f"{'by':5s} {'xbound':>6s} {'library':>7s}  variant  geometry")
        for g in table:
            by = ("ops" if g["flops"] / PEAK_FP32_FLOPS
                  >= g["bytes"] / PEAK_BYTES_S else "bytes")
            g["bound_by"] = "operations" if by == "ops" else "bytes"
            g["x_bound"] = g["ms"] / g["bound_ms"]
            log(f"    {g['kernel']:18s} {g['calls']:5d} {g['ms']:7.4f} "
                f"{g['bound_ms']:7.4f} {by:5s} {g['x_bound']:6.1f} "
                f"{g['library_ms']:7.4f}  {g['variant']}  {g['geometry']}")
        worst = max(table, key=lambda g: g["x_bound"])
        log(f"  worst x bound: {worst['x_bound']:.1f} ({worst['kernel']} "
            f"{worst['geometry']}, {worst['ms']:.4f} ms against "
            f"{worst['bound_ms']:.4f})")
        return table

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

    # ------------------------------------------- matmul and attention
    def phase_lm_kernels(self):
        torch = self.torch
        kmm, kfa = self.kmm, self.kfa
        log(f"phase 6: matmul and flash attention vs plain on the card (fp32: "
            f"{TOL} x max(1, max|plain|); bf16, each element: 2^-7 |plain| + "
            f"{TOL} x max(1, max|plain|))")
        g = torch.Generator().manual_seed(SEED + 3)
        f32, bf16 = torch.float32, torch.bfloat16

        def rand(shape, dtype):
            return torch.randn(shape, generator=g).to(self.dev, dtype)

        mm_cases = [(m, n, k, dt, dt) for m, n, k in
                    ((1, 128, 7), (100, 60, 36), (16, 16, 16),
                     (256, 512, 128), (4097, 33, 65)) for dt in (f32, bf16)]
        mm_cases.append((100, 60, 36, bf16, f32))
        # bf16 edges of the wgmma variant: ragged M and N tiles, M = 1,
        # K = 72 (not a multiple of the 64-deep K step), K = 8
        mm_cases += [(m, n, k, bf16, bf16) for m, n, k in
                     ((4097, 2056, 2048), (1, 128, 2048), (300, 200, 64),
                      (100, 64, 72), (130, 264, 8))]
        for m, n, k, da, db in mm_cases:
            a, b = rand((m, k), da), rand((k, n), db)
            variant = kmm.matmul_variant(a, b)
            self.compare(f"matmul ({m}, {k}) {da} @ ({k}, {n}) {db} "
                         f"[{variant}]", "matmul", kmm.matmul_cuda(a, b),
                         kmm.matmul_plain(a, b))
        fa_cases = [  # q shape, kv length, causal, dtype
            *[(qs, qs[2], c, f32) for qs in ((1, 2, 128, 64), (2, 4, 100, 32),
                                             (1, 1, 257, 64))
              for c in (True, False)],
            ((1, 2, 64, 64), 96, True, f32), ((1, 2, 96, 64), 64, True, f32),
            ((2, 2, 1, 64), 70, True, f32), ((1, 3, 77, 16), 77, True, f32),
            ((1, 2, 130, 128), 200, True, f32),
            ((1, 2, 70, 256), 130, False, f32),
            ((1, 2, 70, 256), 70, True, f32),
            ((1, 2, 64, 64), 64, True, bf16),
            ((1, 4, 300, 64), 300, True, bf16),
            # bf16 edges of the wgmma variant (dh 64 and 128, B*H > 1 so a
            # read across a head boundary would show)
            *[(qs, sk, c, bf16) for qs, sk in
              (((2, 3, 300, 64), 300), ((2, 2, 64, 128), 96),
               ((2, 2, 96, 64), 64), ((2, 2, 1, 64), 70),
               ((1, 3, 1, 128), 300), ((1, 2, 4097, 64), 4097),
               ((2, 2, 300, 128), 300), ((1, 2, 4097, 128), 200),
               ((1, 2, 200, 128), 4097))
              for c in (True, False)],
            ((1, 2, 70, 256), 130, True, bf16)]
        for qs, sk, causal, dt in fa_cases:
            ks = qs[:2] + (sk, qs[3])
            q, k, v = rand(qs, dt), rand(ks, dt), rand(ks, dt)
            variant = kfa.attention_variant(q, k, v)
            self.compare(f"attention q{qs} sk={sk} causal={causal} {dt} "
                         f"[{variant}]", "flash_attention",
                         kfa.flash_attention_cuda(q, k, v, causal),
                         kfa.attention_plain(q, k, v, causal=causal))
        torch.cuda.synchronize()
        worst = {k: float(f"{self.worst[k]:.3e}")
                 for k in ("matmul", "flash_attention")}
        log(f"  all ok; worst max abs err {json.dumps(worst)}")

    def lm_weights(self, dtype):
        """Seeded random weights of one StableLM-2-1.6B layer (scaled by
        fan-in^-1/2, so activations stay O(1)) and a prefill's input."""
        torch = self.torch
        g = torch.Generator().manual_seed(SEED + 4)

        def rand(fan_in, *shape):
            return (torch.randn(shape, generator=g) * fan_in ** -0.5).to(
                self.dev, dtype)

        d, ff = LM_D, LM_FF
        return {"x": rand(1, LM_SEQ, d),
                **{n: rand(d, d, d) for n in ("wq", "wk", "wv", "wo")},
                "w_gate": rand(d, d, ff), "w_up": rand(d, d, ff),
                "w_down": rand(ff, ff, d)}

    def lm_layer(self, p, record):
        """One layer's kernel calls through ``repro_torch.kernels.ops``:
        q/k/v projections, causal MHA over 32 heads of 64, the output
        projection and the gated (SiLU) MLP.  ``record(label, name, args,
        out)`` sees each call."""
        torch = self.torch
        from repro_torch.kernels import ops

        s, h, dh = LM_SEQ, LM_HEADS, LM_HEAD_DIM

        def mm(label, a, b):
            out = ops.matmul(a, b)
            record(label, "matmul", (a, b), out)
            return out

        def heads(t):  # (S, D) -> (1, H, S, dh)
            return t.view(1, s, h, dh).transpose(1, 2).contiguous()

        x = p["x"]
        q, k, v = (heads(mm(f"{n} projection", x, p[w]))
                   for n, w in (("q", "wq"), ("k", "wk"), ("v", "wv")))
        a = ops.attention(q, k, v, causal=True)
        record("causal attention", "flash_attention", (q, k, v), a)
        mm("o projection", a.transpose(1, 2).reshape(s, LM_D), p["wo"])
        gate = mm("mlp gate", x, p["w_gate"])
        up = mm("mlp up", x, p["w_up"])
        mm("mlp down", torch.nn.functional.silu(gate) * up, p["w_down"])

    def phase_lm_main(self):
        torch = self.torch
        log(f"phase 7: kernels.ops at StableLM-2-1.6B width: d {LM_D}, "
            f"{LM_HEADS} heads x {LM_HEAD_DIM}, d_ff {LM_FF}, batch 1, "
            f"{LM_SEQ} tokens, one layer, fp32 and bf16")
        calls = []
        self.lm_launches = {"matmul": 0, "flash_attention": 0}
        for dtype in (torch.float32, torch.bfloat16):
            p = self.lm_weights(dtype)
            recorded = []
            self.reset_counts()
            with torch.no_grad():
                self.lm_layer(p, lambda *call: recorded.append(call))
            torch.cuda.synchronize()
            counts, variants = self.read_counts(), self.read_variants()
            log(f"  {dtype}: launches {counts}, by variant {variants}")
            if counts != LAUNCHES_PER_LM_LAYER:
                raise RuntimeError(f"launch counts {counts} != "
                                   f"{LAUNCHES_PER_LM_LAYER}")
            want = {name: {v: (LAUNCHES_PER_LM_LAYER[name]
                               if v == LM_VARIANT[str(dtype)] else 0)
                           for v in by_variant}
                    for name, by_variant in variants.items()}
            if variants != want:
                raise RuntimeError(f"{dtype} launches by variant {variants} "
                                   f"!= {want}")
            for name in self.lm_launches:
                self.lm_launches[name] += counts[name]
            for label, name, args, out in recorded:
                plain = self.lm_call(name, args)[1]
                self.compare(f"{label} {dtype} "
                             f"{[tuple(t.shape) for t in args]}",
                             name, out, plain())
                calls.append((label, name, dtype, args))
            del p, recorded
        return calls

    def phase_lm_times(self, calls):
        torch = self.torch
        log("phase 8: times of the StableLM-width calls (device ms, median "
            "of 3 rounds of 10 launches; plain 3 launches)")
        groups = {}  # (kernel, dtype, geometry) -> the timed calls
        with torch.no_grad():
            for label, name, dtype, args in calls:
                kern, plain, lib, flops, nbytes, geo, variant = self.lm_call(
                    name, args)
                peak = (PEAK_FP32_FLOPS if dtype == torch.float32
                        else PEAK_BF16_FLOPS)
                ops_ms = 1e3 * flops / peak
                bytes_ms = 1e3 * nbytes / PEAK_BYTES_S
                row = {"kernel": name, "call": label, "dtype": str(dtype),
                       "variant": variant, "geometry": geo, "flops": flops,
                       "bytes": nbytes,
                       "ms": self.device_ms(kern),
                       "plain_ms": self.device_ms(plain, reps=3),
                       "library_ms": self.device_ms(lib),
                       "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                       "bound_ms": max(ops_ms, bytes_ms),
                       "bound_by": ("operations" if ops_ms >= bytes_ms
                                    else "bytes")}
                self.report["lm_calls"].append(row)
                groups.setdefault((name, row["dtype"], geo), []).append(row)
                log(f"  {name} [{variant}] {label} {dtype} {geo}: "
                    f"{row['ms']:.3f} ms, "
                    f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
                    f"plain {row['plain_ms']:.3f} ms, library "
                    f"{row['library_ms']:.3f} ms, "
                    f"{flops / row['ms'] / 1e9:.1f} TFLOP/s")
        return self.summarise_lm_calls(groups)

    def lm_call(self, name, args):
        """(kernel, plain version, library yardstick, flops, bytes,
        geometry, variant) of one recorded StableLM-width call."""
        torch = self.torch
        kmm, kfa = self.kmm, self.kfa
        if name == "matmul":
            a, b = args
            m, k = a.shape
            n = b.shape[1]
            return (lambda: kmm.matmul_cuda(a, b),
                    lambda: kmm.matmul_plain(a, b),
                    lambda: torch.matmul(a, b),
                    2 * m * n * k,
                    (a.numel() + b.numel() + m * n) * a.element_size(),
                    f"({m}, {k}) @ ({k}, {n})", kmm.matmul_variant(a, b))
        q, k, v = args
        bsz, h, sq, dh = q.shape
        sk = k.shape[2]
        # unmasked (q, k) pairs of the top-left causal mask
        pairs = sum(min(i + 1, sk) for i in range(sq))
        return (lambda: kfa.flash_attention_cuda(q, k, v, True),
                lambda: kfa.attention_plain(q, k, v, causal=True),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True),
                4 * bsz * h * dh * pairs,
                2 * (q.numel() + k.numel()) * q.element_size(),
                f"q{tuple(q.shape)} k{tuple(k.shape)} causal",
                kfa.attention_variant(q, k, v))

    def summarise_lm_calls(self, groups):
        """From the timed calls grouped by (kernel, dtype, geometry): the
        mean per call shape, the sum per layer and dtype, and each kernel's
        entry of the kernels line (both dtypes' layers).  Logged and kept
        in the report."""
        keys = ("ms", "plain_ms", "bound_ms", "library_ms", "ops_ms",
                "bytes_ms")
        by_shape, by_layer = [], {}
        per = {name: dict.fromkeys(keys, 0.0) for name in self.lm_launches}
        for (name, dtype, geo), rows in groups.items():
            sums = {k: sum(r[k] for r in rows) for k in keys}
            mean = {k: v / len(rows) for k, v in sums.items()}
            variant = rows[0]["variant"]
            tflops = rows[0]["flops"] / mean["ms"] / 1e9
            by_shape.append({"kernel": name, "dtype": dtype, "geometry": geo,
                             "variant": variant, "calls": len(rows),
                             "tflops": tflops, **mean})
            log(f"  mean of {len(rows)} x {name} [{variant}] {dtype} {geo}: "
                + ", ".join(f"{k} {mean[k]:.3f}" for k in keys[:4])
                + f", {tflops:.1f} TFLOP/s")
            layer = by_layer.setdefault(
                (dtype, name), {"launches": 0, **dict.fromkeys(keys, 0.0)})
            layer["launches"] += len(rows)
            for k in keys:
                layer[k] += sums[k]
                per[name][k] += sums[k]
        for (dtype, name), layer in by_layer.items():
            log(f"  layer {dtype} {name} x{layer['launches']}: "
                + ", ".join(f"{k} {layer[k]:.3f}" for k in keys[:4]))
        self.report["lm_summary"] = {
            "by_shape": by_shape,
            "by_layer": [{"kernel": n, "dtype": d, **v}
                         for (d, n), v in by_layer.items()]}
        entries = []
        for name, p in per.items():
            log(f"  {name}: {p['ms']:.3f} ms over "
                f"{self.lm_launches[name]} launches (fp32 + bf16 layer); "
                f"bound {p['bound_ms']:.3f} ms; plain {p['plain_ms']:.3f} "
                f"ms; library {p['library_ms']:.3f} ms")
            entries.append({
                "name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1],
                "launches": self.lm_launches[name],
                "max_abs_err": self.worst[name], "ms": p["ms"],
                "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                "bound_by": ("operations" if p["ops_ms"] >= p["bytes_ms"]
                             else "bytes"),
                "library_ms": p["library_ms"]})
        return entries

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

    def variant(self, name, args):
        """The launch plan of a recorded call: its variant and tile width."""
        x, w = args[0], args[1]
        if name == "conv2d":
            plan = self.kconv.conv_plan(x.shape[-1], w.shape[-1], w.shape[0],
                                        w.shape[1], args[2])
        else:
            plan = self.ktr.tconv_plan(x.shape[-1], w.shape[-1], w.shape[0])
        return f"{plan.variant}/n{plan.bn}"

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
