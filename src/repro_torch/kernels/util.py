"""Shared helpers for the port's kernel package: dtype and device rules,
the device kind that names calibration keys and plan tables, and the timer
of the autotune sweep and the calibration capture."""

from __future__ import annotations

import time

import torch

#: accepted spellings of the compute dtypes the JAX package names
_DTYPE_ALIASES = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "fp32": "float32", "f32": "float32", "float32": "float32",
    "fp16": "float16", "f16": "float16", "float16": "float16",
}


def canon_dtype(compute_dtype) -> torch.dtype | None:
    """Canonicalise a ``compute_dtype`` argument to a torch dtype (or None).

    Accepts ``None`` (keep the input dtype), a ``torch.dtype`` or a string
    alias (``"bf16"``/``"bfloat16"``/``"fp32"``/...), as the reference's
    ``repro.kernels.util.canon_dtype`` does.  fp32 and bf16 are ported;
    fp16 raises ``NotImplementedError`` (still to port, ROADMAP.md).
    """
    if compute_dtype is None:
        return None
    if isinstance(compute_dtype, str):
        alias = _DTYPE_ALIASES.get(compute_dtype.lower())
        if alias is None:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                             f"known: {sorted(set(_DTYPE_ALIASES))}")
        dtype = getattr(torch, alias)
    elif isinstance(compute_dtype, torch.dtype):
        dtype = compute_dtype
    else:
        raise ValueError(f"compute_dtype must be None, a string alias or a "
                         f"torch.dtype, got {compute_dtype!r}")
    if dtype not in DTYPE_CODES:
        raise NotImplementedError(
            f"compute_dtype {dtype} is not ported: the port computes in "
            f"float32 or bfloat16 (fp16 is still to port, ROADMAP.md)")
    return dtype


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for CPU.

    ``None`` means ``"cuda"``.  A CUDA device without a usable card raises:
    an entry point never moves itself to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


#: element types of the kernels, by their C dtype code (``csrc/element.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    """The kernels' code for ``t``'s dtype; raises on an unsupported one."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} is not supported; use "
                        f"float32 or bfloat16")
    return code


def check_device(what: str, *ts: torch.Tensor) -> None:
    """All tensors on one CPU or CUDA device, and no gradient requested."""
    dev = ts[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if any(t.device != dev for t in ts):
        raise ValueError(f"{what}: operands on different devices "
                         f"{[str(t.device) for t in ts]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{what}: the kernel wrapper is forward only (run under "
            f"torch.no_grad(), or differentiate through its autograd "
            f"Function)")


def device_kind(device=None) -> str:
    """The device kind of a calibration key and of a plan table: the
    card's name, sanitised (``NVIDIA H100 80GB HBM3`` ->
    ``NVIDIA_H100_80GB_HBM3``), for a CUDA device, ``"cpu"`` for the CPU.  ``None`` is this host's device: the
    current card when there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    kind = torch.cuda.get_device_name(device)
    return "".join(c if c.isalnum() else "_" for c in kind)


def time_call(fn, *args, iters: int = 5, warmup: int = 1, device=None,
              device_only: bool = False) -> float:
    """Best-of-``iters`` time (seconds) of ``fn(*args)``, the port of
    ``repro.kernels.util.time_call``: the single timer of the autotune
    sweep and the calibration capture.

    ``device`` is where ``fn`` runs (default: the device of the first tensor
    in ``args``, else the CPU).  On a CUDA device each run is bracketed by
    CUDA events and ends in ``torch.cuda.synchronize()`` inside the timed
    region: PyTorch returns before the card is done, so a host clock around
    the call alone would time the enqueue.  The events then span the host's
    enqueue of the call and the device's work.  ``device_only=True`` first
    holds the stream with a spin kernel while the host enqueues, so the
    events bracket the device's work alone (a kernel's time, as the autotune
    sweep wants it).  On the CPU each run is timed by the host clock.
    ``warmup`` untimed runs come first (a kernel library's first load); the
    estimator is the minimum, the stable one on a shared host.
    """
    if device is None:
        device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                      torch.device("cpu"))
    cuda = torch.device(device).type == "cuda"
    for _ in range(max(warmup, 0)):
        fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(max(iters, 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if device_only:
                torch.cuda._sleep(_SPIN_CYCLES)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize(device)
            best = min(best, start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
    return best


#: cycles of the spin kernel that holds the stream while the host enqueues a
#: ``device_only`` run (about 1 ms at the H100's 1.98 GHz boost clock)
_SPIN_CYCLES = 2_000_000
