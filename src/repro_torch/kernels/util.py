"""Shared helpers for the port's kernel package: dtype and device rules."""

from __future__ import annotations

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
    alias (``"fp32"``/``"float32"``/...).  This slice of the port is fp32
    only: bf16 and fp16 raise ``NotImplementedError`` until the bf16 slice
    of ROADMAP.md (queue 1) lands.
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
    if dtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype {dtype} is not ported yet: the port is fp32 only "
            f"until the bf16 slice of ROADMAP.md")
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
