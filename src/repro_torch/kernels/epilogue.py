"""Fused elementwise epilogues for the decomposition engine (DESIGN.md §7).

The port's counterpart of ``repro.kernels.epilogue``.  An
:class:`EpilogueSpec` says which ops run on the fp32 accumulator before the
output is stored, in this order::

    y = conv(x, w)                       # fp32 accumulator
    y = y * scale + shift                if spec.bn        (folded BN)
    y = y + residual                     if spec.residual == "pre_act"
    y = where(y >= 0, y, alpha * y)      if spec.prelu
    y = y + residual                     if spec.residual == "post_act"

``scale``/``shift`` are fp32 per-``Cout`` vectors, ``alpha`` a scalar or
per-channel fp32 slope, ``residual`` has the output's NHWC shape and dtype
(fp32 or bf16; it is widened to fp32 for the add).  Inside the
CUDA kernels the same ops run per output element in registers
(``csrc/epilogue.cuh::apply_epilogue``); :func:`apply_reference` is the
unfused plain version that the torch backend and the kernels' plain
versions apply after the conv.
"""

from __future__ import annotations

import dataclasses

import torch

#: residual placement values
_RESIDUAL = ("none", "pre_act", "post_act")


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Static description of a fused epilogue (hashable)."""

    bn: bool = False            # folded BN: y * scale + shift
    prelu: bool = False         # PReLU with learnable slope alpha
    residual: str = "none"      # "none" | "pre_act" | "post_act"

    def __post_init__(self):
        if self.residual not in _RESIDUAL:
            raise ValueError(f"residual must be one of {_RESIDUAL}, "
                             f"got {self.residual!r}")

    @property
    def empty(self) -> bool:
        return not (self.bn or self.prelu or self.residual != "none")

    @property
    def slots(self) -> tuple[str, ...]:
        """Operand slot names, in packing order."""
        out = []
        if self.bn:
            out += ["scale", "shift"]
        if self.prelu:
            out.append("alpha")
        if self.residual != "none":
            out.append("residual")
        return tuple(out)


NO_EPILOGUE = EpilogueSpec()


def fingerprint(spec: EpilogueSpec | None) -> str:
    """Compact tag of an epilogue configuration (``"none"`` when empty)."""
    if spec is None or spec.empty:
        return "none"
    return f"bn{int(spec.bn)}.pr{int(spec.prelu)}.res-{spec.residual}"


def pack_args(spec: EpilogueSpec, *, scale=None, shift=None, alpha=None,
              residual=None) -> tuple[torch.Tensor, ...]:
    """Collect the operand tensors a spec needs into its canonical tuple.

    Raises if a required operand is missing or a superfluous one is given.
    """
    given = {"scale": scale, "shift": shift, "alpha": alpha,
             "residual": residual}
    for name, v in given.items():
        if (name in spec.slots) != (v is not None):
            need = "requires" if name in spec.slots else "does not take"
            raise ValueError(f"epilogue {spec} {need} operand {name!r}")
    return tuple(given[name] for name in spec.slots)


def _chanvec(v, cout: int, device=None) -> torch.Tensor:
    """Broadcast a scalar/per-channel epilogue operand to a (cout,) vector."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if v.shape[0] not in (1, cout):
        raise ValueError(f"epilogue channel operand has {v.shape[0]} entries, "
                         f"expected 1 or {cout}")
    return v.expand(cout)


def apply_reference(spec: EpilogueSpec, z: torch.Tensor,
                    args: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Unfused plain version: the epilogue as torch ops on the conv output.

    Computes in fp32 and casts back to ``z.dtype``, as the kernels apply it
    on the fp32 accumulator before the store.
    """
    if spec.empty:
        return z
    it = iter(args)
    cout = z.shape[-1]
    y = z.to(torch.float32)
    if spec.bn:
        y = y * _chanvec(next(it), cout, z.device) \
            + _chanvec(next(it), cout, z.device)
    if spec.prelu:
        alpha = _chanvec(next(it), cout, z.device)
        if spec.residual == "pre_act":
            y = y + next(it).to(torch.float32)
        y = torch.where(y >= 0, y, alpha * y)
        if spec.residual == "post_act":
            y = y + next(it).to(torch.float32)
    elif spec.residual != "none":
        y = y + next(it).to(torch.float32)
    return y.to(z.dtype)


def kernel_operands(spec: EpilogueSpec, args: tuple[torch.Tensor, ...],
                    out_shape: tuple[int, ...], device: torch.device,
                    dtype: torch.dtype = torch.float32
                    ) -> dict[str, torch.Tensor | None]:
    """The epilogue operands as the CUDA kernels take them, for an output of
    ``out_shape`` and ``dtype`` (fp32 or bf16) on ``device``.

    Channel vectors become contiguous fp32 ``(cout,)`` tensors (a scalar
    slope is broadcast); the residual must have the output's dtype, device
    and exact shape, and is made contiguous.  Absent slots map to ``None``
    (a null pointer).
    """
    cout = out_shape[-1]
    ops = dict.fromkeys(("scale", "shift", "alpha", "residual"))
    for name, v in zip(spec.slots, args):
        if name == "residual":
            if tuple(v.shape) != tuple(out_shape):
                raise ValueError(f"residual shape {tuple(v.shape)} != output "
                                 f"{tuple(out_shape)}")
            if v.dtype != dtype or v.device != device:
                raise ValueError(f"residual must be {dtype} on {device}, got "
                                 f"{v.dtype} on {v.device}")
            ops[name] = v.contiguous()
        else:
            ops[name] = _chanvec(v, cout, device).contiguous()
    return ops


def operand_ptrs(ops: dict[str, torch.Tensor | None]) -> list[int | None]:
    """Device pointers of :func:`kernel_operands` in the kernels' argument
    order (scale, shift, alpha, residual); ``None`` passes a null pointer."""
    return [None if ops[k] is None else ops[k].data_ptr()
            for k in ("scale", "shift", "alpha", "residual")]


def residual_code(spec: EpilogueSpec) -> int:
    """The kernels' integer code for the residual placement."""
    return _RESIDUAL.index(spec.residual)


__all__ = ["EpilogueSpec", "NO_EPILOGUE", "pack_args", "apply_reference",
           "fingerprint", "kernel_operands", "operand_ptrs", "residual_code"]
