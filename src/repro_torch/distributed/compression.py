"""Gradient compression and the fixed-order all-reduce of the data axis.

The port of ``repro.distributed.compression``, over flat ``{name: tensor}``
dicts where the reference maps pytrees:

* ``bf16``: fp32 gradients cast to bf16 for the wire (2x smaller);
* ``int8``: per-tensor symmetric int8 with error feedback: the
  quantization residual is kept and added to the next step's gradient;
* :func:`pack_int8` / :func:`unpack_int8`: a quantized dict as ONE int8
  buffer, each leaf padded to a multiple of ``word`` bytes, with a
  manifest that restores it exactly (scalar and empty leaves included);
* :func:`mesh_allreduce`: the sum of per-chunk gradient stacks over a
  process group in ONE fixed order, whatever the group's size.

Each rank holds a ``(C_local, ...)`` stack of per-chunk gradients;
:func:`mesh_allreduce` all-gathers the stacks in rank order into the
whole ``(C, ...)`` stack and reduces it with one ``torch.sum(dim=0)``.
The reduction runs over the same stack on every world size, so its
roundings are the same: a sharded step is bitwise the 1-rank step (a
ring all-reduce regroups the sum with the world size and is not).  With
``transport="bf16"`` the stacks are cast before the gather and widened
to fp32 before the sum.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.collectives import all_gather_cat

#: gradient wire formats of :func:`mesh_allreduce`
TRANSPORTS = ("dense", "bf16")


def compress_bf16(grads: dict) -> dict:
    return {k: g.to(torch.bfloat16) for k, g in grads.items()}


def decompress_bf16(grads: dict) -> dict:
    return {k: g.to(torch.float32) for k, g in grads.items()}


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 scale): ``max|g| / 127``, at least 1e-12 / 127;
    an empty ``g`` takes the floor (the reference's ``initial=0.0``)."""
    g = g.to(torch.float32)
    top = g.abs().max() if g.numel() else g.new_zeros(())
    scale = torch.clamp_min(top, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_int8_ef(grads: dict, errors: dict):
    """Returns (q dict, scale dict, new error-feedback dict)."""
    qs, scales, new_es = {}, {}, {}
    for k, g in grads.items():
        g = g.to(torch.float32) + errors[k]
        q, scale = quantize_int8(g)
        qs[k], scales[k] = q, scale
        new_es[k] = g - dequantize_int8(q, scale)
    return qs, scales, new_es


def decompress_int8(q_tree: dict, scale_tree: dict) -> dict:
    return {k: dequantize_int8(q, scale_tree[k]) for k, q in q_tree.items()}


def pack_int8(q_tree: dict, *, word: int = 4):
    """Flatten an int8 dict into one padded wire buffer.

    Each leaf is raveled and zero-padded to a multiple of ``word`` bytes,
    in the sorted order of the names (the reference's dict flattening);
    the manifest records each leaf's name, shape, offset and true length.
    Returns ``(buffer, manifest)``."""
    if word < 1:
        raise ValueError(f"word must be >= 1, got {word}")
    chunks, entries, off = [], [], 0
    device = None
    for k in sorted(q_tree):
        leaf = q_tree[k]
        flat = leaf.reshape(-1).to(torch.int8)
        device = flat.device
        padded = flat.numel() + (-flat.numel() % word)
        chunks.append(torch.cat([flat, flat.new_zeros(padded - flat.numel())]))
        entries.append((k, tuple(leaf.shape), off, flat.numel()))
        off += padded
    buf = (torch.cat(chunks) if chunks
           else torch.zeros((0,), dtype=torch.int8, device=device))
    return buf, tuple(entries)


def unpack_int8(buf: torch.Tensor, manifest) -> dict:
    """Inverse of :func:`pack_int8`."""
    return {k: buf[off:off + size].reshape(shape)
            for k, shape, off, size in manifest}


def mesh_allreduce(grads: dict, group, *, transport: str = "dense") -> dict:
    """Fixed-order all-reduce of per-chunk gradient stacks.

    Every leaf of ``grads`` carries a leading axis of this rank's chunks
    ``(C_local, ...)``.  The stacks are all-gathered in rank order (so the
    gathered ``(C, ...)`` stack is in chunk order when each rank holds a
    contiguous run of chunks) and reduced by one ``torch.sum(dim=0)``.
    ``transport="bf16"`` casts the stacks to bf16 before the gather and
    back to fp32 before the sum.  ``group`` is a ``torch.distributed``
    group (``None``: the world).
    """
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; known: "
                         f"{TRANSPORTS}")
    if transport == "bf16":
        grads = compress_bf16(grads)
    gathered = {k: all_gather_cat(g, group) for k, g in grads.items()}
    if transport == "bf16":
        gathered = decompress_bf16(gathered)
    return {k: torch.sum(g, dim=0) for k, g in gathered.items()}


__all__ = ["TRANSPORTS", "compress_bf16", "decompress_bf16", "quantize_int8",
           "dequantize_int8", "init_error_feedback", "compress_int8_ef",
           "decompress_int8", "pack_int8", "unpack_int8", "mesh_allreduce"]
