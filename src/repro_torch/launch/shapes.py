"""Assigned input-shape cells and their abstract input specs.

The port of ``repro.launch.shapes``.  Every (architecture x shape) pair is
a *cell*; :func:`input_specs` returns the step's inputs as ``meta``
tensors of the right shapes and dtypes (no allocation), where the
reference returns ``jax.ShapeDtypeStruct`` stand-ins:

* ``train_4k``    -> train step   (tokens/labels/mask)
* ``prefill_32k`` -> prefill step (tokens -> logits + caches)
* ``decode_32k``  -> serve step   (1 new token, KV cache of seq_len)
* ``long_500k``   -> serve step   (sub-quadratic archs only)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.util import canon_dtype
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(supported, reason if not), as the reference decides it."""
    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention config: a 500k dense KV per layer "
                       "has no published sparsity mechanism for this arch")
    if cell.kind == "decode" and not cfg.decode_supported:
        return False, "encoder-only architecture has no decode step"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """The cell's model inputs as ``meta`` tensors."""
    cell = SHAPES[shape]
    b, s = cell.global_batch, cell.seq_len
    frames = (b, cfg.encoder_ctx, cfg.d_model)
    if cell.kind == "train":
        specs = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32),
                 "mask": _meta((b, s), torch.float32)}
        if cfg.encoder_layers:  # stub modality frontend: frame embeddings
            specs["frames"] = _meta(frames, torch.float32)
        return specs
    if cell.kind == "prefill":
        specs = {"tokens": _meta((b, s), torch.int32)}
        if cfg.encoder_layers:
            specs["frames"] = _meta(frames, torch.float32)
        return specs
    # decode: one new token against a seq_len KV cache
    specs = {"token": _meta((b, 1), torch.int32),
             "cache_pos": _meta((), torch.int32)}
    if cfg.encoder_layers:
        specs["enc_out"] = _meta(frames, canon_dtype(cfg.dtype))
    return specs


__all__ = ["ShapeCell", "SHAPES", "cell_supported", "input_specs"]
