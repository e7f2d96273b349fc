"""Atomic manifest checkpoints of the port (``repro.checkpoint``)."""

from repro_torch.checkpoint.ckpt import (CheckpointFuture, all_steps,
                                         flatten_tree, latest_step,
                                         load_extra, load_flat,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "flatten_tree",
           "all_steps", "latest_step", "load_flat", "load_extra",
           "CheckpointFuture"]
