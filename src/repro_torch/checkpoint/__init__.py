"""Atomic manifest checkpoints of the port (``repro.checkpoint``)."""

from repro_torch.checkpoint.ckpt import (CheckpointFuture, all_steps,
                                         latest_step, load_extra, load_flat,
                                         save_checkpoint)

__all__ = ["save_checkpoint", "all_steps", "latest_step", "load_flat",
           "load_extra", "CheckpointFuture"]
