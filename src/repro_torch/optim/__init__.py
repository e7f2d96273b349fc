"""Optimizer, schedules and loss scaling of the port (``repro.optim``)."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.loss_scale import (DynamicLossScale, LossScaleState,
                                          select_tree)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "DynamicLossScale", "LossScaleState", "select_tree",
           "cosine_schedule", "linear_warmup"]
