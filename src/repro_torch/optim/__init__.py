"""Optimizers and learning-rate schedules (reference: ``repro/optim``)."""
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          clip_by_global_norm, pick_optimizer)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["Optimizer", "adamw", "adafactor", "clip_by_global_norm",
           "pick_optimizer", "cosine_schedule", "linear_warmup"]
