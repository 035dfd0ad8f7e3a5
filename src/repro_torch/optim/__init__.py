"""Optimizers (functional ``init/update`` pairs over parameter trees)."""

from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    sgd,
)

__all__ = ["Optimizer", "adafactor", "adam", "adamw", "apply_updates", "clip_by_global_norm", "sgd"]
