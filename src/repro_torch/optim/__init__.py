"""Optimizers and learning-rate schedules of the port (``repro.optim``)."""
from repro_torch.optim.adamw import (
    SGD, AdamW, AdamWState, clip_by_global_norm, global_norm,
)
from repro_torch.optim.schedules import constant, step_decay, warmup_cosine

__all__ = [
    "AdamW", "AdamWState", "SGD", "clip_by_global_norm", "global_norm",
    "constant", "step_decay", "warmup_cosine",
]
