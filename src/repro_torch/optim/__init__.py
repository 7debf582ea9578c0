"""Optimizers (port of ``repro.optim``)."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    apply,
    clip_by_global_norm,
    global_norm,
    init,
    schedule,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "apply",
    "clip_by_global_norm",
    "global_norm",
    "init",
    "schedule",
]
