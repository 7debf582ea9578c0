"""Multi-pod training under a consistency policy (port of
``repro.train``)."""

from repro_torch.train.train_step import (
    TrainFns,
    TrainState,
    make_train_fns,
    split_batch_for_pods,
    stack_for_pods,
)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "TrainFns",
    "TrainState",
    "Trainer",
    "TrainerConfig",
    "make_train_fns",
    "split_batch_for_pods",
    "stack_for_pods",
]
