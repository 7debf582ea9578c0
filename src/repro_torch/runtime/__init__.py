"""The training runtime (port of ``repro.runtime``): failure detection,
restart and straggler mitigation (``fault_tolerance``), elastic pod
counts (``elastic``) and the unified recovery API (``recovery``)."""

from repro_torch.runtime.fault_tolerance import (
    FailurePolicy,
    NodeHealth,
    RestartManager,
    StragglerMonitor,
    schedule_from_snapshots,
)
from repro_torch.runtime.recovery import (
    CheckpointRecovery,
    PartialRestoreError,
    RecoveryOutcome,
    StoreRecovery,
)
from repro_torch.runtime.elastic import rescale_stacked, rescale_train_state

__all__ = [
    "CheckpointRecovery",
    "FailurePolicy",
    "NodeHealth",
    "PartialRestoreError",
    "RecoveryOutcome",
    "RestartManager",
    "StoreRecovery",
    "StragglerMonitor",
    "schedule_from_snapshots",
    "rescale_stacked",
    "rescale_train_state",
]
