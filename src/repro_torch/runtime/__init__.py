"""The runtime's unified recovery API (port of ``repro.runtime``, its
``recovery`` module).  ``elastic`` and ``fault_tolerance`` come with the
training runtime."""

from repro_torch.runtime.recovery import (
    CheckpointRecovery,
    PartialRestoreError,
    RecoveryOutcome,
    StoreRecovery,
)

__all__ = [
    "CheckpointRecovery",
    "PartialRestoreError",
    "RecoveryOutcome",
    "StoreRecovery",
]
