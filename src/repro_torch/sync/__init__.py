"""Policy-driven parameter sync across pods (port of ``repro.sync``)."""

from repro_torch.sync.engine import SyncEngine, SyncState
from repro_torch.sync import compression

__all__ = ["SyncEngine", "SyncState", "compression"]
