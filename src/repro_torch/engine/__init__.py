"""Unified epoch engine (port of ``repro.engine``): one replay loop for
every replay entry point, ``EpochEngine(EngineConfig(...)).run(workload)``.

``jit_entries`` and ``unified_runner`` hold the reference's compiled XLA
programs and have no counterpart here; ``obs.trace.traced_run`` records a
replay's kernel launches in place of its ``jit_entries``.
"""

from repro_torch.engine.config import EngineConfig
from repro_torch.engine.replay import EpochEngine, session_telemetry_runner
from repro_torch.engine.stream import (
    OP_COLS, attach_clients, batch_inputs, cadence_plan, clamp_apply_idx,
    fault_epoch_inputs, op_stream, op_stream_phased,
)

__all__ = [
    "EngineConfig",
    "EpochEngine",
    "OP_COLS",
    "attach_clients",
    "batch_inputs",
    "cadence_plan",
    "clamp_apply_idx",
    "fault_epoch_inputs",
    "op_stream",
    "op_stream_phased",
    "session_telemetry_runner",
]
