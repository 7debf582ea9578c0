"""X-STCC core on PyTorch (port of ``repro.core``).

Modules:
  vector_clock — Fidge/Mattern clock algebra.
  availability — FaultSchedule availability timelines (outages,
                 partitions, closure, heal detection).
  duot         — Distributed User Operations Table (bounded op log).
  audit        — eq. 1a–1d pair classification + violation detection.
  odg          — Operations Dependency Graph (Timed/Causal/Data edges).
  consistency  — ConsistencyLevel / ConsistencyPolicy.
  xstcc        — the protocol engine (sessions + timed-causal merge),
                 one op at a time and batched.
  replicated_store — the ReplicatedStore facade consumed by the
                 storage and serve layers.
  staleness    — Appendix A stale-read model (analytic + Monte-Carlo).
  cost_model   — Appendix B monetary cost model (Table 2 pricing).
"""

from repro_torch.core import (
    audit,
    availability,
    cost_model,
    duot,
    odg,
    replicated_store,
    staleness,
    vector_clock,
    xstcc,
)
from repro_torch.core.availability import FaultSchedule
from repro_torch.core.consistency import (
    PAPER_LEVELS,
    ConsistencyLevel,
    ConsistencyPolicy,
    policy_for,
)
from repro_torch.core.replicated_store import ReplicatedStore, StoreState

__all__ = [
    "audit",
    "availability",
    "FaultSchedule",
    "cost_model",
    "duot",
    "odg",
    "replicated_store",
    "staleness",
    "vector_clock",
    "xstcc",
    "ReplicatedStore",
    "StoreState",
    "ConsistencyLevel",
    "ConsistencyPolicy",
    "PAPER_LEVELS",
    "policy_for",
]
