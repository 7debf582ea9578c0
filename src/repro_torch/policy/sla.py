"""Declarative SLAs (port of ``repro.policy.sla``, the dataclass and the
two canonical SLAs only).

The placement planner (``repro_torch.geo.placement``) reads an SLA's
``max_read_latency_ms``; the adaptive controller's per-level scorer,
which reads the other bounds, is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SLA:
    """Per-session service-level agreement (all bounds inclusive)."""

    name: str = "default"
    max_stale_read_rate: float = 1.0
    max_violation_rate: float = 1.0
    max_read_latency_ms: float = math.inf
    max_staleness_ms: float = math.inf


# STRICT keeps only the timed causal levels in play; RELAXED is bound by
# session-guarantee violations (both bound reads at 10 ms).
SLA_STRICT = SLA(
    "strict", max_stale_read_rate=0.20, max_violation_rate=0.02,
    max_read_latency_ms=10.0, max_staleness_ms=50.0,
)
SLA_RELAXED = SLA(
    "relaxed", max_stale_read_rate=0.55, max_violation_rate=0.06,
    max_read_latency_ms=10.0,
)
