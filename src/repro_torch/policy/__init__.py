"""The adaptive control plane (port of ``repro.policy``): declarative
SLAs and the per-level scorer (``policy.sla``), and the ε-greedy
consistency-level and gossip-cadence controllers (``policy.controller``)."""

from repro_torch.policy.controller import (  # noqa: F401
    AdaptiveController,
    CadenceController,
    CadenceState,
    ControllerState,
)
from repro_torch.policy.sla import (  # noqa: F401
    POLICY_LEVELS,
    SLA,
    SLA_RELAXED,
    SLA_STRICT,
    epoch_cost,
    level_table,
    score_levels,
    session_params,
)
