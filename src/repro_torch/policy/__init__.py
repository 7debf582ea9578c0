"""Service-level agreements (port of ``repro.policy``, the part the
placement planner reads)."""
