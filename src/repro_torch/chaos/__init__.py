"""Seeded chaos harness (port of ``repro.chaos``): nemesis schedules
(:mod:`~repro_torch.chaos.nemesis`), causal-invariant checks
(:mod:`~repro_torch.chaos.invariants`) and bit-exact convergence to the
never-crashed twin (:mod:`~repro_torch.chaos.harness`)."""

from repro_torch.chaos.harness import DEFAULT_RECOVERY, run_chaos, run_chaos_suite
from repro_torch.chaos.invariants import check_invariants
from repro_torch.chaos.nemesis import random_gossip, random_schedule

__all__ = [
    "DEFAULT_RECOVERY",
    "check_invariants",
    "random_gossip",
    "random_schedule",
    "run_chaos",
    "run_chaos_suite",
]
