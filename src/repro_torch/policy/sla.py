"""Declarative SLAs and the per-level feasibility/utility scorer (port of
``repro.policy.sla``).

The adaptive control plane chooses, per session, a consistency level
from {ONE, CAUSAL, TCC, X-STCC, QUORUM, ALL} that minimizes the monetary
cost of eq. 5-8 (``repro_torch.core.cost_model``) subject to an
:class:`SLA` on the stale-read rate, the violation rate, the read latency
and the age of served data.  Cost per op is analytic (:func:`level_table`);
staleness and violation rates are learned from windowed telemetry, and
cells with no telemetry are scored optimistically.  One call of
:func:`score_levels` scores the whole (sessions × levels) fleet through
``repro_torch.kernels.ops.policy_score``.

The placement planner (``repro_torch.geo.placement``) reads an SLA's
``max_read_latency_ms``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.core.cost_model import PAPER_PRICING, PricingScheme
from repro_torch.core.replicated_store import merge_cadence
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.fp import fma_f32
from repro_torch.kernels.policy_score import (  # noqa: F401
    INFEASIBLE_PENALTY,
    LVL_COLS,
    LVL_READ_COST,
    LVL_READ_LAT,
    LVL_REPAIR_COST,
    LVL_STALE_AGE,
    LVL_WRITE_COST,
    SP_COLS,
    SP_MAX_AGE,
    SP_MAX_LAT,
    SP_MAX_STALE,
    SP_MAX_VIOL,
    SP_READ_FRAC,
    SP_VALID,
    STRUCTURAL_WEIGHT,
    pack_sessions,
)
from repro_torch.storage.cluster import PAPER_CLUSTER, ClusterConfig

# The level set the control plane selects over, in ascending nominal
# cost order (ties broken by the analytic cost vectors at run time).
POLICY_LEVELS: tuple[ConsistencyLevel, ...] = (
    ConsistencyLevel.ONE,
    ConsistencyLevel.CAUSAL,
    ConsistencyLevel.TCC,
    ConsistencyLevel.X_STCC,
    ConsistencyLevel.QUORUM,
    ConsistencyLevel.ALL,
)


@dataclasses.dataclass(frozen=True)
class SLA:
    """Per-session service-level agreement (all bounds inclusive)."""

    name: str = "default"
    max_stale_read_rate: float = 1.0
    max_violation_rate: float = 1.0
    max_read_latency_ms: float = math.inf
    max_staleness_ms: float = math.inf


# STRICT keeps only the timed causal levels in play (and nothing at all
# during write storms, where the graded excess falls back to the
# least-violating level); RELAXED is bound by session-guarantee
# violations (both bound reads at 10 ms).
SLA_STRICT = SLA(
    "strict", max_stale_read_rate=0.20, max_violation_rate=0.02,
    max_read_latency_ms=10.0, max_staleness_ms=50.0,
)
SLA_RELAXED = SLA(
    "relaxed", max_stale_read_rate=0.55, max_violation_rate=0.06,
    max_read_latency_ms=10.0,
)


def sla_bounds(sla: SLA) -> tuple[float, float, float, float]:
    """The SLA's ``(max_stale, max_viol, max_lat, max_age)``, the bounds of
    the session-parameter columns ``SP_MAX_*``."""
    return (sla.max_stale_read_rate, sla.max_violation_rate,
            sla.max_read_latency_ms, sla.max_staleness_ms)


def session_params(
    sla: SLA,
    n_sessions: int,
    *,
    read_frac: torch.Tensor | float = 0.5,
    valid: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Pack one SLA (shared by the fleet) into the (S, SP_COLS) f32 array.

    ``read_frac`` may be per session (the session's recent op mix); it
    feeds the read/write blend of the analytic cost."""
    return pack_sessions(n_sessions, sla_bounds(sla), read_frac=read_frac,
                         valid=valid, device=resolve_device(device))


def _instance_cost_per_work(cfg: ClusterConfig, pricing: PricingScheme) -> float:
    """$ per unit of server work (one op's service cost on one node)."""
    return pricing.compute_unit_per_hour / 3600.0 / cfg.node_service_rate_ops_s


def level_table(
    levels: tuple[ConsistencyLevel, ...] = POLICY_LEVELS,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: PricingScheme = PAPER_PRICING,
    *,
    merge_every: int = 8,
    delta: int = 24,
    ms_per_op: float | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Analytic per-level table, packed as (LVL_COLS, L) float32.

    Rows: ``LVL_READ_COST`` ($ per read: I/O for the consulted replicas,
    inter-DC fan-out beyond the local DC, service work),
    ``LVL_WRITE_COST`` ($ per write: propagation to the 8 remote replicas
    plus the causal levels' clock piggyback, per-ack I/O, coordination
    work), ``LVL_REPAIR_COST`` ($ per stale read: read-repair traffic and
    work), ``LVL_READ_LAT`` (ms, from the topology) and ``LVL_STALE_AGE``
    (the level's data-age bound in ms: 0 for synchronous levels, Δ ops ×
    ``ms_per_op`` for timed levels, ∞ for untimed causal propagation).
    Each cell is computed in Python floats and stored once as f32.
    Inter-DC bytes are priced at the marginal rate at zero volume (the
    first tier of a tiered scheme)."""
    # Deferred: storage.simulator imports this module for adaptive mode.
    from repro_torch.storage.simulator import REPAIR_COST, REPAIR_REMOTE, WRITE_COORD

    if ms_per_op is None:
        ms_per_op = 1e3 / cfg.node_service_rate_ops_s
    inter_gb = pricing.marginal_inter_dc_per_gb()
    intra_gb = pricing.intra_dc_per_gb
    io = pricing.storage_per_million_requests / 1e6
    inst = _instance_cost_per_work(cfg, pricing)
    row = cfg.row_bytes

    tab = torch.zeros((LVL_COLS, len(levels)), dtype=torch.float32)
    for j, lv in enumerate(levels):
        acks = lv.write_acks(cfg.replication_factor)
        consulted = lv.read_replicas(cfg.replication_factor)
        remote_reads = max(0, consulted - cfg.replicas_per_dc)
        local_reads = min(consulted, cfg.replicas_per_dc)

        w_inter = 8 * row + (8 * 64 if lv.is_causal else 0)
        w_intra = 3 * row + (3 * 64 if lv.is_causal else 0)
        write_cost = (
            w_inter / 1e9 * inter_gb
            + w_intra / 1e9 * intra_gb
            + acks * io
            + (1.0 + WRITE_COORD[lv]) * inst
        )
        read_cost = (
            remote_reads * row / 1e9 * inter_gb
            + local_reads * row / 1e9 * intra_gb
            + consulted * io
            + 1.0 * inst
        )
        repair_cost = (
            REPAIR_REMOTE[lv] * row / 1e9 * inter_gb
            + REPAIR_COST[lv] * inst
        )
        sync_every, d = merge_cadence(lv, merge_every, delta)
        if sync_every == 1:
            stale_age = 0.0
        elif lv.is_timed:
            stale_age = d * ms_per_op
        else:
            stale_age = math.inf

        tab[LVL_READ_COST, j] = read_cost
        tab[LVL_WRITE_COST, j] = write_cost
        tab[LVL_REPAIR_COST, j] = repair_cost
        tab[LVL_READ_LAT, j] = cfg.read_latency_ms(consulted)
        tab[LVL_STALE_AGE, j] = stale_age
    return tab.to(resolve_device(device))


def epoch_cost(
    table: torch.Tensor,
    level_idx: torch.Tensor,
    *,
    reads: torch.Tensor,
    writes: torch.Tensor,
    stale: torch.Tensor,
) -> torch.Tensor:
    """Realized $ of one epoch per session, given each session's level.

    ``level_idx``/``reads``/``writes``/``stale`` are (S,) tensors.  The
    contract is the reference's ``reads·read + stale·repair +
    writes·write`` under ``jit``, where XLA fuses the two outer
    multiply-adds: ``fma(writes, write, fma(reads, read, stale·repair))``.
    """
    li = level_idx.long()
    f = torch.float32
    return fma_f32(
        writes.to(f), table[LVL_WRITE_COST, li],
        fma_f32(reads.to(f), table[LVL_READ_COST, li],
                stale.to(f) * table[LVL_REPAIR_COST, li]),
    )


def score_levels(
    sess: torch.Tensor,    # (S, SP_COLS) f32 — session_params()
    table: torch.Tensor,   # (LVL_COLS, L) f32 — level_table()
    stale: torch.Tensor,   # (S, L) f32 — windowed stale-read rate
    viol: torch.Tensor,    # (S, L) f32 — windowed violation rate
    count: torch.Tensor,   # (S, L) f32 — telemetry samples (0 = unobserved)
    *,
    impl: str | None = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(utility, feasible) over the (sessions × levels) fleet.

    ``argmax(utility, 1)`` is the controller's greedy arm: the cheapest
    SLA-feasible level (unobserved cells optimistic), falling back to the
    least-violating level when nothing is feasible.  ``impl`` is the
    ``ops.policy_score`` dispatch: the kernel on the card, the plain
    version on the CPU."""
    return kernel_ops.policy_score(sess, table, stale, viol, count, impl=impl)
