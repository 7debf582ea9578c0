"""Auditing strategy — paper §3.3 and the five-phase flowchart (§3.4)
(port of ``repro.core.audit``).

Every ordered pair of live DUOT operations ``(o1, o2)`` with
``T(o1) < T(o2)`` on the same resource is classified (paper eq. 1a–1d):

  same client, o1 -> o2:   a1 R,R (MR)   a2 W,W (MW)
                           a3 W,R (RYW)  a4 R,W (WFR)
  different clients, o1 -> o2:  b1 timed causal (TCC)
  no happens-before:            b2 concurrent (never a violation)

plus the timed bound: a (write, later read) pair more than Δ timestamps
apart whose read missed the write.  The O(m²·n) pairwise pass runs in
the CUDA kernel ``kernels/vclock_audit`` for CUDA tensors, or as the
dense plain path on the CPU; both give the same result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import vector_clock as vclock
from repro_torch.core.duot import Duot, READ, WRITE
from repro_torch.kernels import ops as kernel_ops

PHASE_NONE = 0
PHASE_A1_MR = 1
PHASE_A2_MW = 2
PHASE_A3_RYW = 3
PHASE_A4_WFR = 4
PHASE_B1_TCC = 5
PHASE_B2_CONCURRENT = 6

PHASE_NAMES = {
    PHASE_NONE: "none",
    PHASE_A1_MR: "a1:monotonic-read",
    PHASE_A2_MW: "a2:monotonic-write",
    PHASE_A3_RYW: "a3:read-your-write",
    PHASE_A4_WFR: "a4:write-follows-read",
    PHASE_B1_TCC: "b1:timed-causal",
    PHASE_B2_CONCURRENT: "b2:concurrent",
}

# ODG edge-kind weights for severity (paper §3.4.1: Timed, Causal, Data).
WEIGHT_TIMED = 1
WEIGHT_CAUSAL = 2
WEIGHT_DATA = 3


class AuditResult(NamedTuple):
    """Dense audit output over an m-entry log."""

    phase: torch.Tensor         # (m, m) int32 — phase code for pair (i, j)
    violation: torch.Tensor     # (m, m) bool — pair (i, j) violates its guarantee
    vio_kind: torch.Tensor      # (m, m) int32 — phase code of the violated rule
    timed_vio: torch.Tensor     # (m, m) bool — Δ-bound exceeded
    n_audited: torch.Tensor     # () int32 — pairs classified (phase != NONE)
    n_violations: torch.Tensor  # () int32
    severity: torch.Tensor      # () float32 — weighted severity in [0, 1]


def classify_pairs(table: Duot, hb: torch.Tensor | None = None) -> torch.Tensor:
    """Phase classification matrix (paper Fig. 4), no violation check."""
    m = table.capacity
    valid = table.valid
    pair_valid = valid[:, None] & valid[None, :]
    same_res = table.resource[:, None] == table.resource[None, :]
    ordered = table.seq[:, None] < table.seq[None, :]
    same_client = table.client[:, None] == table.client[None, :]
    if hb is None:
        hb = vclock.happens_before_matrix(table.vc)

    base = pair_valid & same_res & ordered
    ki = table.kind[:, None]
    kj = table.kind[None, :]

    phase = torch.zeros((m, m), dtype=torch.int32, device=table.vc.device)
    sc_hb = base & same_client & hb
    phase = torch.where(sc_hb & (ki == READ) & (kj == READ), PHASE_A1_MR, phase)
    phase = torch.where(sc_hb & (ki == WRITE) & (kj == WRITE), PHASE_A2_MW, phase)
    phase = torch.where(sc_hb & (ki == WRITE) & (kj == READ), PHASE_A3_RYW, phase)
    phase = torch.where(sc_hb & (ki == READ) & (kj == WRITE), PHASE_A4_WFR, phase)
    phase = torch.where(base & ~same_client & hb, PHASE_B1_TCC, phase)
    phase = torch.where(base & ~hb, PHASE_B2_CONCURRENT, phase)
    return phase


def audit(table: Duot, *, delta: int = 0, impl: str | None = "auto") -> AuditResult:
    """Full audit: classify every pair and flag violations.

    ``delta`` is the timed bound Δ in ``seq`` units (0 disables the
    timed check).  ``impl`` picks the pairwise pass as in
    ``kernels.ops``: ``"auto"`` runs the CUDA kernel for CUDA tensors
    and the dense plain path for CPU tensors.
    """
    delta = int(delta)
    if kernel_ops.resolve_impl(impl, table.vc) == "cuda":
        return _audit_from_codes(table, delta, impl="cuda")
    hb = vclock.happens_before_matrix(table.vc)
    phase = classify_pairs(table, hb)
    vi = table.version[:, None]
    vj = table.version[None, :]
    ki = table.kind[:, None]
    kj = table.kind[None, :]

    viol = (
        ((phase == PHASE_A1_MR) & (vj < vi))
        | ((phase == PHASE_A2_MW) & (vj <= vi))
        | ((phase == PHASE_A3_RYW) & (vj < vi))
        | ((phase == PHASE_A4_WFR) & (vj <= vi))
        # b1: a causally-later read must observe causally-earlier writes.
        | ((phase == PHASE_B1_TCC) & (ki == WRITE) & (kj == READ) & (vj < vi))
    )
    # Timed bound: any (write, later read) on the same resource separated
    # by more than Δ timestamps must be visible regardless of causality.
    gap = table.seq[None, :] - table.seq[:, None]
    timed_vio = (
        (phase != PHASE_NONE) & (ki == WRITE) & (kj == READ)
        & (gap > delta) & (vj < vi)
    ) if delta > 0 else torch.zeros_like(viol)
    return _assemble_result(table, phase, viol, timed_vio)


def _assemble_result(
    table: Duot, phase: torch.Tensor, viol: torch.Tensor, timed_vio: torch.Tensor
) -> AuditResult:
    """Counts + ODG-weighted severity from the per-pair flags.

    Severity (paper §3.4.1): violated ODG edges weighted by kind over all
    audited edges.  Data edges: (write, later read) pairs on one
    resource; Causal edges: happens-before pairs; Timed edges: the
    remaining ordered same-resource pairs.

    The weights are small integers, so both weighted sums are taken
    exactly in int64 and divided once in float32.  The reference sums
    float32 weights, which is exact while each sum stays below 2**24 —
    there the two agree bit for bit; beyond it the reference rounds its
    partial sums and this does not.
    """
    vio_kind = torch.where(viol, phase, PHASE_NONE).to(torch.int32)
    n_audited = (phase != PHASE_NONE).sum(dtype=torch.int32)
    n_violations = viol.sum(dtype=torch.int32) + timed_vio.sum(dtype=torch.int32)

    base = phase != PHASE_NONE
    causal_edge = (phase >= PHASE_A1_MR) & (phase <= PHASE_B1_TCC)
    ki = table.kind[:, None]
    kj = table.kind[None, :]
    data_edge = base & (ki == WRITE) & (kj == READ)
    other = ~causal_edge & ~data_edge

    def count(mask):
        return mask.sum(dtype=torch.int64)

    w = (
        WEIGHT_DATA * count(viol & data_edge)
        + WEIGHT_CAUSAL * count(viol & causal_edge & ~data_edge)
        + WEIGHT_TIMED * count((viol | timed_vio) & other)
    )
    denom = (
        WEIGHT_DATA * count(data_edge)
        + WEIGHT_CAUSAL * count(causal_edge & ~data_edge)
        + WEIGHT_TIMED * count(base & other)
    )
    severity = w.to(torch.float32) / denom.to(torch.float32).clamp_min(1.0)
    return AuditResult(
        phase=phase,
        violation=viol,
        vio_kind=vio_kind,
        timed_vio=timed_vio,
        n_audited=n_audited,
        n_violations=n_violations,
        severity=severity,
    )


def _audit_from_codes(table: Duot, delta: int, impl: str | None = "auto") -> AuditResult:
    """Rebuild an :class:`AuditResult` from the packed audit codes
    (``phase | violation << 8 | timed << 9``)."""
    codes = kernel_ops.audit_duot(table, delta=delta, impl=impl)
    phase = codes & 0xFF
    viol = ((codes >> 8) & 1).to(torch.bool)
    timed_vio = ((codes >> 9) & 1).to(torch.bool)
    return _assemble_result(table, phase, viol, timed_vio)


def session_guarantee_report(result: AuditResult) -> dict[str, torch.Tensor]:
    """Per-guarantee violation counts (for Figs 12–13 style reporting)."""
    out = {}
    for code, name in [
        (PHASE_A1_MR, "monotonic_read"),
        (PHASE_A2_MW, "monotonic_write"),
        (PHASE_A3_RYW, "read_your_write"),
        (PHASE_A4_WFR, "write_follows_read"),
        (PHASE_B1_TCC, "timed_causal"),
    ]:
        out[name] = (result.vio_kind == code).sum(dtype=torch.int32)
    out["timed_bound"] = result.timed_vio.sum(dtype=torch.int32)
    return out
