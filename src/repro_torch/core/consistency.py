"""Consistency levels and policies (port of ``repro.core.consistency``).

A :class:`ConsistencyPolicy` is the configuration consumed by
``repro_torch.sync.engine`` (parameter sync across pods during training)
and ``repro_torch.checkpoint.store`` (replicated checkpoints).

Semantics (write path, R = replication factor):

  ONE      ack after 1 replica; propagation is asynchronous gossip.
  TWO      ack after 2 replicas.
  QUORUM   ack after floor(R/2)+1 replicas.
  ALL      ack after all R replicas (synchronous everywhere).
  CAUSAL   ack after 1; remote apply is gated on causal dependencies
           (vector clocks), unbounded propagation time.
  TCC      CAUSAL + the timed bound: propagation must complete within Δ.
  X_STCC   TCC at the server side + the four session guarantees (MR,
           RYW, MW, WFR) enforced at the client side (the paper's model).
"""

from __future__ import annotations

import dataclasses
import enum


class ConsistencyLevel(enum.Enum):
    ONE = "ONE"
    TWO = "TWO"
    QUORUM = "QUORUM"
    ALL = "ALL"
    CAUSAL = "CAUSAL"
    TCC = "TCC"
    X_STCC = "X_STCC"

    @property
    def is_session_guarded(self) -> bool:
        return self is ConsistencyLevel.X_STCC

    @property
    def is_causal(self) -> bool:
        return self in (
            ConsistencyLevel.CAUSAL,
            ConsistencyLevel.TCC,
            ConsistencyLevel.X_STCC,
        )

    @property
    def is_timed(self) -> bool:
        return self in (ConsistencyLevel.TCC, ConsistencyLevel.X_STCC)

    def write_acks(self, replication_factor: int) -> int:
        """Replicas that must acknowledge a write before it commits."""
        if self is ConsistencyLevel.ONE:
            return 1
        if self is ConsistencyLevel.TWO:
            return min(2, replication_factor)
        if self is ConsistencyLevel.QUORUM:
            return replication_factor // 2 + 1
        if self is ConsistencyLevel.ALL:
            return replication_factor
        # Causal-family levels commit locally and order remotely.
        return 1

    def read_replicas(self, replication_factor: int) -> int:
        """Replicas consulted by a read (X_R in the staleness model)."""
        if self is ConsistencyLevel.ONE:
            return 1
        if self is ConsistencyLevel.TWO:
            return min(2, replication_factor)
        if self is ConsistencyLevel.QUORUM:
            return replication_factor // 2 + 1
        if self is ConsistencyLevel.ALL:
            return replication_factor
        return 1


# The six levels of the paper's evaluation path (Figs 8-15).
EVAL_LEVELS: tuple[ConsistencyLevel, ...] = (
    ConsistencyLevel.X_STCC,
    ConsistencyLevel.TCC,
    ConsistencyLevel.CAUSAL,
    ConsistencyLevel.ONE,
    ConsistencyLevel.QUORUM,
    ConsistencyLevel.ALL,
)


@dataclasses.dataclass(frozen=True)
class ConsistencyPolicy:
    """Full policy consumed by the sync engine and the simulators.

    Attributes:
      level: the consistency level.
      delta_steps: timed bound Δ for TCC/X-STCC, in optimizer steps (the
        training-side unit of logical time).  A write (parameter update)
        must be visible at every replica within Δ steps.  For ONE this is
        the *gossip* period instead (no ordering guarantee).
      quorum_fraction: fraction of pods in the quorum group (QUORUM only).
      compress_inter_pod: 'none' | 'int8' | 'topk' — gradient compression
        applied to the inter-pod (inter-DC, i.e. billed) hop only.
      topk_fraction: kept fraction for top-k compression.
      duot_capacity: bounded op-log size for the audit layer.
      audit_every: run the X-STCC audit every this many merges (0 = off).
    """

    level: ConsistencyLevel = ConsistencyLevel.X_STCC
    delta_steps: int = 8
    quorum_fraction: float = 0.5
    compress_inter_pod: str = "none"
    topk_fraction: float = 0.01
    duot_capacity: int = 256
    audit_every: int = 1

    def __post_init__(self):
        if self.compress_inter_pod not in ("none", "int8", "topk"):
            raise ValueError(
                f"unknown compression {self.compress_inter_pod!r}"
            )
        if self.delta_steps < 1:
            raise ValueError("delta_steps must be >= 1")

    def quorum_size(self, n_pods: int) -> int:
        return max(1, int(n_pods * self.quorum_fraction) + 1) if n_pods > 1 else 1

    def inter_pod_period(self) -> int:
        """Steps between inter-pod synchronizations.

        ALL/QUORUM/CAUSAL sync the pod axis every step; the timed levels
        every Δ; ONE gossips every Δ (same period, weaker guarantee) so
        cost comparisons isolate the *ordering* difference."""
        if self.level in (
            ConsistencyLevel.ALL,
            ConsistencyLevel.TWO,
            ConsistencyLevel.QUORUM,
            ConsistencyLevel.CAUSAL,
        ):
            return 1
        return self.delta_steps


# The five bars of the paper's figures.
PAPER_LEVELS: tuple[ConsistencyLevel, ...] = (
    ConsistencyLevel.ONE,
    ConsistencyLevel.QUORUM,
    ConsistencyLevel.ALL,
    ConsistencyLevel.CAUSAL,
    ConsistencyLevel.X_STCC,
)


def policy_for(level: ConsistencyLevel | str, **kw) -> ConsistencyPolicy:
    if isinstance(level, str):
        level = ConsistencyLevel[level.upper().replace("-", "_")]
    return ConsistencyPolicy(level=level, **kw)
