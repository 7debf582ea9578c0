"""Consistency levels (port of ``repro.core.consistency``).

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
