"""Configuration of the epoch engine — the flat fields plus ``lean``
(port of ``repro.engine.config``).

The reference composes topology, fault schedules, gossip, durability,
sharding and observability into the same dataclass; those pieces are
not ported yet, and a config that sets any of them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.consistency import ConsistencyLevel

_NOT_PORTED = ("topology", "faults", "schedule_unit", "gossip", "durability", "obs")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything one flat epoch-engine replay needs.

    ``lean`` skips the vector-clock chain, the DUOT record and the
    causal-dependency merge gate when the closed-form cadence emulation
    already carries visibility (emulated levels, ``audit=False``).
    ``ingest`` picks the kernels' implementation (``"auto"`` /
    ``"cuda"`` / ``"torch"``); ``audit`` is a result-assembly knob.
    """

    level: ConsistencyLevel
    n_ops: int = 6000
    n_clients: int = 16
    n_resources: int = 24
    merge_every: int = 8
    delta: int = 24
    duot_cap: int = 2048
    batch_size: int = 128
    seed: int = 0
    audit: bool = True
    ingest: str = "auto"
    lean: bool = False
    pending_cap: int | None = None
    n_shards: int = 1
    topology: Any = None
    faults: Any = None
    schedule_unit: int | None = None
    gossip: Any = None
    durability: Any = None
    obs: Any = None

    def __post_init__(self) -> None:
        for name in _NOT_PORTED:
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"EngineConfig.{name} is not ported yet: repro_torch "
                    "runs the flat engine only"
                )
        if self.n_shards != 1:
            raise NotImplementedError(
                "EngineConfig.n_shards > 1 is not ported yet: repro_torch "
                "runs the flat engine only"
            )
        if self.ingest not in ("auto", "cuda", "torch"):
            raise ValueError(
                f"ingest must be 'auto', 'cuda' or 'torch', got {self.ingest!r}"
            )
        if self.lean and self.audit:
            raise ValueError(
                "lean fidelity serves the flat throughput path only: "
                "audit=False"
            )

    @property
    def n_replicas(self) -> int:
        return 3

    def resolved_pending_cap(self) -> int:
        """The pending-ring bound: the all-up path sizes it to the batch."""
        from repro_torch.engine.stream import cadence_plan

        if self.pending_cap is not None:
            return self.pending_cap
        sub, _, _, _ = cadence_plan(
            self.level, self.n_ops, self.batch_size, self.merge_every,
            self.delta,
        )
        return max(128, 2 * sub)
