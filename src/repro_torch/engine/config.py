"""Configuration of the epoch engine (port of ``repro.engine.config``).

One frozen dataclass holds every piece of a replay: level and cadence,
batching, the region ``topology`` (two-tier merge, RTT latency, per-pair
egress bill), the fault schedule (``faults``, anchored per merge round
or, with ``schedule_unit``, per op-index window), ``gossip``,
``durability``, ``n_shards`` disjoint tenant shards, ``obs`` and the
``lean`` fidelity switch.  A fault schedule may carry crash events, and
composes with a topology that places the paper's 3 replicas.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.availability import FaultSchedule
from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.gossip.scheduler import GossipConfig
from repro_torch.obs.metrics import ObsConfig


@dataclasses.dataclass(frozen=True, eq=False)
class EngineConfig:
    """Everything one epoch-engine replay needs.

    ``lean`` skips the vector-clock chain, the DUOT record and the
    causal-dependency merge gate when the closed-form cadence emulation
    already carries visibility (emulated levels, flat path,
    ``audit=False``).  ``ingest`` picks the kernels' implementation
    (``"auto"`` / ``"cuda"`` / ``"torch"``); ``audit`` is a
    result-assembly knob.  Equality and hashing compare the fault masks
    by their bytes, as the reference does.

    ``n_shards`` splits clients, resources and ops into disjoint tenant
    shards, each replayed on its own stream (seed ``seed + s``) under the
    one fault schedule.  ``use_devices`` spreads the shards one per rank
    where the reference spreads them one per device: with no faults and no
    topology, over the active ``DeviceMesh``'s 'shard' axis (or, with no
    mesh, the initialized process group) when it has at least
    ``n_shards`` ranks (``replay.shard_group``); otherwise the shards run
    one after another, as the reference runs them with too few devices.
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
    faults: FaultSchedule | None = None
    schedule_unit: int | None = None
    gossip: GossipConfig | None = None
    durability: DurabilityConfig | None = None
    use_devices: bool = True
    obs: ObsConfig | None = None

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_shards > 1 and (
            self.n_clients % self.n_shards
            or self.n_resources % self.n_shards
            or self.n_ops % self.n_shards
        ):
            raise ValueError(
                f"n_clients={self.n_clients}, n_resources="
                f"{self.n_resources}, and n_ops={self.n_ops} must all be "
                f"divisible by n_shards={self.n_shards}"
            )
        if self.faults is not None and self.faults.n_replicas != 3:
            raise ValueError(
                f"schedule covers {self.faults.n_replicas} replicas; the "
                "paper cluster has 3 DCs"
            )
        if self.topology is not None and self.n_shards > 1:
            raise ValueError("topology does not compose with n_shards > 1")
        if (
            self.topology is not None and self.faults is not None
            and self.topology.n_replicas != 3
        ):
            raise ValueError(
                "fault schedules cover the paper's 3 DCs; a composed "
                "topology must place exactly 3 replicas"
            )
        if self.ingest not in ("auto", "cuda", "torch"):
            raise ValueError(
                f"ingest must be 'auto', 'cuda' or 'torch', got {self.ingest!r}"
            )
        if self.lean and (
            self.faults is not None or self.topology is not None
            or self.gossip is not None or self.durability is not None
            or self.audit
        ):
            raise ValueError(
                "lean fidelity serves the flat throughput path only: no "
                "faults/topology/gossip/durability, audit=False"
            )

    # -- identity ---------------------------------------------------------

    def _key(self) -> tuple:
        f = self.faults
        faults_key = None if f is None else (
            f.up.tobytes(), f.link.tobytes(), f.crash.tobytes(), f.up.shape
        )
        return (
            self.level, self.n_ops, self.n_clients, self.n_resources,
            self.merge_every, self.delta, self.duot_cap, self.batch_size,
            self.seed, self.audit, self.ingest, self.lean, self.topology,
            self.n_shards, faults_key, self.schedule_unit, self.gossip,
            self.durability, self.pending_cap, self.use_devices, self.obs,
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, EngineConfig):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    # -- derived plan -----------------------------------------------------

    @property
    def n_replicas(self) -> int:
        return 3 if self.topology is None else self.topology.n_replicas

    @property
    def shard_clients(self) -> int:
        return self.n_clients // self.n_shards

    @property
    def shard_resources(self) -> int:
        return self.n_resources // self.n_shards

    @property
    def shard_ops(self) -> int:
        return self.n_ops // self.n_shards

    def resolved_pending_cap(self, w_read_fraction: float) -> int:
        """The pending-ring bound this replay runs with.

        Fault schedules hold a partition backlog (a write's slot stays
        live until every replica has it), so the fault path sizes the
        ring to the run's expected writes; the all-up path sizes it to
        the batch.
        """
        from repro_torch.engine.stream import cadence_plan

        sub, _, _, _ = cadence_plan(
            self.level, self.shard_ops, self.batch_size, self.merge_every,
            self.delta,
        )
        if self.pending_cap is not None:
            return self.pending_cap
        if self.faults is not None:
            n_writes = int(round((1.0 - w_read_fraction) * self.shard_ops))
            return max(256, 2 * sub, n_writes + 1)
        return max(128, 2 * sub)
