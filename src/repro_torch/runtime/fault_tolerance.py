"""Fault tolerance: failure detection, restart, straggler mitigation
(port of ``repro.runtime.fault_tolerance``).

CPU container = no real node failures, so the detector consumes an
*injectable* health source (tests and examples inject failures), while
the recovery path is the real one: restore from the replicated
checkpoint store under session guarantees, rebuild the step functions,
and replay the deterministic data pipeline from the restored step.

Straggler mitigation is the timed bound Δ put to work: a pod that
misses a merge deadline is simply excluded from that merge's quorum
(its weight is redistributed) and catches up at the next one — the
X-STCC guarantee caps how stale it can get (Δ·step_time), which is the
paper's "timed" property doing straggler duty.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass
class NodeHealth:
    """Injectable health source.  Production would wire this to the
    coordination service heartbeats; tests flip bits.

    Besides per-node liveness it can carry a network partition
    (:meth:`set_partition`), and it is the canonical driver of the
    availability masks the rest of the stack consumes: ``up_mask()`` /
    ``link_mask()`` feed ``repro_torch.core.xstcc.server_merge``'s masked
    propagation, ``ServingEngine.set_replica_health`` takes the object
    directly, and :meth:`snapshot`+:func:`schedule_from_snapshots`
    turn a health history into a
    :class:`repro_torch.core.availability.FaultSchedule` for the failure
    drivers."""

    n_nodes: int
    heartbeat_timeout_s: float = 30.0

    def __post_init__(self):
        now = time.time()
        self.last_heartbeat = [now] * self.n_nodes
        self.forced_down: set[int] = set()
        self._partition: np.ndarray | None = None  # (n, n) link matrix

    def beat(self, node: int, now: float | None = None) -> None:
        self.last_heartbeat[node] = time.time() if now is None else now

    def fail(self, node: int) -> None:
        self.forced_down.add(node)

    def recover(self, node: int) -> None:
        self.forced_down.discard(node)
        self.beat(node)

    def alive(self, now: float | None = None) -> list[bool]:
        now = time.time() if now is None else now
        return [
            (i not in self.forced_down)
            and (now - self.last_heartbeat[i] < self.heartbeat_timeout_s)
            for i in range(self.n_nodes)
        ]

    # -- availability masks ----------------------------------------------------

    def set_partition(self, groups: Sequence[Sequence[int]] | None) -> None:
        """Declare a network partition (``None`` heals it).

        Validation and membership come from
        :func:`repro_torch.core.availability.partition_link` — the same
        implementation the schedule constructors use, so health-driven
        and schedule-driven masks cannot diverge."""
        from repro_torch.core.availability import partition_link

        self._partition = (
            None if groups is None
            else partition_link(self.n_nodes, groups)
        )

    def up_mask(self, now: float | None = None) -> np.ndarray:
        """(n_nodes,) bool liveness — the ``up`` mask of the masked merge."""
        return np.asarray(self.alive(now), bool)

    def link_mask(self) -> np.ndarray:
        """(n_nodes, n_nodes) bool connectivity from the partition state."""
        if self._partition is None:
            return np.ones((self.n_nodes, self.n_nodes), bool)
        return self._partition.copy()

    def snapshot(self, now: float | None = None) -> tuple[np.ndarray, np.ndarray]:
        """One availability epoch: ``(up, link)`` as of ``now``."""
        return self.up_mask(now), self.link_mask()


def schedule_from_snapshots(snapshots: Sequence[tuple[np.ndarray, np.ndarray]]):
    """Stack :meth:`NodeHealth.snapshot` epochs into a FaultSchedule."""
    from repro_torch.core.availability import FaultSchedule

    return FaultSchedule(
        np.stack([s[0] for s in snapshots]),
        np.stack([s[1] for s in snapshots]),
    )


@dataclasses.dataclass
class FailurePolicy:
    """What the trainer does when the detector fires."""

    max_restarts: int = 8
    straggler_deadline_factor: float = 3.0  # x median step time


class StragglerMonitor:
    """Tracks per-pod step durations; flags pods exceeding the deadline."""

    def __init__(self, n_pods: int, factor: float = 3.0, window: int = 32):
        self.n_pods = n_pods
        self.factor = factor
        self.window = window
        self.durations: list[list[float]] = [[] for _ in range(n_pods)]

    def record(self, pod: int, seconds: float) -> None:
        d = self.durations[pod]
        d.append(seconds)
        if len(d) > self.window:
            d.pop(0)

    def median_all(self) -> float:
        import statistics

        flat = [x for d in self.durations for x in d]
        return statistics.median(flat) if flat else 0.0

    def stragglers(self) -> list[int]:
        med = self.median_all()
        if med <= 0:
            return []
        out = []
        for pod, d in enumerate(self.durations):
            if d and d[-1] > self.factor * med:
                out.append(pod)
        return out

    def up_mask(self) -> np.ndarray:
        """(n_pods,) bool — stragglers dropped from the next merge.

        This is the availability mask ``SyncEngine.merge(params, sync,
        up=...)`` consumes (the same mask shape the replicated store's
        failure path uses): a flagged pod neither contributes to nor
        receives the merge and catches up at the next one — the Δ-skip.
        When every pod straggles the mask keeps everyone (a merge of
        nobody is no merge at all).
        """
        lag = set(self.stragglers())
        up = np.ones(self.n_pods, bool)
        if len(lag) < self.n_pods:
            up[list(lag)] = False
        return up

    def merge_weights(self) -> torch.Tensor:
        """Per-pod f32 weights of :meth:`up_mask`, a host tensor (legacy
        shape: the mass of the dropped pods redistributed; sums to
        n_pods)."""
        up = self.up_mask()
        return torch.from_numpy(
            up.astype(np.float32) * (self.n_pods / max(1, int(up.sum())))
        )


class RestartManager:
    """Coordinates restart-from-checkpoint after a failure.

    The restore itself is delegated to
    :class:`repro_torch.runtime.recovery.CheckpointRecovery` — the ML
    checkpoint path is one client of the unified recovery API (the
    device-fleet crash path is the other); this class only owns the
    restart *budget* policy around it."""

    def __init__(self, store, policy: FailurePolicy):
        self.store = store
        self.policy = policy
        self.restarts = 0
        self.last_outcome = None

    def recover(
        self, template, session, allow_partial: bool = False
    ) -> tuple[object, int]:
        """Restore params and the step to resume from.

        Session guarantees make this safe against replica lag: a worker
        that already saw version v can never be handed v' < v (monotonic
        read), and a worker restarting right after its own save is
        guaranteed to see that save (read-your-write).

        Only a *successful* recovery consumes restart budget — a
        restore that throws leaves the budget untouched so the caller
        can retry against a healed store.  A restored version that no
        replica has metadata for is an integrity error and raises
        (silently resuming from step 0 would replay the whole run over
        a live checkpoint).  A restore that lands **behind the fleet's
        newest known checkpoint** is *partial*: it raises
        :class:`repro_torch.runtime.recovery.PartialRestoreError` (budget
        untouched) unless ``allow_partial=True``, in which case the
        outcome — with its ``partial``/``behind`` fields — is kept in
        ``last_outcome``."""
        from repro_torch.runtime.recovery import CheckpointRecovery

        if self.restarts >= self.policy.max_restarts:
            raise RuntimeError("restart budget exhausted")
        params, outcome = CheckpointRecovery(self.store).recover(
            template, session, allow_partial=allow_partial
        )
        self.restarts += 1
        self.last_outcome = outcome
        return params, outcome.step
