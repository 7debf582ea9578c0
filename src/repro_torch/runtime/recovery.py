"""One recovery API over both replicated artifact stores (port of
``repro.runtime.recovery``).

* **device-fleet state** — a crashed protocol replica restores from the
  durability layer and peer-bootstraps the rest
  (:meth:`repro_torch.core.replicated_store.ReplicatedStore.crash` /
  :meth:`~repro_torch.core.replicated_store.ReplicatedStore.bootstrap`):
  :class:`StoreRecovery`;
* **ML checkpoints** — a restarting trainer restores params from a
  replicated checkpoint store under session guarantees:
  :class:`CheckpointRecovery`, over
  :class:`repro_torch.checkpoint.CheckpointStore` (or anything with its
  surface).

Both produce a :class:`RecoveryOutcome` that says how complete the
restore was.  A restore that lands behind the fleet's newest version is
*partial*: callers opt in with ``allow_partial=True`` or get a
:class:`PartialRestoreError`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = [
    "CheckpointRecovery",
    "PartialRestoreError",
    "RecoveryOutcome",
    "StoreRecovery",
]


class PartialRestoreError(RuntimeError):
    """A restore succeeded but recovered less than the fleet knows.

    Carries the :class:`RecoveryOutcome` (``.outcome``) so the caller can
    inspect what *was* recovered before deciding to retry, wait for
    propagation, or accept the partial state explicitly."""

    def __init__(self, message: str, outcome: "RecoveryOutcome"):
        super().__init__(message)
        self.outcome = outcome


@dataclasses.dataclass(frozen=True)
class RecoveryOutcome:
    """What a recovery achieved: ``version`` / ``step`` locate the
    restored state, ``rerouted`` is the session-guarantee reroute flag,
    ``partial`` is True when a fresher version exists in the fleet, and
    ``behind`` is how many versions behind the restore landed."""

    version: int
    step: int
    rerouted: bool
    partial: bool
    behind: int


class CheckpointRecovery:
    """Checkpoint restore as a client of the unified recovery path.

    Wraps anything with a checkpoint store's surface (``propagate`` /
    ``restore`` / ``_read_meta`` / ``n_replicas``).  On top of the
    store's session-guarded restore it resolves the restored version to
    its training step from the replica metadata (a version no replica has
    metadata for is an integrity error), and flags the restore partial
    when it is behind the newest version any replica knows of (committed
    metadata and in-flight pending propagations)."""

    def __init__(self, store):
        self.store = store

    def _fleet_latest(self) -> int:
        """Newest version any replica has committed *or* pending."""
        latest = 0
        for r in range(self.store.n_replicas):
            meta = self.store._read_meta(r)
            latest = max(latest, int(meta.get("version", 0)))
            for k in meta.get("entries", {}):
                latest = max(latest, int(k))
            for p in meta.get("pending", ()):
                latest = max(latest, int(p.get("version", 0)))
        return latest

    def recover(self, template, session, *,
                allow_partial: bool = False) -> tuple[Any, RecoveryOutcome]:
        """Restore params; return ``(params, outcome)``.  Raises
        :class:`PartialRestoreError` when the restore lands behind the
        fleet's newest known version and ``allow_partial`` is False."""
        self.store.propagate()
        params, version, rerouted = self.store.restore(template, session)
        step = None
        for r in range(self.store.n_replicas):
            e = self.store._read_meta(r).get("entries", {}).get(str(version))
            if e:
                step = int(e["step"])
                break
        if step is None:
            raise RuntimeError(
                f"restored checkpoint version {version} has no metadata "
                "entry on any replica; refusing to resume from step 0"
            )
        latest = self._fleet_latest()
        outcome = RecoveryOutcome(
            version=int(version),
            step=step,
            rerouted=bool(rerouted),
            partial=version < latest,
            behind=max(0, latest - int(version)),
        )
        if outcome.partial and not allow_partial:
            raise PartialRestoreError(
                f"restored version {version} is {outcome.behind} behind "
                f"the fleet's newest checkpoint {latest}; pass "
                "allow_partial=True to resume from it anyway",
                outcome,
            )
        return params, outcome


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class StoreRecovery:
    """Device-fleet crash recovery as a client of the same API.

    Wraps a :class:`repro_torch.core.replicated_store.ReplicatedStore`
    and rebuilds a set of crashed replicas: durable restore (snapshot +
    WAL replay), then peer bootstrap over the digest ranges.  The
    outcome's ``version`` is the highest version the rebuilt rows
    reached, with ``partial`` / ``behind`` measured against the fleet's
    version frontier: a bootstrap with no live peer in reach leaves the
    replica behind, and that shows here."""

    def __init__(self, store):
        self.store = store

    def recover(self, state, crashed, *, up, link, n_ranges: int = 8,
                allow_partial: bool = False) -> tuple[Any, RecoveryOutcome]:
        mask = _host(crashed).astype(bool)
        state, _ = self.store.crash(state, mask)
        state, tel = self.store.bootstrap(state, targets=mask, up=up, link=link,
                                          n_ranges=n_ranges)
        rv = _host(state.cluster.replica_version)
        fleet = int(rv.max()) if rv.size else 0
        reached = int(rv[mask].max()) if mask.any() else fleet
        outcome = RecoveryOutcome(
            version=reached,
            step=int(state.cluster.clock),
            rerouted=bool(_host(tel["valid"]).any()),
            partial=reached < fleet,
            behind=max(0, fleet - reached),
        )
        if outcome.partial and not allow_partial:
            raise PartialRestoreError(
                f"rebuilt replicas reached version {reached} but the "
                f"fleet frontier is {fleet}; no live peer close enough "
                "— pass allow_partial=True to accept the lag",
                outcome,
            )
        return state, outcome
