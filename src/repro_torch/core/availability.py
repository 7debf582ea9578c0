"""Availability timelines: replica outages and network partitions (port
of ``repro.core.availability``).

A :class:`FaultSchedule` is an availability timeline over ``T`` epochs
(one epoch is one merge round of the engine) and ``R`` replicas:

  * ``up``    — ``(T, R)`` bool, replica liveness per epoch;
  * ``link``  — ``(T, R, R)`` bool, symmetric pairwise connectivity;
  * ``crash`` — ``(T, R)`` bool crash *events* (default none).

Schedules are host numpy: the engine reads them per round on the host
and moves to the device only what a merge consumes.  Everything
downstream uses the *closed* connectivity :meth:`FaultSchedule.closure`
(``conn[t, i, j]``: a version held at a live ``i`` can reach a live
``j`` during epoch ``t`` through live, linked replicas).

:func:`reroute_ops` takes numpy arrays or, for the engine's device
batches, torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch


def _closure_one(conn: np.ndarray) -> np.ndarray:
    """Transitive closure of one boolean connectivity matrix."""
    c = conn.copy()
    r = c.shape[0]
    hops = max(1, int(np.ceil(np.log2(max(r, 2)))))
    for _ in range(hops):  # repeated squaring: paths double per round
        c = c | ((c @ c) > 0)
    return c


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Per-epoch availability of a replica fleet (see module docstring)."""

    up: np.ndarray    # (T, R) bool
    link: np.ndarray  # (T, R, R) bool, symmetric, True diagonal
    crash: np.ndarray | None = None  # (T, R) bool crash *events*

    def __post_init__(self):
        up = np.asarray(self.up, bool)
        link = np.asarray(self.link, bool)
        if up.ndim != 2 or link.shape != up.shape + (up.shape[1],):
            raise ValueError(
                f"up must be (T, R) and link (T, R, R); got {up.shape} "
                f"and {link.shape}"
            )
        # Symmetric channel, every replica trivially linked to itself.
        link = link | link.transpose(0, 2, 1)
        eye = np.eye(up.shape[1], dtype=bool)
        link = link | eye[None]
        if not up.any(axis=1).all():
            raise ValueError(
                "schedule leaves no replica up in some epoch; clients "
                "would have nowhere to route"
            )
        crash = (
            np.zeros_like(up)
            if self.crash is None
            else np.asarray(self.crash, bool)
        )
        if crash.shape != up.shape:
            raise ValueError(
                f"crash must match up's shape {up.shape}; got {crash.shape}"
            )
        if (crash & up).any():
            raise ValueError(
                "a crash event implies the replica is down that epoch; "
                "crash & up must be empty"
            )
        object.__setattr__(self, "up", up)
        object.__setattr__(self, "link", link)
        object.__setattr__(self, "crash", crash)

    # -- shape ----------------------------------------------------------------

    @property
    def n_epochs(self) -> int:
        return self.up.shape[0]

    @property
    def n_replicas(self) -> int:
        return self.up.shape[1]

    def slice(self, n_epochs: int) -> "FaultSchedule":
        """First ``n_epochs`` epochs, extending with the last epoch's
        ``up``/``link`` state; crash *events* are never repeated."""
        t = self.n_epochs
        if n_epochs <= t:
            return FaultSchedule(
                self.up[:n_epochs], self.link[:n_epochs],
                crash=self.crash[:n_epochs],
            )
        pad = n_epochs - t
        return FaultSchedule(
            np.concatenate([self.up, np.repeat(self.up[-1:], pad, 0)]),
            np.concatenate([self.link, np.repeat(self.link[-1:], pad, 0)]),
            crash=np.concatenate(
                [self.crash, np.zeros((pad, self.n_replicas), bool)]),
        )

    # -- derived masks --------------------------------------------------------

    def closure(self) -> np.ndarray:
        """(T, R, R) closed effective connectivity among live replicas:
        the transitive closure of ``up ∧ up ∧ link`` with diagonal
        ``up`` (a down replica reaches nothing, not even itself).
        Memoized on the frozen instance."""
        cached = getattr(self, "_closure", None)
        if cached is not None:
            return cached
        eff = self.link & self.up[:, :, None] & self.up[:, None, :]
        out = np.stack([_closure_one(eff[t]) for t in range(self.n_epochs)])
        eye = np.eye(self.n_replicas, dtype=bool)
        out = np.where(eye[None], self.up[:, :, None] & eye[None], out)
        object.__setattr__(self, "_closure", out)
        return out

    def faulty(self) -> np.ndarray:
        """(T,) bool — any replica down or any live pair disconnected."""
        conn = self.closure()
        full = self.up.all(axis=1) & conn.all(axis=(1, 2))
        return ~full

    def heals(self) -> np.ndarray:
        """(T,) bool — epochs whose connectivity *gained* an edge (the
        anti-entropy trigger).  Epoch 0 never heals."""
        conn = self.closure()
        gained = np.zeros(self.n_epochs, bool)
        gained[1:] = (conn[1:] & ~conn[:-1]).any(axis=(1, 2))
        return gained

    # -- crash events ---------------------------------------------------------

    def crashes(self) -> np.ndarray:
        """(T, R) bool — crash *events* (state loss, not mere outage)."""
        return self.crash

    @property
    def has_crashes(self) -> bool:
        return bool(self.crash.any())

    def rejoins(self) -> np.ndarray:
        """(T, R) bool — first up epoch after each crash."""
        out = np.zeros_like(self.up)
        pending = np.zeros(self.n_replicas, bool)
        for t in range(self.n_epochs):
            pending |= self.crash[t]
            rejoin = pending & self.up[t]
            out[t] = rejoin
            pending &= ~rejoin
        return out

    def strip_crashes(self) -> "FaultSchedule":
        """The same outage/partition timeline with no state loss."""
        return FaultSchedule(self.up, self.link)

    # -- composition ----------------------------------------------------------

    def __and__(self, other: "FaultSchedule") -> "FaultSchedule":
        if self.up.shape != other.up.shape:
            raise ValueError(
                f"schedules disagree on shape: {self.up.shape} vs "
                f"{other.up.shape}"
            )
        return FaultSchedule(
            self.up & other.up, self.link & other.link,
            crash=self.crash | other.crash,
        )


# -- constructors -------------------------------------------------------------


def all_up(n_epochs: int, n_replicas: int) -> FaultSchedule:
    """The no-fault schedule."""
    return FaultSchedule(
        np.ones((n_epochs, n_replicas), bool),
        np.ones((n_epochs, n_replicas, n_replicas), bool),
    )


def replica_outage(
    n_epochs: int, n_replicas: int, replica: int, start: int, stop: int
) -> FaultSchedule:
    """Replica ``replica`` is down for epochs ``[start, stop)``."""
    s = all_up(n_epochs, n_replicas)
    up = s.up.copy()
    up[start:stop, replica] = False
    return FaultSchedule(up, s.link)


def replica_crash(
    n_epochs: int, n_replicas: int, replica: int, epoch: int,
    down_for: int = 1,
) -> FaultSchedule:
    """Replica ``replica`` crashes at ``epoch``, is down for
    ``[epoch, epoch + down_for)`` and rejoins amnesiac."""
    if not 0 <= epoch < n_epochs:
        raise ValueError(f"crash epoch {epoch} outside [0, {n_epochs})")
    if down_for < 1:
        raise ValueError("a crash takes the replica down for >= 1 epoch")
    s = replica_outage(
        n_epochs, n_replicas, replica, epoch, min(epoch + down_for, n_epochs))
    crash = np.zeros((n_epochs, n_replicas), bool)
    crash[epoch, replica] = True
    return FaultSchedule(s.up, s.link, crash=crash)


def partition_link(
    n_replicas: int, groups: Sequence[Sequence[int]]
) -> np.ndarray:
    """(R, R) connectivity of one partition into ``groups``, which must
    cover every replica exactly once."""
    seen = sorted(r for g in groups for r in g)
    if seen != list(range(n_replicas)):
        raise ValueError(
            f"groups {groups} must partition replicas 0..{n_replicas - 1}"
        )
    member = np.zeros(n_replicas, np.int32)
    for gid, g in enumerate(groups):
        for r in g:
            member[r] = gid
    same = member[:, None] == member[None, :]
    return same | np.eye(n_replicas, dtype=bool)


def partition(
    n_epochs: int, n_replicas: int, groups: Sequence[Sequence[int]],
    start: int, stop: int,
) -> FaultSchedule:
    """Network partition into ``groups`` for epochs ``[start, stop)``."""
    same = partition_link(n_replicas, groups)
    s = all_up(n_epochs, n_replicas)
    link = s.link.copy()
    link[start:stop] &= same[None]
    return FaultSchedule(s.up, link)


def from_predicates(
    n_epochs: int,
    n_replicas: int,
    up_fn: Callable[[np.ndarray, np.ndarray], np.ndarray] | None = None,
    link_fn: Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray]
    | None = None,
) -> FaultSchedule:
    """Closed-form schedule: ``up_fn(t, r)`` and ``link_fn(t, i, j)``
    evaluated over broadcast index grids; omitted ones are all-True."""
    t = np.arange(n_epochs)[:, None]
    r = np.arange(n_replicas)[None, :]
    up = (
        np.broadcast_to(np.asarray(up_fn(t, r), bool),
                        (n_epochs, n_replicas)).copy()
        if up_fn is not None
        else np.ones((n_epochs, n_replicas), bool)
    )
    if link_fn is not None:
        tt = np.arange(n_epochs)[:, None, None]
        i = np.arange(n_replicas)[None, :, None]
        j = np.arange(n_replicas)[None, None, :]
        link = np.broadcast_to(
            np.asarray(link_fn(tt, i, j), bool),
            (n_epochs, n_replicas, n_replicas),
        ).copy()
    else:
        link = np.ones((n_epochs, n_replicas, n_replicas), bool)
    return FaultSchedule(up, link)


def reroute_ops(home, up):
    """First live replica at or after ``home`` in ring order.

    ``home`` is ``(B,)`` int and ``up`` ``(R,)`` bool, both numpy or both
    torch (the engine passes its device batch); ops whose home replica is
    down fail over to the next live replica.  With no live replica the
    op keeps its home, as ``argmax`` of an all-False row picks index 0.
    """
    if isinstance(home, torch.Tensor):
        u = torch.as_tensor(up, dtype=torch.bool, device=home.device)
        r = u.shape[0]
        offs = torch.arange(r, dtype=home.dtype, device=home.device)
        cand = (home[:, None] + offs[None, :]) % r                    # (B, R)
        # torch.argmax takes no bool; ties go to the first index.
        first = torch.argmax(u[cand.long()].to(torch.int32), dim=1)
        return cand.gather(1, first[:, None]).squeeze(1)
    r = up.shape[0]
    offs = np.arange(r, dtype=np.int32)
    cand = (home[:, None] + offs[None, :]) % r        # (B, R)
    first = up[cand].argmax(axis=1)                   # first live candidate
    return cand[np.arange(home.shape[0]), first]
