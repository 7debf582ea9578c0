"""Seeded nemesis: randomized fault schedules for the chaos harness (port
of ``repro.chaos.nemesis``; host numpy, the same draws for the same seed).

A nemesis composes replica **crashes** (state-destroying), replica
**outages** (unreachable but intact), network **partitions** and a
randomized **gossip cadence** into a
:class:`repro_torch.core.availability.FaultSchedule` that is adversarial
but recoverable: at least one replica is up in every epoch, and the last
``quiet_tail`` epochs are all-up and fully connected, so every crashed
replica rejoins and the run ends on a quiescent window the harness can
compare bit-exactly against the never-crashed twin.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.availability import FaultSchedule, partition_link
from repro_torch.gossip import GossipConfig

__all__ = ["random_gossip", "random_schedule"]


def random_schedule(
    n_epochs: int,
    n_replicas: int,
    *,
    seed: int,
    p_crash: float = 0.08,
    p_outage: float = 0.10,
    p_partition: float = 0.08,
    max_down_for: int = 2,
    quiet_tail: int = 3,
) -> FaultSchedule:
    """One seeded nemesis schedule (crashes x outages x partitions).

    Per active epoch (everything before the quiet tail), each replica
    independently crashes with ``p_crash`` or suffers a plain outage with
    ``p_outage`` (each lasting 1..``max_down_for`` epochs), and the fleet
    partitions into two groups with ``p_partition`` for one epoch.  An
    event that would leave some epoch with no live replica is skipped.
    """
    if n_epochs <= quiet_tail:
        raise ValueError(
            f"n_epochs={n_epochs} must exceed quiet_tail={quiet_tail}"
        )
    rng = np.random.default_rng(seed)
    up = np.ones((n_epochs, n_replicas), bool)
    link = np.ones((n_epochs, n_replicas, n_replicas), bool)
    crash = np.zeros((n_epochs, n_replicas), bool)
    active = n_epochs - quiet_tail

    for t in range(active):
        for r in range(n_replicas):
            if not up[t, r]:
                continue  # already down from an earlier event
            roll = rng.random()
            if roll >= p_crash + p_outage:
                continue
            down_for = int(rng.integers(1, max_down_for + 1))
            end = min(t + down_for, active)
            window = up[t:end].copy()
            window[:, r] = False
            if not window.any(axis=1).all():
                continue  # would empty the fleet somewhere: skip
            up[t:end, r] = False
            if roll < p_crash:
                crash[t, r] = True
        if n_replicas >= 2 and rng.random() < p_partition:
            members = rng.permutation(n_replicas)
            cut = int(rng.integers(1, n_replicas))
            groups = [members[:cut].tolist(), members[cut:].tolist()]
            link[t] = partition_link(n_replicas, groups)

    return FaultSchedule(up, link, crash=crash)


def random_gossip(
    seed: int,
    cadences: tuple[int, ...] = (0, 1, 2, 4),
    hint_cap: int = 32,
) -> GossipConfig | None:
    """A seeded gossip cadence draw (``None`` = gossip disabled): chaos
    runs must hold their invariants with and without continuous
    anti-entropy."""
    rng = np.random.default_rng(seed + 0x9E3779B9)
    cadence = int(rng.choice(np.asarray(cadences)))
    if cadence == 0:
        return None
    return GossipConfig(cadence=cadence, hint_cap=hint_cap)
