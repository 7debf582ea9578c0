"""Gossip cadence configuration and peer-pair schedules (port of
``repro.gossip.scheduler``; host numpy).

Every ``cadence`` merge epochs each replica contacts one peer, diffs
range digests and repairs the stale ranges
(``ReplicatedStore.gossip_round``).  :class:`GossipConfig` holds the
knobs; :func:`gossip_pairs` precomputes the ``(T,)`` active mask and the
``(T, P, 2)`` pair schedule.  Peer selection is the round-robin ring:
exchange ``n`` pairs replica ``p`` with ``(p + 1 + (n-1) mod (P-1)) mod
P``; ``peer="nearest"`` orders each replica's peers by the topology's
region RTT (ties by replica id).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Knobs of the continuous anti-entropy pass (hashable, static).

    ``cadence`` — merge epochs between digest exchanges (``0`` disables
    gossip); ``n_ranges`` — digest ranges per replica; ``peer`` —
    ``"round_robin"`` or ``"nearest"`` (by region RTT); ``hint_cap`` —
    hinted-handoff queue bound per destination (``0`` disables handoff);
    ``impl`` — the ``digest_compare`` implementation (``None`` = auto).
    """

    cadence: int = 0
    n_ranges: int = 8
    peer: str = "round_robin"
    hint_cap: int = 0
    impl: str | None = None

    def __post_init__(self):
        if self.cadence < 0 or self.n_ranges < 1 or self.hint_cap < 0:
            raise ValueError(
                f"invalid gossip config: cadence={self.cadence}, "
                f"n_ranges={self.n_ranges}, hint_cap={self.hint_cap}"
            )
        if self.peer not in ("round_robin", "nearest"):
            raise ValueError(f"unknown peer policy: {self.peer!r}")

    @property
    def enabled(self) -> bool:
        return self.cadence > 0

    @property
    def handoff(self) -> bool:
        return self.hint_cap > 0


def _peer_order(n_replicas: int, topology=None) -> np.ndarray:
    """(P, P-1) int32 — each replica's peers in exchange order: ring
    offsets 1..P-1 without a topology, else by replica-pair RTT, ties
    by replica id."""
    p = n_replicas
    if topology is None:
        return np.stack(
            [(np.arange(1, p) + i) % p for i in range(p)]
        ).astype(np.int32)
    reg = np.asarray(topology.regions())
    rtt_g = np.asarray(topology.rtt(), np.float64)
    rtt = rtt_g[reg[:, None], reg[None, :]]     # replica-pair RTT
    order = []
    for i in range(p):
        others = np.array([j for j in range(p) if j != i])
        key = np.lexsort((others, rtt[i, others]))
        order.append(others[key])
    return np.stack(order).astype(np.int32)


def gossip_pairs(
    n_replicas: int, n_epochs: int, cfg: GossipConfig, topology=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(active, pairs): ``(T,)`` bool (every ``cadence``-th epoch ends
    with an exchange) and ``(T, P, 2)`` int32, row ``p`` of epoch ``t``
    the ordered ``(p, peer)`` exchange; inactive epochs carry self-loops
    ``(p, p)``, which the repair merge treats as invalid.
    ``peer="nearest"`` needs ``topology`` (its RTTs order the peers);
    round-robin ignores it."""
    p = n_replicas
    t = n_epochs
    active = np.zeros(t, bool)
    me = np.arange(p, dtype=np.int32)
    pairs = np.stack([me, me], axis=1)[None].repeat(t, axis=0)
    if not cfg.enabled or p < 2:
        return active, pairs.astype(np.int32)
    if cfg.peer == "nearest" and topology is None:
        raise ValueError('peer="nearest" needs a RegionTopology')
    order = _peer_order(p, topology if cfg.peer == "nearest" else None)
    epochs = np.arange(t)
    active = (epochs + 1) % cfg.cadence == 0
    nth = (epochs + 1) // cfg.cadence - 1      # 0-based exchange counter
    col = nth % (p - 1)
    for ti in np.flatnonzero(active):
        pairs[ti, :, 1] = order[:, col[ti]]
    return active, pairs.astype(np.int32)
