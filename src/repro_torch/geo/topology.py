"""Region-aware cluster topology — the subset the flat path needs (port
of ``repro.geo.topology``).

:class:`RegionTopology` maps each replica to a region and answers RTT
lookups from a (G, G) matrix; ``ClusterConfig`` prices write acks and
read fan-out through it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cost_model import EgressMatrix, PAPER_PRICING, PricingScheme


@dataclasses.dataclass(frozen=True)
class RegionTopology:
    """Replica→region map + (G, G) RTT and egress-price matrices."""

    replica_region: tuple[int, ...]            # (P,) region per replica
    rtt_ms: tuple[tuple[float, ...], ...]      # (G, G) round-trip ms
    egress: EgressMatrix                       # (G, G) price-tier matrix
    client_region: tuple[int, ...] | None = None

    def __post_init__(self):
        g = len(self.rtt_ms)
        if any(len(row) != g for row in self.rtt_ms):
            raise ValueError("rtt_ms must be square (G, G)")
        if self.egress.n_regions != g:
            raise ValueError(
                f"egress matrix covers {self.egress.n_regions} regions, "
                f"rtt_ms covers {g}"
            )
        for r in self.replica_region:
            if not 0 <= r < g:
                raise ValueError(f"replica region {r} out of range [0, {g})")

    @property
    def n_regions(self) -> int:
        return len(self.rtt_ms)

    @property
    def n_replicas(self) -> int:
        return len(self.replica_region)

    def regions(self) -> np.ndarray:
        """(P,) int32 replica→region map."""
        return np.asarray(self.replica_region, np.int32)

    def replica_rtt_from(self, region: int) -> np.ndarray:
        """(P,) RTT from a client region to every replica (float64, so
        the paper's exact constants survive the lookup)."""
        return np.asarray(self.rtt_ms, np.float64)[region][self.regions()]

    def ack_latency_ms(self, region: int, acks: int) -> float:
        """RTT of the ``acks``-th nearest replica from ``region``."""
        rtts = np.sort(self.replica_rtt_from(region), kind="stable")
        if not 1 <= acks <= len(rtts):
            raise ValueError(
                f"acks={acks} outside [1, {len(rtts)}] for this topology"
            )
        return float(rtts[acks - 1])

    def read_latency_ms(self, region: int, consulted: int) -> float:
        """Latency of a read consulting ``consulted`` replicas."""
        return self.ack_latency_ms(region, consulted)


def uniform_topology(
    replica_region: tuple[int, ...],
    *,
    intra_rtt_ms: float,
    inter_rtt_ms: float,
    pricing: PricingScheme = PAPER_PRICING,
    client_region: tuple[int, ...] | None = None,
) -> RegionTopology:
    """Two-RTT topology: one LAN and one WAN value, scalar pricing."""
    g = max(replica_region) + 1 if replica_region else 1
    rtt = tuple(
        tuple(intra_rtt_ms if i == j else inter_rtt_ms for j in range(g))
        for i in range(g)
    )
    return RegionTopology(
        replica_region=tuple(int(r) for r in replica_region),
        rtt_ms=rtt,
        egress=EgressMatrix.from_pricing(g, pricing),
        client_region=client_region,
    )
