"""Region-aware cluster topology (port of ``repro.geo.topology``).

:class:`RegionTopology` maps each protocol replica to a region, answers
latency questions from a (G, G) RTT matrix, and prices every region pair
through a tiered :class:`repro_torch.core.cost_model.EgressMatrix`.

The paper's cluster is the degenerate instance :data:`PAPER_TOPOLOGY`:
three regions, one replica each, 0.115 ms on the diagonal, 45.7 ms off
it, intra free / inter $0.01 per GB.  :func:`single_region` degenerates
further (every pair is intra), and the geo driver equals the flat one on
it.  Every field is a tuple, so topologies hash and compare by value.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.cost_model import EgressMatrix, PAPER_PRICING, PricingScheme


@dataclasses.dataclass(frozen=True)
class RegionTopology:
    """Replica→region map + (G, G) RTT and egress-price matrices.

    ``client_region`` optionally pins client populations to regions; by
    default a client lives where its home replica does
    (``replica_region[client % P]``).
    """

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
        if self.client_region is not None:
            for r in self.client_region:
                if not 0 <= r < g:
                    raise ValueError(
                        f"client region {r} out of range [0, {g})"
                    )

    # -- shapes -----------------------------------------------------------------

    @property
    def n_regions(self) -> int:
        return len(self.rtt_ms)

    @property
    def n_replicas(self) -> int:
        return len(self.replica_region)

    def regions(self) -> np.ndarray:
        """(P,) int32 replica→region map."""
        return np.asarray(self.replica_region, np.int32)

    def rtt(self) -> np.ndarray:
        """(G, G) float32 RTT matrix (what the engine and planner read)."""
        return np.asarray(self.rtt_ms, np.float32)

    def replicas_in(self, region: int) -> np.ndarray:
        return np.flatnonzero(self.regions() == region)

    def region_counts(self) -> np.ndarray:
        """(G,) replicas hosted per region."""
        return np.bincount(self.regions(), minlength=self.n_regions)

    # -- client / latency lookups -----------------------------------------------

    def client_region_of(self, client) -> np.ndarray:
        """Region of each client id: ``client_region[c % len]`` when the
        table is set, else the home replica's region."""
        c = np.asarray(client, np.int64)
        if self.client_region is not None:
            table = np.asarray(self.client_region, np.int32)
            return table[c % len(table)]
        return self.regions()[c % self.n_replicas]

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

    def nearest_replica(self, region: int, up: np.ndarray | None = None) -> int:
        """Nearest replica to ``region`` by RTT (ties → lowest index);
        ``up`` restricts to live replicas, and none live raises."""
        rtts = self.replica_rtt_from(region)
        if up is not None:
            mask = np.asarray(up, bool)[: self.n_replicas]
            if not mask.any():
                raise ValueError("no live replica")
            rtts = np.where(mask, rtts, np.inf)
        return int(np.argmin(rtts))

    # -- merge structure ----------------------------------------------------------

    def intra_link(self) -> np.ndarray:
        """(P, P) bool — same-region replica pairs (tier-1 merge links)."""
        r = self.regions()
        return r[:, None] == r[None, :]

    def region_onehot(self) -> np.ndarray:
        """(P, G) bool — replica p hosted in region g."""
        return (
            self.regions()[:, None]
            == np.arange(self.n_regions, dtype=np.int32)[None, :]
        )


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


@functools.lru_cache(maxsize=None)
def single_region(
    n_replicas: int = 3,
    *,
    intra_rtt_ms: float = 0.115,
    pricing: PricingScheme = PAPER_PRICING,
) -> RegionTopology:
    """The one-region fleet: every pair is intra-region, so the two-tier
    merge has no WAN phase and the geo driver equals the flat one."""
    return uniform_topology(
        (0,) * n_replicas,
        intra_rtt_ms=intra_rtt_ms,
        inter_rtt_ms=intra_rtt_ms,
        pricing=pricing,
    )


# The paper's §4 setup: three regions (the DCs), one protocol replica
# each, Gigabit LAN on the diagonal, the measured 45.7 ms WAN elsewhere,
# Table-2 pricing (intra free, inter $0.01/GB).
PAPER_TOPOLOGY = uniform_topology(
    (0, 1, 2), intra_rtt_ms=0.115, inter_rtt_ms=45.7, pricing=PAPER_PRICING
)
