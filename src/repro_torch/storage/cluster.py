"""Cluster topology — the paper's experimental setup (§4, Fig. 7).

Three datacenters, 24 nodes total (8 per DC), replication factor 12 with
NetworkTopologyStrategy placement (4 replicas per DC), Gigabit Ethernet
inside a DC (0.115 ms RTT), 45.7 ms RTT between DCs; 2 cores / 4 GB per
node; 512 GiB storage per node.  (Port of ``repro.storage.cluster``.)
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.geo.topology import uniform_topology


@functools.lru_cache(maxsize=None)
def _config_topology(
    n_datacenters: int,
    replicas_per_dc: int,
    intra_dc_rtt_ms: float,
    inter_dc_rtt_ms: float,
):
    """RegionTopology of one config's key-replica placement (cached)."""
    return uniform_topology(
        tuple(
            int(d)
            for d in np.repeat(np.arange(n_datacenters), replicas_per_dc)
        ),
        intra_rtt_ms=intra_dc_rtt_ms,
        inter_rtt_ms=inter_dc_rtt_ms,
    )


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    n_datacenters: int = 3
    nodes_per_dc: int = 8
    replication_factor: int = 12
    replicas_per_dc: int = 4          # NetworkTopologyStrategy
    intra_dc_rtt_ms: float = 0.115
    inter_dc_rtt_ms: float = 45.7
    node_service_rate_ops_s: float = 4200.0   # per-node capacity (2 cores)
    row_bytes: int = 1024                      # YCSB default row payload
    dataset_rows: int = 5_000_000
    total_data_gb_after_replication: float = 18.65

    @property
    def n_nodes(self) -> int:
        return self.n_datacenters * self.nodes_per_dc

    def replica_dcs(self) -> np.ndarray:
        """DC id of each of the RF replicas of any key."""
        per = self.replicas_per_dc
        return np.repeat(np.arange(self.n_datacenters), per)

    def topology(self):
        """This config's key replicas as a RegionTopology."""
        return _config_topology(
            self.n_datacenters, self.replicas_per_dc,
            self.intra_dc_rtt_ms, self.inter_dc_rtt_ms,
        )

    def ack_latency_ms(self, acks: int) -> float:
        """Latency until `acks` replicas acknowledged a write (RTT of
        the ``acks``-th nearest replica from the client's region)."""
        topo = self.topology()
        return topo.ack_latency_ms(
            0, min(max(acks, 1), topo.n_replicas)
        )

    def read_latency_ms(self, consulted: int) -> float:
        topo = self.topology()
        return topo.read_latency_ms(
            0, min(max(consulted, 1), topo.n_replicas)
        )


PAPER_CLUSTER = ClusterConfig()
