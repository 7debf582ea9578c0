"""Region-aware geo-replication layer (port of ``repro.geo``).

``geo.topology`` holds the replica→region map, the (G, G) RTT matrix and
the per-pair egress prices; ``geo.placement`` is the replica-placement
planner.  The init imports only the topology: ``storage.cluster``
derives its latency lookups from it, and ``geo.placement`` imports the
cluster config, so importing both here would close a cycle.
"""

from repro_torch.geo.topology import (  # noqa: F401
    PAPER_TOPOLOGY,
    RegionTopology,
    single_region,
)
