"""Continuous gossip anti-entropy + hinted handoff (port of
``repro.gossip``): range digests (:mod:`.digest`) and the host-side
cadence and peer schedules (:mod:`.scheduler`).  The digest diff is
``repro_torch.kernels.ops.digest_compare_pairs``; the repair merges and hint
queues live on ``repro_torch.core.replicated_store.ReplicatedStore``."""

from repro_torch.gossip.digest import (
    DIGEST_BYTES,
    N_COMPONENTS,
    checksum_weights,
    range_digests,
    range_of_resource,
)
from repro_torch.gossip.scheduler import GossipConfig, gossip_pairs

__all__ = [
    "DIGEST_BYTES",
    "N_COMPONENTS",
    "GossipConfig",
    "checksum_weights",
    "gossip_pairs",
    "range_digests",
    "range_of_resource",
]
