"""Storage simulator (port of ``repro.storage``)."""

from repro_torch.storage.cluster import PAPER_CLUSTER, ClusterConfig
from repro_torch.storage.simulator import (
    LevelMetrics,
    evaluate_level,
    run_protocol,
    run_protocol_scalar,
)
from repro_torch.storage.ycsb import WORKLOAD_A, WORKLOAD_B, Workload, generate

__all__ = [
    "PAPER_CLUSTER", "ClusterConfig", "LevelMetrics", "WORKLOAD_A",
    "WORKLOAD_B", "Workload", "evaluate_level", "generate", "run_protocol",
    "run_protocol_scalar",
]
