"""Session-guarantee-aware serving (port of ``repro.serve``)."""

from repro_torch.serve.engine import (
    ReplicaSnapshot,
    RetryPolicy,
    RoutingError,
    ServeSession,
    ServeTimeout,
    ServingEngine,
    ShardedServingRouter,
)

__all__ = [
    "ReplicaSnapshot",
    "RetryPolicy",
    "RoutingError",
    "ServeSession",
    "ServeTimeout",
    "ServingEngine",
    "ShardedServingRouter",
]
