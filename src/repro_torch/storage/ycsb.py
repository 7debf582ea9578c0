"""YCSB workload generator (paper §4.1; port of ``repro.storage.ycsb``).

Workload-A ("read-heavy" in the paper's terminology): 50% reads / 50%
writes.  Workload-B ("write-heavy", as the paper defines it): 5% reads /
95% writes.  Keys follow the YCSB zipfian request distribution over the
5M-row dataset; the paper runs 8M operations per experiment.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    read_fraction: float
    n_operations: int = 8_000_000
    zipf_theta: float = 0.99
    key_space: int = 5_000_000


WORKLOAD_A = Workload("workload-A", read_fraction=0.50)
WORKLOAD_B = Workload("workload-B", read_fraction=0.05)
WORKLOAD_C = Workload("workload-C", read_fraction=0.95)


def generate(
    w: Workload, *, n_ops: int | None = None, n_keys: int | None = None,
    seed: int = 0, zipf_theta: float | None = None,
) -> dict[str, np.ndarray]:
    """Sample a (scaled) operation stream: ``kind`` (0=read 1=write) and
    ``key``, in arrival order."""
    rng = np.random.default_rng(seed)
    n = n_ops or w.n_operations
    keys_n = n_keys or w.key_space
    theta = w.zipf_theta if zipf_theta is None else zipf_theta
    if theta <= 0:
        raise ValueError(
            f"zipf_theta must be > 0 (got {theta}); numpy's zipf sampler "
            "requires exponent 1+theta > 1"
        )
    kind = (rng.random(n) >= w.read_fraction).astype(np.int32)
    # Zipfian over a permuted key space (standard YCSB scrambling).
    ranks = rng.zipf(1.0 + theta, size=n)
    key = ((ranks - 1) % keys_n).astype(np.int64)
    return {"kind": kind, "key": key}

