"""YCSB workload generator (paper §4.1; port of ``repro.storage.ycsb``).

Workload-A ("read-heavy" in the paper's terminology): 50% reads / 50%
writes.  Workload-B ("write-heavy", as the paper defines it): 5% reads /
95% writes.  Keys follow the YCSB zipfian request distribution over the
5M-row dataset; the paper runs 8M operations per experiment.
:class:`PhasedWorkload` runs several mixes back to back (the adaptive
control plane's workloads).
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


# ---------------------------------------------------------------------------
# Phase-shifting workloads
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhasedWorkload:
    """A schedule of workload phases, by fraction of the op stream.

    ``phases`` is a sequence of ``(workload, fraction)`` pairs; fractions
    must sum to 1.  The generated stream runs each phase's read/write mix
    back to back, sharing one key space, so staleness/violation behaviour
    (and therefore the SLA-feasible set of consistency levels) shifts at
    the phase boundaries.
    """

    name: str
    phases: tuple[tuple[Workload, float], ...]
    n_operations: int = 8_000_000
    zipf_theta: float = 0.99
    key_space: int = 5_000_000

    def __post_init__(self):
        total = sum(f for _, f in self.phases)
        if not np.isclose(total, 1.0):
            raise ValueError(f"phase fractions sum to {total}, expected 1")

    @property
    def read_fraction(self) -> float:
        """Stream-average read fraction (for closed-form models)."""
        return sum(w.read_fraction * f for w, f in self.phases)

    def phase_lengths(self, n_ops: int) -> list[int]:
        """Op count per phase (remainder goes to the last phase)."""
        lens = [int(n_ops * f) for _, f in self.phases[:-1]]
        return lens + [n_ops - sum(lens)]


# The adaptive benchmarks' phase-shifting mixes: a single read-heavy →
# write-heavy regime change, and a there-and-back-again.
PHASED_RW = PhasedWorkload(
    "phased-read2write", ((WORKLOAD_C, 0.5), (WORKLOAD_B, 0.5))
)
PHASED_RWR = PhasedWorkload(
    "phased-read-write-read",
    ((WORKLOAD_C, 1 / 3), (WORKLOAD_B, 1 / 3), (WORKLOAD_C, 1 / 3)),
)


def rates(w: Workload, throughput_ops_s: float) -> tuple[float, float]:
    """(lambda_r, lambda_w) per-key-cluster arrival rates at a given
    system throughput (the staleness model's inputs)."""
    lr = w.read_fraction * throughput_ops_s
    lw = (1.0 - w.read_fraction) * throughput_ops_s
    return lr, lw


def generate_phased(
    pw: PhasedWorkload, *, n_ops: int | None = None,
    n_keys: int | None = None, seed: int = 0,
) -> dict[str, np.ndarray]:
    """Sample a phase-shifting op stream: :func:`generate`'s ``kind`` and
    ``key`` plus ``phase``, each op's phase index.  Phase ``i`` draws from
    seed ``seed + 7919 i``."""
    n = n_ops or pw.n_operations
    keys_n = n_keys or pw.key_space
    lens = pw.phase_lengths(n)
    kinds, keys, phase_ids = [], [], []
    for i, ((w, _), ln) in enumerate(zip(pw.phases, lens)):
        part = generate(
            w, n_ops=max(ln, 1), n_keys=keys_n, seed=seed + 7919 * i,
            zipf_theta=pw.zipf_theta,
        )
        kinds.append(part["kind"][:ln])
        keys.append(part["key"][:ln])
        phase_ids.append(np.full(ln, i, np.int32))
    return {
        "kind": np.concatenate(kinds),
        "key": np.concatenate(keys),
        "phase": np.concatenate(phase_ids),
    }
