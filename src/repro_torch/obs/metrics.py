"""Typed metric registry of the observability plane (port of
``repro.obs.metrics``: the registry, the summary, the serving tier's
:class:`HostHistogram` and the bandit windows).

The engine carries an ``obs`` block through its round loop: one
``(M, n_bins)`` int32 histogram matrix — one row per registered
distribution metric — and a dict of counters.  This module is the
bookkeeping around that state: which metrics a configuration records
(:func:`build_metrics`), their bin ranges as kernel inputs
(:func:`batch_bounds`), and the host-side summary of the final state
(:func:`summarize`).  The binning is ``repro_torch.kernels.ops.histogram``.

Distribution metrics, in row order: ``staleness_age`` (write frontier
minus served version, per read), ``violation_severity`` (the same ages
masked to violating reads), ``read_latency_ms`` (the RTT between the
client's and the serving replica's regions, per read; geo only),
``hint_depth`` (per-replica hint-queue depth each epoch; handoff +
faults only).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# Percentiles every summary renders, in order.
PERCENTILES = (50.0, 90.0, 99.0)

# Counter keys of the obs carry block, in registry order.
COUNTERS = ("ops", "reads", "writes", "stale", "viol", "epochs")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """The observability plane's knobs (hashable).

    ``n_bins`` is shared by every metric row; the ``*_hi`` bounds pick
    each metric's bin range (observations at or above saturate into the
    top bin).  ``impl`` is the ``ops.histogram`` implementation
    (``None`` = auto: the kernel on the card, the plain version on the
    CPU).
    """

    enabled: bool = True
    n_bins: int = 64
    age_hi: float = 1024.0
    latency_hi_ms: float = 512.0
    depth_hi: float = 1024.0
    impl: str | None = None

    def __post_init__(self) -> None:
        if self.n_bins < 2:
            raise ValueError(f"n_bins must be >= 2, got {self.n_bins}")
        for name in ("age_hi", "latency_hi_ms", "depth_hi"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")


class MetricSpec(NamedTuple):
    """One registered distribution metric (one histogram row)."""

    name: str
    lo: float
    hi: float
    per_op: bool   # True: one observation per op; False: per epoch state
    mask: str      # which observations count (documentation only)


def build_metrics(
    obs: ObsConfig, *, geo_on: bool, h_on: bool,
) -> tuple[MetricSpec, ...]:
    """The metric registry of one engine configuration: per-op metrics
    first (one kernel call bins them together), then per-epoch state."""
    specs = [
        MetricSpec("staleness_age", 0.0, obs.age_hi, True, "reads"),
        MetricSpec("violation_severity", 0.0, obs.age_hi, True,
                   "violations"),
    ]
    if geo_on:
        specs.append(MetricSpec(
            "read_latency_ms", 0.0, obs.latency_hi_ms, True, "reads"
        ))
    if h_on:
        specs.append(MetricSpec(
            "hint_depth", 0.0, obs.depth_hi, False, "replicas"
        ))
    return tuple(specs)


def batch_bounds(
    specs: tuple[MetricSpec, ...],
) -> tuple[np.ndarray, np.ndarray, int]:
    """(lo, hi, count) of the per-op metric rows, as kernel inputs."""
    per_op = [s for s in specs if s.per_op]
    lo = np.asarray([s.lo for s in per_op], np.float32)
    hi = np.asarray([s.hi for s in per_op], np.float32)
    return lo, hi, len(per_op)


def summarize(
    obs: ObsConfig,
    specs: tuple[MetricSpec, ...],
    hist: np.ndarray,          # (M, n_bins) int32 — final carry state
    counters: dict[str, int],
) -> dict:
    """The per-run obs summary dict: per metric its range, counts,
    histogram and percentiles (:func:`host_percentile`), plus counters."""
    hist = np.asarray(hist)
    metrics = {}
    for row, spec in enumerate(specs):
        counts = hist[row]
        width = (spec.hi - spec.lo) / obs.n_bins
        entry = {
            "lo": spec.lo,
            "hi": spec.hi,
            "n_bins": obs.n_bins,
            "mask": spec.mask,
            "count": int(counts.sum()),
            "hist": counts.tolist(),
        }
        for q in PERCENTILES:
            entry[f"p{q:g}"] = float(host_percentile(
                counts, spec.lo, width, q
            ))
        metrics[spec.name] = entry
    return {
        "n_bins": obs.n_bins,
        "metrics": metrics,
        "counters": {k: int(v) for k, v in counters.items()},
    }


def host_percentile(
    counts: np.ndarray, lo: float, width: float, q: float,
) -> float:
    """Lower-edge percentile of a histogram (the rank rule of
    ``kernels.histogram.hist_percentile``); empty histograms report
    ``lo``."""
    counts = np.asarray(counts, np.int64)
    n = int(counts.sum())
    if n == 0:
        return float(lo)
    rank = int(np.floor(q / 100.0 * np.float32(n - 1)))
    idx = int(np.sum(np.cumsum(counts) <= rank))
    return float(lo + min(idx, counts.shape[0] - 1) * width)


class HostHistogram:
    """Fixed-bin histogram over numpy accumulators — the serving tier's
    per-region latency and staleness-age state, with the device plane's
    bin and percentile rules (saturating edge bins, lower-edge ranks).
    Observations are f32 and ``(values - lo) / width`` stays f32 (NumPy
    >= 2 keeps a Python float from widening an f32 array), so the bins
    equal the reference's."""

    def __init__(self, lo: float, hi: float, n_bins: int = 64):
        if n_bins < 2 or hi <= lo:
            raise ValueError(f"bad histogram range [{lo}, {hi}) x {n_bins}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.n_bins = int(n_bins)
        self.width = (self.hi - self.lo) / self.n_bins
        self.counts = np.zeros(self.n_bins, np.int64)

    def observe(self, values, weights=None) -> None:
        values = np.atleast_1d(np.asarray(values, np.float32))
        idx = np.clip(
            np.floor((values - self.lo) / self.width).astype(np.int64),
            0, self.n_bins - 1,
        )
        if weights is None:
            np.add.at(self.counts, idx, 1)
        else:
            np.add.at(self.counts, idx,
                      np.atleast_1d(np.asarray(weights, np.int64)))

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def percentile(self, q: float) -> float:
        return host_percentile(self.counts, self.lo, self.width, q)

    def summary(self) -> dict:
        out = {"count": self.count}
        for q in PERCENTILES:
            out[f"p{q:g}"] = self.percentile(q)
        return out


# -- bandit windows -------------------------------------------------------------
# The policy controllers' state (``ControllerState`` / ``CadenceState``)
# records epochs and aggregates windowed sums through these, so their
# forgetting semantics cannot drift apart.


def window_init(window: int, shape: tuple[int, ...], *, device="cpu"):
    """A zeroed f32 ``(window, *shape)`` ring."""
    return torch.zeros((window, *shape), dtype=torch.float32, device=device)


def window_record(win, ptr: int, sample):
    """Overwrite slot ``ptr % window`` with this epoch's sample (old
    evidence in that slot ages out — the bandit forgetting scheme).  The
    reference returns a new ring; this writes the slot in place and
    returns ``win``."""
    win[ptr % win.shape[0]] = sample
    return win


def window_total(win):
    """Windowed sum over the ring axis, added slot by slot in index order
    (the reference's reduction order on the CPU; the policy windows hold
    integer counts below 2^24, whose sums are exact in any order)."""
    total = win[0].clone()
    for i in range(1, win.shape[0]):
        total += win[i]
    return total
