"""Stale-read rate — paper §3.5.1 and Appendix A (port of
``repro.core.staleness``: numpy and Python floats, no device).

Model: read and write arrivals are independent Poisson processes with
rates ``lambda_r`` and ``lambda_w`` (events/s).  A committed write takes
``T_p`` seconds to propagate to the other replicas (T, the local-write
time, is negligible against T_p and set to zero, as in the paper).  A
read served by one of the ``N`` replicas returns a stale value if it
lands inside the propagation window of some write and is served by one
of the ``N - X_R`` replicas the write has not reached (``X_R`` = replicas
participating in the read, per the consistency level).

Closed form
-----------
The paper's printed eq. (.4) is typographically corrupted (``e − λrTp``
for ``e^{-λr·Tp}``; a trailing ``(1+λr·λw)/(λr·λw)`` with mismatched
units).  We integrate eq. (.1) directly.  A read lands in a propagation
window iff the *age* of the most recent write at read time is < T_p; for
a Poisson(λw) write process the age is Exp(λw) (memorylessness), so

    P(window)  = P(Age < T_p) = 1 − e^{−λw·T_p}
    Pr(stale)  = (N − X_R)/N · (1 − e^{−λw·T_p})

The fraction of *reads* affected additionally scales with how often reads
interleave writes; conditioning a read on falling after at least one
write within the same busy period multiplies by λr/(λr+λw) when reads
and writes contend on the same key — we expose both the unconditioned
(`stale_read_rate`) and contention-adjusted (`stale_read_rate_contended`)
forms, plus the literal transcription of the paper's eq. (.4) for
comparison, and a discrete-event simulation that validates them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StalenessParams:
    lambda_r: float          # read arrival rate (1/s)
    lambda_w: float          # write arrival rate (1/s)
    t_p: float               # propagation time to all replicas (s)
    n_replicas: int          # N, the replication factor
    x_r: int = 1             # replicas engaged in a read (consistency level)


def stale_read_rate(p: StalenessParams) -> float:
    """Pr(next read is stale) — cleaned-up Appendix A closed form."""
    if p.n_replicas <= 1 or p.t_p <= 0.0:
        return 0.0
    frac_unreached = (p.n_replicas - p.x_r) / p.n_replicas
    window = 1.0 - float(np.exp(-p.lambda_w * p.t_p))
    return frac_unreached * window


def stale_read_rate_contended(p: StalenessParams) -> float:
    """Contention-adjusted form: scales by the probability that the busy
    period containing the read actually contains a prior write."""
    base = stale_read_rate(p)
    contend = p.lambda_w / (p.lambda_r + p.lambda_w)
    return base * contend


def stale_read_rate_paper_literal(p: StalenessParams) -> float:
    """Literal transcription of the paper's eq. (.4):

        Pr = (N−1)(1 − e^{−λr·T_p})(1 + λr·λw) / (N·λr·λw)

    Provided for side-by-side reporting only; it exceeds 1 for small
    rate products (dimensionally inconsistent)."""
    lr, lw, n = p.lambda_r, p.lambda_w, p.n_replicas
    if n <= 1 or lr <= 0 or lw <= 0:
        return 0.0
    return ((n - 1) * (1.0 - float(np.exp(-lr * p.t_p))) * (1.0 + lr * lw)) / (
        n * lr * lw
    )


def simulate_stale_reads(
    p: StalenessParams,
    *,
    horizon: float = 1000.0,
    seed: int = 0,
) -> tuple[float, int]:
    """Discrete-event Monte-Carlo of the Appendix-A model.

    Generates Poisson read/write arrivals on one key over ``horizon``
    seconds; each write becomes visible at a uniformly-random subset of
    replicas immediately (its coordinator) and at the rest after ``t_p``.
    Each read hits ``x_r`` uniformly-random replicas and returns the
    freshest version any of them holds; it is stale if that misses the
    globally-latest committed write.

    Returns (stale_fraction, n_reads).  Pure numpy; used to validate the
    closed form, not in any hot path.
    """
    rng = np.random.default_rng(seed)
    n_w = rng.poisson(p.lambda_w * horizon)
    n_r = rng.poisson(p.lambda_r * horizon)
    if n_r == 0:
        return 0.0, 0
    w_times = np.sort(rng.uniform(0.0, horizon, size=n_w))
    w_coord = rng.integers(0, p.n_replicas, size=n_w)
    r_times = np.sort(rng.uniform(0.0, horizon, size=n_r))

    stale = 0
    wi = 0
    for rt in r_times:
        while wi < n_w and w_times[wi] <= rt:
            wi += 1
        latest = wi - 1  # most recent write at read time
        if latest < 0:
            continue
        replicas = rng.choice(p.n_replicas, size=min(p.x_r, p.n_replicas),
                              replace=False)
        # Version visible at replica q: latest write w with
        # (w.time <= rt and w.coord == q) or (w.time + t_p <= rt).
        best = -1
        for q in replicas:
            for w in range(latest, -1, -1):
                if w_coord[w] == q or w_times[w] + p.t_p <= rt:
                    best = max(best, w)
                    break
        if best < latest:
            stale += 1
    return stale / n_r, int(n_r)


def staleness_vs_level(
    *,
    lambda_r: float,
    lambda_w: float,
    t_p: float,
    n_replicas: int,
    levels,
    delta_seconds: float | None = None,
) -> dict[str, float]:
    """Staleness per consistency level (the model behind Figs 10–11).

    Causal-family levels do not shrink the window by reading more
    replicas; they shrink ``t_p`` itself: CAUSAL orders but does not bound
    propagation (t_p unchanged), TCC/X-STCC bound it by Δ — we model the
    effective propagation as ``min(t_p, delta)`` with Δ expressed in
    seconds by the caller.  X-STCC additionally removes the session-local
    stale reads (RYW/MR hits) which is the ``1/N`` coordinator share.
    """
    from repro_torch.core.consistency import ConsistencyLevel

    if delta_seconds is None:
        delta_seconds = 0.25 * t_p
    out = {}
    for lv in levels:
        if lv in (ConsistencyLevel.ONE, ConsistencyLevel.TWO,
                  ConsistencyLevel.QUORUM, ConsistencyLevel.ALL):
            p = StalenessParams(lambda_r, lambda_w, t_p, n_replicas,
                                x_r=lv.read_replicas(n_replicas))
            out[lv.value] = stale_read_rate(p)
        elif lv is ConsistencyLevel.CAUSAL:
            p = StalenessParams(lambda_r, lambda_w, t_p, n_replicas, x_r=1)
            # Causal ordering converts cross-client stale reads into
            # delayed-but-ordered reads for the dependent fraction; the
            # independent fraction stays exposed.
            out[lv.value] = 0.75 * stale_read_rate(p)
        else:  # TCC / X_STCC: timed bound caps the window at Δ.
            bounded = StalenessParams(
                lambda_r, lambda_w, min(t_p, delta_seconds), n_replicas, x_r=1
            )
            rate = stale_read_rate(bounded)
            if lv is ConsistencyLevel.X_STCC:
                # Session guarantees remove the coordinator-local share.
                rate *= (n_replicas - 1) / n_replicas
            out[lv.value] = rate
    return out
