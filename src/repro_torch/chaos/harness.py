"""Seeded chaos runs: nemesis schedule -> fault path -> invariants (port
of ``repro.chaos.harness``).

One :func:`run_chaos` call draws a randomized nemesis schedule (crashes x
outages x partitions x gossip cadence) from the seed, runs
``run_protocol_faulty`` under it, runs the **never-crashed twin** (the
same schedule with the crash events stripped), then checks the causal
invariants (:mod:`repro_torch.chaos.invariants`) and drives both final
states through a quiescent all-up anti-entropy fixpoint, requiring the
rebuilt fleet to equal the never-crashed one bit for bit (replica
versions, replica clocks, the global version frontier).
:func:`run_chaos_suite` aggregates seeds into one verdict.

``obs=ObsConfig()`` records the crashed run's distributions (the twin
stays obs-free), and ``tracer=Tracer()`` (:mod:`repro_torch.obs.trace`)
receives the nemesis actions, per-epoch violation counts and each
invariant's verdict as trace instants.  Both runs go to ``device``
(``"cuda"`` unless the caller asks for the CPU).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any

import numpy as np
import torch

from repro_torch.chaos.invariants import check_invariants
from repro_torch.chaos.nemesis import random_gossip, random_schedule
from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.gossip import GossipConfig
from repro_torch.obs.metrics import ObsConfig
from repro_torch.storage.simulator import run_protocol_faulty
from repro_torch.storage.ycsb import WORKLOAD_A, Workload

__all__ = ["DEFAULT_RECOVERY", "run_chaos", "run_chaos_suite"]

# Snapshot + WAL: a crash restores the exact pre-crash applied state, so
# bit-exact convergence to the never-crashed twin is guaranteed.
DEFAULT_RECOVERY = DurabilityConfig(snapshot_every=4, wal=True)

_QUIESCE_PASSES = 2


def _quiesce(store, state):
    """All-up anti-entropy fixpoint: flush every live pending write."""
    p = store.n_replicas
    up = torch.ones((p,), dtype=torch.bool, device=store.device)
    link = torch.ones((p, p), dtype=torch.bool, device=store.device)
    for _ in range(_QUIESCE_PASSES):
        state, _ = store.anti_entropy(state, up=up, link=link)
    return state


def _fleet_signature(state) -> dict[str, np.ndarray]:
    cl = state.cluster
    return {
        "replica_version": cl.replica_version.cpu().numpy(),
        "replica_vc": cl.replica_vc.cpu().numpy(),
        "global_version": cl.global_version.cpu().numpy(),
    }


def _trace_nemesis(tracer, schedule) -> None:
    """The drawn schedule's actions, as trace instants on the epoch axis."""
    crashes, up, link = schedule.crashes(), schedule.up, schedule.link
    for t in range(schedule.n_epochs):
        for r in np.flatnonzero(crashes[t]):
            tracer.instant("nemesis.crash", epoch=t, replica=int(r))
        down = np.flatnonzero(~up[t])
        if down.size:
            tracer.instant("nemesis.outage", epoch=t, replicas=down.tolist())
        if not link[t].all():
            cut = int((~link[t]).sum() - (~link[t].diagonal()).sum())
            tracer.instant("nemesis.partition", epoch=t, cut_links=cut)


def run_chaos(
    seed: int,
    *,
    level: ConsistencyLevel = ConsistencyLevel.X_STCC,
    w: Workload = WORKLOAD_A,
    n_ops: int = 1024,
    batch_size: int = 128,
    n_replicas: int = 3,
    recovery: DurabilityConfig | None = DEFAULT_RECOVERY,
    gossip: GossipConfig | str | None = "random",
    p_crash: float = 0.08,
    p_outage: float = 0.10,
    p_partition: float = 0.08,
    quiet_tail: int = 3,
    obs: ObsConfig | None = None,
    tracer=None,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """One seeded chaos experiment; returns a verdict dict.

    ``gossip="random"`` lets the nemesis draw the cadence; a
    :class:`~repro_torch.gossip.GossipConfig` or ``None`` pins it.  The
    verdict's ``ok`` is True iff the invariants held *and* the rebuilt
    fleet converged bit for bit to the never-crashed twin."""
    n_epochs = n_ops // batch_size + (1 if n_ops % batch_size else 0)
    schedule = random_schedule(
        n_epochs, n_replicas, seed=seed, p_crash=p_crash, p_outage=p_outage,
        p_partition=p_partition, quiet_tail=min(quiet_tail, max(1, n_epochs - 1)),
    )
    if gossip == "random":
        gossip = random_gossip(seed)
    if tracer is not None:
        tracer.instant(
            "chaos.schedule", seed=seed, level=level.value, n_epochs=n_epochs,
            n_replicas=n_replicas,
            cadence=gossip.cadence if gossip is not None else 0,
        )
        _trace_nemesis(tracer, schedule)
    span = tracer.span if tracer is not None else (lambda name, **a: nullcontext())
    kw = dict(
        n_ops=n_ops, batch_size=batch_size, schedule=schedule, recovery=recovery,
        gossip=gossip, audit=True, obs=obs, device=device, _return_state=True,
    )
    with span("chaos.run", seed=seed):
        res = run_protocol_faulty(level, w, **kw)
    with span("chaos.twin", seed=seed):
        twin = run_protocol_faulty(level, w, **dict(
            kw, schedule=schedule.strip_crashes(), obs=None))

    crashed = schedule.has_crashes
    breaches = check_invariants(res, level, crashed=crashed)

    first_violation = None
    if obs is not None and obs.enabled:
        ob = res["obs"]
        first_violation = ob.get("first_violation_epoch")
        if tracer is not None:
            for t, v in enumerate(ob["per_round"]["viol"]):
                if v:
                    tracer.instant("invariant.violations", epoch=t, count=int(v))

    with span("chaos.quiesce"):
        sig = _fleet_signature(_quiesce(res["_store"], res["_state"]))
        twin_sig = _fleet_signature(_quiesce(twin["_store"], twin["_state"]))
    diverged = [k for k in sig if not np.array_equal(sig[k], twin_sig[k])]
    converged = not diverged

    if tracer is not None:
        tracer.instant("verdict.invariants", ok=not breaches, seed=seed,
                       **({"breaches": breaches} if breaches else {}))
        tracer.instant("verdict.convergence", ok=converged, seed=seed,
                       **({"diverged": diverged} if diverged else {}))

    return {
        "seed": seed,
        "level": level.value,
        "crashes": int(schedule.crashes().sum()),
        "outage_epochs": int((~schedule.up).sum()),
        "partitions": int(sum(1 for t in range(schedule.n_epochs)
                              if not schedule.link[t].all())),
        "gossip_cadence": gossip.cadence if gossip is not None else 0,
        "breaches": breaches,
        "converged": converged,
        "diverged_fields": diverged,
        "first_violation_epoch": first_violation,
        "metrics": {k: res[k] for k in ("staleness_rate", "violation_rate",
                                        "severity", "n_reads", "dropped_writes")},
        "recovery": res.get("recovery"),
        "ok": converged and not breaches,
    }


def run_chaos_suite(seeds=range(5), **kwargs: Any) -> dict[str, Any]:
    """:func:`run_chaos` across seeds, aggregated: ``ok`` is True iff every
    seed passed; the per-seed verdicts ride along under ``"runs"``."""
    runs = [run_chaos(int(s), **kwargs) for s in seeds]
    return {
        "n_seeds": len(runs),
        "n_crashes": sum(r["crashes"] for r in runs),
        "n_breaches": sum(len(r["breaches"]) for r in runs),
        "n_diverged": sum(0 if r["converged"] else 1 for r in runs),
        "ok": all(r["ok"] for r in runs),
        "runs": runs,
    }
