"""Op-stream generation and batching plans (port of
``repro.engine.stream``; numpy, computed on the host once per run)."""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.core.replicated_store import merge_cadence

if TYPE_CHECKING:
    # Annotation-only: the ycsb import is deferred into op_stream /
    # op_stream_phased, as in the reference, so that ``import
    # repro_torch.engine`` works before ``repro_torch.storage`` finishes
    # initializing (its __init__ pulls the simulator, which imports
    # this package).
    from repro_torch.storage.ycsb import PhasedWorkload, Workload

OP_COLS = ("client", "kind", "resource", "home")


def attach_clients(
    ops: dict[str, np.ndarray], n_ops: int, n_clients: int,
    n_resources: int, seed: int, n_replicas: int = 3,
) -> dict[str, np.ndarray]:
    """Attach the client/mobility model to a generated op stream.

    A client's home replica is its DC (``client % n_replicas``); 30% of
    ops hit one of the next two replicas in ring order instead (client
    mobility, paper Fig. 2)."""
    rng = np.random.default_rng(seed + 1)
    client = rng.integers(0, n_clients, n_ops).astype(np.int32)
    move = rng.random(n_ops) < 0.30
    offset = rng.integers(1, 3, n_ops)
    home = (
        (client % n_replicas + np.where(move, offset, 0)) % n_replicas
    ).astype(np.int32)
    return {
        "client": client,
        "kind": ops["kind"].astype(np.int32),
        "resource": (ops["key"] % n_resources).astype(np.int32),
        "home": home,
    }


def op_stream(
    w: Workload, n_ops: int, n_clients: int, n_resources: int, seed: int,
    n_replicas: int = 3,
) -> dict[str, np.ndarray]:
    """The YCSB op stream of one run."""
    from repro_torch.storage.ycsb import generate

    ops = generate(w, n_ops=n_ops, n_keys=n_resources, seed=seed)
    return attach_clients(
        ops, n_ops, n_clients, n_resources, seed, n_replicas
    )


def op_stream_phased(
    pw: PhasedWorkload, n_ops: int, n_clients: int, n_resources: int,
    seed: int,
) -> dict[str, np.ndarray]:
    """Phase-shifting variant of :func:`op_stream` (same client model)."""
    from repro_torch.storage.ycsb import generate_phased

    ops = generate_phased(pw, n_ops=n_ops, n_keys=n_resources, seed=seed)
    return attach_clients(ops, n_ops, n_clients, n_resources, seed)


def cadence_plan(
    level: ConsistencyLevel, n_ops: int, batch_size: int,
    merge_every: int, delta: int,
) -> tuple[int, int, int, bool]:
    """(sub, rem, n_rounds, emulate) — the per-level batching plan.

    Synchronous and timed levels emulate their merge cadence inside
    ``batch_size``-op batches; untimed causal levels batch at their
    real merge period.
    """
    sync_every, _ = merge_cadence(level, merge_every, delta)
    emulate = sync_every == 1 or level.is_timed
    sub = batch_size if emulate else sync_every
    sub = max(1, min(sub, n_ops))
    n_rounds = n_ops // sub
    rem = n_ops - n_rounds * sub
    return sub, rem, n_rounds, emulate


def batch_inputs(
    stream: dict[str, np.ndarray], store, sub: int, n_rounds: int,
    rem: int, emulate: bool,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """(batched, tail) per-round inputs for one stream under one plan.

    ``batched[k]`` is ``(n_rounds, sub)``; the emulated-cadence levels
    also carry the precomputed apply-point schedule
    (``store.schedule_stream``), sliced per round.  ``rem == 0`` still
    builds a one-op tail, which the replay ignores.
    """
    batched = {
        k: stream[k][: n_rounds * sub].reshape(n_rounds, sub)
        for k in OP_COLS
    }
    tail = {k: stream[k][-max(rem, 1):] for k in OP_COLS}
    if emulate and store.sync_every > 1:
        apply_idx = store.schedule_stream(
            stream["client"], stream["home"], stream["kind"]
        )
        batched["apply_idx"] = apply_idx[: n_rounds * sub].reshape(
            n_rounds, sub
        )
        tail["apply_idx"] = apply_idx[-max(rem, 1):]
    return batched, tail


def fault_epoch_inputs(
    schedule, n_rounds: int, rem: int, crashes: bool = False,
) -> tuple[object, dict[str, np.ndarray], dict[str, np.ndarray]]:
    """(schedule, per-round mask arrays, tail mask arrays) of a schedule
    sliced to the run's epochs: ``up``, the closed ``conn``, ``faulty``
    and ``heal``; ``crashes`` adds the crash-event and rejoin masks
    (``crash``, ``rejoin``)."""
    n_epochs = n_rounds + (1 if rem else 0)
    schedule = schedule.slice(n_epochs)
    conn = schedule.closure()
    faulty = schedule.faulty()
    heals = schedule.heals()
    per_round = {
        "up": schedule.up[:n_rounds],
        "conn": conn[:n_rounds],
        "faulty": faulty[:n_rounds],
        "heal": heals[:n_rounds],
    }
    t = n_epochs - 1
    tail = {
        "up": schedule.up[t],
        "conn": conn[t],
        "faulty": faulty[t],
        "heal": heals[t],
    }
    if crashes:
        crash = schedule.crashes()
        rejoin = schedule.rejoins()
        per_round["crash"] = crash[:n_rounds]
        per_round["rejoin"] = rejoin[:n_rounds]
        tail["crash"] = crash[t]
        tail["rejoin"] = rejoin[t]
    return schedule, per_round, tail


def clamp_apply_idx(
    apply_idx: np.ndarray, faulty: np.ndarray, sub: int, n_ops: int,
) -> np.ndarray:
    """Defer emulated apply points to end-of-epoch in faulty epochs."""
    out = np.asarray(apply_idx, np.int32).copy()
    for t in np.flatnonzero(faulty):
        lo = t * sub
        hi = min(n_ops, lo + sub)
        out[lo:hi] = np.maximum(out[lo:hi], hi)
    return out
