"""Cluster simulator: the paper's evaluation (§4) and its failure path
(port of ``repro.storage.simulator``).

Three coupled models produce every figure of the paper:

  * **Latency/throughput** (Figs 8-9): a closed-loop model over the
    3-DC topology with per-level repair and coordination work;
  * **Protocol engine** (Figs 10-13): the op stream runs through the
    batched X-STCC engine (:class:`repro_torch.engine.EpochEngine`) on
    the device; staleness and violations are measured and severity
    comes from the DUOT audit;
  * **Monetary** (Figs 14-15): measured traffic × Table-2 pricing
    through ``core.cost_model``.

:func:`run_protocol_geo` replays the same stream over a region topology
(two-tier merge, RTT-matrix latency, per-pair egress bill);
:func:`run_protocol_faulty` replays it under replica outages and
partitions, with gossip anti-entropy, hinted handoff and WAL/snapshot
durability; :func:`run_protocol_sharded` splits it into disjoint tenant
shards.  :func:`run_protocol_adaptive` re-selects each session's level
every merge epoch through the adaptive control plane
(``repro_torch.policy``).  Every replay is a thin
:class:`repro_torch.engine.config.EngineConfig` over the one epoch engine.
Only the scalar engine (:func:`run_protocol_scalar`, one op at a time)
keeps its own loop: it is the semantic baseline the batched engine is
held against.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import audit as audit_lib
from repro_torch.core import availability as avail_lib
from repro_torch.core import cost_model, xstcc
from repro_torch.core import duot as duot_lib
from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.core.replicated_store import DurabilityConfig, merge_cadence
from repro_torch.engine import results as engine_results
from repro_torch.engine import stream as engine_stream
from repro_torch.engine.config import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.engine.replay import EpochEngine, session_telemetry_runner
from repro_torch.gossip.scheduler import GossipConfig
from repro_torch.obs.metrics import ObsConfig
from repro_torch.storage.cluster import PAPER_CLUSTER, ClusterConfig
from repro_torch.storage.ycsb import PhasedWorkload, Workload

# Server-side repair work per stale read, in units of one op's service
# cost (ONE repairs across DCs; X-STCC fixes up locally via the DUOT).
REPAIR_COST = {
    ConsistencyLevel.ONE: 1.8,
    ConsistencyLevel.CAUSAL: 0.8,
    ConsistencyLevel.TCC: 0.45,
    ConsistencyLevel.X_STCC: 0.25,
    ConsistencyLevel.QUORUM: 0.3,
    ConsistencyLevel.ALL: 0.0,
    ConsistencyLevel.TWO: 1.0,
}
# Extra coordination work per write (remote ack bookkeeping).
WRITE_COORD = {
    ConsistencyLevel.ONE: 0.14,
    ConsistencyLevel.CAUSAL: 0.22,
    ConsistencyLevel.TCC: 0.10,
    ConsistencyLevel.X_STCC: 0.02,   # 64-byte DUOT append, piggybacked
    ConsistencyLevel.QUORUM: 0.42,
    ConsistencyLevel.ALL: 0.62,
    ConsistencyLevel.TWO: 0.2,
}
# Remote (inter-DC) repair traffic per stale read, in row payloads.
REPAIR_REMOTE = {
    ConsistencyLevel.ONE: 1.0, ConsistencyLevel.TWO: 1.0,
    ConsistencyLevel.CAUSAL: 0.5, ConsistencyLevel.TCC: 0.25,
    ConsistencyLevel.X_STCC: 0.0, ConsistencyLevel.QUORUM: 0.0,
    ConsistencyLevel.ALL: 0.0,
}


@dataclasses.dataclass
class LevelMetrics:
    level: str
    workload: str
    n_threads: int
    throughput_ops_s: float
    mean_latency_ms: float
    staleness_rate: float
    violation_rate: float
    severity: float
    runtime_s: float
    inter_dc_gb: float
    intra_dc_gb: float
    cost: dict


def op_latency_ms(
    level: ConsistencyLevel, kind: str, cfg: ClusterConfig, stale_rate: float,
) -> float:
    """Mean client-observed latency of one op."""
    acks = level.write_acks(cfg.replication_factor)
    reads = level.read_replicas(cfg.replication_factor)
    if kind == "write":
        # X-STCC's DUOT registration piggybacks on the write itself.
        return cfg.ack_latency_ms(acks)
    base = cfg.read_latency_ms(reads)
    # Only X-STCC's session reroute is synchronous, and it is intra-DC.
    if level is ConsistencyLevel.X_STCC:
        base += stale_rate * cfg.intra_dc_rtt_ms
    return base


def throughput_model(
    level: ConsistencyLevel, w: Workload, n_threads: int,
    cfg: ClusterConfig, stale_rate: float,
) -> tuple[float, float]:
    """(throughput ops/s, mean latency ms) — closed loop with saturation."""
    r = w.read_fraction
    lat = (r * op_latency_ms(level, "read", cfg, stale_rate)
           + (1 - r) * op_latency_ms(level, "write", cfg, stale_rate))
    pipeline_depth = 8          # async requests in flight per thread
    offered = pipeline_depth * n_threads / (lat / 1e3)
    work = 1.0 + r * stale_rate * REPAIR_COST[level] \
        + (1 - r) * WRITE_COORD[level]
    capacity = cfg.n_nodes * cfg.node_service_rate_ops_s / work
    # Smooth saturation + mild coordination decay beyond 64 threads.
    thr = offered / (1.0 + (offered / capacity) ** 2) ** 0.5
    if n_threads > 64:
        thr *= 1.0 - 0.08 * (n_threads - 64) / 36.0
    eff_lat = n_threads / thr * 1e3
    return thr, eff_lat


def run_protocol(
    level: ConsistencyLevel,
    w: Workload,
    *,
    n_ops: int = 6000,
    n_clients: int = 16,
    n_resources: int = 24,
    merge_every: int = 8,
    delta: int = 24,
    duot_cap: int = 2048,
    seed: int = 0,
    batch_size: int = 128,
    audit: bool = True,
    ingest: str = "auto",
    lean: bool = False,
    obs: ObsConfig | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Run a scaled YCSB stream through the batched X-STCC engine.

    Synchronous and timed levels ingest ``batch_size``-op batches with
    their finer merge cadence emulated inside each batch; untimed causal
    levels (CAUSAL / ONE) batch at their real merge period.
    ``audit=False`` skips the end-of-run DUOT audit (severity 0);
    ``lean`` (emulated levels, ``audit=False``) drops the clock chain,
    the DUOT record and the causal merge gate.  ``obs`` (an
    :class:`~repro_torch.obs.metrics.ObsConfig`) adds an ``"obs"`` block
    (histograms, percentiles, per-round stale/violation series) and
    leaves every other key unchanged.  Runs on ``device`` (``"cuda"``
    unless the caller asks for the CPU).
    """
    config = EngineConfig(
        level, n_ops=n_ops, n_clients=n_clients, n_resources=n_resources,
        merge_every=merge_every, delta=delta, duot_cap=duot_cap,
        seed=seed, batch_size=batch_size, audit=audit, ingest=ingest,
        lean=lean, obs=obs,
    )
    engine = EpochEngine(config, device=device)
    return engine_results.assemble(config, engine.replay(w), w)


def run_protocol_geo(
    level: ConsistencyLevel,
    w: Workload,
    *,
    topology=None,
    n_ops: int = 6000,
    n_clients: int = 16,
    n_resources: int = 24,
    merge_every: int = 8,
    delta: int = 24,
    duot_cap: int = 2048,
    seed: int = 0,
    batch_size: int = 128,
    audit: bool = True,
    ingest: str = "auto",
    gossip: GossipConfig | None = None,
    recovery: DurabilityConfig | None = None,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: cost_model.PricingScheme = cost_model.PAPER_PRICING,
    obs: ObsConfig | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Run the protocol with region-aware propagation and billing.

    Same engine and op stream as :func:`run_protocol`, over a
    :class:`repro_torch.geo.topology.RegionTopology` (default: the
    paper's 3-region :data:`~repro_torch.geo.topology.PAPER_TOPOLOGY`):

      * the boundary merge is the two-tier region-grouped merge — the
        flat merge's state, with every delivery attributed to a region
        pair (LAN fan-out on the diagonal, one WAN hop per (write, newly
        reached region) off it);
      * the ``(G, G)`` traffic matrix is billed per pair through the
        topology's egress matrix, next to the aggregate-scalar bill;
      * per-op latency is the RTT between the client's region and the
        serving replica's region, reported per region with staleness.

    On :func:`~repro_torch.geo.topology.single_region` the protocol
    metrics equal :func:`run_protocol`'s.  ``gossip`` adds the scheduled
    digest exchange (``peer="nearest"`` orders peers by region RTT),
    billed per region pair; ``recovery`` bills the steady-state WAL and
    snapshot I/O on the matrix's diagonal; ``obs`` adds the ``"obs"``
    block with the ``read_latency_ms`` row.  Runs on ``device``
    (``"cuda"`` unless the caller asks for the CPU).
    """
    if topology is None:
        from repro_torch.geo.topology import PAPER_TOPOLOGY

        topology = PAPER_TOPOLOGY
    config = EngineConfig(
        level, n_ops=n_ops, n_clients=n_clients, n_resources=n_resources,
        merge_every=merge_every, delta=delta, duot_cap=duot_cap,
        seed=seed, batch_size=batch_size, audit=audit, ingest=ingest,
        topology=topology, gossip=gossip, durability=recovery, obs=obs,
    )
    engine = EpochEngine(config, device=device)
    return engine_results.assemble(config, engine.replay(w), w, cfg, pricing)


def run_protocol_faulty(
    level: ConsistencyLevel,
    w: Workload,
    *,
    schedule=None,
    n_ops: int = 6000,
    n_clients: int = 16,
    n_resources: int = 24,
    merge_every: int = 8,
    delta: int = 24,
    duot_cap: int = 2048,
    seed: int = 0,
    batch_size: int = 128,
    audit: bool = True,
    ingest: str = "auto",
    pending_cap: int | None = None,
    n_shards: int = 1,
    schedule_unit: int | None = None,
    gossip: GossipConfig | None = None,
    recovery: DurabilityConfig | None = None,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: cost_model.PricingScheme = cost_model.PAPER_PRICING,
    obs: ObsConfig | None = None,
    device: str | torch.device = "cuda",
    _return_state: bool = False,
) -> dict[str, Any]:
    """Run the protocol under replica outages and network partitions.

    ``schedule`` is a :class:`repro_torch.core.availability.FaultSchedule`
    whose epochs are this run's merge rounds (``None`` = all-up), sliced
    or extended to the run; ``schedule_unit`` (ops per schedule epoch)
    anchors it in op-index space instead, so one schedule describes the
    same outage window for every level.  Per epoch the engine runs the
    heal-time anti-entropy pass when connectivity gained an edge, fails
    over ops whose home replica is down, defers the closed-form cadence
    emulation to the masked merges while a fault is active, and merges
    along live, connected pairs only.  With an all-up schedule every
    step is the identity.

    The pending ring holds the partition backlog, so ``pending_cap``
    defaults to ``max(256, 2·sub, n_writes + 1)``.  ``gossip`` adds the
    scheduled digest exchange (and, with ``hint_cap > 0``, hinted
    handoff); ``recovery`` adds WAL/snapshot journaling, billed in
    eq. 8 with a ``"recovery"`` block.  ``obs`` adds the ``"obs"``
    block.  ``n_shards > 1`` stacks disjoint tenant shards under the one
    schedule (the :func:`run_protocol_sharded` scheme, counts summed).

    A schedule with crash events
    (:func:`repro_torch.core.availability.replica_crash`) destroys the
    crashed replica's applied state at the crash epoch and rebuilds it at
    its rejoin epoch: restore from ``recovery``'s durability layer, then a
    peer bootstrap that pulls the stale digest ranges from the nearest
    live holder.  The recovery I/O and traffic join the eq. 8 bill and
    the result gains ``crash_epochs``.  ``_return_state`` adds the final
    state and store under ``_state`` / ``_store`` (the chaos harness's
    convergence check).  Runs on ``device`` (``"cuda"`` unless the caller
    asks for the CPU).
    """
    if n_clients % n_shards or n_resources % n_shards or n_ops % n_shards:
        raise ValueError(
            f"n_clients={n_clients}, n_resources={n_resources}, and "
            f"n_ops={n_ops} must all be divisible by n_shards={n_shards}"
        )
    if schedule is None:
        s_ops = n_ops // n_shards
        _, rem, n_rounds, _ = engine_stream.cadence_plan(
            level, s_ops, batch_size, merge_every, delta
        )
        schedule = avail_lib.all_up(max(1, n_rounds + (1 if rem else 0)), 3)
    if schedule.n_replicas != 3:
        raise ValueError(
            f"schedule covers {schedule.n_replicas} replicas; the paper "
            "cluster has 3 DCs"
        )
    config = EngineConfig(
        level, n_ops=n_ops, n_clients=n_clients, n_resources=n_resources,
        merge_every=merge_every, delta=delta, duot_cap=duot_cap,
        seed=seed, batch_size=batch_size, audit=audit, ingest=ingest,
        faults=schedule, schedule_unit=schedule_unit, gossip=gossip,
        durability=recovery, pending_cap=pending_cap, n_shards=n_shards,
        obs=obs,
    )
    engine = EpochEngine(config, device=device)
    return engine_results.assemble(config, engine.replay(w), w, cfg, pricing,
                                   _return_state)


def run_protocol_sharded(
    level: ConsistencyLevel,
    w: Workload,
    *,
    n_shards: int = 2,
    n_ops: int = 6000,
    n_clients: int = 16,
    n_resources: int = 24,
    merge_every: int = 8,
    delta: int = 24,
    duot_cap: int = 2048,
    seed: int = 0,
    batch_size: int = 128,
    audit: bool = False,
    ingest: str = "auto",
    use_devices: bool = True,
    obs: ObsConfig | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Multi-tenant scale-out: disjoint shards of the workload.

    Partitions the cluster into ``n_shards`` tenant groups, each with
    ``n_clients / n_shards`` sessions, ``n_resources / n_shards`` key
    buckets and its own ``n_ops / n_shards``-op YCSB stream (seeded
    ``seed + shard``).  The shards share no replicas, sessions or
    resources, so the merged telemetry is exactly the sum of the
    per-shard unsharded runs; ``per_shard`` lists each shard's counts and
    ``severity`` (with ``audit``) is the mean of the shards'.  The shards
    run one after another inside each round on ``device``; with
    ``use_devices`` and a process group of at least ``n_shards`` ranks
    (the active ``DeviceMesh``'s 'shard' axis, or the world with no mesh
    set), each rank replays only its own shard on ``device`` and every
    rank returns the one-process result (``engine.replay.shard_group``).
    """
    if n_clients % n_shards or n_resources % n_shards or n_ops % n_shards:
        raise ValueError(
            f"n_clients={n_clients}, n_resources={n_resources}, and "
            f"n_ops={n_ops} must all be divisible by n_shards={n_shards}"
        )
    config = EngineConfig(
        level, n_ops=n_ops, n_clients=n_clients, n_resources=n_resources,
        merge_every=merge_every, delta=delta, duot_cap=duot_cap,
        seed=seed, batch_size=batch_size, audit=audit, ingest=ingest,
        n_shards=n_shards, use_devices=use_devices, obs=obs,
    )
    engine = EpochEngine(config, device=device)
    return engine_results.assemble(config, engine.replay(w), w)


def run_protocol_scalar(
    level: ConsistencyLevel,
    w: Workload,
    *,
    n_ops: int = 6000,
    n_clients: int = 16,
    n_resources: int = 24,
    merge_every: int = 8,
    delta: int = 24,
    duot_cap: int = 2048,
    seed: int = 0,
    audit: bool = True,
    device: str | torch.device = "cuda",
) -> dict[str, float]:
    """The scalar engine: one op at a time, the sequential merge.

    Scalar op ingestion and the one-slot-at-a-time
    :func:`~repro_torch.core.xstcc.server_merge_sequential` pass, the
    semantic and speed baseline the batched engine is held against.
    Runs on ``device`` (``"cuda"`` unless the caller asks for the CPU);
    the audit behind ``severity`` is the one of :func:`run_protocol`.
    """
    dev = resolve_device(device)
    stream = engine_stream.op_stream(w, n_ops, n_clients, n_resources, seed)
    _, d = merge_cadence(level, merge_every, delta)
    run = _scalar_runner(level, n_clients, n_resources, merge_every, delta,
                         duot_cap, dev)
    _, duot, n_stale, n_viol, n_reads = run(
        stream["client"], stream["kind"], stream["resource"], stream["home"])
    severity = 0.0
    if audit:
        severity = float(audit_lib.audit(duot, delta=d if d else 0).severity)
    n_reads_f = max(1, int(n_reads))
    return {
        "staleness_rate": float(int(n_stale)) / n_reads_f,
        "violation_rate": float(int(n_viol)) / n_reads_f,
        "severity": severity,
        "n_reads": int(n_reads),
    }


_PEND = ("pend_client", "pend_resource", "pend_version", "pend_vc", "pend_coord",
         "pend_time", "pend_live", "pend_applied")


def _scalar_runner(
    level: ConsistencyLevel,
    n_clients: int,
    n_resources: int,
    merge_every: int,
    delta: int,
    duot_cap: int,
    device: str | torch.device = "cuda",
):
    """``run(client, kind, resource, home)`` over host op columns:
    returns ``(state, duot, n_stale, n_viol, n_reads)``, the reference
    scan's final carry (3 replicas, a 256-slot pending ring).

    The reference steps one ``lax.cond`` per op inside a ``lax.scan``.
    Here the op columns are on the host, so the branch on the op's kind,
    the op's client, resource and home, the logical clock (one tick per
    op and per merge) and the DUOT row (the log never wraps) are all
    known there and cost the device nothing.  The state lives on the
    device and is updated in place: a write is ``client_write`` (merge
    and tick the session clock, the next version, the coordinator's copy
    and clock, the floors, the first free pending slot — an ``argmin``
    over the live flags plus one spare row, cleared after every write,
    so a full ring lands in the spare row and is counted as dropped); a
    read is
    ``client_read`` (served = max(replica, floors) under session
    enforcement, the read floor, the session clock).  Served versions
    and the frontier each read saw go to per-op buffers, so the stale
    and violation counts are two reductions at the end and no op needs a
    host read.  Every ``sync_every``-th op ends with
    :func:`~repro_torch.core.xstcc.merge_sequential_`, one host read each.
    """
    sync_every, d = merge_cadence(level, merge_every, delta)
    enforce = level is ConsistencyLevel.X_STCC
    dev = resolve_device(device)
    P, C, R, Q = 3, n_clients, n_resources, 256

    def run(client, kind, resource, home):
        client, kind, resource, home = (np.asarray(x, np.int32)
                                        for x in (client, kind, resource, home))
        n = client.shape[0]
        idx = np.arange(n, dtype=np.int32)
        clock_at = idx + idx // sync_every     # one tick per op and per merge
        i32 = dict(dtype=torch.int32, device=dev)
        col = {k: torch.from_numpy(v).to(dev) for k, v in (
            ("client", client), ("resource", resource), ("home", home),
            ("time", clock_at))}
        col["applied"] = (torch.arange(P, device=dev)[None, :]
                          == col["home"].long()[:, None])
        true = torch.ones((), dtype=torch.bool, device=dev)

        ext = xstcc.make_cluster(P, C, R, pending_cap=Q + 1, device=dev)
        st = ext._replace(**{k: getattr(ext, k)[:Q] for k in _PEND})
        live_u8 = ext.pend_live.view(torch.uint8)
        rv, rvc, svc_all = st.replica_version, st.replica_vc, st.session_vc
        rf, wf, gv = st.read_floor, st.write_floor, st.global_version
        version = torch.zeros((n,), **i32)     # created (W) or served (R)
        floor = torch.zeros((n,), **i32)       # read floor seen (R)
        frontier = torch.zeros((n,), **i32)    # global version seen (R)
        is_w = kind == duot_lib.WRITE
        slots = torch.zeros((int(is_w.sum()),), dtype=torch.int64, device=dev)
        m = min(n, duot_cap)
        duot_vc = torch.zeros((duot_cap, C), **i32)
        w_i = 0
        for i in range(n):
            c, r, h = int(client[i]), int(resource[i]), int(home[i])
            svc = svc_all[c]
            ver = version[i]
            if is_w[i]:
                torch.maximum(svc, rvc[h], out=svc)
                svc[c].add_(1)
                torch.add(gv[r], 1, out=ver)
                rv[h, r].clamp_(min=ver)
                rvc[h].clamp_(min=svc)
                wf[c, r].clamp_(min=ver)
                rf[c, r].clamp_(min=ver)
                gv[r].copy_(ver)
                q = torch.argmin(live_u8).view(1)
                slots[w_i].copy_(q[0])
                w_i += 1
                for name, val in (("pend_client", col["client"][i]),
                                  ("pend_resource", col["resource"][i]),
                                  ("pend_version", ver), ("pend_vc", svc),
                                  ("pend_coord", col["home"][i]),
                                  ("pend_time", col["time"][i]), ("pend_live", true),
                                  ("pend_applied", col["applied"][i])):
                    getattr(ext, name).index_put_((q,), val)
                ext.pend_live[Q] = False
            else:
                torch.maximum(rf[c, r], wf[c, r], out=floor[i])
                if enforce:
                    torch.maximum(rv[h, r], floor[i], out=ver)
                else:
                    ver.copy_(rv[h, r])
                frontier[i].copy_(gv[r])
                torch.maximum(svc, rvc[h], out=svc)
                svc[c].add_(1)
                rf[c, r].clamp_(min=ver)
            if i < m:
                duot_vc[i].copy_(svc)
            if i % sync_every == sync_every - 1:
                st.clock.fill_(int(clock_at[i]) + 1)
                xstcc.merge_sequential_(st, d, count=False)
        st.clock.fill_(n + n // sync_every)

        reads = torch.from_numpy(~is_w).to(dev)
        n_stale = ((version < frontier) & reads).sum(dtype=torch.int32)
        n_viol = (torch.zeros((), dtype=torch.int32, device=dev) if enforce
                  else ((version < floor) & reads).sum(dtype=torch.int32))
        dropped = torch.clamp((slots == Q).sum(), max=xstcc.INT32_MAX)
        state = st._replace(pend_dropped=dropped.to(torch.int32))

        def logged(a, fill):
            out = torch.full((duot_cap,), fill, **i32)
            out[:m] = torch.from_numpy(a[:m]).to(dev)
            return out

        valid = torch.zeros((duot_cap,), dtype=torch.bool, device=dev)
        valid[:m] = True
        seq = torch.zeros((duot_cap,), **i32)
        seq[:m] = torch.arange(m, **i32)
        log_version = torch.zeros((duot_cap,), **i32)
        log_version[:m] = version[:m]
        duot = duot_lib.Duot(
            client=logged(client, -1), kind=logged(kind, 0),
            resource=logged(resource, -1), version=log_version,
            replica=logged(home, -1), seq=seq, vc=duot_vc, valid=valid,
            size=torch.tensor(m, **i32), next_seq=torch.tensor(n, **i32),
        )
        n_reads = torch.tensor(int((~is_w).sum()), **i32)
        return state, duot, n_stale, n_viol, n_reads

    return run


# ---------------------------------------------------------------------------
# Adaptive mode: per-session level selection over merge epochs
# ---------------------------------------------------------------------------


def level_session_telemetry(
    level: ConsistencyLevel,
    stream: dict[str, np.ndarray],
    *,
    n_clients: int,
    n_resources: int,
    epoch_size: int,
    merge_every: int = 8,
    delta: int = 24,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Per-(epoch, session) protocol telemetry of one level on a stream.

    Runs the whole stream through the level's engine (the stream is
    level-independent, so this is the exact counterfactual of "every
    session at this level") and returns (E, S) int64 count arrays:
    ``stale``, ``viol``, ``reads``, ``writes``.  ``len(stream)`` must be
    a multiple of ``epoch_size``, and ``epoch_size`` a multiple of the
    level's merge cadence (so epochs align with real merge boundaries).
    The engine is the epoch engine in telemetry mode
    (:func:`repro_torch.engine.replay.session_telemetry_runner`), on
    ``device``.
    """
    n_ops = len(stream["client"])
    sync_every, _ = merge_cadence(level, merge_every, delta)
    emulate = sync_every == 1 or level.is_timed
    sub = epoch_size if emulate else sync_every
    if n_ops % epoch_size or epoch_size % sub:
        raise ValueError(
            f"n_ops={n_ops} must tile into epochs of {epoch_size}, and "
            f"epochs into merge sub-batches of {sub}"
        )
    n_sub = n_ops // sub

    store, run = session_telemetry_runner(
        level, n_clients, n_resources, merge_every, delta, sub, emulate,
        device=device,
    )
    batched = {k: stream[k].reshape(n_sub, sub) for k in engine_stream.OP_COLS}
    if emulate and store.sync_every > 1:
        apply_idx = store.schedule_stream(
            stream["client"], stream["home"], stream["kind"]
        )
        batched["apply_idx"] = apply_idx.reshape(n_sub, sub)
    stale, viol, reads, writes = run(batched)

    per_epoch = epoch_size // sub
    n_epochs = n_ops // epoch_size

    def fold(y):
        return y.reshape(n_epochs, per_epoch, n_clients).sum(1)

    return {
        "stale": fold(stale), "viol": fold(viol),
        "reads": fold(reads), "writes": fold(writes),
    }


def adaptive_telemetry(
    w: Workload | PhasedWorkload,
    *,
    n_ops: int = 6400,
    n_clients: int = 16,
    n_resources: int = 24,
    epoch_size: int | None = None,
    levels: tuple[ConsistencyLevel, ...] | None = None,
    merge_every: int = 8,
    delta: int = 24,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """The telemetry pass of :func:`run_protocol_adaptive` (same
    arguments): the run's ``n_ops`` (cut to whole epochs), ``epoch_size``
    and ``levels``, and ``telemetry``, the (E, S, L) ``stale``/``viol``
    and (E, S) ``reads``/``writes`` counts of every level on the run's
    stream."""
    from repro_torch.policy import sla as sla_lib

    if levels is None:
        levels = sla_lib.POLICY_LEVELS
    if epoch_size is None:
        # ~32 controller consultations, aligned to the slowest cadence
        # (ONE merges every 2*merge_every ops).
        align = 2 * merge_every
        epoch_size = max(align, (n_ops // 32) // align * align)
    n_ops = (n_ops // epoch_size) * epoch_size

    if isinstance(w, PhasedWorkload):
        stream = engine_stream.op_stream_phased(w, n_ops, n_clients, n_resources, seed)
    else:
        stream = engine_stream.op_stream(w, n_ops, n_clients, n_resources, seed)
    per_level = [
        level_session_telemetry(
            lv, stream, n_clients=n_clients, n_resources=n_resources,
            epoch_size=epoch_size, merge_every=merge_every, delta=delta,
            device=device,
        )
        for lv in levels
    ]
    return {
        "n_ops": n_ops,
        "epoch_size": epoch_size,
        "levels": tuple(levels),
        "telemetry": {
            "stale": np.stack([t["stale"] for t in per_level], axis=-1),
            "viol": np.stack([t["viol"] for t in per_level], axis=-1),
            # Read/write counts are stream properties, equal across levels.
            "reads": per_level[0]["reads"],
            "writes": per_level[0]["writes"],
        },
    }


def run_protocol_adaptive(
    w: Workload | PhasedWorkload,
    sla,
    *,
    n_ops: int = 6400,
    n_clients: int = 16,
    n_resources: int = 24,
    epoch_size: int | None = None,
    levels: tuple[ConsistencyLevel, ...] | None = None,
    merge_every: int = 8,
    delta: int = 24,
    seed: int = 0,
    window: int = 8,
    eps0: float = 0.02,
    eps_decay: float = 0.9,
    margin: float = 0.8,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: cost_model.PricingScheme = cost_model.PAPER_PRICING,
    impl: str = "auto",
    draws=None,
    telemetry: dict[str, Any] | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Adaptive mode: re-consult the controller every merge epoch.

    The op stream is cut into merge epochs (``epoch_size`` ops, each a
    whole number of the engine's merge cadences).  Every epoch the
    :class:`repro_torch.policy.controller.AdaptiveController` selects each
    session's consistency level from its SLA-scored telemetry window
    (``policy_score`` on the card); the epoch's ops then run at the
    selected levels and the measured per-session staleness/violations
    feed back into the window.  Because the op stream is
    level-independent, per-level telemetry is exact and precomputed
    (:func:`adaptive_telemetry`; pass its result as ``telemetry`` to
    reuse one pass).  The returned frontier compares the adaptive trace
    with every static level priced on the same telemetry.

    ``draws`` is the controller's ``(explore_u, arm)``, each (E, S);
    ``None`` draws them from a CPU generator seeded with ``seed`` (the
    reference's ``jax.random`` stream cannot be reproduced).  The
    adaptive cost sums the per-epoch f32 costs in f64.  Runs on
    ``device`` (``"cuda"`` unless the caller asks for the CPU).
    """
    from repro_torch.policy import sla as sla_lib
    from repro_torch.policy.controller import AdaptiveController

    if telemetry is None:
        telemetry = adaptive_telemetry(
            w, n_ops=n_ops, n_clients=n_clients, n_resources=n_resources,
            epoch_size=epoch_size, levels=levels, merge_every=merge_every,
            delta=delta, seed=seed, device=device,
        )
    n_ops, epoch_size, levels = (telemetry[k] for k in ("n_ops", "epoch_size",
                                                        "levels"))
    tel = telemetry["telemetry"]
    controller = AdaptiveController(
        n_clients, sla, levels=levels, window=window, eps0=eps0,
        eps_decay=eps_decay, margin=margin, cfg=cfg, pricing=pricing,
        merge_every=merge_every, delta=delta, impl=impl, device=device,
    )
    _, trace = controller.run_scan(seed, tel, draws=draws)

    reads_total = float(tel["reads"].sum())
    writes_total = float(tel["writes"].sum())
    table = controller.table.cpu().numpy()

    def level_static(j: int) -> dict[str, Any]:
        stale = float(tel["stale"][..., j].sum())
        viol = float(tel["viol"][..., j].sum())
        cost = (
            reads_total * float(table[sla_lib.LVL_READ_COST, j])
            + stale * float(table[sla_lib.LVL_REPAIR_COST, j])
            + writes_total * float(table[sla_lib.LVL_WRITE_COST, j])
        )
        stale_rate = stale / max(1.0, reads_total)
        viol_rate = viol / max(1.0, reads_total)
        feasible = (
            stale_rate <= sla.max_stale_read_rate
            and viol_rate <= sla.max_violation_rate
            and float(table[sla_lib.LVL_READ_LAT, j]) <= sla.max_read_latency_ms
            and float(table[sla_lib.LVL_STALE_AGE, j]) <= sla.max_staleness_ms
        )
        return {
            "cost": cost, "staleness_rate": stale_rate,
            "violation_rate": viol_rate, "feasible": feasible,
        }

    static = {lv.value: level_static(j) for j, lv in enumerate(levels)}
    feasible_costs = {k: v["cost"] for k, v in static.items() if v["feasible"]}
    cheapest = (min(feasible_costs, key=feasible_costs.get) if feasible_costs
                else None)

    # On the host, in a fixed order: the card and the CPU agree exactly.
    # The played counts are integer-valued f32.
    adaptive_stale = float(trace["stale"].cpu().numpy().astype(np.int64).sum())
    adaptive_viol = float(trace["viol"].cpu().numpy().astype(np.int64).sum())
    adaptive_cost = float(trace["cost"].cpu().numpy().astype(np.float64).sum())
    choice = trace["choice"].cpu().numpy()                  # (E, S)
    level_share = {
        lv.value: float((choice == j).mean()) for j, lv in enumerate(levels)
    }
    return {
        "workload": w.name,
        "sla": sla.name,
        "n_ops": n_ops,
        "epoch_size": epoch_size,
        "adaptive": {
            "cost": adaptive_cost,
            "staleness_rate": adaptive_stale / max(1.0, reads_total),
            "violation_rate": adaptive_viol / max(1.0, reads_total),
            "level_share": level_share,
        },
        "static": static,
        "cheapest_feasible_static": cheapest,
        "choice": choice,
    }


def traffic_gb(
    level: ConsistencyLevel, w: Workload, n_ops: int, cfg: ClusterConfig,
    stale_rate: float,
) -> tuple[float, float]:
    """(inter_dc_gb, intra_dc_gb) for the run — replica propagation +
    read fan-out + repair traffic."""
    r = w.read_fraction
    writes = (1 - r) * n_ops
    reads = r * n_ops
    row = cfg.row_bytes
    consulted = level.read_replicas(cfg.replication_factor)

    # Every write eventually reaches all 12 replicas (8 remote):
    inter = writes * 8 * row
    intra = writes * 3 * row
    # Synchronous read fan-out beyond the local DC:
    remote_reads = max(0, consulted - cfg.replicas_per_dc)
    inter += reads * remote_reads * row
    intra += reads * min(consulted, cfg.replicas_per_dc) * row
    # Repair traffic for stale reads:
    inter += reads * stale_rate * REPAIR_REMOTE[level] * row
    # X-STCC piggybacks vector clocks + DUOT entries on propagation:
    if level.is_causal:
        inter += writes * 8 * 64          # 16 clients x int32 clock
        intra += writes * 3 * 64
    return inter / 1e9, intra / 1e9


def evaluate_level(
    level: ConsistencyLevel,
    w: Workload,
    n_threads: int = 64,
    cfg: ClusterConfig = PAPER_CLUSTER,
    *,
    engine_ops: int = 6000,
    seed: int = 0,
    pricing: cost_model.PricingScheme = cost_model.PAPER_PRICING,
    device: str | torch.device = "cuda",
) -> LevelMetrics:
    """One level's full evaluation: measured protocol metrics, then the
    throughput, traffic and eq. 5-8 cost models."""
    proto = run_protocol(level, w, n_ops=engine_ops, seed=seed, device=device)
    stale = proto["staleness_rate"]
    thr, lat = throughput_model(level, w, n_threads, cfg, stale)
    runtime_s = w.n_operations / thr
    inter_gb, intra_gb = traffic_gb(level, w, w.n_operations, cfg, stale)
    bill = cost_model.cost_all(
        nb_instances=cfg.n_nodes,
        runtime_hours=runtime_s / 3600.0,
        hosted_gb=cfg.total_data_gb_after_replication,
        months=runtime_s / (30 * 24 * 3600.0),
        io_requests=float(w.n_operations) * level.write_acks(
            cfg.replication_factor),
        inter_dc_gb=inter_gb,
        intra_dc_gb=intra_gb,
        pricing=pricing,
    )
    return LevelMetrics(
        level=level.value,
        workload=w.name,
        n_threads=n_threads,
        throughput_ops_s=thr,
        mean_latency_ms=lat,
        staleness_rate=stale,
        violation_rate=proto["violation_rate"],
        severity=proto["severity"],
        runtime_s=runtime_s,
        inter_dc_gb=inter_gb,
        intra_dc_gb=intra_gb,
        cost=bill.as_dict(),
    )
