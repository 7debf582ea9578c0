"""Result assembly for the epoch engine (port of
``repro.engine.results``: the flat, sharded, geo and fault-path
dictionaries, the fault path's ``"geo"`` block, the ``"obs"`` block and
its cost attribution).

Each ``assemble_*`` turns one :meth:`EpochEngine.replay` output into the
reference's dictionary — same keys, same float arithmetic, same order of
the billing terms — so results compare with ``==``.  The one exception
is the geo path's latency: ``mean_latency_ms`` and
``per_region.mean_latency_ms`` come from exact per-(client region,
serving region) op counts, ``Σ count·f64(rtt_f32)``, where the reference
adds f32 RTTs in an order XLA picks; the two agree within 1e-5
relative.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.replicated_store import index_tree
from repro_torch.engine.config import EngineConfig
from repro_torch.gossip import DIGEST_BYTES
from repro_torch.obs import metrics as obs_lib
from repro_torch.storage.cluster import PAPER_CLUSTER, ClusterConfig
from repro_torch.storage.ycsb import Workload


def _total(x) -> int:
    """A count summed over the shard axis (a tensor, array or int)."""
    return int(x.sum()) if isinstance(x, (torch.Tensor, np.ndarray)) else int(x)


def _severity(config: EngineConfig, store, st) -> float:
    """The DUOT audit's severity; with shards, the mean of the shards'
    severities (f64, as ``np.mean`` takes it)."""
    if not config.audit:
        return 0.0
    if config.n_shards > 1:
        sev = [float(store.audit(index_tree(st, s), delta=store.delta or 0).severity)
               for s in range(config.n_shards)]
        return float(np.mean(sev))
    return float(store.audit(st, delta=store.delta or 0).severity)


def assemble_flat(config: EngineConfig, prep: dict) -> dict[str, float]:
    out = prep["out"]
    st = out["st"]
    n_reads = int(out["reads"])
    n_reads_f = max(1, n_reads)
    return {
        "staleness_rate": float(int(out["stale"])) / n_reads_f,
        "violation_rate": float(int(out["viol"])) / n_reads_f,
        "severity": _severity(config, prep["store"], st),
        "n_reads": n_reads,
        "dropped_writes": int(st.cluster.pend_dropped),
    }


def assemble_sharded(config: EngineConfig, prep: dict) -> dict[str, Any]:
    """The multi-tenant dictionary: rates over the summed counts, and
    each shard's stale, violation and read counts."""
    out = prep["out"]
    st = out["st"]
    n_reads_total = _total(out["reads"])
    return {
        "staleness_rate": float(_total(out["stale"])) / max(1, n_reads_total),
        "violation_rate": float(_total(out["viol"])) / max(1, n_reads_total),
        "severity": _severity(config, prep["store"], st),
        "n_reads": n_reads_total,
        "dropped_writes": _total(st.cluster.pend_dropped),
        "n_shards": config.n_shards,
        "per_shard": {
            k: out[k].reshape(-1).tolist() for k in ("stale", "viol", "reads")
        },
    }


def _region_latency(config: EngineConfig, out: dict, sharded: bool = False):
    """(reads, stale, ops, latency sums) per client region, int64 and f64:
    the latency sum of region ``g`` is ``Σ_h count[g, h]·f64(rtt[g, h])``
    over the serving regions ``h``.  ``sharded`` sums the shard axis."""
    reg = {k: v.cpu().numpy().astype(np.int64) for k, v in out["reg"].items()}
    if sharded:
        reg = {k: v.sum(axis=0) for k, v in reg.items()}
    pairs = reg["pairs"]
    rtt = config.topology.rtt().astype(np.float64)
    lat = (pairs * rtt).sum(axis=1)
    return reg["reads"], reg["stale"], pairs.sum(axis=1), lat


def _per_region(reads, stale, ops, lat) -> dict[str, Any]:
    return {
        "reads": reads.tolist(),
        "stale": stale.tolist(),
        "ops": ops.tolist(),
        "staleness_rate": (stale / np.maximum(1, reads)).tolist(),
        "mean_latency_ms": (lat / np.maximum(1, ops)).tolist(),
    }


def assemble_geo(
    config: EngineConfig,
    prep: dict,
    w: Workload,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: cost_model.PricingScheme = cost_model.PAPER_PRICING,
) -> dict[str, Any]:
    """The region-aware dictionary: protocol rates, the (G, G) traffic
    matrix billed per pair (next to the aggregate-scalar bill), per-region
    staleness and RTT latency, and the ``"gossip"`` / ``"durability"``
    blocks when those subsystems ran."""
    from repro_torch.storage.simulator import throughput_model

    out = prep["out"]
    topology = config.topology
    gossip = config.gossip
    recovery = config.durability
    g_on = gossip is not None and gossip.enabled
    st = out["st"]
    n_reads = int(out["reads"])
    n_reads_f = max(1, n_reads)
    severity = _severity(config, prep["store"], st)
    stale_rate = float(int(out["stale"])) / n_reads_f
    n_ops = config.n_ops

    # -- region-pair billing (eq. 8 over the measured traffic matrix) ----
    events = out["traffic"].cpu().numpy().astype(np.int64)
    prop_gb = events * cfg.row_bytes / 1e9
    off = ~np.eye(topology.n_regions, dtype=bool)
    inter_gb = float(prop_gb[off].sum())
    intra_gb = float(np.diag(prop_gb).sum())
    # One pricebook per run: a custom egress matrix wins, but the default
    # paper-derived matrix follows a ``pricing`` override.
    egress = topology.egress
    if egress == cost_model.EgressMatrix.from_pricing(
        topology.n_regions, cost_model.PAPER_PRICING
    ):
        egress = cost_model.EgressMatrix.from_pricing(topology.n_regions, pricing)
    network_geo = cost_model.cost_network_matrix(traffic_gb=prop_gb, egress=egress)
    network_scalar = cost_model.cost_network(
        inter_dc_gb=inter_gb, intra_dc_gb=intra_gb, pricing=pricing
    )
    thr, _ = throughput_model(config.level, w, 64, cfg, stale_rate)
    runtime_s = n_ops / thr
    bill = cost_model.cost_all(
        nb_instances=cfg.n_nodes,
        runtime_hours=runtime_s / 3600.0,
        hosted_gb=cfg.total_data_gb_after_replication,
        months=runtime_s / (30 * 24 * 3600.0),
        io_requests=float(n_ops)
        * config.level.write_acks(cfg.replication_factor),
        inter_dc_gb=inter_gb,
        intra_dc_gb=intra_gb,
        pricing=pricing,
    )
    cost = bill.as_dict()
    cost["network_geo"] = network_geo
    cost["network_scalar"] = network_scalar
    cost["total_geo"] = cost["instances"] + cost["storage"] + network_geo

    gossip_info = None
    if g_on:
        ggx = out["ggx"]
        g_traffic = ggx["traffic"].cpu().numpy()
        g_digest = ggx["digest"].cpu().numpy()
        k_eff = max(1, min(gossip.n_ranges, config.n_resources))
        repair_mat_gb = g_traffic.astype(np.float64) * cfg.row_bytes / 1e9
        digest_mat_gb = g_digest.astype(np.float64) * k_eff * DIGEST_BYTES / 1e9
        gossip_network_geo = cost_model.cost_network_matrix(
            traffic_gb=repair_mat_gb + digest_mat_gb, egress=egress
        )
        cost["gossip_network_geo"] = gossip_network_geo
        cost["total_geo"] += gossip_network_geo
        gossip_info = {
            "cadence": gossip.cadence,
            "repair_events": g_traffic.tolist(),
            "repair_gb": float(repair_mat_gb.sum()),
            "digest_gb": float(digest_mat_gb.sum()),
            "ranges_diffed": int(ggx["ranges"]),
            "gap_repaired": int(ggx["gap"]),
            "peer": gossip.peer,
        }

    durability_info = None
    if recovery is not None and recovery.enabled:
        # Steady-state durable-I/O model (all-up, host-side only): every
        # write applies at all P replicas, and each snapshot persists the
        # inter-marker working set capped at the key count.
        n_epochs_total = prep["n_rounds"] + (1 if prep["rem"] else 0)
        se = recovery.snapshot_every
        n_snaps = n_epochs_total // se if se > 0 else 0
        n_writes = int((prep["streams"][0]["kind"] == 1).sum())
        wal_records_pp = n_writes if recovery.wal else 0
        per_snap = (
            min(config.n_resources, -(-n_writes // n_snaps)) if n_snaps else 0
        )
        snap_cells_pp = per_snap * n_snaps
        per_region = np.bincount(topology.regions(), minlength=topology.n_regions)
        dur_mat_gb = np.diag(
            (snap_cells_pp + wal_records_pp) * per_region * cfg.row_bytes / 1e9
        )
        durability_network_geo = cost_model.cost_network_matrix(
            traffic_gb=dur_mat_gb, egress=egress
        )
        cost["durability_network_geo"] = durability_network_geo
        cost["total_geo"] += durability_network_geo
        cost["durability_storage"] = cost_model.cost_storage(
            hosted_gb=3 * config.n_resources * cfg.row_bytes / 1e9,
            months=runtime_s / (30 * 24 * 3600.0),
            io_requests=float(
                (snap_cells_pp + wal_records_pp) * topology.n_replicas
            ),
            pricing=pricing,
        )
        durability_info = {
            "snapshot_every": se,
            "wal": recovery.wal,
            "snapshots": n_snaps,
            "snapshot_cells": snap_cells_pp * topology.n_replicas,
            "wal_records": wal_records_pp * topology.n_replicas,
            "durable_gb": float(dur_mat_gb.sum()),
            "durable_gb_by_region": np.diag(dur_mat_gb).tolist(),
        }

    reg_reads, reg_stale, reg_ops, reg_lat = _region_latency(config, out)
    result = {
        "staleness_rate": stale_rate,
        "violation_rate": float(int(out["viol"])) / n_reads_f,
        "severity": severity,
        "n_reads": n_reads,
        "dropped_writes": int(st.cluster.pend_dropped),
        "n_regions": topology.n_regions,
        "traffic_events": events.tolist(),
        "propagation_gb": prop_gb.tolist(),
        "mean_latency_ms": float(reg_lat.sum() / max(1, reg_ops.sum())),
        "per_region": _per_region(reg_reads, reg_stale, reg_ops, reg_lat),
        "cost": cost,
    }
    if gossip_info is not None:
        result["gossip"] = gossip_info
    if durability_info is not None:
        result["durability"] = durability_info
    return result


def _geo_block(config: EngineConfig, out: dict, cfg: ClusterConfig,
               sharded: bool) -> dict[str, Any]:
    """Region attribution of a run on a topology composed with faults:
    the (G, G) delivery matrix billed per pair (the topology's own egress
    matrix), and the per-region staleness and latency."""
    topology = config.topology
    events = out["traffic"].cpu().numpy().astype(np.int64)
    if sharded:
        events = events.sum(axis=0)
    prop_gb = events * cfg.row_bytes / 1e9
    reg_reads, reg_stale, reg_ops, reg_lat = _region_latency(config, out, sharded)
    return {
        "n_regions": topology.n_regions,
        "traffic_events": events.tolist(),
        "propagation_gb": prop_gb.tolist(),
        "network_geo": cost_model.cost_network_matrix(
            traffic_gb=prop_gb, egress=topology.egress
        ),
        "mean_latency_ms": float(reg_lat.sum() / max(1, reg_ops.sum())),
        "per_region": _per_region(reg_reads, reg_stale, reg_ops, reg_lat),
    }


def assemble_faulty(
    config: EngineConfig,
    prep: dict,
    w: Workload,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: cost_model.PricingScheme = cost_model.PAPER_PRICING,
    _return_state: bool = False,
) -> dict[str, Any]:
    """The failure-path dictionary: protocol rates, failover and
    propagation counts, the eq. 8 bill with the measured anti-entropy,
    gossip, durability and recovery traffic, and the ``"gossip"``,
    ``"recovery"`` (with ``crash_epochs``) and ``"geo"`` blocks when those
    subsystems ran.  ``_return_state`` adds the final state and the store
    under underscore keys (``_state``, ``_store``), which the
    dict-equality gates never see."""
    from repro_torch.storage.simulator import throughput_model, traffic_gb

    out = prep["out"]
    store = prep["store"]
    schedule = prep["schedule"]
    gossip = config.gossip
    recovery = config.durability
    n_shards = config.n_shards
    sharded = n_shards > 1
    d_on = recovery is not None and recovery.enabled
    rx_on = d_on or config.faults.has_crashes
    n_ops = config.n_ops
    s_resources = config.shard_resources
    rem = prep["rem"]

    st = out["st"]
    n_stale, n_viol, n_reads = (
        _total(out["stale"]), _total(out["viol"]), _total(out["reads"])
    )
    ae_ev, prop_ev, n_fail = (
        _total(out["ae"]), _total(out["prop"]), _total(out["fail"])
    )
    dropped = _total(st.cluster.pend_dropped)
    gx = rx = per_round = None
    if gossip is not None:
        gd = out["gx"]
        h_deliv_vec = gd.get("h_deliv")
        if h_deliv_vec is None:
            h_deliv_vec = np.zeros((3,), np.int64)
        else:
            h_deliv_vec = h_deliv_vec.cpu().numpy()
            if sharded:
                h_deliv_vec = h_deliv_vec.sum(axis=0)
        gx = (
            _total(gd["deliv"]), _total(gd["ranges"]), _total(gd["pairs"]),
            _total(gd["gap"]),
            _total(gd["h_enq"]) if "h_enq" in gd else 0,
            _total(gd["h_drop"]) if "h_drop" in gd else 0,
            h_deliv_vec,
        )
        per_round = prep["per_round"]["gossip"]
        if sharded:
            per_round = tuple(x.sum(axis=0) for x in per_round)
    if rx_on:
        rxd = out["rx"]
        rx = tuple(_total(rxd[k]) for k in (
            "crashes", "wal_replayed", "rows_lost", "snap_read",
            "boot_cells", "boot_pend", "boot_events",
        ))

    severity = _severity(config, store, st)
    stale_rate = n_stale / max(1, n_reads)
    viol_rate = n_viol / max(1, n_reads)

    # -- eq. 8: the measured failure-path traffic joins the bill ---------
    row = cfg.row_bytes
    anti_entropy_gb = ae_ev * row / 1e9
    propagation_gb = prop_ev * row / 1e9
    gossip_gb = 0.0
    if gossip is not None:
        (g_deliv, g_ranges, g_pair_n, g_gap, h_enq, h_drop,
         h_deliv_vec) = gx
        h_deliv = int(h_deliv_vec.sum())
        k_eff = max(1, min(gossip.n_ranges, s_resources))
        digest_gb = g_pair_n * 2 * k_eff * DIGEST_BYTES / 1e9
        repair_gb = (g_deliv + h_deliv) * row / 1e9
        gossip_gb = digest_gb + repair_gb
    # -- durability + crash recovery (eq. 8's storage/network split) -----
    snapshot_gb = wal_gb = replay_gb = bootstrap_gb = 0.0
    recovery_info = None
    if rx_on:
        (crash_n, wal_rep, rows_lost, snap_read,
         boot_cells, boot_pend, boot_events) = rx
        snap_rows = _total(st.dura.snap_rows) if d_on else 0
        wal_total = _total(st.dura.wal_total) if d_on else 0
        bk = max(1, min(
            recovery.bootstrap_ranges if recovery is not None else 8,
            s_resources,
        ))
        snapshot_gb = snap_rows * row / 1e9
        wal_gb = wal_total * row / 1e9
        replay_gb = (wal_rep + snap_read) * row / 1e9
        bootstrap_gb = (
            (boot_cells + boot_pend) * row
            + boot_events * 2 * bk * DIGEST_BYTES
        ) / 1e9
        recovery_info = {
            "crashes": crash_n,
            "rejoins": boot_events,
            "rows_lost": rows_lost,
            "wal_replayed": wal_rep,
            "snapshot_cells_read": snap_read,
            "snapshot_cells": snap_rows,
            "wal_records": wal_total,
            "bootstrap_cells": boot_cells,
            "bootstrap_pending": boot_pend,
            "snapshot_gb": snapshot_gb,
            "wal_gb": wal_gb,
            "replay_gb": replay_gb,
            "bootstrap_gb": bootstrap_gb,
            "recovery_gb": bootstrap_gb + replay_gb,
        }
    thr, _ = throughput_model(config.level, w, 64, cfg, stale_rate)
    runtime_s = n_ops / thr
    inter_gb, intra_gb = traffic_gb(config.level, w, n_ops, cfg, stale_rate)
    bill = cost_model.cost_all(
        nb_instances=cfg.n_nodes,
        runtime_hours=runtime_s / 3600.0,
        hosted_gb=cfg.total_data_gb_after_replication,
        months=runtime_s / (30 * 24 * 3600.0),
        io_requests=float(n_ops)
        * config.level.write_acks(cfg.replication_factor),
        inter_dc_gb=inter_gb + anti_entropy_gb + gossip_gb + bootstrap_gb,
        intra_dc_gb=intra_gb + snapshot_gb + wal_gb + replay_gb,
        pricing=pricing,
    )
    cost = bill.as_dict()
    cost["anti_entropy_network"] = cost_model.cost_network(
        inter_dc_gb=anti_entropy_gb, intra_dc_gb=0.0, pricing=pricing
    )
    if rx_on:
        # The durable-media side of eq. 8: snapshot copies hosted for
        # the run plus every marker/journal/restore I/O event.
        cost["durability_storage"] = cost_model.cost_storage(
            hosted_gb=(
                (3 * s_resources * row / 1e9) * n_shards if d_on else 0.0
            ),
            months=runtime_s / (30 * 24 * 3600.0),
            io_requests=float(
                snap_rows + wal_total + wal_rep + snap_read
            ) if d_on else float(0),
            pricing=pricing,
        )
        cost["durability_network"] = cost_model.cost_network(
            inter_dc_gb=bootstrap_gb,
            intra_dc_gb=snapshot_gb + wal_gb + replay_gb,
            pricing=pricing,
        )
    result: dict[str, Any] = {
        "staleness_rate": stale_rate,
        "violation_rate": viol_rate,
        "severity": severity,
        "n_reads": n_reads,
        "dropped_writes": dropped,
        "failovers": n_fail,
        "anti_entropy_events": ae_ev,
        "propagation_events": prop_ev,
        "anti_entropy_gb": anti_entropy_gb,
        "propagation_gb": propagation_gb,
        "n_epochs": schedule.n_epochs,
        "faulty_epochs": int(schedule.faulty().sum()),
        "heal_epochs": int(schedule.heals().sum()),
        "n_shards": n_shards,
        "cost": cost,
    }
    if gossip is not None:
        cost["gossip_network"] = cost_model.cost_network(
            inter_dc_gb=gossip_gb, intra_dc_gb=0.0, pricing=pricing
        )
        pr_deliv, pr_ranges, pr_gap = per_round
        result["gossip"] = {
            "cadence": gossip.cadence,
            "rounds": int(np.asarray(prep["masks"]["gossip"]).sum())
            + (int(bool(prep["tail_masks"]["gossip"])) if rem else 0),
            "pairs_exchanged": g_pair_n,
            "ranges_diffed": g_ranges,
            "repair_events": g_deliv + h_deliv,
            "gap_repaired": g_gap,
            "digest_gb": digest_gb,
            "repair_gb": repair_gb,
            "hints": {
                "enqueued": h_enq,
                "dropped": h_drop,
                "delivered": h_deliv,
                "delivered_by_replica": h_deliv_vec.tolist(),
            },
            "per_round": {
                "deliveries": pr_deliv.tolist(),
                "ranges_diffed": pr_ranges.tolist(),
                "gap_repaired": pr_gap.tolist(),
            },
        }
    if recovery_info is not None:
        result["crash_epochs"] = np.flatnonzero(
            schedule.crashes().any(axis=1)
        ).tolist()
        result["recovery"] = recovery_info
    if config.topology is not None:
        result["geo"] = _geo_block(config, out, cfg, sharded)
    if _return_state:
        result["_state"] = st
        result["_store"] = store
    return result


def _obs_block(config: EngineConfig, prep: dict) -> dict[str, Any]:
    """Summarize the final obs carry into the result's ``"obs"`` block:
    the registry rebuilt host-side, percentile tables, and the per-round
    stale/violation series of the full rounds (the tail round's series
    is dropped, as the reference's scan drops it)."""
    obs = config.obs
    out = prep["out"]
    sharded = config.n_shards > 1
    hist = out["obs"]["hist"].cpu().numpy()
    if sharded:
        # Integer counts: the per-shard sum is exact.
        hist = hist.sum(axis=0)
    counters = {k: _total(v) for k, v in out["obs"]["counters"].items()}
    h_on = (
        config.gossip is not None and config.gossip.handoff
        and config.faults is not None
    )
    specs = obs_lib.build_metrics(obs, geo_on=config.topology is not None,
                                  h_on=h_on)
    block = obs_lib.summarize(obs, specs, hist, counters)
    pr = prep.get("per_round")
    if pr is not None and "obs" in pr:
        es, ev = (np.asarray(x) for x in pr["obs"])
        if sharded:
            es, ev = es.sum(axis=0), ev.sum(axis=0)
        viol_rounds = np.flatnonzero(ev)
        block["per_round"] = {"stale": es.tolist(), "viol": ev.tolist()}
        block["first_violation_epoch"] = (
            int(viol_rounds[0]) if viol_rounds.size else None
        )
    return block


def _cost_attribution(result: dict[str, Any]) -> dict[str, float]:
    """Re-key the bill's eq. 8 terms by subsystem (an attribution view
    of ``result["cost"]``; dicts without a bill attribute zeros)."""
    cost = result.get("cost") or {}

    def total(*keys: str) -> float:
        return float(sum(cost.get(k, 0.0) for k in keys))

    return {
        "merge": total("anti_entropy_network"),
        "gossip": total("gossip_network", "gossip_network_geo"),
        "wal": total(
            "durability_storage", "durability_network",
            "durability_network_geo",
        ),
        "egress": total("network", "network_geo"),
    }


def assemble(
    config: EngineConfig,
    prep: dict,
    w: Workload,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: cost_model.PricingScheme = cost_model.PAPER_PRICING,
    _return_state: bool = False,
) -> dict[str, Any]:
    """Dispatch the replay output to its config's result shape."""
    if config.faults is not None:
        result = assemble_faulty(config, prep, w, cfg, pricing, _return_state)
    elif config.topology is not None:
        result = assemble_geo(config, prep, w, cfg, pricing)
    elif config.n_shards > 1:
        result = assemble_sharded(config, prep)
    else:
        result = assemble_flat(config, prep)
    if config.obs is not None and config.obs.enabled:
        result["obs"] = _obs_block(config, prep)
        result["obs"]["cost_attribution"] = _cost_attribution(result)
    return result
