"""Result assembly for the epoch engine (port of
``repro.engine.results``: the flat and fault-path dictionaries, the
``"obs"`` block and its cost attribution).

Each ``assemble_*`` turns one :meth:`EpochEngine.replay` output into the
reference's dictionary — same keys, same float arithmetic, same order of
the billing terms — so results compare with ``==``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core import cost_model
from repro_torch.engine.config import EngineConfig
from repro_torch.gossip import DIGEST_BYTES
from repro_torch.obs import metrics as obs_lib
from repro_torch.storage.cluster import PAPER_CLUSTER, ClusterConfig
from repro_torch.storage.ycsb import Workload


def _severity(config: EngineConfig, store, st) -> float:
    if not config.audit:
        return 0.0
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


def assemble_faulty(
    config: EngineConfig,
    prep: dict,
    w: Workload,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: cost_model.PricingScheme = cost_model.PAPER_PRICING,
) -> dict[str, Any]:
    """The failure-path dictionary: protocol rates, failover and
    propagation counts, the eq. 8 bill with the measured anti-entropy,
    gossip and durability traffic, and the ``"gossip"`` / ``"recovery"``
    blocks when those subsystems ran."""
    from repro_torch.storage.simulator import throughput_model, traffic_gb

    out = prep["out"]
    store = prep["store"]
    schedule = prep["schedule"]
    gossip = config.gossip
    recovery = config.durability
    d_on = recovery is not None and recovery.enabled
    rx_on = d_on      # crash events are not ported
    n_ops = config.n_ops
    s_resources = config.n_resources
    rem = prep["rem"]

    st = out["st"]
    n_stale, n_viol, n_reads = (
        int(out["stale"]), int(out["viol"]), int(out["reads"])
    )
    ae_ev, prop_ev, n_fail = int(out["ae"]), int(out["prop"]), int(out["fail"])
    dropped = int(st.cluster.pend_dropped)
    gx = rx = per_round = None
    if gossip is not None:
        gd = out["gx"]
        h_deliv_vec = gd.get("h_deliv")
        h_deliv_vec = (np.zeros((3,), np.int64) if h_deliv_vec is None
                       else h_deliv_vec.cpu().numpy())
        gx = (
            int(gd["deliv"]), int(gd["ranges"]), int(gd["pairs"]),
            int(gd["gap"]),
            int(gd["h_enq"]) if "h_enq" in gd else 0,
            int(gd["h_drop"]) if "h_drop" in gd else 0,
            h_deliv_vec,
        )
        per_round = prep["per_round"]["gossip"]
    if rx_on:
        rxd = out["rx"]
        rx = tuple(int(rxd[k]) for k in (
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
    # -- durability (eq. 8's storage/network split) ----------------------
    snapshot_gb = wal_gb = replay_gb = bootstrap_gb = 0.0
    recovery_info = None
    if rx_on:
        (crash_n, wal_rep, rows_lost, snap_read,
         boot_cells, boot_pend, boot_events) = rx
        snap_rows = int(st.dura.snap_rows) if d_on else 0
        wal_total = int(st.dura.wal_total) if d_on else 0
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
            hosted_gb=(3 * s_resources * row / 1e9) if d_on else 0.0,
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
        "n_shards": config.n_shards,
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
    return result


def _obs_block(config: EngineConfig, prep: dict) -> dict[str, Any]:
    """Summarize the final obs carry into the result's ``"obs"`` block:
    the registry rebuilt host-side, percentile tables, and the per-round
    stale/violation series of the full rounds (the tail round's series
    is dropped, as the reference's scan drops it)."""
    obs = config.obs
    out = prep["out"]
    hist = out["obs"]["hist"].cpu().numpy()
    counters = {k: int(v) for k, v in out["obs"]["counters"].items()}
    h_on = (
        config.gossip is not None and config.gossip.handoff
        and config.faults is not None
    )
    specs = obs_lib.build_metrics(obs, geo_on=False, h_on=h_on)
    block = obs_lib.summarize(obs, specs, hist, counters)
    pr = prep.get("per_round")
    if pr is not None and "obs" in pr:
        es, ev = (np.asarray(x) for x in pr["obs"])
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
) -> dict[str, Any]:
    """Dispatch the replay output to its config's result shape."""
    if config.faults is not None:
        result = assemble_faulty(config, prep, w, cfg, pricing)
    else:
        result = assemble_flat(config, prep)
    if config.obs is not None and config.obs.enabled:
        result["obs"] = _obs_block(config, prep)
        result["obs"]["cost_attribution"] = _cost_attribution(result)
    return result
