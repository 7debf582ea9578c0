"""Replica-placement planner (port of ``repro.geo.placement``).

Scores candidate per-resource plans — a replication factor split across
regions, a ``(G,)`` count vector — against each resource's regional
demand, the topology's RTT and egress-price matrices, and an SLA's
read-latency bound:

  * **cost** (eq. 5-8, analytic): storage for every hosted copy, the
    two-tier write propagation (client→coordinator upload, one WAN hop
    per hosting region, LAN fan-out within each region), and reads
    served from the nearest hosting region at that pair's egress price;
  * **SLA**: a plan is infeasible for a resource when a region with
    demand reads further than ``sla.max_read_latency_ms`` from its
    nearest hosting region.

The candidate tables, the demand counts and the cost of the chosen plans
are small and stay numpy on the host, op for op as in the reference, so
they round as it does.  The (R, K) grid is scored and reduced to each
resource's choice on the device in one call, ``kernels.ops.
placement_select`` (one kernel launch on the card, which never writes
the grid), between the copies in (``device_inputs``: one for a small
demand and the tables, three for a large one) and one (3, R) copy out.
``score_candidates`` still returns the whole grid, as the reference's
does.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from repro_torch.core.cost_model import PAPER_PRICING, PricingScheme
from repro_torch.device import resolve_device
from repro_torch.geo.topology import RegionTopology
from repro_torch.kernels import ops as kernel_ops
from repro_torch.storage.cluster import PAPER_CLUSTER, ClusterConfig


def enumerate_candidates(
    n_regions: int,
    *,
    max_per_region: int = 4,
    max_total: int | None = None,
    min_total: int = 1,
) -> np.ndarray:
    """All (G,) replica-count vectors within the caps, as (K, G) int32,
    in lexicographic order (candidate indices are stable)."""
    if max_total is None:
        max_total = max_per_region * n_regions
    cands = [
        c
        for c in itertools.product(range(max_per_region + 1), repeat=n_regions)
        if min_total <= sum(c) <= max_total
    ]
    if not cands:
        raise ValueError("no candidate satisfies the replica caps")
    return np.asarray(cands, np.int32)


def static_counts(topology: RegionTopology, per_region: int = 4) -> np.ndarray:
    """The paper's NetworkTopologyStrategy placement: k copies per region."""
    return np.full((topology.n_regions,), per_region, np.int32)


def candidate_tables(
    topology: RegionTopology,
    candidates: np.ndarray,           # (K, G) int
    *,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: PricingScheme = PAPER_PRICING,
    resource_gb: float | None = None,
    months: float = 1.0,
    min_replicas: int = 1,
) -> dict[str, np.ndarray]:
    """The scorer's f32 tables of candidate count vectors.

    Per candidate ``k`` and client region ``g``: ``read_price[k, g]``
    ($/read: one row from the nearest hosting region at that pair's
    egress price, plus I/O and one unit of service work),
    ``write_price[k, g]`` ($/write under two-tier propagation),
    ``read_rtt[k, g]`` (RTT to the nearest hosting region),
    ``cand_meta[0, k]`` (storage $ of the hosted copies over ``months``)
    and ``cand_meta[1, k]`` (validity: at least ``min_replicas`` copies).
    Egress is priced at each pair's marginal-at-zero rate.  Computed in
    f64 and cast once, as the reference does.
    """
    cand = np.asarray(candidates, np.int32)
    k, g = cand.shape
    if g != topology.n_regions:
        raise ValueError(
            f"candidates cover {g} regions, topology has {topology.n_regions}"
        )
    if resource_gb is None:
        resource_gb = cfg.dataset_rows * cfg.row_bytes / 1e9
    rtt = topology.rtt().astype(np.float64)
    price = np.asarray(topology.egress.price_matrix(), np.float64)
    row_gb = cfg.row_bytes / 1e9
    io = pricing.storage_per_million_requests / 1e6
    inst = pricing.compute_unit_per_hour / 3600.0 / cfg.node_service_rate_ops_s

    read_price = np.zeros((k, g), np.float64)
    write_price = np.zeros((k, g), np.float64)
    read_rtt = np.zeros((k, g), np.float64)
    store = np.zeros((k,), np.float64)
    valid = np.zeros((k,), np.float64)
    for ki in range(k):
        counts = cand[ki]
        hosting = np.flatnonzero(counts > 0)
        total = int(counts.sum())
        store[ki] = total * resource_gb * pricing.storage_gb_month * months
        if total < min_replicas or hosting.size == 0:
            # Invalid plans keep finite rows; the validity flag ranks them out.
            read_rtt[ki] = 0.0
            valid[ki] = 0.0
            continue
        valid[ki] = 1.0
        # LAN fan-out within each hosting region: copies beyond the first
        # bill at the region's intra pair price.
        fanout = sum((counts[h] - 1) * price[h, h] for h in hosting) * row_gb
        for gi in range(g):
            # np.argmin keeps the first minimum: lowest hosting-region id.
            near = hosting[np.argmin(rtt[gi, hosting])]
            read_rtt[ki, gi] = rtt[gi, near]
            read_price[ki, gi] = price[near, gi] * row_gb + io + inst
            coord = near
            wan = sum(price[coord, h] * row_gb for h in hosting if h != coord)
            write_price[ki, gi] = (
                price[gi, coord] * row_gb   # client upload
                + wan + fanout
                + total * io + inst
            )
    return {
        "read_price": read_price.astype(np.float32),
        "write_price": write_price.astype(np.float32),
        "read_rtt": read_rtt.astype(np.float32),
        "cand_meta": np.stack([store, valid]).astype(np.float32),
        "candidates": cand,
    }


def region_demand(
    client: np.ndarray,
    kind: np.ndarray,
    resource: np.ndarray,
    topology: RegionTopology,
    n_resources: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(reads, writes) as (R, G) float32 counts from an op stream, each op
    attributed to its client's region (where demand originates)."""
    creg = topology.client_region_of(np.asarray(client))
    res = np.asarray(resource, np.int64)
    is_w = np.asarray(kind) == 1
    g = topology.n_regions
    flat = res * g + creg
    reads = np.bincount(flat[~is_w], minlength=n_resources * g).reshape(n_resources, g)
    writes = np.bincount(flat[is_w], minlength=n_resources * g).reshape(n_resources, g)
    return reads.astype(np.float32), writes.astype(np.float32)


def fleet_topology(topology: RegionTopology, counts: np.ndarray) -> RegionTopology:
    """A fleet-wide placement as a replayable :class:`RegionTopology`: one
    protocol replica per hosted copy over the same RTT and egress
    matrices, with the client population pinned to the base topology's
    assignment (placement moves replicas, never demand)."""
    cnt = np.asarray(counts, np.int64)
    if cnt.shape[0] != topology.n_regions:
        raise ValueError(
            f"counts cover {cnt.shape[0]} regions, topology has "
            f"{topology.n_regions}"
        )
    if (cnt < 0).any() or cnt.sum() < 1:
        raise ValueError("placement must host at least one replica")
    replica_region = tuple(
        int(g) for g in np.repeat(np.arange(topology.n_regions), cnt)
    )
    client_region = topology.client_region
    if client_region is None:
        client_region = tuple(int(r) for r in topology.regions())
    return dataclasses.replace(
        topology, replica_region=replica_region, client_region=client_region
    )


@dataclasses.dataclass(frozen=True)
class PlacementResult:
    """One planning pass over the (resources × candidates) grid."""

    choice: np.ndarray        # (R,) int32 — chosen candidate per resource
    counts: np.ndarray        # (R, G) int32 — chosen replicas per region
    utility: np.ndarray       # (R,) f32 — utility of the chosen plan
    feasible: np.ndarray      # (R,) bool — chosen plan meets the SLA
    cost: np.ndarray          # (R,) f32 — analytic $ of the chosen plan
    candidates: np.ndarray    # (K, G) int32 — the searched universe

    @property
    def total_cost(self) -> float:
        return float(self.cost.sum())

    @property
    def n_feasible(self) -> int:
        return int(self.feasible.sum())

    def summary(self) -> dict[str, Any]:
        return {
            "total_cost": self.total_cost,
            "n_feasible": self.n_feasible,
            "n_resources": int(self.choice.shape[0]),
            "mean_replicas": float(self.counts.sum(axis=1).mean()),
        }


def _resource_gb(cfg: ClusterConfig, reads: np.ndarray) -> float:
    # Each key bucket hosts an even share of the dataset.
    return cfg.dataset_rows * cfg.row_bytes / 1e9 / max(1, reads.shape[0])


_TABLES = ("read_price", "write_price", "read_rtt", "cand_meta")
# Demand up to this size rides in the tables' copy (the geo path's plans
# send 576 B): stacking a few KiB on the host costs microseconds, less
# than a second copy's fixed cost.  Larger demand is copied straight from
# its two arrays, since stacking it would write the whole demand again on
# the host (120 MB at R = 5,000,000, G = 3).
ONE_COPY_BYTES = 1 << 16


def _one_copy(arrays: list[np.ndarray], dev: torch.device) -> list[torch.Tensor]:
    """f32 ``arrays`` joined on the host, sent in one copy, split on ``dev``
    into flat views."""
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrays])).to(dev)
    return list(torch.split(flat, [a.size for a in arrays]))


def device_inputs(
    reads: np.ndarray,
    writes: np.ndarray,
    tables: dict[str, np.ndarray],
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, ...]:
    """The scorer's six f32 inputs on ``device``: ``reads``, ``writes``
    (R, G), ``read_price``, ``write_price``, ``read_rtt`` (K, G) and
    ``cand_meta`` (2, K).  The four tables go as one flat copy, the
    demand with them up to ``ONE_COPY_BYTES`` (one copy in all), else as
    two copies of its own."""
    dev = resolve_device(device)
    reads = np.ascontiguousarray(reads, np.float32)
    writes = np.ascontiguousarray(writes, np.float32)
    (r, g), k = reads.shape, tables["read_price"].shape[0]
    tabs = [np.asarray(tables[name], np.float32) for name in _TABLES]
    if reads.nbytes <= ONE_COPY_BYTES:
        parts = _one_copy([reads, writes, *tabs], dev)
    else:
        parts = [torch.from_numpy(a).to(dev) for a in (reads, writes)]
        parts += _one_copy(tabs, dev)
    rd, wr, rp, wp, rtt, meta = parts
    return (rd.view(r, g), wr.view(r, g), rp.view(k, g), wp.view(k, g),
            rtt.view(k, g), meta.view(2, k))


def select_candidates(
    reads: np.ndarray,
    writes: np.ndarray,
    tables: dict[str, np.ndarray],
    sla,
    *,
    impl: str | None = "auto",
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per resource the first candidate of maximal utility, with that
    cell's utility and feasibility: ``(choice (R,) int32, utility (R,)
    f32, feasible (R,) bool)`` on the host, the reference's ``argmax`` and
    gathers over ``score_candidates``' grid, bit for bit.  One
    ``ops.placement_select`` call on ``device``."""
    out = kernel_ops.placement_select(
        *device_inputs(reads, writes, tables, device),
        max_latency_ms=float(sla.max_read_latency_ms), impl=impl,
    ).cpu().numpy()
    return out[0], out[1].view(np.float32), out[2].astype(bool)


def score_candidates(
    reads: np.ndarray,
    writes: np.ndarray,
    tables: dict[str, np.ndarray],
    sla,
    *,
    impl: str | None = "auto",
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(utility, feasible) over the (R, K) grid, as tensors on ``device``
    (the reference returns numpy; the port keeps the grid on the card)."""
    return kernel_ops.placement_score(
        *device_inputs(reads, writes, tables, device),
        max_latency_ms=float(sla.max_read_latency_ms), impl=impl,
    )


def plan_tables(
    topology: RegionTopology,
    reads: np.ndarray,
    *,
    candidates: np.ndarray | None = None,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: PricingScheme = PAPER_PRICING,
    resource_gb: float | None = None,
    months: float = 1.0,
    min_replicas: int = 1,
    max_per_region: int = 4,
) -> dict[str, np.ndarray]:
    """``plan_placement``'s candidate set (with the static placement
    added) and its tables, on the host."""
    if candidates is None:
        candidates = enumerate_candidates(
            topology.n_regions, max_per_region=max_per_region,
            min_total=min_replicas,
        )
    cand = np.asarray(candidates, np.int32)
    static = static_counts(topology, max_per_region)[None, :]
    if not (cand == static).all(axis=1).any():
        cand = np.concatenate([cand, static.astype(np.int32)], axis=0)
    if resource_gb is None:
        resource_gb = _resource_gb(cfg, reads)
    return candidate_tables(
        topology, cand, cfg=cfg, pricing=pricing, resource_gb=resource_gb,
        months=months, min_replicas=min_replicas,
    )


def chosen_cost(tables: dict[str, np.ndarray], choice: np.ndarray,
                reads: np.ndarray, writes: np.ndarray) -> np.ndarray:
    """Analytic cost of each resource's chosen plan (the -utility of a
    feasible cell, recomputed so infeasible fallbacks report cost without
    the penalty), host numpy op for op as the reference."""
    return (
        tables["cand_meta"][0][choice]
        + np.sum(reads * tables["read_price"][choice], axis=1)
        + np.sum(writes * tables["write_price"][choice], axis=1)
    ).astype(np.float32)


def plan_placement(
    topology: RegionTopology,
    reads: np.ndarray,            # (R, G) demand
    writes: np.ndarray,           # (R, G) demand
    sla,
    *,
    candidates: np.ndarray | None = None,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: PricingScheme = PAPER_PRICING,
    resource_gb: float | None = None,
    months: float = 1.0,
    min_replicas: int = 1,
    max_per_region: int = 4,
    impl: str | None = "auto",
    device: str | torch.device = "cuda",
) -> PlacementResult:
    """Choose, per resource, the cheapest SLA-feasible placement.

    The candidate set always includes the static ``max_per_region``-per-
    region placement, so the plan is never costlier than it wherever both
    are feasible.  Scoring and the per-resource choice run on ``device``
    (``"cuda"`` unless the caller asks for the CPU) as one
    ``ops.placement_select`` call; only (R,) results come back.
    """
    tables = plan_tables(
        topology, reads, candidates=candidates, cfg=cfg, pricing=pricing,
        resource_gb=resource_gb, months=months, min_replicas=min_replicas,
        max_per_region=max_per_region,
    )
    choice, utility, feasible = select_candidates(
        reads, writes, tables, sla, impl=impl, device=device)
    cand = tables["candidates"]
    return PlacementResult(
        choice=choice,
        counts=cand[choice],
        utility=utility,
        feasible=feasible,
        cost=chosen_cost(tables, choice, reads, writes),
        candidates=cand,
    )


def evaluate_counts(
    topology: RegionTopology,
    counts: np.ndarray,           # (G,) one fleet-wide placement
    reads: np.ndarray,
    writes: np.ndarray,
    sla,
    *,
    cfg: ClusterConfig = PAPER_CLUSTER,
    pricing: PricingScheme = PAPER_PRICING,
    resource_gb: float | None = None,
    months: float = 1.0,
    min_replicas: int = 1,
    impl: str | None = "auto",
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Cost and feasibility of one fixed placement applied to every
    resource, priced through the same tables and scorer (the planner's
    comparison baseline, e.g. the static 4-per-DC placement)."""
    cand = np.asarray(counts, np.int32)[None, :]
    if resource_gb is None:
        resource_gb = _resource_gb(cfg, reads)
    tables = candidate_tables(
        topology, cand, cfg=cfg, pricing=pricing, resource_gb=resource_gb,
        months=months, min_replicas=min_replicas,
    )
    _, util, feas = select_candidates(reads, writes, tables, sla, impl=impl,
                                      device=device)
    cost = (
        tables["cand_meta"][0][0]
        + np.sum(reads * tables["read_price"][0][None, :], axis=1)
        + np.sum(writes * tables["write_price"][0][None, :], axis=1)
    ).astype(np.float32)
    return {
        "cost": cost,
        "total_cost": float(cost.sum()),
        "feasible": feas,
        "n_feasible": int(feas.sum()),
        "utility": util,
    }
