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
they round as it does.  Only the (R, K) grid runs on the device: the
scoring (``kernels.ops.placement_score``), the per-row argmax and the
gather of the chosen cells.  The (R, K) utility never leaves the device.
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
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    return kernel_ops.placement_score(
        t(reads), t(writes), t(tables["read_price"]), t(tables["write_price"]),
        t(tables["read_rtt"]), t(tables["cand_meta"]),
        max_latency_ms=float(sla.max_read_latency_ms), impl=impl,
    )


def _resource_gb(cfg: ClusterConfig, reads: np.ndarray) -> float:
    # Each key bucket hosts an even share of the dataset.
    return cfg.dataset_rows * cfg.row_bytes / 1e9 / max(1, reads.shape[0])


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
    are feasible.  Scoring, argmax and the gather of the chosen cells run
    on ``device`` (``"cuda"`` unless the caller asks for the CPU); only
    (R,) results come back.
    """
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
    tables = candidate_tables(
        topology, cand, cfg=cfg, pricing=pricing, resource_gb=resource_gb,
        months=months, min_replicas=min_replicas,
    )
    util, feas = score_candidates(reads, writes, tables, sla, impl=impl,
                                  device=device)
    # torch.argmax returns the first maximum along the row, as np.argmax
    # does, so tied candidates resolve to the lowest index in both.
    choice_t = torch.argmax(util, dim=1, keepdim=True)
    utility = torch.gather(util, 1, choice_t)[:, 0].cpu().numpy()
    feasible = torch.gather(feas, 1, choice_t)[:, 0].cpu().numpy()
    del util, feas
    choice = choice_t[:, 0].cpu().numpy().astype(np.int32)
    # Analytic cost of the chosen plan (the -utility of a feasible cell,
    # recomputed so infeasible fallbacks report cost without the penalty).
    cost = (
        tables["cand_meta"][0][choice]
        + np.sum(reads * tables["read_price"][choice], axis=1)
        + np.sum(writes * tables["write_price"][choice], axis=1)
    ).astype(np.float32)
    return PlacementResult(
        choice=choice,
        counts=cand[choice],
        utility=utility.astype(np.float32),
        feasible=feasible.astype(bool),
        cost=cost,
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
    util, feas = score_candidates(reads, writes, tables, sla, impl=impl,
                                  device=device)
    util = util[:, 0].cpu().numpy()
    feas = feas[:, 0].cpu().numpy()
    cost = (
        tables["cand_meta"][0][0]
        + np.sum(reads * tables["read_price"][0][None, :], axis=1)
        + np.sum(writes * tables["write_price"][0][None, :], axis=1)
    ).astype(np.float32)
    return {
        "cost": cost,
        "total_cost": float(cost.sum()),
        "feasible": feas.astype(bool),
        "n_feasible": int(feas.sum()),
        "utility": np.asarray(util, np.float32),
    }
