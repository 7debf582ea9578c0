"""Monetary cost model — paper §3.5.2, §4.2.4 and Appendix B (port of
``repro.core.cost_model``, plain Python).

``Cost_all(cl) = Cost_in(cl) + Cost_st(cl) + Cost_tr(cl)``          (eq .5)

  * instances: ``nbInstances × price × runtime/timeUnit``            (eq .6)
  * storage:   physical hosting (GB-month) + I/O requests            (eq .7)
  * network:   inter-DC traffic × price(interDC)
             + intra-DC traffic × price(intraDC)                     (eq .8)

Pricing defaults are the paper's Table 2 (Amazon EC2/EBS, 2020).
"""

from __future__ import annotations

import dataclasses


def tiered_cost(
    gb: float, flat_per_gb: float, tiers: tuple[tuple[float, float], ...]
) -> float:
    """Piecewise-linear volume cost: ``tiers`` of ``(up_to_gb, price)``.

    With no tiers, bills flat at ``flat_per_gb``.  Volume beyond the
    last threshold bills at the last tier's price.
    """
    if not tiers:
        return gb * flat_per_gb
    cost, prev = 0.0, 0.0
    for up_to, price in tiers:
        take = max(0.0, min(gb, up_to) - prev)
        cost += take * price
        prev = up_to
        if gb <= up_to:
            break
    else:
        cost += (gb - prev) * tiers[-1][1]
    return cost


def tiered_marginal(
    gb: float, flat_per_gb: float, tiers: tuple[tuple[float, float], ...]
) -> float:
    """$/GB of the tier the volume ``gb`` falls in (flat otherwise)."""
    if not tiers:
        return flat_per_gb
    for up_to, price in tiers:
        if gb < up_to:
            return price
    return tiers[-1][1]


@dataclasses.dataclass(frozen=True)
class PricingScheme:
    """Paper Table 2 (defaults) — all prices in USD.

    ``inter_dc_tiers`` optionally replaces the flat inter-DC price with
    ``(up_to_gb, price_per_gb)`` volume tiers.
    """

    compute_unit_per_hour: float = 0.0464       # VM instance $/hour
    storage_gb_month: float = 0.10              # leased volume $/GB-month
    storage_per_million_requests: float = 0.10  # I/O $/1e6 requests
    intra_dc_per_gb: float = 0.00               # free inside a DC
    inter_dc_per_gb: float = 0.01               # billed across DCs
    inter_dc_tiers: tuple[tuple[float, float], ...] = ()

    def inter_dc_cost(self, gb: float) -> float:
        """Inter-DC transfer cost, tiered when tiers are configured."""
        return tiered_cost(gb, self.inter_dc_per_gb, self.inter_dc_tiers)

    def marginal_inter_dc_per_gb(self, gb: float = 0.0) -> float:
        """$/GB of the tier the volume ``gb`` falls in (flat otherwise)."""
        return tiered_marginal(gb, self.inter_dc_per_gb, self.inter_dc_tiers)


PAPER_PRICING = PricingScheme()

# GCP-style preset: the classic network-egress tiering (0-1 TB at
# $0.12/GB, 1-10 TB at $0.11, beyond at $0.08) applied to the inter-DC
# hop, e2-small-equivalent instances, PD-balanced storage, and Cloud
# Storage class-A-like request pricing.  A second provider shows that
# cost orderings across consistency levels are not a single-provider
# artifact.
GCP_PRICING = PricingScheme(
    compute_unit_per_hour=0.0335,
    storage_gb_month=0.10,
    storage_per_million_requests=0.40,
    intra_dc_per_gb=0.00,
    inter_dc_per_gb=0.08,
    inter_dc_tiers=((1024.0, 0.12), (10240.0, 0.11), (float("inf"), 0.08)),
)

# The reference's third preset prices a TPU instance, which the port does
# not run on; it is left out.
PRICING_PRESETS: dict[str, PricingScheme] = {
    "paper": PAPER_PRICING,
    "gcp": GCP_PRICING,
}


@dataclasses.dataclass(frozen=True)
class EgressMatrix:
    """Per-region-pair egress pricing over a ``G``-region topology.

    ``pair_class[g][h]`` assigns region pair ``(g, h)`` (traffic *from*
    g *to* h) a price class; ``class_per_gb[k]`` is class k's flat $/GB
    and ``class_tiers[k]`` its optional ``(up_to_gb, price)`` volume
    tiers (as in :func:`tiered_cost`).  Class 0 is conventionally the
    intra-region class.  All fields are tuples, so instances hash.
    """

    pair_class: tuple[tuple[int, ...], ...]      # (G, G) class ids
    class_per_gb: tuple[float, ...]              # flat $/GB per class
    class_tiers: tuple[tuple[tuple[float, float], ...], ...] = ()

    def __post_init__(self):
        g = len(self.pair_class)
        if any(len(row) != g for row in self.pair_class):
            raise ValueError("pair_class must be square (G, G)")
        n_cls = len(self.class_per_gb)
        if self.class_tiers and len(self.class_tiers) != n_cls:
            raise ValueError(
                "class_tiers must be empty or have one entry per class"
            )
        for row in self.pair_class:
            for k in row:
                if not 0 <= k < n_cls:
                    raise ValueError(f"pair class {k} out of range")

    @property
    def n_regions(self) -> int:
        return len(self.pair_class)

    def _tiers(self, k: int) -> tuple[tuple[float, float], ...]:
        return self.class_tiers[k] if self.class_tiers else ()

    def pair_cost(self, g: int, h: int, gb: float) -> float:
        """Cost of ``gb`` shipped from region ``g`` to region ``h``; each
        pair bills its own tiered integral, so a pair with no traffic
        costs exactly zero."""
        k = self.pair_class[g][h]
        return tiered_cost(gb, self.class_per_gb[k], self._tiers(k))

    def pair_marginal(self, g: int, h: int, gb: float = 0.0) -> float:
        """$/GB of the tier pair ``(g, h)``'s volume ``gb`` falls in."""
        k = self.pair_class[g][h]
        return tiered_marginal(gb, self.class_per_gb[k], self._tiers(k))

    def price_matrix(self) -> list[list[float]]:
        """(G, G) marginal-at-zero $/GB — the planner's analytic prices."""
        g = self.n_regions
        return [
            [self.pair_marginal(i, j, 0.0) for j in range(g)]
            for i in range(g)
        ]

    @classmethod
    def from_pricing(cls, n_regions: int, pricing: PricingScheme) -> "EgressMatrix":
        """Intra pairs at ``intra_dc_per_gb``, inter pairs at the inter-DC
        price including its volume tiers."""
        pair = tuple(
            tuple(0 if i == j else 1 for j in range(n_regions))
            for i in range(n_regions)
        )
        return cls(
            pair_class=pair,
            class_per_gb=(pricing.intra_dc_per_gb, pricing.inter_dc_per_gb),
            class_tiers=((), tuple(pricing.inter_dc_tiers)),
        )


def cost_network_matrix(*, traffic_gb, egress: EgressMatrix) -> float:
    """Eq. (.8) generalized: a (G, G) traffic matrix billed per pair
    through each pair's tiered price class (pairs summed in row-major
    order, zero-traffic pairs skipped)."""
    total = 0.0
    g = egress.n_regions
    for i in range(g):
        for j in range(g):
            vol = float(traffic_gb[i][j])
            if vol:
                total += egress.pair_cost(i, j, vol)
    return total


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    instances: float
    storage: float
    network: float

    @property
    def total(self) -> float:
        return self.instances + self.storage + self.network

    def as_dict(self) -> dict[str, float]:
        return {
            "instances": self.instances,
            "storage": self.storage,
            "network": self.network,
            "total": self.total,
        }


def cost_instances(
    *, nb_instances: int, runtime_hours: float, pricing: PricingScheme
) -> float:
    """Eq. (.6): leasing nbInstances for `runtime` at `price`/timeUnit."""
    return nb_instances * pricing.compute_unit_per_hour * runtime_hours


def cost_storage(
    *, hosted_gb: float, months: float, io_requests: float,
    pricing: PricingScheme,
) -> float:
    """Eq. (.7): physical hosting + I/O requests."""
    hosting = hosted_gb * pricing.storage_gb_month * months
    io = (io_requests / 1e6) * pricing.storage_per_million_requests
    return hosting + io


def cost_network(
    *, inter_dc_gb: float, intra_dc_gb: float, pricing: PricingScheme,
) -> float:
    """Eq. (.8): inter- + intra-DC transfer (inter tiered when configured)."""
    return (
        pricing.inter_dc_cost(inter_dc_gb)
        + intra_dc_gb * pricing.intra_dc_per_gb
    )


def cost_all(
    *,
    nb_instances: int,
    runtime_hours: float,
    hosted_gb: float,
    months: float,
    io_requests: float,
    inter_dc_gb: float,
    intra_dc_gb: float,
    pricing: PricingScheme = PAPER_PRICING,
) -> CostBreakdown:
    """Eq. (.5): the full bill for one consistency level."""
    return CostBreakdown(
        instances=cost_instances(
            nb_instances=nb_instances, runtime_hours=runtime_hours,
            pricing=pricing,
        ),
        storage=cost_storage(
            hosted_gb=hosted_gb, months=months, io_requests=io_requests,
            pricing=pricing,
        ),
        network=cost_network(
            inter_dc_gb=inter_dc_gb, intra_dc_gb=intra_dc_gb,
            pricing=pricing,
        ),
    )


def training_run_cost(
    *,
    n_chips: int,
    step_time_s: float,
    n_steps: int,
    inter_pod_bytes_per_step: float,
    intra_pod_bytes_per_step: float,
    ckpt_bytes: float,
    ckpt_every: int,
    pricing: PricingScheme,
) -> CostBreakdown:
    """The paper's bill applied to a multi-pod training run.

    * instances: chip-hours over the run (latency ⇒ money, §3.5.2);
    * storage: checkpoint volume held for the run duration + one I/O
      request per parameter-shard write;
    * network: inter-pod collective bytes billed as inter-DC, intra-pod
      as intra-DC (free) — this is the term X-STCC shrinks by ~Δ×.

    ``pricing`` has no default: the reference's default is its TPU
    preset, which the port does not carry.
    """
    runtime_hours = step_time_s * n_steps / 3600.0
    n_ckpts = max(1, n_steps // max(1, ckpt_every))
    return cost_all(
        nb_instances=n_chips,
        runtime_hours=runtime_hours,
        hosted_gb=ckpt_bytes / 1e9,
        months=runtime_hours / (30 * 24),
        io_requests=float(n_ckpts) * n_chips,
        inter_dc_gb=inter_pod_bytes_per_step * n_steps / 1e9,
        intra_dc_gb=intra_pod_bytes_per_step * n_steps / 1e9,
        pricing=pricing,
    )
