"""Port's geo layer == JAX's: per-pair egress pricing, the region
topology, the two-tier merge (state and (G, G) traffic, partitions
included), nearest-peer gossip order, the geo obs registry, the seven
golden ``geo/*`` cases, nearest-peer gossip + durability + obs against the
live reference, and the one-region identity with ``run_protocol``."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from golden_bridge import load_golden, sanitize
from repro.core import cost_model as jcost
from repro.core.consistency import ConsistencyLevel as JL
from repro.core.replicated_store import DurabilityConfig as JDura
from repro.core.replicated_store import ReplicatedStore as JStore
from repro.geo import placement as jpl
from repro.geo import topology as jtopo
from repro.gossip import scheduler as jsched
from repro.obs import metrics as jobs
from repro.storage import simulator as jsim
from repro.storage.ycsb import WORKLOAD_A as JA
from repro_torch import convert
from repro_torch.core import cost_model as tcost
from repro_torch.core.consistency import EVAL_LEVELS
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.core.replicated_store import ReplicatedStore as TStore
from repro_torch.geo import placement as tpl
from repro_torch.geo import topology as ttopo
from repro_torch.gossip import scheduler as tsched
from repro_torch.obs import metrics as tobs
from repro_torch.storage import simulator as tsim
from repro_torch.storage.ycsb import WORKLOAD_A

from torch_port_helpers import (CPU, assert_tree_equal, geo_mismatches,
                                jax_to_numpy, jlevel)

torch.set_num_threads(1)

TIERS = ((1.0, 0.12), (10.0, 0.11), (float("inf"), 0.08))
J_EGRESS = jcost.EgressMatrix(
    pair_class=((0, 1, 2), (1, 0, 1), (2, 1, 0)),
    class_per_gb=(0.0, 0.01, 0.08),
    class_tiers=((), TIERS, ((5.0, 0.09),)),
)
J_ASYM = jtopo.RegionTopology(
    (0, 1, 2, 2), ((0.1, 30.0, 80.0), (30.0, 0.1, 5.0), (80.0, 5.0, 0.1)), J_EGRESS,
)
J_FIVE = jtopo.uniform_topology((0, 0, 1, 1, 2), intra_rtt_ms=0.1, inter_rtt_ms=40.0)
J_FLEET = jpl.fleet_topology(jtopo.PAPER_TOPOLOGY,
                             jpl.static_counts(jtopo.PAPER_TOPOLOGY, 4))


# -- cost model -----------------------------------------------------------------


@pytest.mark.parametrize("gb", [0.0, 0.5, 1.0, 3.0, 10.0, 25.0])
def test_egress_pricing_matches(gb):
    t_egress = convert.region_topology(J_ASYM).egress
    for tiers in ((), TIERS, ((5.0, 0.09),)):
        assert tcost.tiered_marginal(gb, 0.02, tiers) == jcost.tiered_marginal(
            gb, 0.02, tiers)
    p = jcost.PricingScheme(inter_dc_tiers=TIERS)
    assert (tcost.PricingScheme(inter_dc_tiers=TIERS).marginal_inter_dc_per_gb(gb)
            == p.marginal_inter_dc_per_gb(gb))
    for g in range(3):
        for h in range(3):
            assert t_egress.pair_cost(g, h, gb) == J_EGRESS.pair_cost(g, h, gb)
            assert t_egress.pair_marginal(g, h, gb) == J_EGRESS.pair_marginal(g, h, gb)
    assert t_egress.price_matrix() == J_EGRESS.price_matrix()
    traffic = np.arange(9, dtype=np.float64).reshape(3, 3) * gb / 7
    assert (tcost.cost_network_matrix(traffic_gb=traffic, egress=t_egress)
            == jcost.cost_network_matrix(traffic_gb=traffic, egress=J_EGRESS))


# -- topology -------------------------------------------------------------------


def test_topology_matches_reference():
    for jt in (jtopo.PAPER_TOPOLOGY, J_ASYM, J_FIVE, J_FLEET, jtopo.single_region(4)):
        tt = convert.region_topology(jt)
        for name in ("regions", "rtt", "region_counts", "intra_link", "region_onehot"):
            a, b = getattr(jt, name)(), getattr(tt, name)()
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        clients = np.arange(40)
        np.testing.assert_array_equal(jt.client_region_of(clients),
                                      tt.client_region_of(clients))
        for g in range(jt.n_regions):
            np.testing.assert_array_equal(jt.replicas_in(g), tt.replicas_in(g))
            assert jt.nearest_replica(g) == tt.nearest_replica(g)
            up = np.arange(jt.n_replicas) % 2 == 1
            assert jt.nearest_replica(g, up=up) == tt.nearest_replica(g, up=up)
            for acks in range(1, jt.n_replicas + 1):
                assert jt.ack_latency_ms(g, acks) == tt.ack_latency_ms(g, acks)
    assert convert.region_topology(jtopo.PAPER_TOPOLOGY) == ttopo.PAPER_TOPOLOGY
    assert convert.region_topology(jtopo.single_region(3)) == ttopo.single_region(3)
    assert ttopo.single_region(3) is ttopo.single_region(3)          # cached
    with pytest.raises(ValueError, match="live"):
        ttopo.PAPER_TOPOLOGY.nearest_replica(0, up=[False] * 3)
    with pytest.raises(ValueError, match="client region"):
        dataclasses.replace(ttopo.PAPER_TOPOLOGY, client_region=(5,))


# -- two-tier merge -------------------------------------------------------------


def _random_states(jt, level, seed, n_batches=3, b=32):
    """A reference store with writes held pending, and the same state in
    the port."""
    jstore = JStore(jt.n_replicas, 8, 12, level=jlevel(level), pending_cap=256,
                    delta=1 << 20, merge_every=1 << 20)
    tstore = TStore(jt.n_replicas, 8, 12, level=level, pending_cap=256,
                    delta=1 << 20, merge_every=1 << 20, device=CPU)
    rng = np.random.default_rng(seed)
    st = jstore.init()
    for _ in range(n_batches):
        st, _ = jstore.apply_batch(
            st, client=rng.integers(0, 8, b), replica=rng.integers(0, jt.n_replicas, b),
            resource=rng.integers(0, 12, b), kind=rng.integers(0, 2, b),
        )
    return jstore, tstore, st, convert.store_state_from_numpy(jax_to_numpy(st), device=CPU)


def _severing_masks(jt, seed):
    """Random liveness plus a partition that cuts the last region off."""
    rng = np.random.default_rng(seed)
    reg = jt.regions()
    up = rng.random(jt.n_replicas) < 0.8
    up[0] = True
    cut = reg == reg.max()
    link = (cut[:, None] == cut[None, :])
    return up, link


@pytest.mark.parametrize("topo,level,masked", [
    (topo, TL.X_STCC, masked) for topo in ("paper", "asym", "five", "fleet")
    for masked in (False, True)
] + [("five", TL.CAUSAL, True), ("fleet", TL.ONE, True)],
    ids=lambda v: getattr(v, "name", str(v)))
def test_merge_geo_matches_reference(topo, level, masked):
    """State equals the reference's (and the port's flat merge), traffic
    equals the reference's, with and without a partition that severs the
    last region; the level only changes how the pending state was made."""
    jt = {"paper": jtopo.PAPER_TOPOLOGY, "asym": J_ASYM, "five": J_FIVE,
          "fleet": J_FLEET}[topo]
    tt = convert.region_topology(jt)
    jstore, tstore, jst, tst = _random_states(jt, level, seed=3)
    kw = {}
    if masked:
        up, link = _severing_masks(jt, seed=7)
        kw = dict(up=up, link=link)
    want, wn, wtr = jstore.merge_geo(jst, jt, delta=0, **kw)
    got, gn, gtr = tstore.merge_geo(tst, tt, delta=0,
                                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert_tree_equal(want, got, "merge_geo")
    assert int(wn) == int(gn)
    assert gtr.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(wtr), gtr.numpy())
    # The state is the flat merge's, and every delivery is counted once.
    flat, _ = tstore.merge(tst, delta=0, **{k: torch.from_numpy(v) for k, v in kw.items()})
    for a, b in zip(jax.tree.leaves(jax_to_numpy(want)), jax.tree.leaves(convert.to_numpy(flat))):
        np.testing.assert_array_equal(a, b)
    newly = got.cluster.pend_applied & ~tst.cluster.pend_applied
    assert int(gtr.sum()) == int(newly.sum())


def test_merge_geo_wan_source_and_partition_heal():
    """The copy into a region that was unreachable ships from the nearest
    holder region once the partition heals, as in the reference."""
    jt = jtopo.RegionTopology((0, 1, 2), J_ASYM.rtt_ms, jcost.EgressMatrix.from_pricing(
        3, jcost.PAPER_PRICING))
    tt = convert.region_topology(jt)
    jstore = JStore(3, 4, 4, level=JL.X_STCC, pending_cap=16)
    tstore = TStore(3, 4, 4, level=TL.X_STCC, pending_cap=16, device=CPU)
    jst, _ = jstore.apply_batch(jstore.init(), client=np.array([0]), replica=np.array([0]),
                                resource=np.array([0]), kind=np.array([1]))
    tst = convert.store_state_from_numpy(jax_to_numpy(jst), device=CPU)
    up = np.array([True, True, False])
    steps = [dict(up=up, link=np.ones((3, 3), bool)), {}]
    for kw in steps:
        jst, _, wtr = jstore.merge_geo(jst, jt, delta=0, **kw)
        tst, _, gtr = tstore.merge_geo(tst, tt, delta=0,
                                       **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_array_equal(np.asarray(wtr), gtr.numpy())
        assert_tree_equal(jst, tst, "heal")
    assert gtr.tolist() == [[0, 0, 0], [0, 0, 1], [0, 0, 0]]   # from region 1


def test_merge_geo_rejects_mismatched_topology():
    store = TStore(3, 4, 4, level=TL.X_STCC, device=CPU)
    with pytest.raises(ValueError, match="topology places"):
        store.merge_geo(store.init(), convert.region_topology(J_FIVE))


# -- nearest-peer gossip and the geo obs row --------------------------------------


@pytest.mark.parametrize("topo", ["paper", "asym", "five", "fleet"])
@pytest.mark.parametrize("peer", ["nearest", "round_robin"])
def test_gossip_pairs_match_reference(topo, peer):
    jt = {"paper": jtopo.PAPER_TOPOLOGY, "asym": J_ASYM, "five": J_FIVE,
          "fleet": J_FLEET}[topo]
    tt = convert.region_topology(jt)
    p = jt.n_replicas
    np.testing.assert_array_equal(jsched._peer_order(p, jt), tsched._peer_order(p, tt))
    for cadence in (1, 2, 3):
        want = jsched.gossip_pairs(p, 13, jsched.GossipConfig(cadence=cadence, peer=peer), jt)
        got = tsched.gossip_pairs(p, 13, tsched.GossipConfig(cadence=cadence, peer=peer), tt)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h_on", [False, True])
def test_geo_obs_registry_matches(h_on):
    jspecs = jobs.build_metrics(jobs.ObsConfig(n_bins=16), geo_on=True, h_on=h_on)
    tspecs = tobs.build_metrics(tobs.ObsConfig(n_bins=16), geo_on=True, h_on=h_on)
    assert [tuple(s) for s in jspecs] == [tuple(s) for s in tspecs]
    assert tspecs[2].name == "read_latency_ms"
    for a, b in zip(jobs.batch_bounds(jspecs), tobs.batch_bounds(tspecs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- whole runs -------------------------------------------------------------------


GOLDEN_GEO = [f"geo/{lv.name}" for lv in EVAL_LEVELS] + ["geo/X_STCC/gossip_recovery"]


@pytest.mark.parametrize("case", GOLDEN_GEO)
def test_golden_geo_case(case):
    """The golden file's geo cases: exact but for the latency fields,
    held within 1e-5 relative (the reference's own f32 sums drift from
    the file by ~1e-6)."""
    level = TL[case.split("/")[1]]
    kw = {}
    if case.endswith("gossip_recovery"):
        kw = dict(gossip=tsched.GossipConfig(cadence=2, hint_cap=32),
                  recovery=DurabilityConfig(snapshot_every=2, wal=True))
    got = sanitize(tsim.run_protocol_geo(level, WORKLOAD_A, n_ops=600, device=CPU, **kw))
    assert geo_mismatches(load_golden()[case], got) == []


@functools.lru_cache(maxsize=None)
def _reference_nearest(topo: str):
    jt = {"paper": jtopo.PAPER_TOPOLOGY, "fleet": J_FLEET}[topo]
    return sanitize(jsim.run_protocol_geo(
        JL.X_STCC, JA, topology=jt, n_ops=600,
        gossip=jsched.GossipConfig(cadence=2, peer="nearest"),
        recovery=JDura(snapshot_every=2, wal=True), obs=jobs.ObsConfig(),
    ))


@pytest.mark.parametrize("topo", ["paper", "fleet"])
def test_nearest_gossip_durability_obs_matches_reference(topo):
    jt = {"paper": jtopo.PAPER_TOPOLOGY, "fleet": J_FLEET}[topo]
    got = sanitize(tsim.run_protocol_geo(
        TL.X_STCC, WORKLOAD_A, topology=convert.region_topology(jt), n_ops=600,
        gossip=tsched.GossipConfig(cadence=2, peer="nearest"),
        recovery=DurabilityConfig(snapshot_every=2, wal=True),
        obs=tobs.ObsConfig(), device=CPU,
    ))
    want = _reference_nearest(topo)
    assert geo_mismatches(want, got) == []
    assert "read_latency_ms" in got["obs"]["metrics"]
    assert got["gossip"]["peer"] == "nearest"


@pytest.mark.parametrize("level", EVAL_LEVELS, ids=lambda lv: lv.name)
def test_single_region_equals_run_protocol(level):
    keys = ("staleness_rate", "violation_rate", "severity", "n_reads", "dropped_writes")
    geo = tsim.run_protocol_geo(level, WORKLOAD_A, topology=ttopo.single_region(3),
                                n_ops=600, device=CPU)
    flat = tsim.run_protocol(level, WORKLOAD_A, n_ops=600, device=CPU)
    assert {k: geo[k] for k in keys} == {k: flat[k] for k in keys}
    assert np.asarray(geo["traffic_events"]).sum() == np.trace(geo["traffic_events"])


def test_geo_obs_off_leaves_the_rest_unchanged():
    on = tsim.run_protocol_geo(TL.TCC, WORKLOAD_A, n_ops=600, obs=tobs.ObsConfig(),
                               device=CPU)
    off = tsim.run_protocol_geo(TL.TCC, WORKLOAD_A, n_ops=600, device=CPU)
    assert {k: v for k, v in on.items() if k != "obs"} == off
