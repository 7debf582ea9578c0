"""Port's leaf modules == JAX's: consistency levels, vector clocks, the
DUOT, the eq. 5-8 cost model, the cluster's RTT lookups, and the state
conversion both ways."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcost
from repro.core import duot as jduot
from repro.core import vector_clock as jvc
from repro.core import xstcc as jx
from repro.core.consistency import ConsistencyLevel as JL
from repro.storage.cluster import ClusterConfig as JCluster
from repro_torch import convert
from repro_torch.core import cost_model as tcost
from repro_torch.core import duot as tduot
from repro_torch.core import vector_clock as tvc
from repro_torch.core import xstcc as tx
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.engine.config import EngineConfig
from repro_torch.storage.cluster import ClusterConfig as TCluster

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU, as_np, assert_tree_equal, jax_to_numpy, jlevel

torch.set_num_threads(1)


@pytest.mark.parametrize("level", list(TL))
def test_consistency_level_matches(level):
    j = jlevel(level)
    assert level.value == j.value
    for rf in range(1, 13):
        assert level.write_acks(rf) == j.write_acks(rf)
        assert level.read_replicas(rf) == j.read_replicas(rf)
    assert (level.is_causal, level.is_timed, level.is_session_guarded) == (
        j.is_causal, j.is_timed, j.is_session_guarded)


@pytest.mark.parametrize("seed", range(3))
def test_vector_clock_ops_match(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 6, (40, 7)).astype(np.int32)
    b = rng.integers(0, 6, (40, 7)).astype(np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(as_np(tvc.merge(ta, tb)), np.asarray(jvc.merge(ja, jb)))
    np.testing.assert_array_equal(as_np(tvc.leq(ta, tb)), np.asarray(jvc.leq(ja, jb)))
    np.testing.assert_array_equal(
        as_np(tvc.receive(ta[0], tb[0], 3)), np.asarray(jvc.receive(ja[0], jb[0], 3)))
    np.testing.assert_array_equal(as_np(tvc.tick(ta[1], 6)), np.asarray(jvc.tick(ja[1], 6)))
    np.testing.assert_array_equal(
        as_np(tvc.happens_before_matrix(ta)), np.asarray(jvc.happens_before_matrix(ja)))


def _duot_batch(rng, b, n):
    return {
        "client": rng.integers(0, n, b).astype(np.int32),
        "kind": rng.integers(0, 2, b).astype(np.int32),
        "resource": rng.integers(0, 5, b).astype(np.int32),
        "version": rng.integers(0, 40, b).astype(np.int32),
        "replica": rng.integers(0, 3, b).astype(np.int32),
        "vc": rng.integers(0, 25, (b, n)).astype(np.int32),
    }


@pytest.mark.parametrize("sizes", [(10, 20, 30), (50,), (64, 64, 1), (70, 70)])
def test_duot_record_matches_contiguous_and_straddle(sizes):
    """Batches that fit, that straddle the capacity, and that overflow."""
    rng = np.random.default_rng(sum(sizes))
    jt = jduot.make(64, 6)
    tt = tduot.make(64, 6, device=CPU)
    for b in sizes:
        batch = _duot_batch(rng, b, 6)
        jt = jduot.record(jt, {k: jnp.asarray(v) for k, v in batch.items()})
        tt = tduot.record(tt, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert_tree_equal(jt, tt, f"duot after b={b}")
    assert tt.capacity == 64 and tt.n_clients == 6


def test_duot_append_matches():
    rng = np.random.default_rng(4)
    jt = jduot.make(3, 4)
    tt = tduot.make(3, 4, device=CPU)
    for _ in range(5):                      # past capacity: dropped
        c, k, r, v, p = (int(x) for x in rng.integers(0, 3, 5))
        vc = rng.integers(0, 9, 4).astype(np.int32)
        jt = jduot.append(jt, client=c, kind=k, resource=r, version=v,
                          replica=p, vc=jnp.asarray(vc))
        tt = tduot.append(tt, client=c, kind=k, resource=r, version=v,
                          replica=p, vc=torch.from_numpy(vc))
        assert_tree_equal(jt, tt, "append")


@pytest.mark.parametrize("pricing", ["PAPER_PRICING", "tiered"])
def test_cost_model_matches(pricing):
    if pricing == "tiered":
        tiers = ((10.0, 0.12), (100.0, 0.11), (float("inf"), 0.08))
        jp = jcost.PricingScheme(inter_dc_per_gb=0.08, inter_dc_tiers=tiers)
        tp = tcost.PricingScheme(inter_dc_per_gb=0.08, inter_dc_tiers=tiers)
    else:
        jp, tp = jcost.PAPER_PRICING, tcost.PAPER_PRICING
    for gb in (0.0, 3.5, 10.0, 64.2, 1e4):
        kw = dict(nb_instances=24, runtime_hours=gb / 7, hosted_gb=18.65,
                  months=gb / 1e3, io_requests=gb * 1e6, inter_dc_gb=gb,
                  intra_dc_gb=gb / 2)
        want = jcost.cost_all(**kw, pricing=jp).as_dict()
        got = tcost.cost_all(**kw, pricing=tp).as_dict()
        assert want == got
        assert jcost.tiered_cost(gb, 0.01, jp.inter_dc_tiers) == \
            tcost.tiered_cost(gb, 0.01, tp.inter_dc_tiers)
    assert dataclasses.asdict(tcost.EgressMatrix.from_pricing(3, tp)) == \
        dataclasses.asdict(jcost.EgressMatrix.from_pricing(3, jp))


@pytest.mark.parametrize("cfg_kw", [{}, dict(n_datacenters=4, replicas_per_dc=2),
                                    dict(replication_factor=30)])
def test_cluster_latency_lookups_match(cfg_kw):
    jc, tc = JCluster(**cfg_kw), TCluster(**cfg_kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert jc.n_nodes == tc.n_nodes
    np.testing.assert_array_equal(jc.replica_dcs(), tc.replica_dcs())
    for n in range(0, 16):
        assert jc.ack_latency_ms(n) == tc.ack_latency_ms(n)
        assert jc.read_latency_ms(n) == tc.read_latency_ms(n)
    for lv in JL:
        acks = lv.write_acks(jc.replication_factor)
        assert jc.ack_latency_ms(acks) == tc.ack_latency_ms(acks)


def test_convert_round_trips_reference_state():
    st = jx.make_cluster(3, 5, 4, pending_cap=8)
    st = jx.client_write(st, client=1, replica=2, resource=3).state
    d = jax_to_numpy(st)
    port = convert.cluster_state_from_numpy(d, device=CPU)
    assert_tree_equal(st, port, "cluster")
    back = convert.to_numpy(port)
    for k, v in d.items():
        np.testing.assert_array_equal(v, back[k])
        assert v.dtype == back[k].dtype, k
    t = jduot.make(8, 5)
    assert_tree_equal(t, convert.duot_from_numpy(jax_to_numpy(t), device=CPU))
    with pytest.raises(KeyError):
        convert.cluster_state_from_numpy({"clock": np.int32(0)}, device=CPU)


def test_make_cluster_matches():
    assert_tree_equal(jx.make_cluster(3, 4, 6, pending_cap=9),
                      tx.make_cluster(3, 4, 6, pending_cap=9, device=CPU))


def test_engine_config_validates_flat_fields():
    with pytest.raises(ValueError):
        EngineConfig(TL.X_STCC, ingest="pallas")
    with pytest.raises(ValueError):
        EngineConfig(TL.X_STCC, lean=True)          # lean needs audit=False
    cfg = EngineConfig(TL.X_STCC, lean=True, audit=False)
    assert cfg.resolved_pending_cap(0.5) == 256
    assert EngineConfig(TL.CAUSAL).resolved_pending_cap(0.05) == 128
