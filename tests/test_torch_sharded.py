"""Port's sharded path == JAX's: the seven golden sharded cases, the
per-shard-sum identity, the sharded severity, obs and fault blocks
against the live reference, the engine config's sharding, and
``ShardedStore`` against the reference's mapped store.  Exact
everywhere (counts, rates, severity, costs compare with ``==``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_bridge import load_golden, sanitize
from repro.core import availability as jav
from repro.core.consistency import ConsistencyLevel as JL
from repro.core.replicated_store import ReplicatedStore as JStore
from repro.core.replicated_store import ShardedStore as JSharded
from repro.engine import EngineConfig as JConfig
from repro.gossip.scheduler import GossipConfig as JGossip
from repro.core.replicated_store import DurabilityConfig as JDura
from repro.obs.metrics import ObsConfig as JObs
from repro.storage import simulator as jsim
from repro.storage.ycsb import WORKLOAD_A as JA
from repro_torch.core import availability as tav
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.core.replicated_store import ReplicatedStore as TStore
from repro_torch.core.replicated_store import ShardedStore as TSharded
from repro_torch.core.replicated_store import index_tree
from repro_torch.engine import EngineConfig as TConfig
from repro_torch.engine import EpochEngine
from repro_torch.gossip.scheduler import GossipConfig
from repro_torch.obs.metrics import ObsConfig
from repro_torch.storage import simulator as tsim
from repro_torch.storage.ycsb import WORKLOAD_A as TA

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU, as_np, assert_tree_equal

torch.set_num_threads(1)

LEVELS = (TL.X_STCC, TL.TCC, TL.CAUSAL, TL.ONE, TL.QUORUM, TL.ALL)

# -- the seven golden sharded cases -------------------------------------------


@pytest.mark.parametrize("level", LEVELS, ids=lambda lv: lv.name)
def test_golden_sharded_case(level):
    got = tsim.run_protocol_sharded(level, TA, n_ops=600, n_shards=2, device=CPU)
    assert sanitize(got) == load_golden()[f"sharded/{level.name}"]


def test_golden_faulty_sharded_case():
    got = tsim.run_protocol_faulty(
        TL.X_STCC, TA, n_ops=600, n_shards=2, schedule=tav.replica_outage(5, 3, 1, 1, 3),
        schedule_unit=128, audit=False, device=CPU)
    assert sanitize(got) == load_golden()["faulty/X_STCC/sharded"]


# -- per-shard sums, severity, obs, faults against the live reference ----------


@pytest.mark.parametrize("level", (TL.X_STCC, TL.CAUSAL, TL.ALL), ids=lambda lv: lv.name)
def test_per_shard_counts_equal_unsharded_runs(level):
    """A 2-shard split equals the reference's and, shard by shard, the
    port's unsharded run of that shard (seed s): the reference's own
    identity, with exact counts."""
    kw = dict(n_ops=800, n_clients=16, n_resources=24, audit=False)
    got = tsim.run_protocol_sharded(level, TA, n_shards=2, device=CPU, **kw)
    assert got == jsim.run_protocol_sharded(JL[level.name], JA, n_shards=2, **kw)
    for s in range(2):
        config = TConfig(level, n_ops=400, n_clients=8, n_resources=12, seed=s,
                         audit=False)
        out = EpochEngine(config, device=CPU).replay(TA)["out"]
        for k in ("stale", "viol", "reads"):
            assert got["per_shard"][k][s] == int(out[k]), (s, k)
    assert got["n_reads"] == sum(got["per_shard"]["reads"])


@pytest.mark.parametrize("n_shards,kw", [
    (2, dict(audit=True)),
    (3, dict(audit=True, n_ops=900, n_clients=12, n_resources=12, seed=5)),
    (2, dict(obs=True, batch_size=64, merge_every=4, delta=12)),
], ids=["severity", "three_shards", "obs"])
def test_sharded_matches_reference(n_shards, kw):
    """Severity is the mean of the shards' audits (f64 of f32, as
    ``np.mean`` takes it); the obs block sums the shards' counts."""
    kw = {"n_ops": 600, **kw}
    obs = kw.pop("obs", False)
    got = tsim.run_protocol_sharded(TL.CAUSAL, TA, n_shards=n_shards, device=CPU,
                                    obs=ObsConfig() if obs else None, **kw)
    want = jsim.run_protocol_sharded(JL.CAUSAL, JA, n_shards=n_shards,
                                     obs=JObs() if obs else None, **kw)
    assert sanitize(got) == sanitize(want)
    if kw.get("audit"):
        assert 0.0 < got["severity"] < 1.0


def test_faulty_sharded_with_gossip_hints_durability_obs():
    sched_t, sched_j = tav.replica_outage(5, 3, 1, 1, 3), jav.replica_outage(5, 3, 1, 1, 3)
    got = tsim.run_protocol_faulty(
        TL.X_STCC, TA, n_ops=600, n_shards=2, schedule=sched_t, schedule_unit=128,
        gossip=GossipConfig(cadence=2, hint_cap=32), obs=ObsConfig(),
        recovery=DurabilityConfig(snapshot_every=2, wal=True), device=CPU)
    want = jsim.run_protocol_faulty(
        JL.X_STCC, JA, n_ops=600, n_shards=2, schedule=sched_j, schedule_unit=128,
        gossip=JGossip(cadence=2, hint_cap=32), obs=JObs(),
        recovery=JDura(snapshot_every=2, wal=True))
    assert sanitize(got) == sanitize(want)
    assert got["gossip"]["hints"]["enqueued"] > 0


def test_sharded_replay_stacks_the_carry():
    config = TConfig(TL.X_STCC, n_ops=600, n_shards=3, n_clients=12, n_resources=24)
    prep = EpochEngine(config, device=CPU).replay(TA)
    st = prep["out"]["st"]
    assert st.cluster.replica_version.shape == (3, 3, 8)
    assert st.duot.vc.shape == (3, 2048, 4)
    assert prep["out"]["reads"].shape == (3,)
    assert [s["client"].max() < 4 for s in prep["streams"]] == [True] * 3


# -- the engine config ---------------------------------------------------------


def test_engine_config_sharding_matches_reference():
    for kw in (dict(n_shards=2), dict(n_shards=4, n_clients=64, n_resources=5_000_000,
                                       n_ops=8_000_000, batch_size=4096),
               dict(n_shards=3, n_clients=12, n_resources=12, n_ops=900)):
        for level in (TL.X_STCC, TL.ONE):
            t, j = TConfig(level, **kw), JConfig(JL[level.name], **kw)
            assert (t.shard_clients, t.shard_resources, t.shard_ops) == (
                j.shard_clients, j.shard_resources, j.shard_ops)
            assert t.resolved_pending_cap(0.5) == j.resolved_pending_cap(0.5)
            sched_t, sched_j = tav.all_up(5, 3), jav.all_up(5, 3)
            assert (TConfig(level, faults=sched_t, **kw).resolved_pending_cap(0.5)
                    == JConfig(JL[level.name], faults=sched_j, **kw)
                    .resolved_pending_cap(0.5))
    assert TConfig(TL.X_STCC, n_shards=2) != TConfig(TL.X_STCC, n_shards=2,
                                                     use_devices=False)
    for bad in (dict(n_clients=15), dict(n_resources=25), dict(n_ops=601)):
        with pytest.raises(ValueError, match="divisible"):
            TConfig(TL.X_STCC, n_shards=2, **bad)
        with pytest.raises(ValueError, match="divisible"):
            tsim.run_protocol_sharded(TL.X_STCC, TA, n_shards=2, device=CPU, **bad)
    from repro_torch.geo.topology import PAPER_TOPOLOGY

    with pytest.raises(ValueError, match="topology"):
        TConfig(TL.X_STCC, n_shards=2, topology=PAPER_TOPOLOGY)


def test_use_devices_changes_nothing():
    a = tsim.run_protocol_sharded(TL.TCC, TA, n_ops=400, device=CPU, use_devices=True)
    b = tsim.run_protocol_sharded(TL.TCC, TA, n_ops=400, device=CPU, use_devices=False)
    assert a == b


# -- ShardedStore ---------------------------------------------------------------

S, P, C, R, Q, B = 2, 3, 4, 5, 16, 12


def _shard_ops(rng):
    return {
        "client": rng.integers(0, C, (S, B)).astype(np.int32),
        "replica": rng.integers(0, P, (S, B)).astype(np.int32),
        "resource": rng.integers(0, R, (S, B)).astype(np.int32),
        "kind": rng.integers(0, 2, (S, B)).astype(np.int32),
    }


@functools.lru_cache(maxsize=None)
def _reference_sharded_store():
    """The reference's mapped store with its methods jitted once (eager
    ``vmap`` retraces every call)."""
    js = JSharded(JStore(P, C, R, level=JL.X_STCC, pending_cap=Q, duot_cap=64), S)
    for name in ("apply_batch", "read_batch", "write_batch"):
        setattr(js, name, jax.jit(getattr(js, name), static_argnames=("record",)))
    for name in ("merge", "anti_entropy"):
        setattr(js, name, jax.jit(getattr(js, name)))
    js.install = jax.jit(js.install, static_argnames=("replica", "resource", "version"))
    return js


@pytest.mark.parametrize("seed", range(2))
def test_sharded_store_matches_reference(seed):
    rng = np.random.default_rng(seed)
    js = _reference_sharded_store()
    ts = TSharded(TStore(P, C, R, level=TL.X_STCC, pending_cap=Q, duot_cap=64,
                         device=CPU), S)
    jst, tst = js.init(), ts.init()
    assert_tree_equal(jst, tst, "init")
    for rd in range(2):
        o = _shard_ops(rng)
        jst, jres = js.apply_batch(jst, **{k: jnp.asarray(v) for k, v in o.items()})
        tst, tres = ts.apply_batch(tst, **{k: torch.from_numpy(v) for k, v in o.items()})
        assert_tree_equal(jst, tst, f"apply {rd}")
        for f in ("version", "vc", "stale", "violation", "slot"):
            np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                          as_np(getattr(tres, f)), err_msg=f)
        rd_ops = {k: o[k] for k in ("client", "replica", "resource")}
        jst, _ = js.read_batch(jst, **{k: jnp.asarray(v) for k, v in rd_ops.items()})
        tst, _ = ts.read_batch(tst, **{k: torch.from_numpy(v) for k, v in rd_ops.items()})
        jst, _ = js.write_batch(jst, **{k: jnp.asarray(v) for k, v in rd_ops.items()})
        tst, _ = ts.write_batch(tst, **{k: torch.from_numpy(v) for k, v in rd_ops.items()})
        up = rng.random(P) < 0.7
        link = rng.random((P, P)) < 0.7
        link = link | link.T
        jst, jn = js.merge(jst, up=jnp.asarray(up), link=jnp.asarray(link))
        tst, tn = ts.merge(tst, up=torch.from_numpy(up), link=torch.from_numpy(link))
        np.testing.assert_array_equal(np.asarray(jn), as_np(tn))
        jst, jev = js.anti_entropy(jst, up=jnp.ones(P, bool), link=jnp.ones((P, P), bool))
        tst, tev = ts.anti_entropy(tst, up=torch.ones(P, dtype=torch.bool),
                                   link=torch.ones((P, P), dtype=torch.bool))
        assert int(jev) == int(tev)
        jst = js.install(jst, replica=rd % P, resource=rd, version=50 + rd)
        tst = ts.install(tst, replica=rd % P, resource=rd, version=50 + rd)
        assert_tree_equal(jst, tst, f"round {rd}")
    # With op_step0, each shard emulates its cadence from its own offset.
    o = {k: torch.from_numpy(v) for k, v in _shard_ops(rng).items()}
    got, _ = ts.apply_batch(tst, **o, op_step0=[24, 40])
    for s, step0 in enumerate((24, 40)):
        want, _ = ts.store.apply_batch(index_tree(tst, s), **{k: v[s] for k, v in o.items()},
                                       op_step0=step0)
        for a, b in zip(jax.tree_util.tree_leaves(index_tree(got, s)),
                        jax.tree_util.tree_leaves(want)):
            assert torch.equal(a, b)
