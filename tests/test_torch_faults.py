"""Port's fault path == JAX's: availability schedules, failover, the
masked merge fixpoint (over live slots) and its all-up identity,
``merge_faulty`` / ``anti_entropy``, the engine config's fault fields,
and the eight golden fault cases."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_bridge import load_golden, sanitize
from repro.core import availability as jav
from repro.core import xstcc as jx
from repro.core.consistency import ConsistencyLevel as JL
from repro.core.replicated_store import ReplicatedStore as JStore
from repro.engine import EngineConfig as JConfig
from repro_torch import convert
from repro_torch.core import availability as tav
from repro_torch.core import xstcc as tx
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.core.replicated_store import ReplicatedStore as TStore
from repro_torch.engine.config import EngineConfig as TConfig
from repro_torch.gossip.scheduler import GossipConfig
from repro_torch.storage import simulator as tsim
from repro_torch.storage import ycsb as tycsb

from test_torch_xstcc import C, P, R, _ops
from torch_port_helpers import CPU, as_np, assert_tree_equal, jax_to_numpy, tlevel

torch.set_num_threads(1)

Q = 40


def _random_schedule(rng, t=7, r=3):
    up = rng.random((t, r)) < 0.75
    up[np.arange(t), rng.integers(0, r, t)] = True      # someone is up
    link = rng.random((t, r, r)) < 0.6
    return up, link


# -- schedules ----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_schedule_masks_match_reference(seed):
    up, link = _random_schedule(np.random.default_rng(seed))
    js, ts = jav.FaultSchedule(up, link), tav.FaultSchedule(up, link)
    for name in ("closure", "faulty", "heals", "crashes", "rejoins"):
        np.testing.assert_array_equal(getattr(js, name)(), getattr(ts, name)(),
                                      err_msg=name)
    for n in (3, 7, 11):
        a, b = js.slice(n), ts.slice(n)
        np.testing.assert_array_equal(a.up, b.up)
        np.testing.assert_array_equal(a.closure(), b.closure())
    both = ts & tav.partition(7, 3, [[0, 1], [2]], 2, 5)
    want = js & jav.partition(7, 3, [[0, 1], [2]], 2, 5)
    np.testing.assert_array_equal(want.closure(), both.closure())
    np.testing.assert_array_equal(want.heals(), both.heals())


def test_schedule_constructors_match_reference():
    pairs = [
        (jav.replica_outage(6, 3, 1, 2, 4), tav.replica_outage(6, 3, 1, 2, 4)),
        (jav.replica_crash(6, 3, 2, 1, 3), tav.replica_crash(6, 3, 2, 1, 3)),
        (jav.partition(6, 3, [[0], [1, 2]], 0, 3),
         tav.partition(6, 3, [[0], [1, 2]], 0, 3)),
        (jav.from_predicates(6, 3, lambda t, r: (t + r) % 4 != 0,
                             lambda t, i, j: (i + j + t) % 3 != 1),
         tav.from_predicates(6, 3, lambda t, r: (t + r) % 4 != 0,
                             lambda t, i, j: (i + j + t) % 3 != 1)),
    ]
    for j, t in pairs:
        for f in ("up", "link", "crash"):
            np.testing.assert_array_equal(getattr(j, f), getattr(t, f))
        np.testing.assert_array_equal(j.rejoins(), t.rejoins())
        assert j.has_crashes == t.has_crashes
        np.testing.assert_array_equal(j.strip_crashes().crash, t.strip_crashes().crash)
    with pytest.raises(ValueError):
        tav.FaultSchedule(np.zeros((2, 3), bool), np.ones((2, 3, 3), bool))
    with pytest.raises(ValueError):
        tav.partition_link(3, [[0, 1]])


@pytest.mark.parametrize("seed", range(4))
def test_reroute_ops_numpy_and_torch_match_reference(seed):
    rng = np.random.default_rng(seed)
    home = rng.integers(0, 3, 50).astype(np.int32)
    for up in ([True, False, True], [False, False, True], [False, True, False],
               [False, False, False], rng.random(3) < 0.5):
        up = np.asarray(up, bool)
        want = np.asarray(jav.reroute_ops(jnp.asarray(home), jnp.asarray(up)))
        np.testing.assert_array_equal(tav.reroute_ops(home, up), want)
        got = tav.reroute_ops(torch.from_numpy(home), torch.from_numpy(up))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# -- masked merge ---------------------------------------------------------------


JSTORE = JStore(P, C, R, level=JL.X_STCC, pending_cap=Q, duot_cap=64)
# Jitted once per module: the reference's merges are while-loops that
# eager JAX would recompile on every call.
_j_apply = jax.jit(lambda st, o, step0: JSTORE.apply_batch(st, **o, op_step0=step0))
_j_merge = jax.jit(lambda cl, delta, up, link: jx.server_merge(cl, delta=delta, up=up,
                                                               link=link))
_j_merge_flat = jax.jit(lambda cl, delta: jx.server_merge(cl, delta=delta))
_j_merge_faulty = jax.jit(lambda st, up, link: JSTORE.merge_faulty(st, up=up, link=link))
_j_anti_entropy = jax.jit(lambda st, up, link: JSTORE.anti_entropy(st, up=up, link=link))


@functools.lru_cache(maxsize=None)
def _faulty_state(seed, *, garbage=False):
    """A JAX StoreState with a partially applied backlog: rounds merged
    under a replica-1 outage, so live slots miss replica 1."""
    store = JSTORE
    st = store.init()
    rng = np.random.default_rng(seed)
    up = jnp.asarray([True, False, True])
    for rd in range(3):
        o = {k: jnp.asarray(v) for k, v in _ops(rng, 10).items()}
        st, _ = _j_apply(st, o, rd * 10)
        st = st._replace(cluster=_j_merge(st.cluster, store.delta, up,
                                          jnp.ones((P, P), bool))[0])
    if garbage:
        # Dead slots carry arbitrary payloads: the live-slot fixpoint
        # must ignore them exactly as the dense one does.
        cl = st.cluster
        dead = ~np.asarray(cl.pend_live)
        vc = np.asarray(cl.pend_vc).copy()
        vc[dead] = rng.integers(0, 99, (int(dead.sum()), C))
        ver = np.asarray(cl.pend_version).copy()
        ver[dead] = rng.integers(0, 99, int(dead.sum()))
        st = st._replace(cluster=cl._replace(
            pend_vc=jnp.asarray(vc, jnp.int32), pend_version=jnp.asarray(ver, jnp.int32)))
    return store, st


MASKS = {
    "outage": ([True, False, True], np.ones((3, 3), bool)),
    "healed": ([True, True, True], np.ones((3, 3), bool)),
    "partition": ([True, True, True], tav.partition_link(3, [[0, 2], [1]])),
    "split_and_down": ([False, True, True], tav.partition_link(3, [[0, 1], [2]])),
}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("delta", [0, 3, 50])
@pytest.mark.parametrize("garbage", [False, True])
def test_masked_server_merge_matches_reference(mask, delta, garbage):
    _, jst = _faulty_state(len(mask) + delta, garbage=garbage)
    assert bool(np.asarray(jst.cluster.pend_live).any())
    up, link = MASKS[mask]
    want, wn = _j_merge(jst.cluster, delta, jnp.asarray(up), jnp.asarray(link))
    tst = convert.cluster_state_from_numpy(jax_to_numpy(jst.cluster), device=CPU)
    got, gn = tx.server_merge(tst, delta=delta, up=torch.tensor(up),
                              link=torch.from_numpy(np.asarray(link)))
    assert_tree_equal(want, got, mask)
    assert int(wn) == int(gn)


@pytest.mark.parametrize("seed", range(3))
def test_live_slot_fixpoint_matches_dense_unmasked_merge(seed):
    """The port gathers the live slots once per merge; the reference
    sweeps the whole ring, dead slots (with garbage payloads) included."""
    _, jst = _faulty_state(seed, garbage=True)
    tst = convert.cluster_state_from_numpy(jax_to_numpy(jst.cluster), device=CPU)
    for delta in (0, 4, 100):
        want, wn = _j_merge_flat(jst.cluster, delta)
        got, gn = tx.server_merge(tst, delta=delta)
        assert_tree_equal(want, got, f"delta={delta}")
        assert int(wn) == int(gn)


@pytest.mark.parametrize("seed", range(3))
def test_all_true_masks_equal_unmasked_merge(seed):
    _, jst = _faulty_state(seed)
    tst = convert.cluster_state_from_numpy(jax_to_numpy(jst.cluster), device=CPU)
    a, na = tx.server_merge(tst, delta=5)
    b, nb = tx.server_merge(tst, delta=5, up=torch.ones(3, dtype=torch.bool),
                            link=torch.ones((3, 3), dtype=torch.bool))
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(na) == int(nb)


def test_masked_merge_rejects_timed_only():
    st = tx.make_cluster(3, 2, 2, pending_cap=4, device=CPU)
    with pytest.raises(ValueError):
        tx.server_merge(st, delta=0, timed_only=True, up=torch.ones(3, dtype=torch.bool))


@pytest.mark.parametrize("mask", ["outage", "healed", "partition"])
def test_merge_faulty_and_anti_entropy_match_reference(mask):
    _, jst = _faulty_state(7)
    tstore = TStore(P, C, R, level=TL.X_STCC, pending_cap=Q, duot_cap=64, device=CPU)
    tst = convert.store_state_from_numpy(jax_to_numpy(jst), device=CPU)
    up, link = MASKS[mask]
    ju, jl = jnp.asarray(up), jnp.asarray(link)
    tu, tl_ = torch.tensor(up), torch.from_numpy(np.asarray(link))
    want, wn, wev = _j_merge_faulty(jst, ju, jl)
    got, gn, gev = tstore.merge_faulty(tst, up=tu, link=tl_)
    assert_tree_equal(want, got, "merge_faulty")
    assert (int(wn), int(wev)) == (int(gn), int(gev))
    want, wev = _j_anti_entropy(jst, ju, jl)
    got, gev = tstore.anti_entropy(tst, up=tu, link=tl_)
    assert_tree_equal(want, got, "anti_entropy")
    assert int(wev) == int(gev)
    # Idempotent: a second pass at the same masks ships nothing.
    again, ev2 = tstore.anti_entropy(got, up=tu, link=tl_)
    assert int(ev2) == 0
    for f in got.cluster._fields:
        assert torch.equal(getattr(got.cluster, f), getattr(again.cluster, f)), f


# -- engine config ------------------------------------------------------------


def test_pending_cap_rule_matches_reference():
    """The flat path's cap is unchanged; the fault path sizes the ring to
    the run's writes."""
    sched_j, sched_t = jav.all_up(5, 3), tav.all_up(5, 3)
    for level in (TL.X_STCC, TL.CAUSAL, TL.ALL):
        for kw in (dict(), dict(n_ops=600), dict(batch_size=512, n_ops=9000),
                   dict(pending_cap=77)):
            for rf in (0.5, 0.05):
                jc = JConfig(JL[level.name], **kw)
                tc = TConfig(level, **kw)
                assert tc.resolved_pending_cap(rf) == jc.resolved_pending_cap(rf)
                jc = JConfig(JL[level.name], faults=sched_j, **kw)
                tc = TConfig(level, faults=sched_t, **kw)
                assert tc.resolved_pending_cap(rf) == jc.resolved_pending_cap(rf)
    assert TConfig(TL.X_STCC).resolved_pending_cap(0.5) == 256
    assert TConfig(TL.X_STCC, faults=sched_t).resolved_pending_cap(0.5) == 3001


def test_engine_config_hashes_fault_masks_by_bytes():
    a = TConfig(TL.X_STCC, faults=tav.replica_outage(5, 3, 1, 1, 3),
                gossip=GossipConfig(cadence=2), durability=DurabilityConfig())
    b = TConfig(TL.X_STCC, faults=tav.replica_outage(5, 3, 1, 1, 3),
                gossip=GossipConfig(cadence=2), durability=DurabilityConfig())
    c = TConfig(TL.X_STCC, faults=tav.replica_outage(5, 3, 1, 1, 4))
    assert a == b and hash(a) == hash(b)
    assert a != c
    with pytest.raises(ValueError):
        TConfig(TL.X_STCC, faults=tav.all_up(3, 4))
    with pytest.raises(ValueError):
        TConfig(TL.X_STCC, faults=tav.all_up(3, 3), lean=True, audit=False)


# -- golden fault cases ---------------------------------------------------------

_OUTAGE = dict(schedule=tav.replica_outage(5, 3, 1, 1, 3), schedule_unit=128)
FAULT_CASES = {
    **{f"faulty_allup/{lv.name}": (lv, {}) for lv in (
        TL.X_STCC, TL.TCC, TL.CAUSAL, TL.ONE, TL.QUORUM, TL.ALL)},
    "faulty/X_STCC/outage": (TL.X_STCC, dict(
        **_OUTAGE, gossip=GossipConfig(cadence=2, hint_cap=32),
        recovery=DurabilityConfig(snapshot_every=2, wal=True))),
    "faulty/CAUSAL/outage": (TL.CAUSAL, dict(**_OUTAGE, audit=False)),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_golden_fault_case(case):
    level, kw = FAULT_CASES[case]
    got = tsim.run_protocol_faulty(level, tycsb.WORKLOAD_A, n_ops=600,
                                   device=CPU, **kw)
    assert sanitize(got) == load_golden()[case]


def test_faulty_store_keeps_hints_and_dura_off_by_default():
    st = TStore(3, 2, 4, device=CPU).init()
    assert st.hints is None and st.dura is None
    st = TStore(3, 2, 4, hint_cap=4, durability=DurabilityConfig(snapshot_every=0),
                device=CPU).init()
    assert st.hints.slot.shape == (3, 4) and st.dura is None
    np.testing.assert_array_equal(as_np(st.hints.count), np.zeros(3))
    assert tlevel(JL.ONE) is TL.ONE
