"""Port's gossip + hinted handoff + durability == JAX's: range digests
(wrapped SUM/CHK included), the digest compare's plain version against
the reference oracle and twin, peer schedules, and ``gossip_round`` /
``enqueue_hints`` / ``drain_hints`` / ``snapshot`` / ``wal_append`` from
one converted state; deferred pieces raise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import availability as jav
from repro.core.consistency import ConsistencyLevel as JL
from repro.core.replicated_store import DurabilityConfig as JDura
from repro.core.replicated_store import ReplicatedStore as JStore
from repro.gossip import digest as jdig
from repro.gossip import scheduler as jsched
from repro.kernels import digest_compare as jdc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import availability as tav
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.core.replicated_store import ReplicatedStore as TStore
from repro_torch.gossip import digest as tdig
from repro_torch.gossip import scheduler as tsched
from repro_torch.kernels import digest_compare as tdc
from repro_torch.kernels import ops
from repro_torch.storage import simulator as tsim
from repro_torch.storage.ycsb import WORKLOAD_A

from test_torch_xstcc import C, P, _ops
from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU, as_np, assert_tree_equal, jax_to_numpy

torch.set_num_threads(1)

I32_MAX = 2 ** 31 - 1

# -- digests ------------------------------------------------------------------


@pytest.mark.parametrize("n_res,n_ranges", [(1, 1), (10, 3), (24, 8), (100, 64), (7, 20)])
def test_range_of_resource_and_weights_match_reference(n_res, n_ranges):
    np.testing.assert_array_equal(
        tdig.range_of_resource(n_res, n_ranges).numpy(),
        np.asarray(jdig.range_of_resource(n_res, n_ranges)))
    np.testing.assert_array_equal(tdig.checksum_weights(n_res).numpy(),
                                  np.asarray(jdig.checksum_weights(n_res)))


@pytest.mark.parametrize("regime", ["small", "wrapping", "negative"])
@pytest.mark.parametrize("n_ranges", [1, 3, 8, 64])
def test_range_digests_match_reference(regime, n_ranges):
    rng = np.random.default_rng(n_ranges)
    lo, hi = {"small": (0, 50), "wrapping": (I32_MAX - 5000, I32_MAX),
              "negative": (-(2 ** 31), I32_MAX)}[regime]
    v = rng.integers(lo, hi, (3, 97), endpoint=True).astype(np.int32)
    v[:, ::5] = 0
    want = np.asarray(jdig.range_digests(jnp.asarray(v), n_ranges))
    got = tdig.range_digests(torch.from_numpy(v), n_ranges)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tdig.range_digests(torch.from_numpy(v[1]), n_ranges).numpy(),
                                  want[1])
    if regime == "wrapping":
        # The range sums really overflow int32.
        assert (v.astype(np.int64).sum(axis=1) > I32_MAX).all()


# -- digest compare -------------------------------------------------------------


def _digest_pair(rng, kind, k):
    if kind == "empty":
        a = b = np.zeros((k, 4), np.int32)
    elif kind == "equal":
        a = b = rng.integers(0, 9, (k, 4)).astype(np.int32)
    elif kind == "fully_stale":
        a = rng.integers(1, 9, (k, 4)).astype(np.int32)
        b = np.zeros((k, 4), np.int32)
    elif kind == "overflowing":
        a = rng.choice(np.asarray([I32_MAX, -(2 ** 31), 1, -1, 0], np.int32), (k, 4))
        b = rng.choice(np.asarray([-(2 ** 31), I32_MAX, -7, 5, 0], np.int32), (k, 4))
    else:  # mixed
        a = rng.integers(0, 3, (k, 4)).astype(np.int32)
        b = rng.integers(0, 3, (k, 4)).astype(np.int32)
    return a, b


@pytest.mark.parametrize("kind", ["empty", "equal", "fully_stale", "overflowing", "mixed"])
@pytest.mark.parametrize("n_ranges", [1, 3, 8, 64])
def test_digest_compare_plain_matches_oracle_and_twin(kind, n_ranges):
    rng = np.random.default_rng(n_ranges * 7 + len(kind))
    a, b = _digest_pair(rng, kind, 3 * n_ranges)
    a, b = a.reshape(3, n_ranges, 4), b.reshape(3, n_ranges, 4)
    want = [np.asarray(x) for x in jref.digest_compare_ref(jnp.asarray(a), jnp.asarray(b))]
    twin = [np.asarray(x) for x in jops.digest_compare(jnp.asarray(a), jnp.asarray(b),
                                                        impl="tiled", block=4)]
    got = ops.digest_compare(torch.from_numpy(a), torch.from_numpy(b), impl="torch")
    for w, t, g in zip(want, twin, got):
        assert g.shape == (3, n_ranges) and g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), t)
    if kind in ("empty", "equal"):
        assert not want[0].any()


def test_digest_compare_packed_rows_with_invalid_rows():
    """The plain version reads the reference's packed layout: inert
    (VALID=0) rows give all-zero verdicts, as in the Pallas twin."""
    rng = np.random.default_rng(3)
    packed = rng.integers(-(2 ** 31), I32_MAX, (64, jdc.DIG_COLS), dtype=np.int64)
    packed[:, jdc.VALID] = rng.integers(0, 2, 64)
    packed[::3, 4:8] = packed[::3, 0:4]              # equal rows
    packed = packed.astype(np.int32)
    want = np.asarray(jdc.digest_compare_tiled(jnp.asarray(packed), block=16))
    got = tdc.digest_compare_ref(torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[packed[:, jdc.VALID] == 0].any()
    layout = tdc.pack_digests(torch.ones((5, 4), dtype=torch.int32),
                              torch.zeros((5, 4), dtype=torch.int32))
    want_layout = np.asarray(jdc.pack_digests(jnp.ones((5, 4), jnp.int32),
                                              jnp.zeros((5, 4), jnp.int32), block=5))
    np.testing.assert_array_equal(layout.numpy(), want_layout)


def test_digest_compare_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        ops.digest_compare(torch.zeros((2, 4), dtype=torch.int32),
                           torch.zeros((2, 4), dtype=torch.int32), impl="cuda")
    with pytest.raises(ValueError):
        tdc.digest_compare_pairs_cuda(torch.zeros((2, 1, 4), dtype=torch.int32),
                                      torch.tensor([0]), torch.tensor([1]), [(0, 1)])


def _digest_table(rng, kind, p, k):
    """A (P, K, 4) digest table whose rows 0 and 1 hold the pair kinds of
    :func:`_digest_pair`; the rest random, replica 2 equal to replica 0."""
    a, b = _digest_pair(rng, kind, k)
    tab = rng.integers(-(2 ** 31), I32_MAX, (p, k, 4), dtype=np.int64).astype(np.int32)
    tab[0], tab[1] = a, b
    if p > 2:
        tab[2] = tab[0]
    return tab


@pytest.mark.parametrize("kind", ["empty", "equal", "fully_stale", "overflowing", "mixed"])
@pytest.mark.parametrize("n_ranges", [1, 8, 64])
def test_digest_compare_pairs_plain_matches_reference(kind, n_ranges):
    """The gathered form's plain version equals the reference's compare of
    the gathered rows, for every ordered pair, self pairs included."""
    rng = np.random.default_rng(n_ranges * 11 + len(kind))
    tab = _digest_table(rng, kind, 4, n_ranges)
    pairs = np.asarray([[a, b] for a in range(4) for b in range(4)], np.int64)
    jt = jnp.asarray(tab)
    want = jops.digest_compare(jt[pairs[:, 0]], jt[pairs[:, 1]], impl="tiled", block=8)
    oracle = jref.digest_compare_ref(jt[pairs[:, 0]], jt[pairs[:, 1]])
    tp = torch.from_numpy(pairs)
    got = ops.digest_compare_pairs(torch.from_numpy(tab), tp[:, 0], tp[:, 1],
                                   host_pairs=pairs.tolist())
    for w, o, g in zip(want, oracle, got):
        assert g.shape == (16, n_ranges) and g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(o))
    # Self pairs and the equal replicas 0 and 2 never differ.
    same = (pairs[:, 0] == pairs[:, 1]) | ((pairs.min(1) == 0) & (pairs.max(1) == 2))
    assert not got[0].numpy()[same].any()
    # Without host pairs the indices are checked from the device tensors.
    for g, w in zip(ops.digest_compare_pairs(torch.from_numpy(tab), tp[:, 0], tp[:, 1]),
                    got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", range(3))
def test_digest_compare_pairs_on_gossip_round_inputs(seed):
    """gossip_round's own digest table and pairs: the gathered plain version
    equals the reference's compare of dig[a] and dig[b]."""
    jst, tst = _both(seed)
    pairs = np.asarray([[0, 1], [1, 2], [2, 0]], np.int64)
    jdg = jdig.range_digests(jst.cluster.replica_version, N_RANGES)
    want = jops.digest_compare(jdg[pairs[:, 0]], jdg[pairs[:, 1]])
    tdg = tdig.range_digests(tst.cluster.replica_version, N_RANGES)
    tp = torch.from_numpy(pairs)
    got = ops.digest_compare_pairs(tdg, tp[:, 0], tp[:, 1], host_pairs=pairs.tolist())
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any()              # the outage left stale ranges


def test_digest_compare_pairs_refuses_cpu_tensors_and_outside_pairs():
    dig = torch.zeros((3, 8, 4), dtype=torch.int32)
    a, b = torch.tensor([0, 1]), torch.tensor([1, 2])
    with pytest.raises(ValueError):
        tdc.digest_compare_pairs_cuda(dig, a, b, [[0, 1], [1, 2]])
    with pytest.raises(ValueError):
        ops.digest_compare_pairs(dig, a, b, impl="cuda")
    for bad in ([[0, 1], [1, 3]], [[-1, 1], [1, 2]]):
        with pytest.raises(ValueError):
            ops.digest_compare_pairs(dig, a, b, host_pairs=bad)
    with pytest.raises(ValueError):
        ops.digest_compare_pairs(dig, a, torch.tensor([1, 3]))


# -- schedules ----------------------------------------------------------------


@pytest.mark.parametrize("cadence,n_ranges,hint_cap", [(0, 8, 0), (1, 4, 2), (2, 8, 32), (3, 1, 0)])
def test_gossip_pairs_match_reference(cadence, n_ranges, hint_cap):
    jc = jsched.GossipConfig(cadence=cadence, n_ranges=n_ranges, hint_cap=hint_cap)
    tc = tsched.GossipConfig(cadence=cadence, n_ranges=n_ranges, hint_cap=hint_cap)
    assert (tc.enabled, tc.handoff) == (jc.enabled, jc.handoff)
    for p, t in ((3, 10), (2, 5), (1, 4)):
        for w, g in zip(jsched.gossip_pairs(p, t, jc), tsched.gossip_pairs(p, t, tc)):
            np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError):
        tsched.GossipConfig(cadence=-1)


# -- store: gossip, hints, durability ---------------------------------------------

R = 12
Q = 48
H = 5
N_RANGES = 4
JSTORE = JStore(P, C, R, level=JL.X_STCC, pending_cap=Q, duot_cap=64, hint_cap=H,
                durability=JDura(snapshot_every=2, wal=True))
OUTAGE_UP = np.asarray([True, False, True])
ALL_CONN = np.ones((P, P), bool)
_j_apply = jax.jit(lambda st, o, step0: JSTORE.apply_batch(st, **o, op_step0=step0))
_j_merge = jax.jit(lambda st, up, link: JSTORE.merge(st, up=up, link=link))
_j_enqueue = jax.jit(lambda st, slot, version, kind, home, conn: JSTORE.enqueue_hints(
    st, slot=slot, version=version, kind=kind, home=home, conn=conn))
_j_drain = jax.jit(lambda st, up, link: JSTORE.drain_hints(st, up=up, link=link))
_j_gossip = jax.jit(lambda st, pairs, up, link: JSTORE.gossip_round(
    st, pairs=pairs, up=up, link=link, n_ranges=N_RANGES))


def _tstore():
    return TStore(P, C, R, level=TL.X_STCC, pending_cap=Q, duot_cap=64, hint_cap=H,
                  durability=DurabilityConfig(snapshot_every=2, wal=True), device=CPU)


@functools.lru_cache(maxsize=None)
def _outage_state(seed):
    """A JAX StoreState after rounds served while replica 1 was down: a
    backlog missing replica 1, and hints queued for it (with overflow)."""
    st = JSTORE.init()
    rng = np.random.default_rng(seed)
    conn = jav.replica_outage(1, 3, 1, 0, 1).closure()[0]
    for rd in range(3):
        o = {k: jnp.asarray(v) for k, v in _ops(rng, 12, n_res=R).items()}
        home = np.asarray(o["replica"]).copy()
        home[home == 1] = 2
        o["replica"] = jnp.asarray(home)
        st, res = _j_apply(st, o, rd * 12)
        st, _, _ = _j_enqueue(st, res.slot, res.version, o["kind"], o["replica"],
                              jnp.asarray(conn))
        st, _ = _j_merge(st, jnp.asarray(OUTAGE_UP), jnp.asarray(conn))
    return st


def _both(seed):
    jst = _outage_state(seed)
    return jst, convert.store_state_from_numpy(jax_to_numpy(jst), device=CPU)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("healed", [False, True])
def test_gossip_round_matches_reference(seed, healed):
    jst, tst = _both(seed)
    up = np.ones(3, bool) if healed else OUTAGE_UP
    pairs = np.asarray([[0, 1], [1, 2], [2, 0]], np.int32)
    want, wtel = _j_gossip(jst, jnp.asarray(pairs), jnp.asarray(up), jnp.asarray(ALL_CONN))
    got, gtel = _tstore().gossip_round(tst, pairs=pairs, up=torch.from_numpy(up),
                                       link=torch.from_numpy(ALL_CONN), n_ranges=N_RANGES)
    assert_tree_equal(want, got, "gossip_round")
    for k in ("valid", "ranges", "growth", "gap_repaired"):
        np.testing.assert_array_equal(as_np(gtel[k]), np.asarray(wtel[k]), err_msg=k)
    if healed:
        assert int(gtel["growth"].sum()) > 0


@pytest.mark.parametrize("seed", range(3))
def test_enqueue_and_drain_hints_match_reference(seed):
    jst, tst = _both(seed)
    assert int(np.asarray(jst.hints.dropped)) > 0        # overflow happened
    tstore = _tstore()
    rng = np.random.default_rng(seed + 10)
    o = _ops(rng, 12, n_res=R)
    slot = rng.integers(0, Q + 1, 12).astype(np.int32)   # Q = no slot
    version = rng.integers(1, 30, 12).astype(np.int32)
    conn = tav.partition(1, 3, [[0, 1], [2]], 0, 1).closure()[0]
    want, wn, wd = _j_enqueue(jst, jnp.asarray(slot), jnp.asarray(version),
                              jnp.asarray(o["kind"]), jnp.asarray(o["replica"]),
                              jnp.asarray(conn))
    got, gn, gd = tstore.enqueue_hints(
        tst, slot=torch.from_numpy(slot), version=torch.from_numpy(version),
        kind=torch.from_numpy(o["kind"]), home=torch.from_numpy(o["replica"]),
        conn=torch.from_numpy(conn))
    assert_tree_equal(want, got, "enqueue_hints")
    assert (int(wn), int(wd)) == (int(gn), int(gd))
    for up in (np.ones(3, bool), OUTAGE_UP):
        want_d, wdel = _j_drain(jst, jnp.asarray(up), jnp.asarray(ALL_CONN))
        got_d, gdel = tstore.drain_hints(tst, up=torch.from_numpy(up),
                                         link=torch.from_numpy(ALL_CONN))
        assert_tree_equal(want_d, got_d, "drain_hints")
        np.testing.assert_array_equal(gdel.numpy(), np.asarray(wdel))


@pytest.mark.parametrize("seed", range(2))
def test_snapshot_and_wal_append_match_reference(seed):
    jst, tst = _both(seed)
    tstore = _tstore()
    rec = np.asarray([3, 0, 7], np.int32)
    want = JSTORE.wal_append(jst, jnp.asarray(rec))
    got = tstore.wal_append(tst, torch.from_numpy(rec))
    assert_tree_equal(want, got, "wal_append")
    want, wc = JSTORE.snapshot(want)
    got, gc = tstore.snapshot(got)
    assert_tree_equal(want, got, "snapshot")
    assert int(wc) == int(gc) > 0
    back = convert.to_numpy(got)
    assert set(back) == {"cluster", "duot", "pend_apply", "hints", "dura"}


# -- deferred pieces ----------------------------------------------------------


def test_deferred_pieces_raise():
    # Nearest-peer gossip needs a topology, in the port as in the reference.
    with pytest.raises(ValueError, match="RegionTopology"):
        tsim.run_protocol_faulty(TL.X_STCC, WORKLOAD_A, n_ops=600, device=CPU,
                                 gossip=tsched.GossipConfig(cadence=2, peer="nearest"))
    with pytest.raises(ValueError, match="RegionTopology"):
        tsched.gossip_pairs(3, 4, tsched.GossipConfig(cadence=1, peer="nearest"))
