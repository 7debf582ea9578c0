"""Port's crash recovery == JAX's: ``ReplicatedStore.crash`` under the
three durability regimes and the peer ``bootstrap`` (partitions, targets
with no live source) on one converted state; ``run_protocol_faulty`` with
crash schedules (six levels, snapshot-only and no durability, anchored
schedules, shards), the crash-stripped twin's convergence, and the
runtime's ``StoreRecovery`` / ``CheckpointRecovery``."""

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
from repro.runtime import recovery as jrec
from repro.storage import simulator as jsim
from repro.storage.ycsb import WORKLOAD_A as JW
from repro_torch import convert
from repro_torch.core import availability as tav
from repro_torch.core.consistency import EVAL_LEVELS
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.core.replicated_store import ReplicatedStore as TStore
from repro_torch.runtime import (CheckpointRecovery, PartialRestoreError, RecoveryOutcome,
                                 StoreRecovery)
from repro_torch.storage import simulator as tsim
from repro_torch.storage.ycsb import WORKLOAD_A

from test_torch_xstcc import C, P, _ops
from torch_port_helpers import CPU, as_np, assert_tree_equal, jax_to_numpy, jlevel

torch.set_num_threads(1)

R, Q, N_RANGES = 12, 48, 4
DURA = {"wal": (2, True), "snap": (2, False), "none": None}
UP = np.ones(3, bool)
FULL = np.ones((3, 3), bool)


# -- store: crash and bootstrap ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jstore(kind):
    d = DURA[kind]
    store = JStore(P, C, R, level=JL.X_STCC, pending_cap=Q, duot_cap=64,
                   durability=JDura(*d) if d else None)
    apply = jax.jit(lambda st, o, s0: store.apply_batch(st, **o, op_step0=s0))
    merge = jax.jit(lambda st, up, link: store.merge(st, up=up, link=link))
    return store, apply, merge


def _tstore(kind):
    d = DURA[kind]
    return TStore(P, C, R, level=TL.X_STCC, pending_cap=Q, duot_cap=64,
                  durability=DurabilityConfig(*d) if d else None, device=CPU)


@functools.lru_cache(maxsize=None)
def _state(kind, seed):
    """A JAX StoreState with a snapshot marker behind the applied state, a
    journal, and a backlog missing replica 1 (written while it was down)."""
    store, apply, merge = _jstore(kind)
    st = store.init()
    rng = np.random.default_rng(seed)
    outage = np.asarray([True, False, True])
    for rd in range(4):
        o = {k: jnp.asarray(v) for k, v in _ops(rng, 12, n_res=R).items()}
        up = outage if rd == 3 else UP
        if rd == 3:
            o["replica"] = jnp.where(o["replica"] == 1, 2, o["replica"])
        st, _ = apply(st, o, rd * 12)
        st, _ = merge(st, jnp.asarray(up), jnp.asarray(up[:, None] & up[None, :]
                                                       | np.eye(3, dtype=bool)))
        if store.durability is not None:
            st = store.wal_append(st, jnp.asarray(rng.integers(0, 5, 3), jnp.int32))
            if rd == 1:
                st, _ = store.snapshot(st)
    return st


def _both(kind, seed):
    jst = _state(kind, seed)
    return jst, convert.store_state_from_numpy(jax_to_numpy(jst), device=CPU)


@pytest.mark.parametrize("kind", list(DURA))
@pytest.mark.parametrize("crashed", [(False, True, False), (True, False, True)])
def test_crash_matches_reference(kind, crashed):
    jst, tst = _both(kind, 0)
    mask = np.asarray(crashed)
    want, winfo = _jstore(kind)[0].crash(jst, jnp.asarray(mask))
    got, ginfo = _tstore(kind).crash(tst, torch.from_numpy(mask))
    assert_tree_equal(want, got, f"crash/{kind}")
    for k in ("wal_replayed", "snap_read", "rows_lost"):
        assert int(ginfo[k]) == int(winfo[k]), k
    if kind == "wal":
        assert int(ginfo["rows_lost"]) == 0 and int(ginfo["wal_replayed"]) > 0
    else:
        assert int(ginfo["rows_lost"]) > 0


def _iso_for(d):
    link = FULL.copy()
    link[d, :] = link[:, d] = False
    link[d, d] = True
    return link


# (targets, up, link): a full fleet; the target partitioned off; no live
# source; a target that is itself down; two targets sharing one source;
# the ring's first peer unreachable, so the second is the source.
BOOT_CASES = {
    "full": ((False, True, False), UP, FULL),
    "partitioned": ((False, True, False), UP, _iso_for(1)),
    "no_live_source": ((False, True, False), np.asarray([False, True, False]), FULL),
    "target_down": ((False, True, False), np.asarray([True, False, True]), FULL),
    "two_targets": ((True, False, True), UP, FULL),
    "second_peer": ((False, True, False), UP,
                    np.asarray([[1, 1, 0], [1, 1, 0], [0, 0, 1]], bool)),
}


@pytest.mark.parametrize("case", list(BOOT_CASES))
@pytest.mark.parametrize("kind", ["snap", "none"])
def test_bootstrap_matches_reference(case, kind):
    targets, up, link = BOOT_CASES[case]
    mask = np.asarray(targets)
    jst, tst = _both(kind, 1)
    jstore, tstore = _jstore(kind)[0], _tstore(kind)
    jst, _ = jstore.crash(jst, jnp.asarray(mask))
    tst, _ = tstore.crash(tst, torch.from_numpy(mask))
    want, wtel = jstore.bootstrap(jst, targets=jnp.asarray(mask), up=jnp.asarray(up),
                                  link=jnp.asarray(link), n_ranges=N_RANGES)
    got, gtel = tstore.bootstrap(tst, targets=torch.from_numpy(mask), up=torch.from_numpy(up),
                                 link=torch.from_numpy(link), n_ranges=N_RANGES)
    assert_tree_equal(want, got, f"bootstrap/{case}")
    for k in ("valid", "source", "cells", "pend", "ranges"):
        np.testing.assert_array_equal(as_np(gtel[k]), np.asarray(wtel[k]), err_msg=k)
    if case in ("full", "two_targets", "second_peer"):
        assert int(gtel["cells"].sum()) > 0
        # Idempotent: a second pass pulls nothing.
        again, tel2 = tstore.bootstrap(got, targets=mask, up=up, link=link,
                                       n_ranges=N_RANGES)
        assert int(tel2["cells"].sum()) == int(tel2["pend"].sum()) == 0
        np.testing.assert_array_equal(again.cluster.replica_version.numpy(),
                                      got.cluster.replica_version.numpy())
    else:
        assert not bool(gtel["valid"].any())


# -- the fault path with crash events ------------------------------------------------

N_OPS, BATCH = 1024, 128


def _crash(m):
    return m.replica_crash(8, 3, 1, 3, 2)


def _faulty_pair(level, schedule, recovery, **kw):
    """The reference's and the port's ``run_protocol_faulty`` results."""
    want = jsim.run_protocol_faulty(
        jlevel(level), JW, n_ops=N_OPS, batch_size=BATCH, schedule=schedule(jav),
        recovery=JDura(*recovery) if recovery else None, **kw)
    got = tsim.run_protocol_faulty(
        level, WORKLOAD_A, n_ops=N_OPS, batch_size=BATCH, schedule=schedule(tav),
        recovery=DurabilityConfig(*recovery) if recovery else None, device=CPU, **kw)
    return want, got


@pytest.mark.parametrize("level", EVAL_LEVELS, ids=lambda lv: lv.name)
def test_crash_run_with_wal_and_snapshots_matches_reference(level):
    want, got = _faulty_pair(level, _crash, (2, True))
    assert got == want
    assert got["crash_epochs"] == [3]
    assert got["recovery"]["crashes"] == 1 and got["recovery"]["rejoins"] == 1
    assert got["recovery"]["rows_lost"] == 0 and got["recovery"]["wal_replayed"] > 0


@pytest.mark.parametrize("level", [TL.X_STCC, TL.ONE], ids=lambda lv: lv.name)
@pytest.mark.parametrize("recovery", [(2, False), None], ids=["snapshots", "none"])
def test_crash_run_without_wal_matches_reference(level, recovery):
    want, got = _faulty_pair(level, _crash, recovery)
    assert got == want
    assert got["recovery"]["rows_lost"] > 0 and got["recovery"]["recovery_gb"] > 0


def test_anchored_crash_fires_once_as_in_reference():
    """With ``schedule_unit`` a schedule epoch spans 16 of CAUSAL's 8-op
    rounds; the crash fires in the first of them only."""
    want, got = _faulty_pair(TL.CAUSAL, lambda m: m.replica_crash(8, 3, 2, 2, 3), (4, True),
                             schedule_unit=BATCH)
    assert got == want
    assert got["recovery"]["crashes"] == 1


def test_sharded_crash_run_matches_reference():
    want, got = _faulty_pair(TL.X_STCC, _crash, (2, True), n_shards=2)
    assert got == want
    assert got["n_shards"] == 2 and got["recovery"]["crashes"] == 2


def test_rebuilt_fleet_converges_to_the_crash_free_twin():
    """The reference's twin check: after a quiescent anti-entropy tail,
    the crashed run's fleet equals the crash-stripped run's bit for bit."""
    kw = dict(n_ops=N_OPS, batch_size=BATCH, audit=False, device=CPU,
              recovery=DurabilityConfig(snapshot_every=4, wal=True), _return_state=True)
    sched = _crash(tav)
    crashed = tsim.run_protocol_faulty(TL.X_STCC, WORKLOAD_A, schedule=sched, **kw)
    twin = tsim.run_protocol_faulty(TL.X_STCC, WORKLOAD_A, schedule=sched.strip_crashes(),
                                    **kw)
    sts = []
    for res in (crashed, twin):
        st = res["_state"]
        for _ in range(2):
            st, _ = res["_store"].anti_entropy(st, up=torch.ones(3, dtype=torch.bool),
                                               link=torch.ones(3, 3, dtype=torch.bool))
        sts.append(st)
    for field in ("replica_version", "replica_vc", "global_version"):
        np.testing.assert_array_equal(getattr(sts[0].cluster, field).numpy(),
                                      getattr(sts[1].cluster, field).numpy(), err_msg=field)
    assert "_state" not in tsim.run_protocol_faulty(
        TL.X_STCC, WORKLOAD_A, schedule=sched, **dict(kw, _return_state=False))


# -- the runtime's recovery API ------------------------------------------------------


class _LagStore:
    """Stub whose replica 1 knows a fresher version than the restore."""

    n_replicas = 2

    def propagate(self):
        pass

    def restore(self, template, session):
        return {"w": 0}, 7, False

    def _read_meta(self, r):
        if r == 0:
            return {"entries": {"7": {"step": 42}}, "pending": [{"version": 8}]}
        return {"entries": {"9": {"step": 99}}, "version": 9}


class _NoMetaStore(_LagStore):
    def _read_meta(self, r):
        return {"entries": {}}


def test_checkpoint_recovery_matches_reference():
    for cls, err in ((jrec.CheckpointRecovery, jrec.PartialRestoreError),
                     (CheckpointRecovery, PartialRestoreError)):
        with pytest.raises(err) as ei:
            cls(_LagStore()).recover(None, None)
        assert ei.value.outcome.behind == 2
    want = jrec.CheckpointRecovery(_LagStore()).recover(None, None, allow_partial=True)
    got = CheckpointRecovery(_LagStore()).recover(None, None, allow_partial=True)
    assert got[0] == want[0]
    assert got[1] == RecoveryOutcome(**vars(want[1]))
    with pytest.raises(RuntimeError, match="no metadata"):
        CheckpointRecovery(_NoMetaStore()).recover(None, None)


@pytest.mark.parametrize("kind", ["wal", "none"])
def test_store_recovery_matches_reference(kind):
    jst, tst = _both(kind, 2)
    mask = np.asarray([False, True, False])
    want_st, want = jrec.StoreRecovery(_jstore(kind)[0]).recover(
        jst, jnp.asarray(mask), up=jnp.asarray(UP), link=jnp.asarray(FULL),
        n_ranges=N_RANGES, allow_partial=True)
    got_st, got = StoreRecovery(_tstore(kind)).recover(
        tst, torch.from_numpy(mask), up=torch.from_numpy(UP), link=torch.from_numpy(FULL),
        n_ranges=N_RANGES, allow_partial=True)
    assert_tree_equal(want_st, got_st, "store_recovery")
    assert vars(got) == vars(want)


def test_store_recovery_surfaces_a_partial_rebuild():
    _, tst = _both("none", 0)
    rec = StoreRecovery(_tstore("none"))
    down = np.asarray([False, True, False])
    with pytest.raises(PartialRestoreError) as ei:
        rec.recover(tst, down, up=np.asarray([False, True, False]), link=FULL,
                    n_ranges=N_RANGES)
    assert ei.value.outcome.partial and ei.value.outcome.behind > 0
    _, out = rec.recover(tst, down, up=UP, link=FULL, n_ranges=N_RANGES)
    assert not out.partial and out.rerouted
