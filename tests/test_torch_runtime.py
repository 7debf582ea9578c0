"""The port's checkpoint store and training runtime — ``CheckpointStore``,
``NodeHealth``, ``StragglerMonitor``, ``RestartManager``, the elastic
rescale — against the JAX reference, on the CPU.

Bounds: checkpoints cross between the packages exactly (f32), and a bf16
checkpoint round-trips in the port bit for bit; the stores' versions,
acks, reroutes and metadata, the health masks, the straggler weights and
the recovery outcomes are exactly equal; the rescale is exact at two
pods and within rtol 1e-6 where it sums more (XLA's sum order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JStore
from repro.checkpoint import SessionToken as JSession
from repro.core import ConsistencyLevel as JLevel
from repro.runtime import elastic as jelastic
from repro.runtime import fault_tolerance as jft
from repro.runtime.recovery import PartialRestoreError as JPartial
from repro_torch.checkpoint import CheckpointStore, SessionToken
from repro_torch.checkpoint.store import DTYPES_KEY
from repro_torch.core import ConsistencyLevel
from repro_torch.runtime import (FailurePolicy, NodeHealth, PartialRestoreError,
                                 RestartManager, StoreRecovery, StragglerMonitor,
                                 elastic, schedule_from_snapshots)
from repro_torch.tree import leaves

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import as_np, port_trainer

torch.set_num_threads(1)
CPU = "cpu"
RESCALE_RTOL = 1e-6


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "blocks": {"w": rng.standard_normal((2, 4, 3)).astype(np.float32),
                       "norm": rng.standard_normal((2, 4)).astype(np.float32)}}


def _t_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _j_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _zeros_like(tree, lib):
    return jax.tree.map(lambda a: lib.zeros(a.shape, dtype=lib.float32), tree)


# ---- checkpoints ---------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_f32_checkpoint_crosses_between_packages(tmp_path, writer):
    tree = _tree(0)
    jstore = JStore(str(tmp_path), n_replicas=3)
    tstore = CheckpointStore(str(tmp_path), n_replicas=3, device=CPU)
    if writer == "port":
        v = tstore.save(_t_tree(tree), step=7, session=SessionToken(client_id=1))
        out, version, _ = jstore.restore(_zeros_like(tree, jnp), JSession(client_id=1))
        got = jax.tree.map(np.asarray, out)
    else:
        v = jstore.save(_j_tree(tree), step=7, session=JSession(client_id=1))
        out, version, _ = tstore.restore(_zeros_like(tree, torch), SessionToken(client_id=1))
        got = jax.tree.map(as_np, out)
    assert version == v == 1
    for (path, want), (_, g) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                    jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_array_equal(g, want, err_msg=jax.tree_util.keystr(path))
    # The same layout: META.json per replica, one npz with '/'-joined keys.
    with np.load(os.path.join(tmp_path, "replica_1", "ckpt_v1.npz")) as z:
        assert sorted(z.files) == ["blocks/norm", "blocks/w", "embed"]


def test_bf16_checkpoint_round_trips_bit_for_bit(tmp_path):
    rng = np.random.default_rng(1)
    bf = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)).to(torch.bfloat16)
    bf[0, 0] = -0.0
    bf[0, 1] = float("inf")
    params = {"w": bf, "n": {"f": torch.arange(3, dtype=torch.float32)}}
    store = CheckpointStore(str(tmp_path), n_replicas=2, device=CPU)
    session = SessionToken(client_id=0)
    store.save(params, step=1, session=session)
    meta_template = {"w": torch.empty((5, 7), dtype=torch.bfloat16, device="meta"),
                     "n": {"f": torch.empty((3,), device="meta")}}
    out, _, _ = store.restore(meta_template, session)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), bf.view(torch.int16))
    assert torch.equal(out["n"]["f"], params["n"]["f"])
    with np.load(os.path.join(tmp_path, "replica_0", "ckpt_v1.npz")) as z:
        assert z["w"].dtype == np.uint16
        assert json.loads(str(z[DTYPES_KEY])) == {"w": "bfloat16"}


def _store_script(store, session_cls, tree_of, zeros):
    """Saves, propagation and restores under lag: every observable."""
    log = []
    writer = session_cls(client_id=0)
    log.append(store.save(tree_of(1.0), step=10, session=writer))
    log.append(store.propagate(now=1e18))
    log.append(store.save(tree_of(2.0), step=20, session=writer))
    log.append([store.latest_version(r) for r in range(store.n_replicas)])
    log.append([store.stale_read_probe(writer, r) for r in range(store.n_replicas)])
    for client, floor in ((2, 0), (2, 2), (1, 0)):
        reader = session_cls(client_id=client, read_floor=floor)
        try:
            out, version, rerouted = store.restore(zeros, reader)
            log.append((version, rerouted, float(np.asarray(out["w"].tolist())[0]),
                        reader.read_floor))
        except RuntimeError as e:
            log.append(("raised", str(e)))
    log.append(store.propagate(now=1e18))
    log.append([store.latest_version(r) for r in range(store.n_replicas)])
    metas = []
    for r in range(store.n_replicas):
        m = store._read_meta(r)
        metas.append({"version": m["version"],
                      "entries": {k: {f: e[f] for f in ("step", "version", "client")}
                                  for k, e in m["entries"].items()},
                      "pending": len(m.get("pending", []))})
    log.append(metas)
    return log


@pytest.mark.parametrize("level", ["ONE", "QUORUM", "ALL", "CAUSAL", "X_STCC"])
def test_store_protocol_matches_reference(tmp_path, level):
    jstore = JStore(str(tmp_path / "j"), n_replicas=3, level=JLevel[level],
                    propagation_lag_s=3600.0)
    tstore = CheckpointStore(str(tmp_path / "t"), n_replicas=3,
                             level=ConsistencyLevel[level], propagation_lag_s=3600.0,
                             device=CPU)
    want = _store_script(jstore, JSession, lambda v: {"w": v * jnp.ones((4,))},
                         {"w": jnp.zeros((4,))})
    got = _store_script(tstore, SessionToken, lambda v: {"w": v * torch.ones(4)},
                        {"w": torch.zeros(4)})
    assert got == want


# ---- restart and recovery -----------------------------------------------------------


def _restart_script(store, session_cls, mgr, tree_of, zeros):
    log = []
    writer = session_cls(client_id=0)
    for i in range(3):
        store.save(tree_of(float(i)), step=4 * (i + 1), session=writer)
    params, step = mgr.recover(zeros, session_cls(client_id=1))
    log.append((step, float(np.asarray(params["w"].tolist())[0]), mgr.restarts))
    o = mgr.last_outcome
    log.append((o.version, o.step, o.rerouted, o.partial, o.behind))
    mgr.recover(zeros, session_cls(client_id=2))
    try:
        mgr.recover(zeros, session_cls(client_id=2))
    except RuntimeError as e:
        log.append(("raised", str(e), mgr.restarts))
    return log


def test_restart_manager_matches_reference(tmp_path):
    jstore = JStore(str(tmp_path / "j"), n_replicas=3)
    tstore = CheckpointStore(str(tmp_path / "t"), n_replicas=3, device=CPU)
    want = _restart_script(jstore, JSession, jft.RestartManager(jstore, jft.FailurePolicy(2)),
                           lambda v: {"w": v * jnp.ones((3,))}, {"w": jnp.zeros((3,))})
    got = _restart_script(tstore, SessionToken, RestartManager(tstore, FailurePolicy(2)),
                          lambda v: {"w": v * torch.ones(3)}, {"w": torch.zeros(3)})
    assert got == want


def test_partial_restore_matches_reference(tmp_path):
    """A lagging home replica under ONE: the restore lands behind the
    fleet's newest version — refused unless ``allow_partial``."""
    outs = []
    for lib, store, session_cls, err, manager in (
            (jnp, JStore(str(tmp_path / "j"), 3, JLevel.ONE, 3600.0), JSession, JPartial,
             jft.RestartManager),
            (torch, CheckpointStore(str(tmp_path / "t"), 3, ConsistencyLevel.ONE, 3600.0,
                                    device=CPU), SessionToken, PartialRestoreError,
             RestartManager)):
        policy = jft.FailurePolicy() if lib is jnp else FailurePolicy()
        manager = manager(store, policy)
        store.save({"w": lib.ones(2)}, step=1, session=session_cls(client_id=0))
        store.propagate(now=1e18)
        store.save({"w": 2 * lib.ones(2)}, step=2, session=session_cls(client_id=0))
        with pytest.raises(err) as info:
            manager.recover({"w": lib.zeros(2)}, session_cls(client_id=2))
        o = info.value.outcome
        _, step = manager.recover({"w": lib.zeros(2)}, session_cls(client_id=2),
                                  allow_partial=True)
        outs.append(((o.version, o.partial, o.behind), step, manager.restarts))
    assert outs[0] == outs[1]


def test_node_health_matches_reference():
    j, t = jft.NodeHealth(4, heartbeat_timeout_s=30.0), NodeHealth(4, heartbeat_timeout_s=30.0)
    for h in (j, t):
        for i in range(4):
            h.beat(i, now=100.0)
        h.fail(2)
        h.beat(3, now=50.0)
    assert t.alive(now=110.0) == j.alive(now=110.0) == [True, True, False, False]
    snaps = {}
    for name, h in (("j", j), ("t", t)):
        out = [h.snapshot(now=110.0)]
        h.set_partition([[0, 1], [2, 3]])
        out.append(h.snapshot(now=110.0))
        h.recover(2)
        h.set_partition(None)
        out.append(h.snapshot(now=h.last_heartbeat[2]))
        snaps[name] = out
    for (ju, jl), (tu, tl) in zip(snaps["j"], snaps["t"]):
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(tl, jl)
    js, ts = jft.schedule_from_snapshots(snaps["j"]), schedule_from_snapshots(snaps["t"])
    np.testing.assert_array_equal(np.asarray(ts.up), np.asarray(js.up))
    np.testing.assert_array_equal(np.asarray(ts.link), np.asarray(js.link))
    with pytest.raises(ValueError):
        t.set_partition([[0, 1], [1, 2]])


@pytest.mark.parametrize("pattern", ["one_straggler", "all_straggle", "none", "empty"])
def test_straggler_monitor_matches_reference(pattern):
    j, t = jft.StragglerMonitor(4, factor=2.0, window=3), StragglerMonitor(4, factor=2.0, window=3)
    for mon in (j, t):
        if pattern == "empty":
            continue
        for pod in range(4):
            for k in range(5):
                mon.record(pod, 1.0 + 0.1 * k)
        if pattern == "one_straggler":
            mon.record(3, 10.0)
        if pattern == "all_straggle":
            for pod in range(4):
                mon.record(pod, 50.0 + pod)
    assert t.stragglers() == j.stragglers()
    assert t.median_all() == j.median_all()
    np.testing.assert_array_equal(t.up_mask(), j.up_mask())
    w = t.merge_weights()
    assert isinstance(w, torch.Tensor) and w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), np.asarray(j.merge_weights()))


# ---- elastic -------------------------------------------------------------------------


@pytest.mark.parametrize("p,new", [(2, 2), (2, 4), (4, 2), (3, 2), (2, 3), (4, 1), (3, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rescale_stacked_matches_reference(p, new, dtype):
    rng = np.random.default_rng(p * 10 + new)
    tree = {"a": rng.standard_normal((p, 5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((p, 7)).astype(np.float32)}}
    jt = jax.tree.map(lambda a: jnp.asarray(a, jnp.dtype(dtype)), tree)
    tt = jax.tree.map(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)), tree)
    want = jelastic.rescale_stacked(jt, new)
    got = elastic.rescale_stacked(tt, new)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], leaves(got)):
        w = np.asarray(w, np.float32)
        g = as_np(g.float())
        assert g.shape == w.shape
        if p in (1, 2) and new <= 4:
            np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
        else:
            rtol = RESCALE_RTOL if dtype == "float32" else 2 ** -7
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))


def test_rescale_train_state_keeps_the_mean():
    """2 -> 4 -> 2 pods: the parameters' mean over pods is kept, the
    moments follow, the bookkeeping restarts, and the rebuilt engine (no
    params template, as in the reference) bills no traffic."""
    tr = port_trainer(("X_STCC", 2, 4, {}), CPU)
    state = tr.run()
    mean0 = [x.float().mean(0) for x in leaves(state.params)]
    s4, e4 = elastic.rescale_train_state(state, tr.fns.engine, 4)
    assert e4.n_pods == 4 and all(x.shape[0] == 4 for x in leaves(s4.opt.mu))
    assert int(s4.sync.merges) == 0 and s4.step == state.step
    s2, e2 = elastic.rescale_train_state(s4, e4, 2)
    for m, x in zip(mean0, leaves(s2.params)):
        torch.testing.assert_close(x.float().mean(0), m, rtol=RESCALE_RTOL, atol=1e-7)
    params, sync = e2.merge(s2.params, s2.sync)
    assert int(sync.merges) == 1 and float(sync.inter_pod_gb) == 0.0


def test_store_recovery_on_the_sync_engines_store():
    """The pods' replica store (client = pod, replica = pod copy) through
    the runtime's crash recovery: replica 1 crashes and rebuilds from its
    peer, fully."""
    tr = port_trainer(("X_STCC", 2, 8, {}), CPU)
    state = tr.run()
    store = tr.fns.engine._store
    st = store.wrap(state.sync.cluster, state.sync.duot)
    down = np.array([False, True])
    rebuilt, outcome = StoreRecovery(store).recover(
        st, down, up=np.ones(2, bool), link=np.ones((2, 2), bool))
    assert not outcome.partial and outcome.behind == 0
    assert torch.equal(rebuilt.cluster.replica_version[1],
                       rebuilt.cluster.replica_version[0])
