"""Port's X-STCC engine == JAX's: ``apply_op_batch`` on states taken
from reference rounds, ``server_merge`` (fixpoint and timed-only), the
plain vector-clock chain, and batch == scalar loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import xstcc as jx
from repro.core.consistency import ConsistencyLevel as JL
from repro.core.replicated_store import ReplicatedStore as JStore
from repro_torch import convert
from repro_torch.core import xstcc as tx
from repro_torch.kernels import ops

from torch_port_helpers import CPU, as_np, assert_tree_equal, jax_to_numpy

torch.set_num_threads(1)

C, P, R, Q = 6, 3, 5, 24


def _ops(rng, b, n_clients=C, n_res=R):
    return {
        "client": rng.integers(0, n_clients, b).astype(np.int32),
        "replica": rng.integers(0, P, b).astype(np.int32),
        "resource": rng.integers(0, n_res, b).astype(np.int32),
        "kind": rng.integers(0, 2, b).astype(np.int32),
    }


def _reference_state(seed, rounds=2):
    """A JAX StoreState after a few emulated X_STCC rounds: live pending
    slots, nonzero clocks and floors."""
    store = JStore(P, C, R, level=JL.X_STCC, pending_cap=Q, duot_cap=128)
    st = store.init()
    rng = np.random.default_rng(seed)
    for rd in range(rounds):
        o = {k: jnp.asarray(v) for k, v in _ops(rng, 16).items()}
        st, _ = store.apply_batch(st, **o, op_step0=rd * 16)
        if rd < rounds - 1:
            st, _ = store.merge(st)
    return st


def _batch_result_equal(want, got, context):
    assert_tree_equal(want.state, got.state, f"{context}: state")
    for f in ("version", "vc", "admissible", "stale", "violation", "dropped", "slot"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      as_np(getattr(got, f)), err_msg=f"{context}: {f}")


@pytest.mark.parametrize("with_clocks", [True, False])
@pytest.mark.parametrize("enforce", ["true", "false", "per_op"])
@pytest.mark.parametrize("cadence", ["scalar", "emulated"])
def test_apply_op_batch_on_reference_state(with_clocks, enforce, cadence):
    jst = _reference_state(seed=len(enforce) + 3 * with_clocks)
    tst = convert.cluster_state_from_numpy(jax_to_numpy(jst.cluster), device=CPU)
    rng = np.random.default_rng(11)
    o = _ops(rng, 40)
    enf = {"true": True, "false": False,
           "per_op": rng.integers(0, 2, 40).astype(bool)}[enforce]
    kw = {}
    if cadence == "emulated":
        step0 = 32
        kw = dict(
            op_index=(step0 + np.arange(40)).astype(np.int32),
            apply_index=(step0 + rng.integers(0, 80, 40)).astype(np.int32),
            pend_apply=np.asarray(jst.pend_apply),
        )
    want = jx.apply_op_batch(
        jst.cluster, **{k: jnp.asarray(v) for k, v in o.items()},
        enforce_sessions=jnp.asarray(enf),
        **{k: jnp.asarray(v) for k, v in kw.items()},
        ingest="dense", with_clocks=with_clocks)
    got = tx.apply_op_batch(
        tst, **{k: torch.from_numpy(v) for k, v in o.items()},
        enforce_sessions=torch.as_tensor(enf),
        **{k: torch.from_numpy(np.array(v)) for k, v in kw.items()},
        with_clocks=with_clocks)
    _batch_result_equal(want, got, f"{cadence}/{enforce}/clocks={with_clocks}")


def test_apply_op_batch_ring_overflow_matches():
    """More writes than free slots: k-th-free-slot ring + saturating drops."""
    jst = _reference_state(seed=5, rounds=1).cluster
    jst = jst._replace(pend_dropped=jnp.asarray(2 ** 31 - 3, jnp.int32))
    tst = convert.cluster_state_from_numpy(jax_to_numpy(jst), device=CPU)
    o = _ops(np.random.default_rng(2), 60)
    o["kind"][:] = 1
    want = jx.apply_op_batch(jst, **{k: jnp.asarray(v) for k, v in o.items()})
    got = tx.apply_op_batch(tst, **{k: torch.from_numpy(v) for k, v in o.items()})
    _batch_result_equal(want, got, "overflow")
    assert int(got.state.pend_dropped) == 2 ** 31 - 1


@pytest.mark.parametrize("delta", [0, 3, 1000])
def test_server_merge_fixpoint_matches(delta):
    jst = _reference_state(seed=delta % 7 + 1).cluster
    tst = convert.cluster_state_from_numpy(jax_to_numpy(jst), device=CPU)
    want, wn = jx.server_merge(jst, delta=delta)
    got, gn = tx.server_merge(tst, delta=delta)
    assert_tree_equal(want, got, "merge")
    assert int(wn) == int(gn)


@pytest.mark.parametrize("use_ready", [False, True])
def test_server_merge_timed_only_matches(use_ready):
    jst = _reference_state(seed=9).cluster
    tst = convert.cluster_state_from_numpy(jax_to_numpy(jst), device=CPU)
    ready = np.random.default_rng(1).integers(0, 2, Q).astype(bool) if use_ready else None
    want, wn = jx.server_merge(jst, delta=2, timed_only=True,
                               ready=None if ready is None else jnp.asarray(ready))
    got, gn = tx.server_merge(tst, delta=2, timed_only=True,
                              ready=None if ready is None else torch.from_numpy(ready))
    assert_tree_equal(want, got, "timed merge")
    assert int(wn) == int(gn)


def test_server_merge_masks_are_not_ported():
    """Fault masks go with the causal fixpoint only: a timed-only merge
    refuses them, as the reference does; the masked fixpoint itself
    equals the reference."""
    tst = tx.make_cluster(P, C, R, device=CPU)
    with pytest.raises(ValueError, match="timed_only"):
        tx.server_merge(tst, delta=1, timed_only=True, up=torch.ones(P, dtype=torch.bool))
    jst = _reference_state(seed=4).cluster
    tst = convert.cluster_state_from_numpy(jax_to_numpy(jst), device=CPU)
    up = np.asarray([True, False, True])
    want, wn = jx.server_merge(jst, delta=1, up=jnp.asarray(up))
    got, gn = tx.server_merge(tst, delta=1, up=torch.from_numpy(up))
    assert_tree_equal(want, got, "masked merge")
    assert int(wn) == int(gn)


@pytest.mark.parametrize("seed", range(3))
def test_plain_vclock_chain_matches_jax_scan(seed):
    jst = _reference_state(seed=seed).cluster
    o = _ops(np.random.default_rng(seed + 50), 64)
    want = jx.apply_op_batch(jst, **{k: jnp.asarray(v) for k, v in o.items()})
    svc, rvc, vcs = ops.vclock_chain(
        torch.from_numpy(o["client"]), torch.from_numpy(o["replica"]),
        torch.from_numpy((o["kind"] == 1).astype(np.int32)),
        torch.from_numpy(np.array(jst.session_vc)),
        torch.from_numpy(np.array(jst.replica_vc)))
    np.testing.assert_array_equal(np.asarray(want.vc), as_np(vcs))
    np.testing.assert_array_equal(np.asarray(want.state.session_vc), as_np(svc))
    np.testing.assert_array_equal(np.asarray(want.state.replica_vc), as_np(rvc))


def _scalar_loop(state, o, enforce):
    vers = []
    for c, p, r, k in zip(o["client"], o["replica"], o["resource"], o["kind"]):
        if k == tx.WRITE:
            out = tx.client_write(state, client=c, replica=p, resource=r)
        else:
            out = tx.client_read(state, client=c, replica=p, resource=r,
                                 enforce_sessions=enforce)
        state = out.state
        vers.append(int(out.version))
    return state, vers


@pytest.mark.parametrize("enforce", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_batch_matches_scalar_loop(enforce, seed):
    """Batch == one-op-at-a-time loop, with intra-batch trains and ring
    overflow (pending_cap 12 < writes), in the port and against JAX."""
    o = _ops(np.random.default_rng(seed), 40, n_clients=4, n_res=3)
    t0 = tx.make_cluster(P, 4, 3, pending_cap=12, device=CPU)
    want_state, want_vers = _scalar_loop(t0, o, enforce)
    got = tx.apply_op_batch(t0, **{k: torch.from_numpy(v) for k, v in o.items()},
                            enforce_sessions=enforce)
    for f in want_state._fields:
        np.testing.assert_array_equal(as_np(getattr(want_state, f)),
                                      as_np(getattr(got.state, f)), err_msg=f)
    assert as_np(got.version).tolist() == want_vers
    j = jx.apply_op_batch(jx.make_cluster(P, 4, 3, pending_cap=12),
                          **{k: jnp.asarray(v) for k, v in o.items()},
                          enforce_sessions=enforce)
    assert_tree_equal(j.state, got.state, "batch vs JAX")
