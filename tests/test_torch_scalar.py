"""Port's scalar engine == JAX's: ``run_protocol_scalar`` and its final
carry, the one-slot-at-a-time ``server_merge_sequential``, the
stability frontier and the batch write/read wrappers, against the live
reference on seeded inputs.  Exact everywhere (the severity bit for
bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import xstcc as jx
from repro.core.consistency import ConsistencyLevel as JL
from repro.storage import simulator as jsim
from repro.storage.ycsb import WORKLOAD_A as JA
from repro.storage.ycsb import WORKLOAD_B as JB
from repro_torch import convert
from repro_torch.core import xstcc as tx
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.engine import stream as tstream
from repro_torch.storage import run_protocol_scalar
from repro_torch.storage import simulator as tsim
from repro_torch.storage.ycsb import WORKLOAD_A as TA
from repro_torch.storage.ycsb import WORKLOAD_B as TB

from torch_port_helpers import CPU, as_np, assert_tree_equal, jax_to_numpy

torch.set_num_threads(1)

LEVELS = ("X_STCC", "TCC", "CAUSAL", "ONE", "QUORUM", "ALL")


@pytest.mark.parametrize("level", LEVELS)
def test_run_protocol_scalar_matches_reference(level):
    """n_ops = 900 (the reference's own scalar-vs-batched size), with the
    audit: staleness, violations, reads and severity equal."""
    want = jsim.run_protocol_scalar(JL[level], JA, n_ops=900)
    got = run_protocol_scalar(TL[level], TA, n_ops=900, device=CPU)
    assert got == want


@pytest.mark.parametrize("level,w,kw", [
    ("X_STCC", "B", dict(n_ops=500, seed=4, merge_every=4, delta=12)),
    ("ONE", "A", dict(n_ops=700, n_clients=8, n_resources=6, duot_cap=256)),
    ("CAUSAL", "B", dict(n_ops=520, n_clients=12, n_resources=40, merge_every=5)),
])
def test_scalar_runner_final_carry_matches_reference(level, w, kw):
    """The whole final carry: cluster state (the 256-slot ring, the
    dropped count, the clock), the DUOT (a log full before the run ends
    included), and the three counters."""
    kw = {"n_clients": 16, "n_resources": 24, "merge_every": 8, "delta": 24,
          "duot_cap": 2048, "seed": 0, **kw}
    n_ops, seed = kw.pop("n_ops"), kw.pop("seed")
    stream = tstream.op_stream(TA if w == "A" else TB, n_ops, kw["n_clients"],
                               kw["n_resources"], seed)
    cols = [stream[k] for k in ("client", "kind", "resource", "home")]
    want = jsim._scalar_runner(JL[level], *kw.values())(*(jnp.asarray(c) for c in cols))
    got = tsim._scalar_runner(TL[level], *kw.values(), device=CPU)(*cols)
    assert_tree_equal(want[0], got[0], "state")
    assert_tree_equal(want[1], got[1], "duot")
    for i, name in ((2, "stale"), (3, "viol"), (4, "reads")):
        assert int(want[i]) == int(got[i]), name
    assert int(got[1].size) == min(n_ops, kw["duot_cap"])


def test_scalar_runner_counts_a_full_ring_as_dropped():
    """More unapplied writes than the 256-slot ring holds: ONE with a
    merge cadence longer than the run, so every write stays pending."""
    kw = dict(n_clients=4, n_resources=3, merge_every=400, delta=10_000, duot_cap=64)
    stream = tstream.op_stream(TB, 700, 4, 3, 1)
    cols = [stream[k] for k in ("client", "kind", "resource", "home")]
    want = jsim._scalar_runner(JL.ONE, *kw.values())(*(jnp.asarray(c) for c in cols))
    got = tsim._scalar_runner(TL.ONE, *kw.values(), device=CPU)(*cols)
    assert int(want[0].pend_dropped) > 0
    assert_tree_equal(want[0], got[0], "state")
    assert_tree_equal(want[1], got[1], "duot")


@pytest.mark.parametrize("level", ("X_STCC", "CAUSAL", "ONE", "ALL"))
def test_scalar_against_batched_as_the_reference_shows(level):
    """The relation the reference shows between its batched and scalar
    engines on the same inputs (they match exactly in staleness and
    violations here) holds for the port's two engines, value for value."""
    jb = jsim.run_protocol(JL[level], JA, n_ops=900, audit=False)
    js = jsim.run_protocol_scalar(JL[level], JA, n_ops=900, audit=False)
    tb = tsim.run_protocol(TL[level], TA, n_ops=900, audit=False, device=CPU)
    ts = run_protocol_scalar(TL[level], TA, n_ops=900, audit=False, device=CPU)
    assert ts == js and tb == jb
    for key in ("staleness_rate", "violation_rate", "n_reads"):
        assert (tb[key] == ts[key]) == (jb[key] == js[key]), key
        assert tb[key] - ts[key] == jb[key] - js[key], key


# -- the sequential merge --------------------------------------------------------


def _both_states(seed, steps=40, c=4, p=3, r=3, q=32):
    """The same random scalar op history through both engines."""
    rng = np.random.default_rng(seed)
    js = jx.make_cluster(p, c, r, pending_cap=q)
    ts = tx.make_cluster(p, c, r, pending_cap=q, device=CPU)
    for _ in range(steps):
        op = rng.random()
        kw = dict(client=int(rng.integers(c)), replica=int(rng.integers(p)),
                  resource=int(rng.integers(r)))
        if op < 0.5:
            js, ts = jx.client_write(js, **kw).state, tx.client_write(ts, **kw).state
        elif op < 0.85:
            e = bool(rng.integers(2))
            js = jx.client_read(js, enforce_sessions=e, **kw).state
            ts = tx.client_read(ts, enforce_sessions=e, **kw).state
        else:
            d = int(rng.integers(0, 30))
            js, _ = jx.server_merge_sequential(js, delta=d)
            ts, _ = tx.server_merge_sequential(ts, delta=d)
    return js, ts


@pytest.mark.parametrize("seed", range(8))
def test_server_merge_sequential_matches_reference(seed):
    js, ts = _both_states(seed)
    assert_tree_equal(js, ts, "history")
    before = [t.clone() for t in ts]
    for d in (0, 3, 12, 1000):
        jn_st, jn = jx.server_merge_sequential(js, delta=d)
        tn_st, tn = tx.server_merge_sequential(ts, delta=d)
        assert int(jn) == int(tn), d
        assert_tree_equal(jn_st, tn_st, f"delta={d}")
    # The input state is left as it was.
    for a, b in zip(before, ts):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(np.asarray(jx.stability_frontier(js)),
                                  as_np(tx.stability_frontier(ts)))


def test_server_merge_sequential_on_a_reference_ring():
    """A ring with live slots not yet due (``pend_time`` ahead of the
    clock), which the reference still applies when their dependencies
    hold, and a carrier case that waits a merge."""
    js, _ = _both_states(11, steps=60)
    d = jax_to_numpy(js)
    d["pend_time"] = np.where(np.arange(d["pend_time"].shape[0]) % 3 == 0,
                              d["pend_time"] + 500, d["pend_time"]).astype(np.int32)
    js = js._replace(pend_time=jnp.asarray(d["pend_time"]))
    ts = convert.cluster_state_from_numpy(d, device=CPU)
    assert np.any(d["pend_live"] & (d["pend_time"] > int(d["clock"])))
    for delta in (0, 5):
        jn_st, jn = jx.server_merge_sequential(js, delta=delta)
        tn_st, tn = tx.server_merge_sequential(ts, delta=delta)
        assert int(jn) == int(tn)
        assert_tree_equal(jn_st, tn_st, f"delta={delta}")


@pytest.mark.parametrize("seed", range(3))
def test_client_batches_match_reference(seed):
    js, ts = _both_states(seed + 20, steps=20)
    rng = np.random.default_rng(seed)
    o = {"client": rng.integers(0, 4, 9).astype(np.int32),
         "replica": rng.integers(0, 3, 9).astype(np.int32),
         "resource": rng.integers(0, 3, 9).astype(np.int32)}
    want = jx.client_write_batch(js, **{k: jnp.asarray(v) for k, v in o.items()})
    got = tx.client_write_batch(ts, **{k: torch.from_numpy(v) for k, v in o.items()})
    assert_tree_equal(want.state, got.state, "write batch")
    np.testing.assert_array_equal(np.asarray(want.version), as_np(got.version))
    enf = bool(seed % 2)
    want = jx.client_read_batch(want.state, **{k: jnp.asarray(v) for k, v in o.items()},
                                enforce_sessions=enf)
    got = tx.client_read_batch(got.state, **{k: torch.from_numpy(v) for k, v in o.items()},
                               enforce_sessions=enf)
    assert_tree_equal(want.state, got.state, "read batch")
    for f in ("version", "stale", "violation", "admissible"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), as_np(getattr(got, f)))
