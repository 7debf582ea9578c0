"""Port's ODG, log GC, staleness model and the small names of the core
== JAX's, on inputs made from a numpy seed.  Exact everywhere, except
``hist_edges`` (within one f32 ulp: XLA reassociates and contracts the
reference's ``linspace``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import audit as jaudit
from repro.core import duot as jduot
from repro.core import odg as jodg
from repro.core import staleness as jstale
from repro.core import vector_clock as jvc
from repro.core.consistency import ConsistencyLevel as JL
from repro.core.replicated_store import ReplicatedStore as JStore
from repro.kernels import histogram as jhist
from repro.kernels import ops as jops
from repro.storage import ycsb as jycsb
from repro_torch import convert
from repro_torch.core import audit as taudit
from repro_torch.core import duot as tduot
from repro_torch.core import odg as todg
from repro_torch.core import staleness as tstale
from repro_torch.core import vector_clock as tvc
from repro_torch.core.consistency import EVAL_LEVELS
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import ReplicatedStore as TStore
from repro_torch.engine import EngineConfig, EpochEngine
from repro_torch.kernels import histogram as thist
from repro_torch.kernels import ops as tops
from repro_torch.storage import simulator as tsim
from repro_torch.storage import ycsb as tycsb

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU, as_np, assert_tree_equal, jax_to_numpy

torch.set_num_threads(1)


def _duot(rng, m, n, *, fill, n_res=4, ties=False, holes=False):
    """A DUOT with ``fill`` entries: clocks cumulative, seqs unique (or
    with ties), valid a prefix (or with holes)."""
    d = {k: np.array(v) for k, v in jax_to_numpy(jduot.make(m, n)).items()}
    d["client"][:fill] = rng.integers(0, n, fill)
    d["kind"][:fill] = rng.integers(0, 2, fill)
    d["resource"][:fill] = rng.integers(0, n_res, fill)
    d["version"][:fill] = rng.integers(0, 6, fill)
    d["replica"][:fill] = rng.integers(0, 3, fill)
    seq = np.arange(fill) if not ties else np.sort(rng.integers(0, fill // 2 + 1, fill))
    d["seq"][:fill] = seq
    d["vc"][:fill] = np.cumsum(rng.integers(0, 2, (fill, n)), axis=0)
    d["valid"][:fill] = True
    if holes:
        d["valid"][:fill] &= rng.random(fill) < 0.8
    d["size"] = np.int32(fill)
    d["next_seq"] = np.int32(fill)
    j = jduot.Duot(**{k: jnp.asarray(v) for k, v in d.items()})
    return j, convert.duot_from_numpy(d, device=CPU)


CASES = [dict(m=40, n=3, fill=40), dict(m=64, n=5, fill=50, holes=True),
         dict(m=48, n=4, fill=48, ties=True), dict(m=33, n=2, fill=33, n_res=1),
         dict(m=96, n=6, fill=90, ties=True, holes=True, n_res=7)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_odg_matches_reference(case):
    rng = np.random.default_rng(case)
    j, t = _duot(rng, **CASES[case])
    jg, tg = jodg.build(j), todg.build(t)
    assert_tree_equal(jg, tg, "build")
    assert {k: int(v) for k, v in jodg.edge_counts(jg).items()} == {
        k: int(v) for k, v in todg.edge_counts(tg).items()}
    for iters in (None, 1, 2):
        np.testing.assert_array_equal(np.asarray(jodg.reachability(jg.causal, iters)),
                                      as_np(todg.reachability(tg.causal, iters)))
    np.testing.assert_array_equal(np.asarray(jodg.dependency_closure(jg)),
                                  as_np(todg.dependency_closure(tg)))
    np.testing.assert_array_equal(np.asarray(jodg.observation_frontier(j, jg)),
                                  as_np(todg.observation_frontier(t, tg)))
    viol_j = jaudit.audit(j, delta=3).violation
    viol_t = taudit.audit(t, delta=3).violation
    np.testing.assert_array_equal(np.asarray(viol_j), as_np(viol_t))
    for w in (dict(), dict(w_timed=0.5, w_causal=1.25, w_data=7.0)):
        want = np.asarray(jodg.severity_from_odg(jg, viol_j, **w))
        got = as_np(todg.severity_from_odg(tg, viol_t, **w))
        assert want.dtype == got.dtype == np.float32
        assert want.tobytes() == got.tobytes(), w
    # A random violation matrix too, so the numerator is not all zero.
    v = rng.random(jg.timed.shape) < 0.4
    assert (np.asarray(jodg.severity_from_odg(jg, jnp.asarray(v))).tobytes()
            == as_np(todg.severity_from_odg(tg, torch.from_numpy(v))).tobytes())


def test_odg_on_an_engine_duot():
    """The DUOT of a protocol run (what the card's smoke builds at M =
    2048), cut to 128 entries."""
    store = JStore(3, 6, 5, level=JL.CAUSAL, duot_cap=128)
    jst = store.init()
    rng = np.random.default_rng(7)
    for rd in range(2):
        o = {"client": rng.integers(0, 6, 70), "replica": rng.integers(0, 3, 70),
             "resource": rng.integers(0, 5, 70), "kind": rng.integers(0, 2, 70)}
        jst, _ = store.apply_batch(jst, **{k: jnp.asarray(v, jnp.int32) for k, v in o.items()})
        jst, _ = store.merge(jst)
    t = convert.duot_from_numpy(jax_to_numpy(jst.duot), device=CPU)
    jg, tg = jodg.build(jst.duot), todg.build(t)
    assert_tree_equal(jg, tg, "build")
    assert int(todg.edge_counts(tg)["timed"]) > 0
    viol = jaudit.audit(jst.duot, delta=8).violation
    assert (np.asarray(jodg.severity_from_odg(jg, viol)).tobytes()
            == as_np(todg.severity_from_odg(tg, torch.from_numpy(np.array(viol))))
            .tobytes())


# -- log GC ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_duot_gc_matches_reference(seed):
    rng = np.random.default_rng(seed)
    j, t = _duot(rng, 48, 4, fill=int(rng.integers(0, 49)), holes=bool(seed % 2))
    for _ in range(3):
        frontier = rng.integers(0, 12, 4).astype(np.int32)
        jg = jduot.gc(j, jnp.asarray(frontier))
        tg = tduot.gc(t, torch.from_numpy(frontier))
        assert_tree_equal(jg, tg, "gc")
    np.testing.assert_array_equal(np.asarray(jduot.live_mask(j)), as_np(tduot.live_mask(t)))
    assert tduot.as_dict(t).keys() == jduot.as_dict(j).keys()
    for k, v in jduot.as_dict(j).items():
        np.testing.assert_array_equal(np.asarray(v), as_np(tduot.as_dict(t)[k]))


def test_store_gc_frontier_and_wrap_match_reference():
    rng = np.random.default_rng(3)
    kw = dict(level=JL.X_STCC, pending_cap=32, duot_cap=96)
    jstore = JStore(3, 4, 4, **kw)
    tstore = TStore(3, 4, 4, **{**kw, "level": TL.X_STCC}, device=CPU)
    jst, tst = jstore.init(), tstore.init()
    for rd in range(3):
        o = {k: rng.integers(0, hi, 24).astype(np.int32)
             for k, hi in (("client", 4), ("replica", 3), ("resource", 4), ("kind", 2))}
        jst, _ = jstore.apply_batch(jst, **{k: jnp.asarray(v) for k, v in o.items()},
                                    op_step0=24 * rd)
        tst, _ = tstore.apply_batch(tst, **{k: torch.from_numpy(v) for k, v in o.items()},
                                    op_step0=24 * rd)
        jst, _ = jstore.merge(jst)
        tst, _ = tstore.merge(tst)
        np.testing.assert_array_equal(np.asarray(jstore.stability_frontier(jst)),
                                      as_np(tstore.stability_frontier(tst)))
        jst, tst = jstore.gc(jst), tstore.gc(tst)
        assert_tree_equal(jst, tst, f"round {rd}")
    assert int(tst.duot.size) < 64
    jw = jstore.wrap(jst.cluster, jst.duot)
    tw = tstore.wrap(tst.cluster, tst.duot)
    assert_tree_equal(jw, tw, "wrap")


# -- the staleness model -----------------------------------------------------------


def _params(mod, rng):
    return mod.StalenessParams(
        lambda_r=float(rng.uniform(0.1, 50)), lambda_w=float(rng.uniform(0.1, 50)),
        t_p=float(rng.uniform(0, 0.3)), n_replicas=int(rng.integers(1, 13)),
        x_r=int(rng.integers(1, 4)))


@pytest.mark.parametrize("seed", range(4))
def test_staleness_model_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        state = rng.bit_generator.state
        jp = _params(jstale, rng)
        rng.bit_generator.state = state
        tp = _params(tstale, rng)
        for f in ("stale_read_rate", "stale_read_rate_contended",
                  "stale_read_rate_paper_literal"):
            assert getattr(jstale, f)(jp) == getattr(tstale, f)(tp), f
    jp, tp = _params(jstale, np.random.default_rng(seed)), _params(tstale, np.random.default_rng(seed))
    assert (jstale.simulate_stale_reads(jp, horizon=40.0, seed=seed)
            == tstale.simulate_stale_reads(tp, horizon=40.0, seed=seed))
    kw = dict(lambda_r=5.0 + seed, lambda_w=2.0, t_p=0.1, n_replicas=12)
    levels_j = [JL[lv.name] for lv in EVAL_LEVELS]
    assert (jstale.staleness_vs_level(levels=levels_j, **kw)
            == tstale.staleness_vs_level(levels=list(EVAL_LEVELS), **kw))
    assert (jstale.staleness_vs_level(levels=levels_j, delta_seconds=0.01, **kw)
            == tstale.staleness_vs_level(levels=list(EVAL_LEVELS), delta_seconds=0.01,
                                         **kw))


def test_ycsb_rates_match_reference():
    for jw, tw in ((jycsb.WORKLOAD_A, tycsb.WORKLOAD_A), (jycsb.WORKLOAD_B, tycsb.WORKLOAD_B),
                   (jycsb.WORKLOAD_C, tycsb.WORKLOAD_C)):
        for thr in (1.0, 1234.5, 8e6):
            assert jycsb.rates(jw, thr) == tycsb.rates(tw, thr)


# -- vector clocks, audit names, ops and histogram helpers -----------------------


@pytest.mark.parametrize("seed", range(3))
def test_vector_clock_names_match_reference(seed):
    rng = np.random.default_rng(seed)
    vcs = rng.integers(0, 3, (30, 4)).astype(np.int32)
    vcs[5] = vcs[6]                      # an equal pair
    a, b = vcs[:15], vcs[15:]
    for f in ("dominates", "concurrent"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jvc, f)(jnp.asarray(a), jnp.asarray(b))),
            as_np(getattr(tvc, f)(torch.from_numpy(a), torch.from_numpy(b))))
    np.testing.assert_array_equal(np.asarray(jvc.concurrency_matrix(jnp.asarray(vcs))),
                                  as_np(tvc.concurrency_matrix(torch.from_numpy(vcs))))
    clients = rng.integers(0, 4, 30).astype(np.int32)
    big = (vcs.astype(np.int64) * 2 ** 27).astype(np.int32)   # int32 wrap
    for v in (vcs, big):
        np.testing.assert_array_equal(
            np.asarray(jvc.total_order_key(jnp.asarray(v), jnp.asarray(clients))),
            as_np(tvc.total_order_key(torch.from_numpy(v), torch.from_numpy(clients))))
    np.testing.assert_array_equal(np.asarray(jvc.zeros(5)), as_np(tvc.zeros(5, device=CPU)))


def test_audit_names_and_summary_match_reference():
    assert taudit.PHASE_NAMES == jaudit.PHASE_NAMES
    rng = np.random.default_rng(0)
    j, t = _duot(rng, 64, 4, fill=60)
    codes = tops.audit_duot(t, delta=3)
    want = jops.audit_summary(jnp.asarray(as_np(codes)))
    got = tops.audit_summary(codes)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), as_np(got[k]), err_msg=k)
    assert int(got["n_audited"]) > 0


def test_histogram_helpers_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(40):
        lo = float(rng.normal() * 10)
        hi = lo + float(rng.uniform(0.5, 40))
        n = int(rng.integers(1, 300))
        want = np.asarray(jhist.hist_edges(lo, hi, n))
        got = as_np(thist.hist_edges(lo, hi, n))
        assert want.dtype == got.dtype == np.float32
        ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32))
        assert ulps.max() <= 1 and want[-1] == got[-1]
        assert want[0] == got[0]
    vals = rng.normal(size=(3, 70)).astype(np.float32)
    mask = rng.random((3, 70)) < 0.5
    for m in (None, mask):
        for block in (8, 70, 128):
            jv, jm = jhist.pack_observations(
                jnp.asarray(vals), None if m is None else jnp.asarray(m), block=block)
            tv, tm = thist.pack_observations(
                torch.from_numpy(vals), None if m is None else torch.from_numpy(m),
                block=block)
            np.testing.assert_array_equal(np.asarray(jv), as_np(tv))
            np.testing.assert_array_equal(np.asarray(jm), as_np(tm))
            assert tv.dtype == torch.float32 and tm.dtype == torch.int32


def test_epoch_engine_run_is_replay_plus_assemble():
    from repro.engine import EngineConfig as JConfig
    from repro.engine import EpochEngine as JEngine
    from repro.storage.ycsb import WORKLOAD_A as JA

    cfg = EngineConfig(TL.CAUSAL, n_ops=400, n_shards=2, audit=True)
    got = EpochEngine(cfg, device=CPU).run(tycsb.WORKLOAD_A)
    assert got == tsim.run_protocol_sharded(TL.CAUSAL, tycsb.WORKLOAD_A, n_ops=400,
                                            audit=True, device=CPU)
    assert got == JEngine(JConfig(JL.CAUSAL, n_ops=400, n_shards=2, audit=True)).run(JA)
    flat = EpochEngine(EngineConfig(TL.ONE, n_ops=300), device=CPU).run(tycsb.WORKLOAD_A)
    assert flat == tsim.run_protocol(TL.ONE, tycsb.WORKLOAD_A, n_ops=300, device=CPU)
