"""Port's region-aware serving and sharded router == JAX's: the
reference's geo serving tests (nearest-replica routing, counted geo
failover, nearest admissible reroute, scalar/batch parity for unguarded
sessions, per-region RTT latency and its p50/p99, topology validation),
the router's failover, its p99 age spike and its equality with the
unsharded engine, and a port engine resuming a reference engine's
mid-run store state — each run through the live reference and the port
on the CPU, everything exact."""

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.geo import topology as ttopo
from repro_torch.serve import engine as tserve

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU, attempt, jax_to_numpy, plain, router_script
from torch_serving_harness import NullModel, Side, run_both, snapshot

torch.set_num_threads(1)


def _geo_engine(s, level="X_STCC"):
    topo = s.uniform_topology((0, 0, 1, 1), intra_rtt_ms=0.1, inter_rtt_ms=40.0)
    eng = s.engine(level, max_replicas=4, max_sessions=8)
    for i in range(4):
        eng.publish(object(), version=1, replica=i)
    eng.set_topology(topo, session_region=[0, 1] * 4)
    return eng


def test_routes_to_nearest_region_replica():
    def script(s):
        eng = _geo_engine(s)
        log = [eng.route(s.session(0)), eng.route(s.session(1))]
        eng.fail_replica(0)
        log.append(eng.route(s.session(0)))
        eng.heal_replica(0)
        return log, {"eng": eng}

    assert run_both(script) == [0, 2, 1]


def test_geo_failover_is_counted():
    def script(s):
        eng = _geo_engine(s, "ONE")
        eng.fail_replica(0)
        log = [eng.route(s.session(0)), eng.failovers, eng.reroutes,
               s.route_batch(eng, [s.session(0), s.session(1)]), eng.failovers]
        eng.heal_replica(0)
        eng.route(s.session(0))
        return log + [eng.failovers], {"eng": eng}

    log = run_both(script)
    assert log[:3] == [1, 1, 1] and log[3][0] == [1, 2] and log[4:] == [2, 2]


def test_reroutes_to_nearest_admissible_replica():
    def script(s):
        eng = _geo_engine(s)
        eng.publish(object(), version=2, replica=2)
        x = s.session(0)
        eng._observe(x, eng.route(x, preferred=2))
        log = [eng.route(x), s.route_batch(eng, [x, s.session(1)])]
        return log, {"eng": eng}

    assert run_both(script) == [2, [[2, 2], [2, 2]]]


def test_geo_scalar_batch_parity_for_unguarded_failover():
    def script(s):
        eng = _geo_engine(s)
        eng.set_session_level(2, s.level("ONE"))
        eng.publish(object(), version=2, replica=3)
        eng.fail_replica(0)
        scalar = eng.route(s.session(2, floor=2))
        rep, _ = s.route_batch(eng, [s.session(0), s.session(2, floor=2)])
        eng.heal_replica(0)
        return [scalar, rep], {"eng": eng}

    log = run_both(script)
    assert log[0] == 1 and log[1][1] == log[0]


def test_region_stats_accumulate_rtt_latency():
    def script(s):
        eng = _geo_engine(s, "ONE")
        s0, s1 = s.session(0), s.session(1)
        eng._observe(s0, eng.route(s0))
        eng._observe(s1, eng.route(s1, preferred=0))
        return [eng.region_stats()], {"eng": eng}

    stats = run_both(script)[0]
    assert stats["serves"] == [1, 1]
    assert stats["mean_latency_ms"] == pytest.approx([0.1, 40.0])


def test_topology_validation():
    eng = tserve.ServingEngine(NullModel(), max_replicas=4, max_sessions=8, device=CPU)
    with pytest.raises(ValueError, match="replicas"):
        eng.set_topology(ttopo.single_region(2))
    with pytest.raises(ValueError, match="session_region"):
        eng.set_topology(ttopo.single_region(4), session_region=[0, 0])
    with pytest.raises(RuntimeError, match="topology"):
        eng.region_stats()


def test_region_stats_percentiles():
    """Default session regions (the topology's client assignment), every
    serve intra-region; the scalar path feeds the same histograms."""

    def script(s):
        topo = s.uniform_topology((0, 0, 1, 1, 2, 2), intra_rtt_ms=2.0,
                                  inter_rtt_ms=40.0)
        eng = s.engine(max_replicas=6, max_sessions=12)
        for _ in range(6):
            eng.publish(None, version=1)
        eng.set_topology(topo)
        sessions = [s.session(i) for i in range(12)]
        log = [s.route_batch(eng, sessions), eng.region_stats()]
        eng._observe(sessions[0], eng.route(sessions[0]))
        return log + [sum(h.count for h in eng._region_hist), eng.region_stats()], \
            {"eng": eng}

    log = run_both(script)
    assert all(p < 40.0 for p in log[1]["p99_latency_ms"]) and log[2] == 13


@pytest.mark.parametrize("lo,hi,n_bins", [(0.0, 60.0, 64), (0.0, 1024.0, 64),
                                          (-3.5, 7.25, 5), (0.0, 44.99, 2)])
def test_host_histogram_matches_reference(lo, hi, n_bins):
    from repro.obs.metrics import HostHistogram as JHist
    from repro_torch.obs.metrics import HostHistogram as THist

    rng = np.random.default_rng(n_bins)
    vals = rng.uniform(lo - 5.0, hi + 5.0, 500).astype(np.float32)
    # Bin edges (in f32 and f64) and both range ends.
    edges = lo + np.arange(n_bins + 1) * ((hi - lo) / n_bins)
    vals = np.concatenate([vals, edges, edges.astype(np.float32), [lo, hi, np.nextafter(hi, lo)]])
    j, t = JHist(lo, hi, n_bins), THist(lo, hi, n_bins)
    for h in (j, t):
        h.observe(vals[:300])
        h.observe(vals[300:], weights=np.arange(vals.size - 300) % 3)
    assert t.counts.tolist() == j.counts.tolist()
    assert t.summary() == j.summary() and t.count == j.count
    with pytest.raises(ValueError):
        THist(1.0, 1.0)


# -- the sharded router -------------------------------------------------------------


def test_sharded_router_fails_over():
    """The reference's case with shard-local ids in range (it routes
    ``arange(8)`` to 4-session shards, whose ids 4-7 JAX clamps; the port
    refuses them, see ``test_router_validation``)."""

    def script(s):
        router = s.router(2, 4)
        router.install(0, 1)
        router.install(1, 2)
        router.set_replica_health([False, True])
        rep, srv = s.router_route(router, np.arange(8).reshape(2, 4) % 4)
        return [rep, srv, router.failovers], {"router": router}

    log = run_both(script)
    assert np.all(np.asarray(log[0]) == 1) and log[2] == 4
    assert np.all(np.asarray(log[1]) == 2)


def test_sharded_router_failover_spikes_p99_not_p50():
    """The reference's case with shard-local ids in range (it routes
    ``arange(16)`` to 8-session shards)."""

    def script(s):
        r = s.router(2, 8, max_replicas=4, age_hi=64)
        for i in range(4):
            r.install(i, version=3)
        sid = np.arange(16).reshape(2, 8) % 8
        log = [s.router_route(r, sid), r.age_stats()]
        r.install(1, version=10)
        r.set_replica_health([False, True, True, True])
        log += [s.router_route(r, sid), r.age_stats()]
        return log, {"router": r}

    log = run_both(script)
    assert log[1] == {"serves": 16, "p50_age": 0.0, "p99_age": 0.0}
    assert log[3]["p50_age"] == 0.0 and log[3]["p99_age"] == 7.0


@pytest.mark.parametrize("level", ["X_STCC", "ONE"])
def test_sharded_serving_router_matches_engine(level):
    """An (S, B) shard-aligned batch routes as the concatenated sessions
    through one unsharded engine, on both packages."""

    def script(s):
        eng = s.engine(level, max_replicas=4, max_sessions=8)
        eng.publish(None, version=1)
        eng.publish(None, version=3)
        sessions = [s.session(i) for i in range(8)]
        router = s.router(2, 4, max_replicas=4, level=level)
        router.install(0, 1)
        router.install(1, 3)
        sid = np.arange(8).reshape(2, 4) % 4
        log = []
        for pref in (1, 0):
            u = s.route_batch(eng, sessions, [pref] * 8)
            v = s.router_route(router, sid, np.full((2, 4), pref))
            assert list(u) == [np.asarray(x).reshape(-1).tolist() for x in v]
            log.append(u)
        assert router.reroutes == eng.reroutes
        assert router.staleness_rate() == eng.staleness_rate()
        return log, {"eng": eng, "router": router}

    run_both(script)


@pytest.mark.parametrize("level", ["X_STCC", "ONE"])
def test_seeded_router_schedule_matches_reference(level):
    def script(s):
        router = s.router(3, 8, max_replicas=5, level=level, age_hi=16.0)
        return router_script(s, router, seed=2, n_epochs=4, rounds=2), {"router": router}

    log = run_both(script)
    assert log[-1]["serves"] == 4 * 2 * 3 * 8 - 24 * sum(
        1 for x in log if isinstance(x, list) and x[0] == "raise")


def test_router_validation():
    r = tserve.ShardedServingRouter(2, 4, max_replicas=3, device=CPU)
    with pytest.raises(RuntimeError, match="no replicas"):
        r.route(np.zeros((2, 4), np.int32))
    with pytest.raises(RuntimeError, match="dense"):
        r.install(1, 1)
    with pytest.raises(RuntimeError, match="max_replicas"):
        r.install(3, 1)
    r.install(0, 1)
    with pytest.raises(ValueError, match="shards"):
        r.route(np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError, match="session ids"):
        r.route(np.arange(8).reshape(2, 4))
    r.set_replica_health([False])
    with pytest.raises(RuntimeError, match="no live replica"):
        r.route(np.zeros((2, 4), np.int32))


# -- resuming from the reference's state ------------------------------------------


def test_port_engine_resumes_reference_mid_run_state():
    """A port engine started from a reference engine's store state
    (through ``convert.store_state_from_numpy``) serves the rest of a
    script exactly as the reference engine does."""
    js, ts = Side("jax"), Side("torch")
    topo = [s.uniform_topology((0, 0, 1, 1), intra_rtt_ms=0.1, inter_rtt_ms=40.0)
            for s in (js, ts)]
    ref = js.engine("X_STCC", max_replicas=4, max_sessions=8)
    for i in range(4):
        ref.publish(None, version=1 + i % 2)
    ref.set_topology(topo[0], session_region=[0, 1] * 4)
    ref.set_session_level(3, js.level("ONE"))
    jsess = [js.session(i) for i in range(8)]
    js.route_batch(ref, jsess, [3, 2, 1, 0, 0, 1, 2, 3])
    ref.publish(None, version=4, replica=0)
    js.route_batch(ref, jsess)

    port = ts.engine("X_STCC", max_replicas=4, max_sessions=8)
    for r in ref.replicas:
        port.publish(None, version=r.version)
    port.set_topology(topo[1], session_region=[0, 1] * 4)
    port.set_session_level(3, ts.level("ONE"))
    port._st = convert.store_state_from_numpy(jax_to_numpy(ref._st), device=CPU)
    tsess = [ts.session(i, floor=x.read_floor) for i, x in enumerate(jsess)]

    logs = []
    for side, eng, sess in ((js, ref, jsess), (ts, port, tsess)):
        eng.fail_replica(0)
        eng.publish(None, version=5, replica=2)
        log = [side.route_batch(eng, sess), side.route_batch(eng, sess, [0] * 8)]
        eng.heal_replica(0)
        log += [attempt(eng.serve_with_retry, sess[k]) for k in (0, 3, 6)]
        log.append([x.read_floor for x in sess])
        logs.append(plain(log))
    assert logs[1] == logs[0]
    assert snapshot(port, False)["store"] == snapshot(ref, True)["store"]
