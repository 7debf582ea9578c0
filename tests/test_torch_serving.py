"""Port's serving engine == JAX's: the reference's dummy-model serving
tests (routing, reroutes, external floors, failover, replica health,
retry/backoff/degraded admission, rebuilding replicas, scalar vs batch
telemetry, decode accounting, generation) run as one script through the
live reference ``ServingEngine(..., jit=False)`` and the port's engine
on the CPU: every returned replica and version, every counter
(``retry_wait_ms`` included), the per-session telemetry and the whole
store state exact."""

import numpy as np
import pytest
import torch

from repro.runtime import NodeHealth
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.serve import engine as tserve

from torch_port_helpers import attempt
from torch_serving_harness import NullModel, run_both

torch.set_num_threads(1)


# -- routing on the store (tests/test_replicated_store.py) -------------------------


@pytest.mark.parametrize("use_kernel", [False, True], ids=["oracle", "pallas"])
def test_route_batch_reroutes_inadmissible_sessions(use_kernel):
    def script(s):
        eng = s.engine("X_STCC")
        eng.publish(None, version=1)
        eng.publish(None, version=3)
        ss = [s.session(i) for i in range(4)]
        log = [s.route_batch(eng, ss, [1, 1, 1, 1]), [x.read_floor for x in ss],
               s.route_batch(eng, ss, [0, 0, 0, 0]), eng.reroutes]
        return log, {"eng": eng}

    log = run_both(script, use_kernel=use_kernel)
    assert log[1] == [3, 3, 3, 3]
    assert log[2] == [[1, 1, 1, 1], [3, 3, 3, 3]] and log[3] == 4


def test_route_batch_honours_external_floor():
    def script(s):
        eng = s.engine("X_STCC")
        eng.publish(None, version=1)
        eng.publish(None, version=3)
        log = [s.route_batch(eng, [s.session(0, floor=2)], [0]),
               attempt(s.route_batch, eng, [s.session(1, floor=99)], [0])]
        return log, {"eng": eng}

    log = run_both(script)
    assert log[0] == [[1], [3]] and log[1][0] == "raise"


def test_session_id_beyond_capacity_raises():
    def script(s):
        eng = s.engine("X_STCC")
        eng.publish(None, version=1)
        return [attempt(eng.route, s.session(eng.max_sessions)),
                attempt(s.route_batch, eng, [s.session(eng.max_sessions)])], {"eng": eng}

    log = run_both(script)
    assert all(x[0] == "raise" for x in log)


def test_weak_level_goes_stale_batched():
    def script(s):
        eng = s.engine("ONE")
        eng.publish(None, version=1)
        eng.publish(None, version=3)
        ss = [s.session(i) for i in range(4)]
        log = [s.route_batch(eng, ss, [1, 1, 1, 1]), s.route_batch(eng, ss, [0, 0, 0, 0]),
               eng.staleness_rate(), eng.reroutes]
        return log, {"eng": eng}

    log = run_both(script)
    assert log[2] > 0 and log[3] == 0


# -- failover and health (tests/test_faults.py) --------------------------------------


def test_route_fails_over_off_down_replica():
    def script(s):
        eng = s.engine()
        eng.publish(None, version=2)
        eng.publish(None, version=1)
        eng.fail_replica(0)
        x = s.session(0)
        log = [eng.route(x, preferred=0), eng.failovers, eng.reroutes]
        eng.heal_replica(0)
        log += [eng.route(x, preferred=0), eng.failovers]
        return log, {"eng": eng}

    assert run_both(script) == [1, 1, 1, 0, 1]


def test_route_no_live_replica_raises():
    def script(s):
        eng = s.engine()
        eng.publish(None, version=1)
        eng.fail_replica(0)
        return [attempt(eng.route, s.session(0)),
                attempt(s.route_batch, eng, [s.session(0)])], {"eng": eng}

    log = run_both(script)
    assert all(x[0] == "raise" and "no live replica" in x[2] for x in log)


def test_route_failover_respects_session_floor():
    def script(s):
        eng = s.engine()
        eng.publish(None, version=1)
        eng.publish(None, version=3)
        x = s.session(0)
        log = [s.route_batch(eng, [x], [1])]
        eng.fail_replica(1)
        log.append(attempt(eng.route, x, preferred=1))
        return log, {"eng": eng}

    log = run_both(script)
    assert log[1][0] == "raise" and "no admissible replica" in log[1][2]


@pytest.mark.parametrize("level", ["X_STCC", "ONE"])
def test_route_batch_fails_over_down_replicas_all_levels(level):
    def script(s):
        eng = s.engine(level)
        eng.publish(None, version=2)
        eng.publish(None, version=2)
        eng.fail_replica(0)
        return [s.route_batch(eng, [s.session(i) for i in range(4)], [0, 1, 0, 1]),
                eng.failovers], {"eng": eng}

    log = run_both(script)
    assert log[0][0] == [1, 1, 1, 1] and log[1] == 2


def test_set_replica_health_from_node_health():
    def script(s):
        eng = s.engine()
        eng.publish(None, version=1)
        eng.publish(None, version=1)
        h = NodeHealth(2, heartbeat_timeout_s=60.0)
        h.fail(1)
        eng.set_replica_health(h)
        log = [eng.route(s.session(1), preferred=1)]
        h.recover(1)
        eng.set_replica_health(h)
        log.append(eng.route(s.session(1), preferred=1))
        return log, {"eng": eng}

    assert run_both(script) == [0, 1]
    eng = tserve.ServingEngine(NullModel(), device="cpu", max_replicas=2)
    with pytest.raises(ValueError, match="health covers"):
        eng.set_replica_health([True] * 3)


# -- retries, backoff, rebuilding replicas (tests/test_recovery.py) -------------------


def _retry_engine(s):
    eng = s.engine("X_STCC", max_replicas=3, max_sessions=4)
    for v in (1, 1, 1):
        eng.publish(None, v)
    return eng


def _raise_floor(eng, x):
    eng.publish(None, 5, replica=0)
    eng.serve_with_retry(x, preferred=0)
    eng.mark_rebuilding(0)


def test_retry_policy_validation():
    for kw in (dict(max_retries=-1), dict(jitter=1.5), dict(backoff_mult=0.5),
               dict(base_backoff_ms=0.0)):
        with pytest.raises(ValueError):
            tserve.RetryPolicy(**kw)
    rng = [np.random.default_rng(3), np.random.default_rng(3)]
    from repro.serve import RetryPolicy as JPolicy

    pol = dict(base_backoff_ms=2.5, backoff_mult=3.0, jitter=0.4)
    assert ([tserve.RetryPolicy(**pol).backoff_ms(a, rng[0]) for a in range(5)]
            == [JPolicy(**pol).backoff_ms(a, rng[1]) for a in range(5)])


def test_retry_then_degraded_admission():
    def script(s):
        eng = _retry_engine(s)
        x = s.session(0)
        log = [eng.serve_with_retry(x)]
        _raise_floor(eng, x)
        log.append(eng.serve_with_retry(x, policy=s.policy(max_retries=2, degrade=True,
                                                            seed=7)))
        log.append(x.read_floor)
        return log, {"eng": eng}

    log = run_both(script)
    assert log[1] in (1, 2)


def test_retry_exhaustion_raises_serve_timeout():
    def script(s):
        eng = _retry_engine(s)
        x = s.session(0)
        eng.serve_with_retry(x)
        _raise_floor(eng, x)
        log = [attempt(eng.serve_with_retry, x,
                       policy=s.policy(max_retries=1, degrade=False)),
               attempt(eng.serve_with_retry, x,
                       policy=s.policy(max_retries=6, timeout_ms=30.0, degrade=False,
                                       seed=11))]
        eng.finish_rebuilding(0)
        log.append(eng.serve_with_retry(x))
        return log, {"eng": eng}

    log = run_both(script)
    assert log[0][1] == log[1][1] == "ServeTimeout" and log[2] == 0


def test_rebuilding_replica_fails_over_like_down():
    def script(s):
        eng = _retry_engine(s)
        eng.mark_rebuilding(0)
        return [eng.serve_with_retry(s.session(0), preferred=0), eng.failovers], {"eng": eng}

    log = run_both(script)
    assert log[0] != 0 and log[1] == 1


def test_backoff_deterministic_per_seed():
    def script(s):
        log, units = [], {}
        for k in range(2):
            eng = _retry_engine(s)
            x = s.session(0)
            eng.serve_with_retry(x)
            _raise_floor(eng, x)
            eng.serve_with_retry(x, policy=s.policy(max_retries=2, degrade=True, seed=3))
            log.append(eng.retry_wait_ms)
            units[f"eng{k}"] = eng
        return log, units

    log = run_both(script)
    assert log[0] == log[1] > 0


# -- telemetry accounting and the model path (tests/test_serving.py) ---------------


def _publish_overwritten(eng):
    eng.publish(None, version=2)
    eng.publish(None, version=3)
    eng.publish(None, version=1, replica=1)


def test_scalar_and_batch_routing_agree_on_telemetry():
    serves = [(0, 0), (1, 0), (2, 1), (1, 1), (0, 0)]

    def script(s):
        scalar, batch = s.engine("ONE"), s.engine("ONE")
        _publish_overwritten(scalar)
        _publish_overwritten(batch)
        log = []
        for sid, pref in serves:
            x = s.session(sid)
            r = scalar.route(x, preferred=pref)
            scalar._observe(x, r)
            log.append((r, x.read_floor, s.route_batch(batch, [s.session(sid)], [pref])))
        return log, {"scalar": scalar, "batch": batch}

    run_both(script)


def test_decode_does_not_inflate_staleness_denominator():
    def script(s):
        eng = s.engine("X_STCC")
        eng.publish(None, version=1)
        x = s.session(0)
        eng._observe(x, eng.route(x))
        log = [eng.decode(x, None, None, replica=0) for _ in range(5)]
        return log + [eng.total_serves, eng.staleness_rate()], {"eng": eng}

    log = run_both(script)
    assert log[-2] == 1


class TinyLM:
    """A deterministic toy language model: embedding ``E`` (V, D) and
    output ``W`` (D, V) with small integer entries, so both frameworks
    compute the same logits exactly.  The cache is the last hidden row."""

    def __init__(self, xp):
        self.xp = xp

    def prefill(self, params, batch):
        h = params["E"][batch["tokens"]]              # (B, S, D)
        return h @ params["W"], h[:, -1]

    def decode_step(self, params, cache, tokens):
        h = params["E"][tokens[:, 0]] + cache         # (B, D)
        return (h @ params["W"])[:, None], h


def _lm_params(seed, xp):
    rng = np.random.default_rng(seed)
    e = rng.integers(-3, 4, (11, 5)).astype(np.float32)
    w = rng.integers(-3, 4, (5, 11)).astype(np.float32)
    if xp == "jax":
        import jax.numpy as jnp

        return {"E": jnp.asarray(e), "W": jnp.asarray(w)}
    return {"E": torch.as_tensor(e), "W": torch.as_tensor(w)}


def _lm_batch(xp):
    toks = np.asarray([[1, 4, 7, 2], [3, 3, 9, 0]], np.int32)
    if xp == "jax":
        import jax.numpy as jnp

        return {"tokens": jnp.asarray(toks)}
    return {"tokens": torch.as_tensor(toks).long()}


def test_generate_with_a_tiny_model():
    def script(s):
        xp = "jax" if s.is_jax else "torch"
        eng = s.engine("X_STCC", model=TinyLM(xp))
        eng.publish(_lm_params(1, xp), version=1)
        eng.publish(_lm_params(2, xp), version=2)
        x = s.session(0)
        toks, r = eng.generate(x, _lm_batch(xp), n_tokens=6, preferred=1)
        toks2, r2 = eng.generate(x, _lm_batch(xp), n_tokens=3, preferred=0)
        return [np.asarray(toks).tolist(), r, np.asarray(toks2).tolist(), r2,
                x.read_floor], {"eng": eng}

    log = run_both(script)
    assert np.asarray(log[0]).shape == (2, 6)
    assert log[1] == 1 and log[3] == 1     # the floor reroutes off replica 0


def test_prefill_reroutes_and_weak_serving_goes_stale():
    def script(s):
        xp = "jax" if s.is_jax else "torch"
        log, units = [], {}
        for level in ("X_STCC", "ONE"):
            eng = s.engine(level, model=TinyLM(xp))
            eng.publish(_lm_params(1, xp), version=1)
            eng.publish(_lm_params(2, xp), version=2)
            x = s.session(0)
            _, _, r1 = eng.prefill(x, _lm_batch(xp), preferred=1)
            logits, _, r0 = eng.prefill(x, _lm_batch(xp), preferred=0)
            log += [r1, r0, x.read_floor, eng.reroutes, eng.staleness_rate(),
                    np.asarray(logits).tolist()]
            units[level] = eng
        no_adm = s.engine("X_STCC")
        no_adm.publish(None, version=1)
        log.append(attempt(no_adm.route, s.session(0, floor=99)))
        return log, units

    log = run_both(script)
    assert log[:4] == [1, 1, 2, 1]             # X_STCC reroutes to the fresh replica
    assert log[6:8] == [1, 0] and log[10] > 0  # ONE serves stale v1
    assert log[-1][0] == "raise"


def test_engine_defaults():
    e = tserve.ServingEngine(NullModel(), TL.ONE, device="cpu")
    assert e.device.type == "cpu" and e._store.device.type == "cpu"
    assert e.level is TL.ONE and e.max_sessions == 64 and e.max_replicas == 8
    with pytest.raises(RuntimeError, match="no replicas"):
        e.route_batch([tserve.ServeSession(0)])


def test_negative_session_id_is_refused():
    """A negative id would alias another session's floor (the plain
    gathers wrap it, the kernel drops it): every entry refuses it."""
    e = tserve.ServingEngine(NullModel(), TL.X_STCC, device="cpu")
    e.publish(None, version=1)
    bad = tserve.ServeSession(-1)
    for call in (lambda: e.route(bad), lambda: e.route_batch([bad]),
                 lambda: e.serve_with_retry(bad)):
        with pytest.raises(ValueError, match="< 0"):
            call()
    assert (e.total_serves, e.retries, e.timeouts) == (0, 0, 0)


def test_serve_with_retry_retries_routing_errors_only():
    """A failed kernel launch under ``serve_with_retry`` propagates as
    itself: it is not counted as a retry, a wait or a timeout."""
    from repro_torch.kernels import build

    e = tserve.ServingEngine(NullModel(), TL.X_STCC, device="cpu")
    e.publish(None, version=1)

    def failing_read(*args, **kwargs):
        build.check(700, "op_ingest")

    e._store.read_batch = failing_read
    with pytest.raises(RuntimeError, match="CUDA launch failed") as info:
        e.serve_with_retry(tserve.ServeSession(0))
    assert not isinstance(info.value, tserve.ServeTimeout)
    assert (e.retries, e.retry_wait_ms, e.timeouts, e.downgrades) == (0, 0.0, 0, 0)
    e.fail_replica(0)
    with pytest.raises(tserve.ServeTimeout) as info:
        e.serve_with_retry(tserve.ServeSession(0), policy=tserve.RetryPolicy(degrade=False))
    assert isinstance(info.value.__cause__, tserve.RoutingError)
    assert e.retries > 0 and e.timeouts == 1
