"""Port's per-session serving control plane and seeded serving schedules
== JAX's: ``adapt_sessions`` with an ``AdaptiveController`` attached,
held against the live reference engine with the reference's
``jax.random`` draws injected, and the seeded serving schedule of
``torch_port_helpers.serving_script`` (rolling publishes, outages,
rebuilding replicas, external floors, ``route_batch`` and
``serve_with_retry`` rounds) with and without a topology, everything
exact.

The reference's ``select`` runs eagerly with ``read_frac=1.0``.  Its
default controller scores with the eager oracle, which rounds every
product; the port's scorer is the jitted contract (three FMAs), which
the reference's ``use_kernel=True`` controller (the interpreted Pallas
kernel) follows.  The port is held against that controller, and the
choices are also checked against the default one on the same script."""

import pytest
import torch

from repro.policy import controller as jctl
from repro.policy import sla as jsla
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.policy import controller as tctl
from repro_torch.policy import sla as tsla
from repro_torch.serve import engine as tserve

from torch_port_helpers import CPU, plain, reference_draws, serving_script
from torch_serving_harness import NullModel, Side, run_both

torch.set_num_threads(1)

S, E = 16, 3


def _adaptive_script(use_kernel: bool, seed: int, sla: str):
    def script(s):
        eng = s.engine("X_STCC", max_replicas=6, max_sessions=S)
        topo = s.uniform_topology((0, 0, 0, 1, 1, 1), intra_rtt_ms=0.5,
                                  inter_rtt_ms=30.0)
        eng.set_topology(topo, session_region=[0, 1] * (S // 2))
        if s.is_jax:
            ctl = jctl.AdaptiveController(S, getattr(jsla, sla), eps0=0.3,
                                          use_kernel=use_kernel)
            eng.attach_controller(ctl)
        else:
            ctl = tctl.AdaptiveController(S, getattr(tsla, sla), eps0=0.3, device=CPU)
            eng.attach_controller(ctl, draws=reference_draws(0, E, (S,), ctl.n_levels))
        log = serving_script(s, eng, seed=seed, n_epochs=E, rounds=2, n_sessions=S)
        return log, {"eng": eng}

    return script


@pytest.mark.parametrize("seed,sla", [(3, "SLA_RELAXED"), (5, "SLA_STRICT")])
def test_adapt_sessions_with_reference_draws(seed, sla):
    log = run_both(_adaptive_script(True, seed, sla))
    levels = [x for x in log if isinstance(x, list) and len(x) == S and isinstance(x[0], str)]
    assert len(levels) == E
    # The controller moved sessions off the engine's default level.
    assert any(lv != "X_STCC" for row in levels for lv in row)


def test_default_controller_makes_the_same_choices():
    """The reference's default (eager-oracle) controller picks the same
    levels as the port (and so as its kernel contract) on this script."""
    script = _adaptive_script(False, 3, "SLA_RELAXED")
    assert plain(script(Side("torch"))[0]) == plain(script(Side("jax"))[0])


def test_attach_controller_validation_and_draws():
    eng = tserve.ServingEngine(NullModel(), TL.X_STCC, max_sessions=8, device=CPU)
    with pytest.raises(RuntimeError, match="no controller"):
        eng.adapt_sessions()
    with pytest.raises(ValueError, match="sessions"):
        eng.attach_controller(tctl.AdaptiveController(4, tsla.SLA_RELAXED, device=CPU))
    two = (TL.ONE, TL.CAUSAL)
    with pytest.raises(ValueError, match="not among"):
        eng.attach_controller(tctl.AdaptiveController(8, tsla.SLA_RELAXED, levels=two,
                                                      device=CPU))
    ctl = tctl.AdaptiveController(8, tsla.SLA_RELAXED, eps0=0.5, device=CPU)
    eng.attach_controller(ctl, draws=tctl.make_draws(0, (1, 8), ctl.n_levels))
    eng.publish(None, 1)
    eng.route_batch([tserve.ServeSession(i) for i in range(8)])
    eng.adapt_sessions()
    with pytest.raises(ValueError, match="draws"):
        eng.adapt_sessions()
    eng.set_session_level(0, TL.TWO)
    eng.attach_controller(ctl)
    with pytest.raises(RuntimeError, match="not among the controller"):
        eng.adapt_sessions()


def test_default_draws_are_seeded():
    """Without injected draws the engine draws from its own seeded CPU
    generator: the same seed gives the same levels."""

    def levels(seed):
        eng = tserve.ServingEngine(NullModel(), TL.X_STCC, max_sessions=8, device=CPU)
        eng.attach_controller(tctl.AdaptiveController(8, tsla.SLA_RELAXED, eps0=0.9,
                                                      device=CPU), seed=seed)
        eng.publish(None, 1)
        out = []
        for _ in range(3):
            eng.route_batch([tserve.ServeSession(i) for i in range(8)])
            out.append([lv.name for lv in eng.adapt_sessions().values()])
        return out

    assert levels(4) == levels(4)
    assert levels(4) != levels(5)


@pytest.mark.parametrize("geo", [False, True], ids=["flat", "geo"])
def test_seeded_serving_schedule_matches_reference(geo):
    def script(s):
        eng = s.engine("X_STCC", max_replicas=4, max_sessions=12)
        if geo:
            eng.set_topology(s.uniform_topology((0, 1, 1, 0), intra_rtt_ms=1.0,
                                                inter_rtt_ms=25.0))
        for sid in (1, 4, 7):
            eng.set_session_level(sid, s.level("ONE"))
        eng.set_session_level(9, s.level("CAUSAL"))
        log = serving_script(s, eng, seed=11 + geo, n_epochs=3, rounds=2, n_sessions=12,
                             retries_per_round=3)
        return log + [[eng.retries, eng.timeouts + eng.downgrades]], {"eng": eng}

    log = run_both(script)
    assert min(log[-1]) > 0       # the late requests retried, then degraded or timed out
    assert max(log[-2]) == 1 + 3  # their floors: the newest version
