"""Port's chaos harness == JAX's: the seeded nemesis schedules and gossip
draws, ``check_invariants`` on the same result dicts, and ``run_chaos``
verdicts (metrics, recovery block, crashes, breaches, convergence) for
the same seeds; the tracer receives the same event sequence."""

import numpy as np
import pytest
import torch

from repro import chaos as jchaos
from repro.core.consistency import ConsistencyLevel as JL
from repro.obs import trace as jtrace
from repro.obs.metrics import ObsConfig as JObs
from repro_torch import chaos
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.obs import trace
from repro_torch.obs.metrics import ObsConfig

from torch_port_helpers import CPU

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", range(8))
def test_nemesis_draws_match_reference(seed):
    kw = dict(seed=seed, p_crash=0.15, p_outage=0.15, p_partition=0.2)
    want = jchaos.random_schedule(12, 3, **kw)
    got = chaos.random_schedule(12, 3, **kw)
    for f in ("up", "link", "crash"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(got.rejoins(), want.rejoins())
    assert got.up[-3:].all() and not got.crashes()[-3:].any()
    jg, tg = jchaos.random_gossip(seed), chaos.random_gossip(seed)
    assert (jg is None) == (tg is None)
    if tg is not None:
        assert (tg.cadence, tg.hint_cap) == (jg.cadence, jg.hint_cap)


def test_nemesis_rejects_a_schedule_without_active_epochs():
    for mod in (jchaos, chaos):
        with pytest.raises(ValueError, match="quiet_tail"):
            mod.random_schedule(3, 3, seed=0)


_REC = {"crashes": 1, "rejoins": 1, "recovery_gb": 1e-6}
INVARIANT_CASES = {
    "clean_crash": (dict(violation_rate=0.0, staleness_rate=0.2, recovery=_REC,
                         cost={"total": 1.0}), "X_STCC", True),
    "violations": (dict(violation_rate=0.01, staleness_rate=0.2), "TCC", False),
    "unguarded": (dict(violation_rate=0.3, staleness_rate=0.5), "ONE", False),
    "no_block": (dict(violation_rate=0.0, staleness_rate=1.5), "X_STCC", True),
    "silent_crash": (dict(recovery={"crashes": 0, "rejoins": 0, "recovery_gb": 0.0}),
                     "X_STCC", True),
    "traffic_without_crash": (dict(recovery=_REC, cost={"network": -1.0, "x": "y"}),
                              "CAUSAL", False),
}


@pytest.mark.parametrize("case", list(INVARIANT_CASES))
def test_check_invariants_matches_reference(case):
    result, level, crashed = INVARIANT_CASES[case]
    want = jchaos.check_invariants(result, JL[level], crashed=crashed)
    got = chaos.check_invariants(result, TL[level], crashed=crashed)
    assert got == want
    assert bool(got) == (case not in ("clean_crash", "unguarded"))


VERDICT_KEYS = ("seed", "level", "crashes", "outage_epochs", "partitions", "gossip_cadence",
                "metrics", "recovery", "breaches", "converged", "diverged_fields", "ok")


@pytest.mark.parametrize("seed", range(2))
def test_run_chaos_verdicts_match_reference(seed):
    want = jchaos.run_chaos(seed)
    got = chaos.run_chaos(seed, device=CPU)
    assert {k: got[k] for k in VERDICT_KEYS} == {k: want[k] for k in VERDICT_KEYS}
    assert got == want
    assert got["ok"] and got["crashes"] >= 1


def test_run_chaos_trace_matches_reference():
    """With obs and a tracer, both packages record the same nemesis
    actions, spans and verdicts, in the same order."""
    jt, tt = jtrace.Tracer(), trace.Tracer()
    want = jchaos.run_chaos(3, obs=JObs(), tracer=jt)
    got = chaos.run_chaos(3, obs=ObsConfig(), tracer=tt, device=CPU)
    assert got == want

    def shape(events):
        return [(e["name"], e["ph"], e["args"]) for e in events]

    assert shape(tt.events) == shape(jt.events)
    names = [e["name"] for e in tt.events]
    assert names[0] == "chaos.schedule" and names[-1] == "verdict.convergence"
    assert {"chaos.run", "chaos.twin", "chaos.quiesce"} <= set(names)


def test_run_chaos_suite_aggregates():
    out = chaos.run_chaos_suite(seeds=[2], device=CPU, gossip=None, n_ops=512)
    assert out["n_seeds"] == 1 and out["ok"] == out["runs"][0]["ok"]
    assert out["n_crashes"] == out["runs"][0]["crashes"]
    assert out["runs"][0]["gossip_cadence"] == 0
