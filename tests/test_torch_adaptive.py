"""Port's adaptive path == JAX's: the phased op streams, the per-level
session telemetry, both controllers' control loops (with the reference's
``jax.random`` draws injected) and ``run_protocol_adaptive`` against the
live reference: counts, choices, shares and the static frontier exact,
the per-epoch cost bit for bit, ``adaptive.cost`` within rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import stream as jstream
from repro.policy import controller as jctl
from repro.policy import sla as jsla
from repro.storage import simulator as jsim
from repro.storage import ycsb as jy
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.engine import stream as tstream
from repro_torch.kernels import ops
from repro_torch.policy import controller as tctl
from repro_torch.policy import sla as tsla
from repro_torch.storage import simulator as tsim
from repro_torch.storage import ycsb as ty

from torch_port_helpers import CPU, adaptive_mismatches, jlevel, reference_draws

torch.set_num_threads(1)

PHASED = {"rw": (jy.PHASED_RW, ty.PHASED_RW), "rwr": (jy.PHASED_RWR, ty.PHASED_RWR)}
SLAS = {"relaxed": (jsla.SLA_RELAXED, tsla.SLA_RELAXED),
        "strict": (jsla.SLA_STRICT, tsla.SLA_STRICT)}


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


# -- streams ----------------------------------------------------------------------


def test_phased_workloads_match():
    for jw, tw in PHASED.values():
        assert tw.name == jw.name and tw.read_fraction == jw.read_fraction
        assert [(w.name, f) for w, f in tw.phases] == [(w.name, f) for w, f in jw.phases]
        for n in (0, 1, 7, 1280, 1537):
            assert tw.phase_lengths(n) == jw.phase_lengths(n)
    with pytest.raises(ValueError, match="sum to"):
        ty.PhasedWorkload("bad", ((ty.WORKLOAD_A, 0.4),))


@pytest.mark.parametrize("phased", sorted(PHASED))
@pytest.mark.parametrize("n_ops,seed", [(1280, 0), (1537, 5), (3, 1)])
def test_generate_phased_and_op_stream_phased_match(phased, n_ops, seed):
    jw, tw = PHASED[phased]
    want = jy.generate_phased(jw, n_ops=n_ops, n_keys=24, seed=seed)
    got = ty.generate_phased(tw, n_ops=n_ops, n_keys=24, seed=seed)
    assert set(got) == set(want) == {"kind", "key", "phase"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    want = jstream.op_stream_phased(jw, n_ops, 16, 24, seed)
    got = tstream.op_stream_phased(tw, n_ops, 16, 24, seed)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- per-level session telemetry ---------------------------------------------------


@pytest.fixture(scope="module")
def rw_stream():
    return jstream.op_stream_phased(jy.PHASED_RW, 1280, 16, 24, 0)


@pytest.mark.parametrize("level", tsla.POLICY_LEVELS, ids=lambda lv: lv.name)
def test_level_session_telemetry_matches(rw_stream, level):
    kw = dict(n_clients=16, n_resources=24, epoch_size=64)
    want = jsim.level_session_telemetry(jlevel(level), rw_stream, **kw)
    got = tsim.level_session_telemetry(level, rw_stream, device=CPU, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["reads"] + got["writes"]).sum(axis=1).tolist() == [64] * 20


@pytest.mark.parametrize("level", [tsla.POLICY_LEVELS[0], tsla.POLICY_LEVELS[3]],
                         ids=lambda lv: lv.name)
def test_level_session_telemetry_other_cadence(level):
    stream = jstream.op_stream_phased(jy.PHASED_RWR, 768, 5, 9, 2)
    kw = dict(n_clients=5, n_resources=9, epoch_size=96, merge_every=4, delta=12)
    want = jsim.level_session_telemetry(jlevel(level), stream, **kw)
    got = tsim.level_session_telemetry(level, stream, device=CPU, **kw)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_level_session_telemetry_rejects_what_the_reference_rejects(rw_stream):
    one = tsla.POLICY_LEVELS[0]       # ONE merges every 16 ops
    for kw in (dict(epoch_size=100), dict(epoch_size=40)):
        with pytest.raises(ValueError, match="must tile"):
            jsim.level_session_telemetry(jlevel(one), rw_stream, n_clients=16,
                                         n_resources=24, **kw)
        with pytest.raises(ValueError, match="must tile"):
            tsim.level_session_telemetry(one, rw_stream, n_clients=16, n_resources=24,
                                         device=CPU, **kw)


def test_telemetry_mode_skips_the_audit(rw_stream):
    ops.reset_launch_counts()
    tsim.level_session_telemetry(tsla.POLICY_LEVELS[3], rw_stream, n_clients=16,
                                 n_resources=24, epoch_size=64, device=CPU)
    # On the CPU the plain versions run: no kernel counts, no DUOT audit.
    assert all(v == 0 for v in ops.launch_counts().values())


# -- the controllers -----------------------------------------------------------------


def _synthetic_telemetry(seed, e, s, n_levels):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 40, (e, s))
    writes = rng.integers(0, 40, (e, s))
    stale = np.minimum(rng.integers(0, 30, (e, s, n_levels)), reads[..., None])
    viol = np.minimum(rng.integers(0, 5, (e, s, n_levels)), reads[..., None])
    return {"stale": stale, "viol": viol, "reads": reads, "writes": writes}


@pytest.mark.parametrize("sla", sorted(SLAS))
@pytest.mark.parametrize("kw", [dict(eps0=0.3), dict(eps0=0.05, window=3, margin=1.0),
                                dict(eps0=0.5, eps_decay=0.5, merge_every=4, delta=12)],
                         ids=["eps", "window", "cadence"])
def test_adaptive_controller_run_scan_matches(sla, kw):
    jsl, tsl = SLAS[sla]
    e, s, n_levels = 24, 40, 6
    tel = _synthetic_telemetry(1, e, s, n_levels)
    jstate, jtrace = jctl.AdaptiveController(s, jsl, **kw).run_scan(
        jax.random.PRNGKey(5), jax.tree.map(jnp.asarray, tel))
    draws = reference_draws(5, e, (s,), n_levels)
    tstate, ttrace = tctl.AdaptiveController(s, tsl, device=CPU, **kw).run_scan(
        5, tel, draws=draws)
    assert set(ttrace) == set(jtrace)
    for k in jtrace:
        np.testing.assert_array_equal(_bits(ttrace[k].numpy()), _bits(jtrace[k]),
                                      err_msg=k)
    for f in ("stale_win", "viol_win", "reads_win"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)), err_msg=f)
    assert (tstate.ptr, tstate.epoch) == (int(jstate.ptr), int(jstate.epoch))


def test_adaptive_controller_two_levels_and_scores_match():
    levels = (tsla.POLICY_LEVELS[0], tsla.POLICY_LEVELS[3])
    tel = _synthetic_telemetry(2, 12, 9, 2)
    jc = jctl.AdaptiveController(9, jsla.SLA_RELAXED,
                                 levels=tuple(jlevel(lv) for lv in levels))
    tc = tctl.AdaptiveController(9, tsla.SLA_RELAXED, levels=levels, device=CPU)
    _, jtrace = jc.run_scan(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, tel))
    _, ttrace = tc.run_scan(0, tel, draws=reference_draws(0, 12, (9,), 2))
    for k in jtrace:
        np.testing.assert_array_equal(_bits(ttrace[k].numpy()), _bits(jtrace[k]))
    # One observe step, then the scores the next selection reads.
    obs = dict(stale=np.arange(9.0), viol=np.ones(9), reads=np.full(9, 20.0))
    li = np.arange(9) % 2
    js = jc.observe(jc.init(), level_idx=li, **obs)
    ts = tc.observe(tc.init(), level_idx=torch.from_numpy(li),
                    **{k: torch.from_numpy(v) for k, v in obs.items()})
    # The read fraction is traced, as in the reference's scan (a Python
    # constant would let XLA fold it into the fused cost differently).
    rf = np.linspace(0.0, 1.0, 9).astype(np.float32)
    want = jax.jit(lambda st, r: jc.scores(st, read_frac=r))(js, rf)
    got = tc.scores(ts, read_frac=torch.from_numpy(rf))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_controller_default_draws_are_seeded():
    tel = _synthetic_telemetry(3, 8, 10, 6)
    tc = tctl.AdaptiveController(10, tsla.SLA_RELAXED, eps0=0.5, device=CPU)
    _, a = tc.run_scan(4, tel)
    _, b = tc.run_scan(4, tel, draws=tctl.make_draws(4, (8, 10), 6))
    for k in a:
        assert torch.equal(a[k], b[k])
    with pytest.raises(ValueError, match="draws"):
        tc.run_scan(4, tel, draws=tctl.make_draws(4, (7, 10), 6))


def test_controller_rejects_counts_too_large_for_f32_sums():
    tel = _synthetic_telemetry(3, 2, 4, 6)
    tel["reads"] = np.full((2, 4), 1 << 22)
    with pytest.raises(ValueError, match="exact f32"):
        tctl.AdaptiveController(4, tsla.SLA_RELAXED, device=CPU).run_scan(0, tel)


@pytest.mark.parametrize("kw", [dict(eps0=0.3), dict(eps0=0.05, window=3),
                                dict(cadences=(0, 2), gb_price=0.5, stale_penalty=0.2)],
                         ids=["eps", "window", "arms"])
def test_cadence_controller_run_scan_matches(kw):
    n_arms = len(kw.get("cadences", (0, 1, 2, 4, 8)))
    e = 40
    rng = np.random.default_rng(6)
    tel = {"gb": (rng.random((e, n_arms)) * 3e-3).astype(np.float32),
           "stale": rng.integers(0, 50, (e, n_arms)),
           "reads": rng.integers(50, 100, e)}
    jstate, jtrace = jctl.CadenceController(**kw).run_scan(
        jax.random.PRNGKey(3), jax.tree.map(jnp.asarray, tel))
    tstate, ttrace = tctl.CadenceController(device=CPU, **kw).run_scan(
        3, tel, draws=reference_draws(3, e, (), n_arms))
    for k in jtrace:
        np.testing.assert_array_equal(_bits(ttrace[k].numpy()), _bits(jtrace[k]),
                                      err_msg=k)
    for f in ("gb_win", "stale_win", "reads_win", "played_win"):
        np.testing.assert_array_equal(_bits(getattr(tstate, f).numpy()),
                                      _bits(getattr(jstate, f)), err_msg=f)
    with pytest.raises(ValueError, match="cadence"):
        tctl.CadenceController((1, -2), device=CPU)


# -- run_protocol_adaptive ---------------------------------------------------------------

CASES = {
    # The golden case's arguments (tests/data/golden_wrappers.json), held
    # against the live reference rather than the file.
    "golden/PHASED_RW": ("rw", "relaxed", dict(n_ops=1280, epoch_size=64),
                         ("ONE", "X_STCC")),
    "PHASED_RWR/strict/six": ("rwr", "strict", dict(n_ops=1536, epoch_size=64), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_protocol_adaptive_matches_live_reference(case):
    phased, sla, kw, names = CASES[case]
    jw, tw = PHASED[phased]
    jsl, tsl = SLAS[sla]
    tl = None if names is None else tuple(TL[n] for n in names)
    jl = None if tl is None else tuple(jlevel(lv) for lv in tl)
    want = jsim.run_protocol_adaptive(jw, jsl, levels=jl, **kw)
    n_levels = 6 if tl is None else len(tl)
    draws = reference_draws(0, kw["n_ops"] // kw["epoch_size"], (16,), n_levels)
    got = tsim.run_protocol_adaptive(tw, tsl, levels=tl, draws=draws, device=CPU, **kw)
    assert adaptive_mismatches(want, got) == []
    assert got["choice"].dtype == np.asarray(want["choice"]).dtype
    # The same run from one precomputed telemetry pass, and with the
    # plain scorer named.
    tel = tsim.adaptive_telemetry(tw, levels=tl, device=CPU, **kw)
    again = tsim.run_protocol_adaptive(tw, tsl, levels=tl, draws=draws, telemetry=tel,
                                       impl="torch", device=CPU, **kw)
    assert adaptive_mismatches(got, again) == [] and got["adaptive"] == again["adaptive"]


def test_run_protocol_adaptive_default_epochs_and_draws():
    kw = dict(n_ops=700, n_clients=6, n_resources=12)
    want = jsim.run_protocol_adaptive(jy.PHASED_RW, jsla.SLA_RELAXED, **kw)
    tel = tsim.adaptive_telemetry(ty.PHASED_RW, device=CPU, **kw)
    # The default epoch rule and the cut to whole epochs.
    assert (tel["n_ops"], tel["epoch_size"]) == (want["n_ops"], want["epoch_size"])
    e = tel["n_ops"] // tel["epoch_size"]
    got = tsim.run_protocol_adaptive(
        ty.PHASED_RW, tsla.SLA_RELAXED, telemetry=tel, device=CPU,
        draws=reference_draws(0, e, (6,), 6), **kw)
    assert adaptive_mismatches(want, got) == []
    # Without draws: the port's own seeded stream, deterministic.
    a = tsim.run_protocol_adaptive(ty.PHASED_RW, tsla.SLA_RELAXED, telemetry=tel,
                                   device=CPU, **kw)
    b = tsim.run_protocol_adaptive(ty.PHASED_RW, tsla.SLA_RELAXED, telemetry=tel,
                                   device=CPU, **kw)
    assert adaptive_mismatches(a, b) == [] and a["adaptive"] == b["adaptive"]
    assert a["sla"] == "relaxed" and a["choice"].shape == (e, 6)
