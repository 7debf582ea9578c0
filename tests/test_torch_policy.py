"""Port's policy scoring == JAX's: the level table, the session packing,
the plain ``policy_score`` bit for bit against the jitted reference and
its interpreted Pallas kernel (the eager oracle is not the contract),
``epoch_cost`` against the jitted reference, the exploration schedule,
the bandit windows and the pricing presets."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import cost_model as jcost
from repro.core.consistency import ConsistencyLevel as JL
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.obs import metrics as jmetrics
from repro.policy import controller as jctl
from repro.policy import sla as jsla
from repro_torch.core import cost_model as tcost
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.kernels import ops
from repro_torch.kernels import policy_score as tps
from repro_torch.obs import metrics as tmetrics
from repro_torch.policy import controller as tctl
from repro_torch.policy import sla as tsla

from torch_port_helpers import CPU, policy_inputs

torch.set_num_threads(1)

SLAS = {"relaxed": (jsla.SLA_RELAXED, tsla.SLA_RELAXED),
        "strict": (jsla.SLA_STRICT, tsla.SLA_STRICT)}
LEVEL_SETS = {
    "policy": jsla.POLICY_LEVELS,
    "two": (JL.ONE, JL.X_STCC),
    "with_two": (JL.TWO, JL.QUORUM, JL.CAUSAL),
}
_jit_score = jax.jit(jref.policy_score_ref)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _tlevels(levels):
    return tuple(TL[lv.name] for lv in levels)


def _assert_scores_equal(want, got):
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# -- tables and packing ---------------------------------------------------------


@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
@pytest.mark.parametrize("pricing", ["paper", "gcp"])
@pytest.mark.parametrize("kw", [{}, dict(merge_every=4, delta=12),
                                dict(ms_per_op=0.5)], ids=["default", "cadence", "ms"])
def test_level_table_bit_equal(levels, pricing, kw):
    lv = LEVEL_SETS[levels]
    want = jsla.level_table(lv, pricing=jcost.PRICING_PRESETS[pricing], **kw)
    got = tsla.level_table(_tlevels(lv), pricing=tcost.PRICING_PRESETS[pricing],
                           device=CPU, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_pricing_presets_match():
    assert set(tcost.PRICING_PRESETS) == {"paper", "gcp"}
    for name, t in tcost.PRICING_PRESETS.items():
        assert dataclasses.asdict(t) == dataclasses.asdict(jcost.PRICING_PRESETS[name])
    assert dataclasses.asdict(tcost.GCP_PRICING) == dataclasses.asdict(jcost.GCP_PRICING)
    paper = tsla.level_table(device=CPU)
    gcp = tsla.level_table(pricing=tcost.GCP_PRICING, device=CPU)
    assert not torch.equal(paper, gcp)


@pytest.mark.parametrize("sla", sorted(SLAS))
@pytest.mark.parametrize("per_session", [False, True])
def test_session_params_bit_equal(sla, per_session):
    jsl, tsl = SLAS[sla]
    rng = np.random.default_rng(3)
    n = 37
    rf = rng.random(n).astype(np.float32) if per_session else 0.3
    valid = (rng.random(n) < 0.7) if per_session else None
    want = jsla.session_params(jsl, n, read_frac=rf, valid=valid)
    got = tsla.session_params(
        tsl, n, read_frac=torch.from_numpy(rf) if per_session else rf,
        valid=None if valid is None else torch.from_numpy(valid), device=CPU)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_layouts_and_constants_match():
    names = ("SP_READ_FRAC", "SP_MAX_STALE", "SP_MAX_VIOL", "SP_MAX_LAT", "SP_MAX_AGE",
             "SP_VALID", "SP_COLS", "LVL_READ_COST", "LVL_WRITE_COST",
             "LVL_REPAIR_COST", "LVL_READ_LAT", "LVL_STALE_AGE", "LVL_COLS",
             "INFEASIBLE_PENALTY", "STRUCTURAL_WEIGHT")
    for n in names:
        assert getattr(tsla, n) == getattr(jsla, n), n
    assert [lv.name for lv in tsla.POLICY_LEVELS] == [lv.name for lv in jsla.POLICY_LEVELS]
    for a, b in ((tsla.SLA_STRICT, jsla.SLA_STRICT), (tsla.SLA_RELAXED, jsla.SLA_RELAXED)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


# -- the scorer -------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 16, 64, 127, 129, 1000])
@pytest.mark.parametrize("levels", ["policy", "two"])
def test_plain_policy_score_bit_equal_to_jit_and_pallas(s, levels):
    args = policy_inputs(np.random.default_rng(s), s, CPU,
                         levels=_tlevels(LEVEL_SETS[levels]))
    np_args = [a.numpy() for a in args]
    got = tps.policy_score_ref(*args)
    _assert_scores_equal(_jit_score(*np_args), got)
    _assert_scores_equal(jops.policy_score(*np_args, interpret=True), got)
    _assert_scores_equal(jops.policy_score(*np_args, block_s=8, interpret=True), got)
    # The port's dispatch and the controller-facing entry agree.
    for via in (ops.policy_score(*args), tsla.score_levels(*args)):
        _assert_scores_equal((got[0].numpy(), got[1].numpy()), via)


def test_eager_oracle_is_not_the_contract():
    """The eager reference rounds each product; the jitted one fuses three
    multiply-adds.  Some cells differ, and the port follows the jit."""
    args = policy_inputs(np.random.default_rng(0), 4096, CPU)
    np_args = [a.numpy() for a in args]
    eager = jref.policy_score_ref(*np_args)
    jitted = _jit_score(*np_args)
    differ = _bits(eager[0]) != _bits(jitted[0])
    assert differ.sum() > 0
    got = tps.policy_score_ref(*args)
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(jitted[0]))
    assert (_bits(got[0].numpy())[differ] != _bits(eager[0])[differ]).all()


def test_near_ties_stay_bit_equal():
    """Levels with equal table columns, read fractions next to 0.5 and
    rates a few ulps around the bounds."""
    rng = np.random.default_rng(9)
    s = 512
    sess, table, stale, viol, count = (a.numpy().copy() for a in policy_inputs(
        rng, s, CPU))
    table[:, 3] = table[:, 2]
    sess[:, tsla.SP_READ_FRAC] = np.nextafter(np.float32(0.5), rng.choice(
        [np.float32(0), np.float32(1)], s)).astype(np.float32)
    bound = sess[:, tsla.SP_MAX_STALE][:, None]
    steps = rng.integers(-3, 4, (s, table.shape[1]))
    near = bound + steps.astype(np.float32) * np.spacing(bound)
    stale = np.where(rng.random(stale.shape) < 0.5, near, stale).astype(np.float32)
    args = (sess, table, stale, viol, count)
    got = tps.policy_score_ref(*(torch.from_numpy(a) for a in args))
    _assert_scores_equal(_jit_score(*args), got)


def _rate():
    return st.floats(0.0, 1.0, width=32, allow_subnormal=False)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(
    s=st.integers(1, 40),
    seed=st.integers(0, 2**32 - 1),
    rf=st.sampled_from([0.0, 1.0, 0.5, None]),
    max_lat=st.sampled_from([10.0, 1.0, math.inf]),
    max_age=st.sampled_from([50.0, 0.0, math.inf]),
    max_stale=_rate(),
    max_viol=st.sampled_from([0.0, 1e-7, 0.02, 0.06, 1.0]),
)
def test_plain_policy_score_property(s, seed, rf, max_lat, max_age, max_stale,
                                     max_viol):
    rng = np.random.default_rng(seed)
    table = np.asarray(jsla.level_table())
    n_levels = table.shape[1]
    sess = np.zeros((s, tsla.SP_COLS), np.float32)
    sess[:, tsla.SP_READ_FRAC] = rng.random(s) if rf is None else rf
    sess[:, tsla.SP_MAX_STALE] = max_stale
    sess[:, tsla.SP_MAX_VIOL] = max_viol
    sess[:, tsla.SP_MAX_LAT] = max_lat
    sess[:, tsla.SP_MAX_AGE] = max_age
    sess[:, tsla.SP_VALID] = rng.random(s) < 0.8
    count = rng.integers(0, 3, (s, n_levels)).astype(np.float32)
    stale = rng.random((s, n_levels)).astype(np.float32)
    viol = (rng.random((s, n_levels)) * 0.1).astype(np.float32)
    args = (sess, table, stale, viol, count)
    got = tps.policy_score_ref(*(torch.from_numpy(np.array(a)) for a in args))
    _assert_scores_equal(_jit_score(*args), got)


def test_invalid_rows_and_unobserved_cells():
    args = [a.clone() for a in policy_inputs(np.random.default_rng(1), 50, CPU)]
    sess, table, stale, viol, count = args
    sess[::2, tsla.SP_VALID] = 0.0
    util, feas = tps.policy_score_ref(*args)
    assert (util[::2] == 0).all() and (feas[::2] == 0).all()
    # Unobserved cells score their analytic cost, whatever the rates say.
    count.zero_()
    stale.fill_(1.0)
    u0, _ = tps.policy_score_ref(sess, table, stale, viol, count)
    u1, _ = tps.policy_score_ref(sess, table, torch.zeros_like(stale), viol, count)
    assert torch.equal(u0, u1)


def test_xla_max_matches_jnp_maximum():
    a = np.array([-0.0, 0.0, -0.0, 0.0, np.nan, 1.0, np.nan, 2.0, -3.0], np.float32)
    b = np.array([0.0, -0.0, -0.0, 0.0, 1.0, np.nan, np.nan, 1.0, 4.0], np.float32)
    want = np.asarray(jax.jit(jnp.maximum)(a, b))
    got = tps.xla_max(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_policy_score_dispatch_and_checks():
    args = policy_inputs(np.random.default_rng(2), 20, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        ops.policy_score(*args, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tps.policy_score_cuda(*args)
    bad = list(args)
    bad[1] = bad[1][:, :-1]
    with pytest.raises(ValueError, match="table"):
        tps.policy_score_ref(*bad)
    assert ops.launch_counts()["policy_score"] == tps.launches


# -- epoch cost, exploration schedule, windows --------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epoch_cost_bit_equal_to_jit(seed):
    rng = np.random.default_rng(seed)
    s = 5000
    table = np.array(jsla.level_table())
    li = rng.integers(0, table.shape[1], s).astype(np.int32)
    reads = rng.integers(0, 4096, s).astype(np.float32)
    writes = rng.integers(0, 4096, s).astype(np.float32)
    stale = np.floor(rng.random(s) * reads).astype(np.float32)
    want = jax.jit(lambda *a: jsla.epoch_cost(a[0], a[1], reads=a[2], writes=a[3],
                                              stale=a[4]))(table, li, reads, writes, stale)
    got = tsla.epoch_cost(torch.from_numpy(table), torch.from_numpy(li),
                          reads=torch.from_numpy(reads), writes=torch.from_numpy(writes),
                          stale=torch.from_numpy(stale))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("eps0,decay", [(0.05, 0.9), (0.02, 0.9), (0.1, 0.9), (0.3, 0.75)])
def test_epsilon_bit_equal_for_64_epochs(eps0, decay):
    jc = jctl.AdaptiveController(4, jsla.SLA_RELAXED, eps0=eps0, eps_decay=decay)
    tc = tctl.AdaptiveController(4, tsla.SLA_RELAXED, eps0=eps0, eps_decay=decay,
                                 device=CPU)
    jcad = jctl.CadenceController(eps0=eps0, eps_decay=decay)
    tcad = tctl.CadenceController(eps0=eps0, eps_decay=decay, device=CPU)
    jeps = jax.jit(lambda e: jc.epsilon(
        jctl.ControllerState(None, None, None, jnp.int32(0), e)))
    jcad_eps = jax.jit(lambda e: jcad.epsilon(
        jctl.CadenceState(None, None, None, None, jnp.int32(0), e)))
    for e in range(64):
        want = np.float32(jeps(jnp.int32(e)))
        assert np.float32(tc.epsilon(tc.init()._replace(epoch=e))) == want, e
        assert np.float32(tcad.epsilon(tcad.init()._replace(epoch=e))) == np.float32(
            jcad_eps(jnp.int32(e))), e


def test_window_primitives_match():
    rng = np.random.default_rng(4)
    jw = jmetrics.window_init(3, (5, 2))
    tw = tmetrics.window_init(3, (5, 2))
    for ptr in range(7):
        x = rng.random((5, 2)).astype(np.float32)
        jw = jmetrics.window_record(jw, jnp.int32(ptr), x)
        tw = tmetrics.window_record(tw, ptr, torch.from_numpy(x))
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        np.testing.assert_array_equal(
            _bits(jax.jit(jmetrics.window_total)(jw)), _bits(tmetrics.window_total(tw).numpy()))


def test_make_draws_is_seeded_and_in_range():
    u, arm = tctl.make_draws(7, (5, 300), 6)
    u2, arm2 = tctl.make_draws(7, (5, 300), 6)
    assert torch.equal(u, u2) and torch.equal(arm, arm2)
    assert u.dtype == torch.float32 and arm.dtype == torch.int32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert set(arm.unique().tolist()) == set(range(6))
    assert not torch.equal(tctl.make_draws(8, (5, 300), 6)[0], u)
