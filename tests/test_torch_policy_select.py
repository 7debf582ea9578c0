"""Port's controller selection from the telemetry rings == JAX's: the plain
``policy_select`` (``kernels.policy_score.policy_select_ref``, what one
kernel launch computes on the card) bit for bit against the reference
controller's ``aggregate`` + the scorer under ``jit`` + ``jnp.argmax`` +
the exploration ``where``, on the same numpy rings and injected draws;
``torch.argmax`` against ``jnp.argmax`` on ties and NaNs; and the
controller's ``select`` / ``scores`` on the plain route."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.policy import controller as jctl
from repro.policy import sla as jsla
from repro_torch.kernels import ops
from repro_torch.kernels import policy_score as tps
from repro_torch.policy import controller as tctl
from repro_torch.policy import sla as tsla

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU, f32_same, select_inputs

torch.set_num_threads(1)

LEVELS = {2: (jsla.POLICY_LEVELS[0], jsla.POLICY_LEVELS[3]), 6: jsla.POLICY_LEVELS}
EPSILONS = (0.0, 1.0, 0.05)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _tlevels(levels):
    return tuple(tsla.POLICY_LEVELS[jsla.POLICY_LEVELS.index(lv)] for lv in levels)


@functools.lru_cache(maxsize=None)
def _reference(levels, n_sessions):
    """The reference controller's selection, jitted: ``aggregate``, the
    session parameters of its target SLA, the scorer, ``jnp.argmax`` and
    the exploration arm, with the draws and ε as inputs."""
    jc = jctl.AdaptiveController(n_sessions, jsla.SLA_STRICT, levels=levels)

    def select(sw, vw, rw, table, rf, valid, u, arm, eps):
        state = jctl.ControllerState(sw, vw, rw, jnp.int32(0), jnp.int32(0))
        stale, viol, count = jc.aggregate(state)
        sess = jsla.session_params(jc.target_sla, n_sessions, read_frac=rf, valid=valid)
        util, feas = jsla.score_levels(sess, table, stale, viol, count)
        greedy = jnp.argmax(util, axis=1).astype(jnp.int32)
        return util, feas, jnp.where(u < eps, arm, greedy)

    return jc, jax.jit(select)


@pytest.mark.parametrize("s", [1, 16, 64, 129, 1000])
@pytest.mark.parametrize("n_levels", [2, 6])
@pytest.mark.parametrize("w", [1, 8])
@pytest.mark.parametrize("per_session", [False, True], ids=["rf_scalar", "rf_per_session"])
def test_plain_policy_select_bit_equal_to_reference(s, n_levels, w, per_session):
    levels = LEVELS[n_levels]
    inp = select_inputs(np.random.default_rng(s * w + n_levels), s, w, CPU,
                        levels=_tlevels(levels), wraps=3)
    rings = [inp[k] for k in ("stale_win", "viol_win", "reads_win")]
    table, u, arm = inp["table"], inp["explore_u"], inp["arm"]
    rf = inp["read_frac"] if per_session else 0.3
    _, ref = _reference(levels, s)

    def want(valid, eps):
        return ref(*(r.numpy() for r in rings), table.numpy(), np.asarray(rf, np.float32),
                   np.ones(s, np.float32) if valid is None else valid.numpy(),
                   u.numpy(), arm.numpy(), np.float32(eps))

    tc = tctl.AdaptiveController(s, tsla.SLA_STRICT, levels=_tlevels(levels), device=CPU)
    bounds = tsla.sla_bounds(tc.target_sla)
    for valid in (None, inp["valid"]):
        for eps in EPSILONS:
            eps = float(np.float32(eps))
            util, feas, choice = want(valid, eps)
            got = ops.policy_select(*rings, table, bounds, read_frac=rf, valid=valid,
                                    explore_u=u, arm=arm, epsilon=eps)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(choice))
        got = tps.policy_select_ref(*rings, table, bounds, read_frac=rf, valid=valid)
        assert f32_same(got[0], torch.from_numpy(np.asarray(util)))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(feas))
    # The controller: its select at its own epsilon, and its scores.
    tc.table = table
    state = tctl.ControllerState(*rings, ptr=w + 3, epoch=2)
    util, feas, choice = want(None, tc.epsilon(state))
    np.testing.assert_array_equal(tc.select(state, u, arm, read_frac=rf).numpy(),
                                  np.asarray(choice))
    got = tc.scores(state, read_frac=rf)
    assert f32_same(got[0], torch.from_numpy(np.asarray(util)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(feas))


def test_select_inputs_exercise_ties_and_nans():
    """The rings' tie rows lead with two equal utilities at levels 0 and 1
    (level 0 is chosen), and the NaN rows choose level 1, the first NaN."""
    s = 1000
    inp = select_inputs(np.random.default_rng(0), s, 8, CPU)
    rings = [inp[k] for k in ("stale_win", "viol_win", "reads_win")]
    bounds = tsla.sla_bounds(tsla.SLA_RELAXED)
    util, _ = tps.policy_select_ref(*rings, inp["table"], bounds)
    greedy = tps.policy_select_ref(*rings, inp["table"], bounds, explore_u=inp["explore_u"],
                                   arm=inp["arm"], epsilon=0.0)
    rows = torch.arange(s)
    tie = (rows % 5 == 0) & (rows % 7 != 0) & (util[:, 0] == util.max(dim=1).values)
    assert int(tie.sum()) > 0 and (util[tie, 0] == util[tie, 1]).all()
    assert (greedy[tie] == 0).all()
    nan = rows % 7 == 0
    assert util[nan, 1].isnan().all() and (greedy[nan] == 1).all()


@pytest.mark.parametrize("row", [
    [1.0, 3.0, 3.0, -1.0],
    [np.nan, 1.0, np.nan, 2.0],
    [0.0, np.nan, np.nan, np.inf],
    [-0.0, 0.0, -0.0, 0.0],
    [-np.inf, -np.inf, -np.inf, -np.inf],
    [2.0, np.inf, np.inf, np.nan],
], ids=["tie", "nan_first", "nan_second", "zeros", "all_minus_inf", "inf_then_nan"])
def test_torch_argmax_matches_jnp_argmax(row):
    """The plain version's greedy arm: ties to the first level, and a NaN
    counts as the largest, the first NaN winning."""
    x = np.asarray([row, row[::-1]], np.float32)
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(torch.argmax(torch.from_numpy(x), dim=1).numpy(), want)


def test_policy_select_dispatch_and_checks():
    inp = select_inputs(np.random.default_rng(1), 20, 3, CPU)
    rings = [inp[k] for k in ("stale_win", "viol_win", "reads_win")]
    bounds = tsla.sla_bounds(tsla.SLA_RELAXED)
    with pytest.raises(ValueError, match="CUDA"):
        ops.policy_select(*rings, inp["table"], bounds, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tps.policy_select_cuda(*rings, inp["table"], bounds)
    before = tps.launches
    ops.policy_select(*rings, inp["table"], bounds)
    assert tps.launches == before == ops.launch_counts()["policy_score"]
