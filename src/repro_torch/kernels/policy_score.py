"""The (sessions × levels) SLA scorer of the adaptive control plane.

Port of ``repro.kernels.policy_score``: every epoch the controller scores
each session ``s`` against each candidate level ``l`` from the packed
session parameters ``sess[s]`` (``SP_*`` columns), the analytic level
table ``table[:, l]`` (``LVL_*`` rows) and the windowed telemetry
``stale``/``viol``/``count`` ``[s, l]``:

    s_e, v_e = (stale, viol) if count > 0 else (0, 0)      (optimistic)
    cost     = fma(rf, fma(s_e, repair, read_cost), (1 - rf) · write_cost)
    excess   = max(s_e - max_stale, 0) / max(max_stale, 1e-6)
             + max(v_e - max_viol, 0) / max(max_viol, 1e-6)
             + 10 · (lat > max_lat) + 10 · (age > max_age)
    feasible = excess == 0 and valid
    utility  = fma(-1e6, excess, -cost) if valid else 0

The contract is the reference's scorer under ``jit`` (``ref.policy_score_ref``
jitted, and its Pallas kernel): XLA contracts exactly the three
multiply-adds written ``fma`` above into fused multiply-adds, and every
other operation rounds once.  The eager reference rounds every product
and is *not* the contract.

Two entries, one kernel (``csrc/policy_score.cu``):

  * the reference's layout — :func:`policy_score_ref` (the plain
    version; PyTorch promises no FMA on every device, so
    :func:`repro_torch.kernels.fp.fma_f32` emulates it exactly) and
    :func:`policy_score_cuda`;
  * the controller's selection, reading its three ``(W, S, L)`` count
    rings in place — :func:`policy_select_ref` (the reference
    controller's composition: :func:`window_rates`,
    :func:`pack_sessions`, the scorer, ``argmax`` and the exploration
    arm) and :func:`policy_select_cuda`, one launch per selection.

Invalid session rows (``SP_VALID == 0``) score utility 0, feasible 0.
Neither version pads the session axis.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fp import fma_f32
from repro_torch.obs.metrics import window_total

# The scoring weights, shared with the placement scorer as in the
# reference (``repro.kernels.ref``): the penalty ranks any feasible level
# above every infeasible one; a structural (latency / data-age) violation
# hits every request and outweighs relative rate overshoots.
from repro_torch.kernels.placement_score import INFEASIBLE_PENALTY, STRUCTURAL_WEIGHT

# Session-parameter columns of the (S, SP_COLS) array.
SP_READ_FRAC, SP_MAX_STALE, SP_MAX_VIOL, SP_MAX_LAT, SP_MAX_AGE, SP_VALID = (
    0, 1, 2, 3, 4, 5,
)
SP_COLS = 8
# Level-table rows of the (LVL_COLS, L) array.
LVL_READ_COST, LVL_WRITE_COST, LVL_REPAIR_COST, LVL_READ_LAT, LVL_STALE_AGE = (
    0, 1, 2, 3, 4,
)
LVL_COLS = 8
RATE_EPS = 1.0e-6      # floor of a rate bound in the relative overshoot
MAX_LEVELS = 64        # the kernel's shared-memory table holds 5 x 64 floats

launches = 0


def _check(sess, table, stale, viol, count):
    s, l = stale.shape
    for name, t, shape in (("sess", sess, (s, SP_COLS)), ("table", table, (LVL_COLS, l)),
                           ("viol", viol, (s, l)), ("count", count, (s, l))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def window_rates(stale_win, viol_win, reads_win):
    """Windowed ``(stale_rate, viol_rate, sample_count)``, each (S, L), of
    the three (W, S, L) count rings: the sums slot by slot in index
    order, the rates over ``max(count, 1)`` (the reference controller's
    ``aggregate``)."""
    reads = window_total(reads_win)
    denom = torch.clamp(reads, min=1.0)
    return window_total(stale_win) / denom, window_total(viol_win) / denom, reads


def pack_sessions(n_sessions: int, bounds, *, read_frac=0.5, valid=None,
                  device="cpu") -> torch.Tensor:
    """The (S, SP_COLS) f32 session parameters: ``bounds`` = ``(max_stale,
    max_viol, max_lat, max_age)``, shared by every row, each stored once
    as f32; ``read_frac`` a value or (S,); ``valid`` None (every row) or
    (S,), valid where > 0."""
    sp = torch.zeros((n_sessions, SP_COLS), dtype=torch.float32, device=device)
    sp[:, SP_READ_FRAC] = torch.as_tensor(read_frac, dtype=torch.float32, device=device)
    for col, v in zip((SP_MAX_STALE, SP_MAX_VIOL, SP_MAX_LAT, SP_MAX_AGE), bounds):
        sp[:, col] = v
    sp[:, SP_VALID] = 1.0 if valid is None else torch.as_tensor(
        valid, device=device).to(torch.float32)
    return sp


def xla_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``: a NaN operand propagates, and of two zeros the
    result is -0 only when both are (``torch.maximum(-0., 0.)`` is -0)."""
    keep_a = torch.isnan(a) | (a > b) | ((a == b) & ~torch.signbit(a))
    return torch.where(keep_a, a, b)


def policy_score_ref(sess, table, stale, viol, count):
    """Plain version: ``(utility (S, L) f32, feasible (S, L) int32)``,
    bit-equal to the reference's jitted contract."""
    sess, table, stale, viol, count = (
        t.to(torch.float32) for t in (sess, table, stale, viol, count))
    _check(sess, table, stale, viol, count)
    dev = stale.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def col(i):
        return sess[:, i:i + 1]

    rf = col(SP_READ_FRAC)
    max_stale, max_viol = col(SP_MAX_STALE), col(SP_MAX_VIOL)
    max_lat, max_age = col(SP_MAX_LAT), col(SP_MAX_AGE)
    valid = col(SP_VALID) > 0.0
    read_cost, write_cost, repair, lat, age = (
        table[i][None, :] for i in (LVL_READ_COST, LVL_WRITE_COST,
                                    LVL_REPAIR_COST, LVL_READ_LAT, LVL_STALE_AGE))
    zero, eps, structural = f32(0.0), f32(RATE_EPS), f32(STRUCTURAL_WEIGHT)
    has = count > 0.0
    s_e = torch.where(has, stale, zero)
    v_e = torch.where(has, viol, zero)
    cost = fma_f32(rf, fma_f32(s_e, repair, read_cost), (f32(1.0) - rf) * write_cost)
    excess = (
        xla_max(s_e - max_stale, zero) / xla_max(max_stale, eps)
        + xla_max(v_e - max_viol, zero) / xla_max(max_viol, eps)
        + structural * (lat > max_lat).to(torch.float32)
        + structural * (age > max_age).to(torch.float32)
    )
    feas = (excess == 0.0) & valid
    util = torch.where(valid, fma_f32(f32(-INFEASIBLE_PENALTY), excess, -cost), zero)
    return util, feas.to(torch.int32)


def policy_select_ref(stale_win, viol_win, reads_win, table, bounds, *,
                      read_frac=0.5, valid=None, explore_u=None, arm=None,
                      epsilon=None):
    """Plain version of the selection from the (W, S, L) count rings:
    with ``explore_u`` (S,) f32, ``arm`` (S,) int32 and ``epsilon`` (an f32
    value), each session's level, (S,) int32 — ``arm`` where ``explore_u <
    epsilon``, else the first level of the largest utility; without them,
    ``(utility (S, L) f32, feasible (S, L) int32)``."""
    stale, viol, count = window_rates(stale_win, viol_win, reads_win)
    sess = pack_sessions(stale.shape[0], bounds, read_frac=read_frac, valid=valid,
                         device=stale.device)
    util, feas = policy_score_ref(sess, table, stale, viol, count)
    if explore_u is None:
        return util, feas
    greedy = torch.argmax(util, dim=1).to(torch.int32)
    return torch.where(explore_u < epsilon, arm, greedy)


def _lib():
    fn = build.load("policy_score").policy_score_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                       vp, vp, vp]
        fn.restype = ctypes.c_int
    return fn


_SELECT_FN = None


def _select_lib():
    global _SELECT_FN
    if _SELECT_FN is None:
        fn = build.load("policy_score").policy_select_launch
        vp, cf = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, vp,
                       vp, cf, vp, cf, cf, cf, cf, vp, vp, cf, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
        _SELECT_FN = fn
    return _SELECT_FN


def policy_score_cuda(sess, table, stale, viol, count):
    """Launch ``csrc/policy_score.cu`` on CUDA f32 tensors; returns
    ``(utility, feasible)``."""
    global launches
    ins = [t.contiguous() for t in (sess, table, stale, viol, count)]
    if not all(t.is_cuda for t in ins):
        raise ValueError("policy_score_cuda needs CUDA tensors")
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError("policy_score_cuda needs float32 tensors")
    _check(*ins)
    sess, table, stale, viol, count = ins
    s, l = stale.shape
    if l > MAX_LEVELS:
        raise ValueError(f"policy_score_cuda: L={l} exceeds {MAX_LEVELS} levels")
    util = torch.empty((s, l), dtype=torch.float32, device=stale.device)
    feas = torch.empty((s, l), dtype=torch.int32, device=stale.device)
    if s == 0 or l == 0:
        return util, feas
    err = _lib()(
        sess.data_ptr(), table.data_ptr(), stale.data_ptr(), viol.data_ptr(),
        count.data_ptr(), s, l, util.data_ptr(), feas.data_ptr(),
        build.stream_ptr(stale),
    )
    build.check(err, "policy_score")
    launches += 1
    return util, feas


def _session_vector(x, s: int, dtype, name: str) -> torch.Tensor:
    if x.dtype != dtype or x.shape != (s,) or not x.is_contiguous():
        x = x.to(dtype).expand(s).contiguous()
    if not x.is_cuda:
        raise ValueError(f"policy_select_cuda: {name} must be on the card")
    return x


def policy_select_cuda(stale_win, viol_win, reads_win, table, bounds, *,
                       read_frac=0.5, valid=None, explore_u=None, arm=None,
                       epsilon=None):
    """Launch ``csrc/policy_score.cu`` on the controller's three (W, S, L)
    f32 rings, read in place: one kernel per call, whose result is
    :func:`policy_select_ref`'s (the choice, or ``(utility, feasible)``
    without draws).  ``bounds`` and ``epsilon`` are host values, passed
    as f32; ``read_frac`` a host value or a tensor of (S,) (then read per
    session)."""
    global launches
    rings = (stale_win, viol_win, reads_win)
    for t in (*rings, table):
        if not t.is_cuda or t.dtype is not torch.float32 or not t.is_contiguous():
            raise ValueError("policy_select_cuda needs contiguous float32 CUDA rings "
                             "and table")
    if stale_win.dim() != 3 or viol_win.shape != stale_win.shape \
            or reads_win.shape != stale_win.shape:
        raise ValueError("the rings must be (W, S, L) alike, got "
                         f"{[tuple(t.shape) for t in rings]}")
    w, s, l = stale_win.shape
    if tuple(table.shape) != (LVL_COLS, l):
        raise ValueError(f"table must be {(LVL_COLS, l)}, got {tuple(table.shape)}")
    if not 1 <= l <= MAX_LEVELS or w < 1:
        raise ValueError(f"policy_select_cuda: W={w}, L={l} (1 <= L <= {MAX_LEVELS})")
    select = explore_u is not None
    if select and (arm is None or epsilon is None):
        raise ValueError("policy_select_cuda: explore_u needs arm and epsilon")
    dev = stale_win.device
    rf_vec, rf_value = None, 0.0
    if isinstance(read_frac, torch.Tensor):
        rf_vec = _session_vector(read_frac, s, torch.float32, "read_frac")
    else:
        rf_value = float(read_frac)
    ok = None if valid is None else _session_vector(
        torch.as_tensor(valid, device=dev), s, torch.float32, "valid")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if select:
        explore_u = _session_vector(explore_u, s, torch.float32, "explore_u")
        arm = _session_vector(arm, s, torch.int32, "arm")
        choice = torch.empty((s,), dtype=torch.int32, device=dev)
        outs = (choice, None, None)
    else:
        outs = (None, torch.empty((s, l), dtype=torch.float32, device=dev),
                torch.empty((s, l), dtype=torch.int32, device=dev))
    if s:
        err = (_SELECT_FN or _select_lib())(
            stale_win.data_ptr(), viol_win.data_ptr(), reads_win.data_ptr(), w, s, l,
            table.data_ptr(), ptr(rf_vec), rf_value, ptr(ok), *map(float, bounds),
            ptr(explore_u), ptr(arm), float(epsilon or 0.0), *map(ptr, outs),
            build.stream_ptr(stale_win))
        if err:
            build.check(err, "policy_select")
        launches += 1
    return outs[0] if select else outs[1:]
