"""Port's placement planner == JAX's: the plain ``placement_score`` bit for
bit against the jitted reference (tiled twin and interpreted Pallas
kernel), its FMA emulation against an exact ``Fraction`` oracle, the
plain ``placement_select`` against the interpreted Pallas kernel followed
by ``np.argmax`` and the chosen cells, and the planner's tables, choices,
utilities, feasibility and costs."""

import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro.core import cost_model as jcost
from repro.geo import placement as jpl
from repro.geo.topology import PAPER_TOPOLOGY as J_PAPER
from repro.geo.topology import RegionTopology as JTopo
from repro.kernels import ops as jops
from repro.policy.sla import SLA as JSLA
from repro.policy.sla import SLA_RELAXED as J_RELAXED
from repro.policy.sla import SLA_STRICT as J_STRICT
from repro_torch import convert
from repro_torch.geo import placement as tpl
from repro_torch.kernels import fp, ops
from repro_torch.kernels import placement_score as tps
from repro_torch.policy import sla as tsla

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU

torch.set_num_threads(1)

# An asymmetric 3-region topology with a tiered WAN class.
J_ASYM = JTopo(
    (0, 1, 2),
    ((0.1, 30.0, 80.0), (30.0, 0.1, 5.0), (80.0, 5.0, 0.1)),
    jcost.EgressMatrix(
        pair_class=((0, 1, 2), (1, 0, 1), (2, 1, 0)),
        class_per_gb=(0.0, 0.01, 0.08),
        class_tiers=((), ((1.0, 0.02), (float("inf"), 0.01)), ()),
    ),
)
TOPOLOGIES = {
    "paper": J_PAPER,
    "hot": dataclasses.replace(J_PAPER, client_region=(0,) * 11 + (1, 1, 1) + (2, 2)),
    "asym": J_ASYM,
}
SLAS = {
    "relaxed": (J_RELAXED, tsla.SLA_RELAXED),
    "strict": (J_STRICT, tsla.SLA_STRICT),
    "local": (JSLA("local-reads", max_read_latency_ms=1.0),
              tsla.SLA("local-reads", max_read_latency_ms=1.0)),
    "none": (JSLA("none"), tsla.SLA("none")),
}


def _f32_round(v: Fraction) -> np.float32:
    """``v`` rounded once to the nearest f32, ties to even."""
    a = np.float32(float(v))
    cands = [np.nextafter(a, np.float32(-np.inf)), a,
             np.nextafter(a, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - v) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - v) == best]
    return min(near, key=lambda c: int(np.asarray(c).view(np.int32)) & 1)


def _fma_oracle(x, y, c) -> np.ndarray:
    return np.asarray([
        _f32_round(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(d)))
        for a, b, d in zip(x, y, c)
    ], np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_fma_emulation_matches_exact_oracle_on_random_triples():
    rng = np.random.default_rng(0)
    n = 3000
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)).astype(np.float32)
    y = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)).astype(np.float32)
    c = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)).astype(np.float32)
    c[::7] = -(x[::7].astype(np.float64) * y[::7]).astype(np.float32)  # cancellation
    got = fp.fma_f32(*(torch.from_numpy(v) for v in (x, y, c))).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_fma_oracle(x, y, c)))


def _double_rounding_triples(n_want=64, seed=1):
    """Triples whose f64 sum lands exactly on an f32 midpoint while the
    exact value does not: naive f64-then-f32 rounding breaks the tie the
    wrong way on about half of them."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_want:
        m = 200_000
        c = rng.uniform(1.0, 2.0, m).astype(np.float32)
        odd = 2 * rng.integers(1, 50, m) + 1
        x = rng.uniform(1.0, 2.0, m).astype(np.float32)
        y = (odd * 2.0 ** -24 / x.astype(np.float64)).astype(np.float32)
        s = x.astype(np.float64) * y + c
        naive = s.astype(np.float32)
        hits = []
        for i in np.flatnonzero(naive != np.float32(0)):
            exact = Fraction(float(x[i])) * Fraction(float(y[i])) + Fraction(float(c[i]))
            if Fraction(float(s[i])) != exact and _f32_round(exact) != naive[i]:
                hits.append(i)
            if len(hits) >= n_want:
                break
        out += [(x[i], y[i], c[i]) for i in hits]
    x, y, c = (np.asarray(v, np.float32) for v in zip(*out[:n_want]))
    return x, y, c


def test_fma_emulation_survives_double_rounding_cases():
    x, y, c = _double_rounding_triples()
    want = _fma_oracle(x, y, c)
    naive = (x.astype(np.float64) * y + c).astype(np.float32)
    assert (_bits(naive) != _bits(want)).all()       # the cases are adversarial
    got = fp.fma_f32(*(torch.from_numpy(v) for v in (x, y, c))).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _inputs(case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    r = {"random": 300, "tail": 130, "one": 1, "invalid": 257, "zero": 200}[case]
    cand = jpl.enumerate_candidates(3)
    tabs = jpl.candidate_tables(J_ASYM if case == "random" else J_PAPER, cand,
                                resource_gb=1.0 / r)
    meta = tabs["cand_meta"].copy()
    reads = (rng.integers(0, 8, (r, 3)) * rng.random((r, 3)) * 100).astype(np.float32)
    writes = rng.integers(0, 8, (r, 3)).astype(np.float32)
    if case == "invalid":
        meta[1, ::5] = 0.0
        meta[1, 3] = np.nan
    if case == "zero":
        reads[::2] = 0.0
        writes[::3] = 0.0
    return (reads, writes, tabs["read_price"], tabs["write_price"], tabs["read_rtt"],
            meta)


@pytest.mark.parametrize("impl", ["tiled", "pallas"])
@pytest.mark.parametrize("case", ["random", "tail", "one", "invalid", "zero"])
@pytest.mark.parametrize("max_lat", [10.0, 1.0, float("inf")])
def test_plain_placement_score_bit_equal_to_jit_reference(impl, case, max_lat):
    args = _inputs(case)
    wu, wf = jops.placement_score(*args, max_latency_ms=max_lat, impl=impl)
    tu, tf = tps.placement_score_ref(*(torch.from_numpy(np.asarray(a)) for a in args),
                                     max_latency_ms=max_lat)
    np.testing.assert_array_equal(_bits(tu.numpy()), _bits(wu))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(wf))


def test_plain_placement_score_chunks_rows(monkeypatch):
    args = [torch.from_numpy(np.asarray(a)) for a in _inputs("random")]
    whole = tps.placement_score_ref(*args, max_latency_ms=10.0)
    monkeypatch.setattr(tps, "ROWS_PER_CHUNK", 7)
    chunked = tps.placement_score_ref(*args, max_latency_ms=10.0)
    for a, b in zip(whole, chunked):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)


def test_placement_score_dispatch_and_checks():
    args = [torch.from_numpy(np.asarray(a)) for a in _inputs("tail")]
    auto = ops.placement_score(*args, max_latency_ms=10.0)
    plain = ops.placement_score(*args, max_latency_ms=10.0, impl="torch")
    assert all(torch.equal(a, b) for a, b in zip(auto, plain))
    with pytest.raises(ValueError, match="CUDA"):
        ops.placement_score(*args, max_latency_ms=10.0, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tps.placement_score_cuda(*args, max_latency_ms=10.0)
    bad = list(args)
    bad[5] = bad[5][:, :-1]
    with pytest.raises(ValueError, match="cand_meta"):
        tps.placement_score_ref(*bad, max_latency_ms=10.0)


# -- the planner's selection ------------------------------------------------------


def _select_case(case: str, seed: int = 0):
    """Inputs of one ``placement_select`` case, numpy f32, on the paper's
    124 candidates unless the case says otherwise."""
    rng = np.random.default_rng(seed)
    r = {"r0": 0, "r1": 1, "random": 130}.get(case, 100)
    cand = jpl.enumerate_candidates(3)
    if case == "k1":
        cand = cand[[57]]
    tabs = jpl.candidate_tables(J_ASYM if case == "random" else J_PAPER, cand,
                                resource_gb=1.0 / max(1, r))
    rp, wp, rtt = (tabs[k].copy() for k in ("read_price", "write_price", "read_rtt"))
    meta = tabs["cand_meta"].copy()
    reads = (rng.integers(0, 6, (r, 3)) * rng.random((r, 3)) * 50).astype(np.float32)
    writes = rng.integers(0, 6, (r, 3)).astype(np.float32)
    if case == "tied":           # every 9th candidate a copy of its left neighbour
        dup = np.arange(1, rp.shape[0], 9)
        for t in (rp, wp, rtt):
            t[dup] = t[dup - 1]
        meta[:, dup] = meta[:, dup - 1]
    if case == "invalid":        # every 17th candidate invalid, one NaN flag
        meta[1, ::17] = 0.0
        meta[1, 3] = np.nan
    if case == "infeasible":     # rows with demand in region 0 fit no candidate at 10 ms
        rtt[:, 0] = 1000.0
        reads[::4, 0] = 0.0
        writes[::4, 0] = 0.0
    if case == "zero":           # zero demand: -0.0 / 0.0 utilities tie
        reads[::2] = 0.0
        writes[::2] = 0.0
        meta[0] = np.where(np.arange(meta.shape[1]) % 2, np.float32(-0.0), 0.0)
        rp[1::2] *= -1.0
        wp[1::2] *= -1.0
    if case == "nan":            # a NaN price: the first NaN utility is the maximum
        rp[5, 1] = np.nan
        wp[40, 2] = np.nan
        reads[::3] = np.nan
    return (reads, writes, rp, wp, rtt, meta)


def _reference_select(args, max_lat) -> np.ndarray:
    """The reference's composition: the Pallas kernel (interpreted), then
    ``np.argmax`` and the chosen cells, packed (3, R) int32.  Its kernel
    refuses R = 0 (a block of zero rows), so an empty grid stands in."""
    if args[0].shape[0]:
        util, feas = (np.asarray(a) for a in jops.placement_score(
            *args, max_latency_ms=max_lat, impl="pallas"))
    else:
        util = np.zeros((0, args[2].shape[0]), np.float32)
        feas = util.astype(np.int32)
    choice = np.argmax(util, axis=1).astype(np.int32)
    rows = np.arange(util.shape[0])
    return np.stack([choice, util[rows, choice].view(np.int32),
                     feas[rows, choice].astype(np.int32)])


SELECT_CASES = ["random", "tied", "invalid", "infeasible", "zero", "nan", "k1",
                "r0", "r1"]


@pytest.mark.parametrize("case", SELECT_CASES)
@pytest.mark.parametrize("max_lat", [10.0, float("inf")])
def test_plain_placement_select_bit_equal_to_pallas_argmax(case, max_lat):
    args = _select_case(case)
    want = _reference_select(args, max_lat)
    got = ops.placement_select(*(torch.from_numpy(a) for a in args),
                               max_latency_ms=max_lat, impl="torch")
    assert got.dtype == torch.int32 and got.shape == want.shape
    got = got.numpy()
    # Choices and feasibility exactly, utilities bit for bit, with any NaN
    # equal to any NaN (the emulated FMA and XLA's give NaNs of two signs).
    nan = np.isnan(got[1].view(np.float32)) & np.isnan(want[1].view(np.float32))
    assert nan.any() == (case == "nan")
    both = np.stack([np.zeros_like(nan), nan, np.zeros_like(nan)])
    np.testing.assert_array_equal(np.where(both, 0, got), np.where(both, 0, want))
    if case == "zero":           # the tie is real and goes to candidate 0's -0.0
        assert (got[0, ::2] == 0).all() and (got[1, ::2] == _bits(-0.0)).all()
    if case == "infeasible" and max_lat == 10.0:
        assert not got[2, 1::4].any() and got[2, ::4].all()


def test_placement_select_dispatch_and_checks(monkeypatch):
    args = [torch.from_numpy(a) for a in _select_case("tied")]
    auto = ops.placement_select(*args, max_latency_ms=10.0)
    assert torch.equal(auto, ops.placement_select(*args, max_latency_ms=10.0,
                                                  impl="torch"))
    # The plain version equals the grid it reduces, in one chunk or many.
    assert torch.equal(auto, tps.select_from_grid(
        *tps.placement_score_ref(*args, max_latency_ms=10.0)))
    monkeypatch.setattr(tps, "ROWS_PER_CHUNK", 7)
    assert torch.equal(auto, tps.placement_select_ref(*args, max_latency_ms=10.0))
    # The planner's copies: a small demand rides in the tables' one copy;
    # above ONE_COPY_BYTES reads and writes go as arrays of their own.
    tables = dict(zip(("read_price", "write_price", "read_rtt", "cand_meta"),
                      (a.numpy() for a in args[2:])))
    for one_copy in (tpl.ONE_COPY_BYTES, 0):
        monkeypatch.setattr(tpl, "ONE_COPY_BYTES", one_copy)
        staged = tpl.device_inputs(args[0].numpy(), args[1].numpy(), tables, CPU)
        assert all(torch.equal(a, b) for a, b in zip(staged, args))
        storages = {t.untyped_storage().data_ptr() for t in staged}
        assert len(storages) == (1 if one_copy else 3)
        assert torch.equal(auto, ops.placement_select(*staged, max_latency_ms=10.0))
    with pytest.raises(ValueError, match="CUDA"):
        ops.placement_select(*args, max_latency_ms=10.0, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tps.placement_select_cuda(*args, max_latency_ms=10.0)
    empty = [args[0], args[1], *(a[:0] for a in args[2:5]), args[5][:, :0]]
    with pytest.raises(ValueError, match="candidate"):
        ops.placement_select(*empty, max_latency_ms=10.0)
    assert ops.launch_counts()["placement_select"] == 0


# -- the planner ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, dict(max_per_region=2), dict(max_per_region=3, max_total=5, min_total=2),
])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_enumerate_candidates_matches(kw, g):
    np.testing.assert_array_equal(jpl.enumerate_candidates(g, **kw),
                                  tpl.enumerate_candidates(g, **kw))


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("min_replicas", [1, 3])
def test_candidate_tables_match(topo, min_replicas):
    jt = TOPOLOGIES[topo]
    tt = convert.region_topology(jt)
    cand = jpl.enumerate_candidates(3)
    want = jpl.candidate_tables(jt, cand, resource_gb=0.5, min_replicas=min_replicas)
    got = tpl.candidate_tables(tt, cand, resource_gb=0.5, min_replicas=min_replicas)
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    np.testing.assert_array_equal(jpl.static_counts(jt, 3), tpl.static_counts(tt, 3))


def _demand(jt, n_ops=3000, n_res=24, seed=0):
    from repro.storage.simulator import _op_stream
    from repro.storage.ycsb import WORKLOAD_A

    s = _op_stream(WORKLOAD_A, n_ops, 16, n_res, seed, jt.n_replicas)
    return s, jpl.region_demand(s["client"], s["kind"], s["resource"], jt, n_res)


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_region_demand_matches(topo):
    jt = TOPOLOGIES[topo]
    s, (wr, ww) = _demand(jt)
    gr, gw = tpl.region_demand(s["client"], s["kind"], s["resource"],
                               convert.region_topology(jt), 24)
    for a, b in ((wr, gr), (ww, gw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _assert_plan_equal(want, got):
    for f in ("choice", "counts", "utility", "feasible", "cost", "candidates"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert want.summary() == got.summary()


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("sla", sorted(SLAS))
def test_plan_placement_and_static_baseline_match(topo, sla):
    jt = TOPOLOGIES[topo]
    tt = convert.region_topology(jt)
    jsla, tsla_ = SLAS[sla]
    _, (reads, writes) = _demand(jt)
    _assert_plan_equal(jpl.plan_placement(jt, reads, writes, jsla),
                       tpl.plan_placement(tt, reads, writes, tsla_, device=CPU))
    static = jpl.static_counts(jt, 4)
    want = jpl.evaluate_counts(jt, static, reads, writes, jsla)
    got = tpl.evaluate_counts(tt, static, reads, writes, tsla_, device=CPU)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), np.asarray(got[k]), err_msg=k)


def test_plan_placement_options_match():
    jt, tt = J_ASYM, convert.region_topology(J_ASYM)
    _, (reads, writes) = _demand(jt, n_res=40, seed=3)
    cand = jpl.enumerate_candidates(3, max_per_region=2)   # static (4,4,4) gets added
    kw = dict(candidates=cand, resource_gb=0.25, months=2.0, min_replicas=2)
    _assert_plan_equal(jpl.plan_placement(jt, reads, writes, J_RELAXED, **kw),
                       tpl.plan_placement(tt, reads, writes, tsla.SLA_RELAXED,
                                          device=CPU, **kw))


def test_tied_utilities_pick_the_first_candidate():
    """Duplicated candidates tie in every row: the reference's np.argmax
    and the port's torch.argmax both take the first of them."""
    one, all4 = np.asarray([1, 0, 0], np.int32), np.asarray([4, 4, 4], np.int32)
    rng = np.random.default_rng(4)
    reads = rng.integers(0, 5, (50, 3)).astype(np.float32)
    writes = rng.integers(0, 5, (50, 3)).astype(np.float32)
    tt = convert.region_topology(J_PAPER)
    for cand, first in ((np.stack([one, one, one]), 0),
                        (np.stack([all4, one, one, one]), 1)):
        got = tpl.plan_placement(tt, reads, writes, tsla.SLA("none"),
                                 candidates=cand, device=CPU)
        want = jpl.plan_placement(J_PAPER, reads, writes, JSLA("none"),
                                  candidates=cand)
        _assert_plan_equal(want, got)
        assert (got.choice == first).all()


def test_score_candidates_keeps_the_grid_on_its_device():
    tt = convert.region_topology(J_PAPER)
    cand = tpl.enumerate_candidates(3)
    tabs = tpl.candidate_tables(tt, cand)
    reads = np.ones((4, 3), np.float32)
    util, feas = tpl.score_candidates(reads, reads, tabs, tsla.SLA_RELAXED, device=CPU)
    assert isinstance(util, torch.Tensor) and util.shape == (4, cand.shape[0])
    assert feas.dtype == torch.int32


@pytest.mark.parametrize("counts", [(4, 4, 4), (1, 0, 2), (0, 3, 0)])
@pytest.mark.parametrize("topo", ["paper", "hot"])
def test_fleet_topology_matches(counts, topo):
    jt = TOPOLOGIES[topo]
    want = jpl.fleet_topology(jt, np.asarray(counts))
    got = tpl.fleet_topology(convert.region_topology(jt), np.asarray(counts))
    assert got == convert.region_topology(want)
    for bad in ((0, 0, 0), (1, -1, 1), (1, 1)):
        with pytest.raises(ValueError):
            tpl.fleet_topology(convert.region_topology(jt), np.asarray(bad))


def test_sla_constants_match():
    for j, t in ((J_RELAXED, tsla.SLA_RELAXED), (J_STRICT, tsla.SLA_STRICT)):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (tps.STRUCTURAL_WEIGHT, tps.INFEASIBLE_PENALTY) == (10.0, 1.0e6)
