"""The port's parameter sync (``repro_torch.sync``: compression and the
``SyncEngine``), the consistency policy and ``training_run_cost``
against the JAX reference on the same numpy inputs, on the CPU.

Bounds: the compression ops and every merge at two pods are exactly
equal (the same f32 operations; both round half to even); at four pods
the mean, quorum and compressed merges are within rtol 1e-6 (XLA picks
the order of a four-term sum); the bookkeeping — merges, violations, the
clocks, the DUOT, ``inter_pod_gb`` and the audit's severity — is exactly
equal at any pod count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consistency as jcons
from repro.core import cost_model as jcost
from repro.sync import compression as jcomp
from repro.sync.engine import SyncEngine as JEngine
from repro_torch.core import consistency as tcons
from repro_torch.core import cost_model as tcost
from repro_torch.sync import compression as tcomp
from repro_torch.sync.engine import SyncEngine as TEngine

from torch_port_helpers import as_np, assert_tree_equal

torch.set_num_threads(1)
CPU = "cpu"
P4_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_t(tree):
    return jax.tree.map(_t, tree)


# ---- policy and cost ----------------------------------------------------------


def test_policy_matches_reference():
    for name in ("one", "TWO", "quorum", "all", "causal", "tcc", "x-stcc", "X_STCC"):
        for kw in ({}, {"delta_steps": 3, "quorum_fraction": 0.75,
                        "compress_inter_pod": "topk", "topk_fraction": 0.1}):
            j, t = jcons.policy_for(name, **kw), tcons.policy_for(name, **kw)
            assert t.level.name == j.level.name
            assert dataclasses.asdict(t) | {"level": None} == \
                dataclasses.asdict(j) | {"level": None}
            assert t.inter_pod_period() == j.inter_pod_period()
            assert [t.quorum_size(n) for n in range(1, 9)] == \
                [j.quorum_size(n) for n in range(1, 9)]
    assert [lv.name for lv in tcons.PAPER_LEVELS] == [lv.name for lv in jcons.PAPER_LEVELS]
    for bad in ({"compress_inter_pod": "fp8"}, {"delta_steps": 0}):
        with pytest.raises(ValueError):
            jcons.policy_for("X_STCC", **bad)
        with pytest.raises(ValueError):
            tcons.policy_for("X_STCC", **bad)


@pytest.mark.parametrize("ckpt_every", [0, 7, 1000])
def test_training_run_cost_matches_reference(ckpt_every):
    jp = jcost.TPU_PRICING
    tp = tcost.PricingScheme(**{f.name: getattr(jp, f.name)
                                for f in dataclasses.fields(jp)})
    kw = dict(n_chips=256, step_time_s=1.73, n_steps=5000,
              inter_pod_bytes_per_step=3.2e9, intra_pod_bytes_per_step=7.5e10,
              ckpt_bytes=2.0e10, ckpt_every=ckpt_every)
    want = jcost.training_run_cost(**kw, pricing=jp)
    got = tcost.training_run_cost(**kw, pricing=tp)
    assert got.as_dict() == want.as_dict()
    with pytest.raises(TypeError):
        tcost.training_run_cost(**kw)    # pricing has no default in the port


# ---- compression ---------------------------------------------------------------


def _planted(rng, shape, levels=7):
    """Values with many equal magnitudes (ties for top-k; exact halves
    for int8 rounding)."""
    v = rng.integers(-levels, levels + 1, size=shape).astype(np.float32)
    return v * np.float32(0.5)


@pytest.mark.parametrize("kind", ["normal", "planted", "zeros", "bf16"])
def test_int8_quantize_matches_reference(kind):
    rng = np.random.default_rng(1)
    x = {"normal": rng.standard_normal((17, 33)).astype(np.float32),
         "planted": _planted(rng, (17, 33), 127),
         "zeros": np.zeros((5, 3), np.float32),
         "bf16": rng.standard_normal((9, 31)).astype(np.float32)}[kind]
    jx = jnp.asarray(x, jnp.bfloat16) if kind == "bf16" else jnp.asarray(x)
    tx = _t(x).to(torch.bfloat16) if kind == "bf16" else _t(x)
    jq, js = jcomp.int8_quantize(jx)
    tq, ts = tcomp.int8_quantize(tx)
    np.testing.assert_array_equal(as_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(as_np(ts), np.asarray(js))
    jd = jcomp.int8_dequantize(jq, js, jnp.float32)
    td = tcomp.int8_dequantize(tq, ts, torch.float32)
    np.testing.assert_array_equal(as_np(td), np.asarray(jd))


def test_int8_trees_match_reference():
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "n": {"b": rng.standard_normal((4,)).astype(np.float32)}}
    jc = jcomp.int8_compress_tree(jax.tree.map(jnp.asarray, tree))
    tc = tcomp.int8_compress_tree(_tree_t(tree))
    for k in (("w",), ("n", "b")):
        jleaf, tleaf = jc, tc
        for key in k:
            jleaf, tleaf = jleaf[key], tleaf[key]
        np.testing.assert_array_equal(as_np(tleaf[0]), np.asarray(jleaf[0]))
        np.testing.assert_array_equal(as_np(tleaf[1]), np.asarray(jleaf[1]))
    jd = jcomp.int8_decompress_tree(jc, jax.tree.map(jnp.asarray, tree))
    td = tcomp.int8_decompress_tree(tc, _tree_t(tree))
    np.testing.assert_array_equal(as_np(td["w"]), np.asarray(jd["w"]))
    np.testing.assert_array_equal(as_np(td["n"]["b"]), np.asarray(jd["n"]["b"]))


@pytest.mark.parametrize("fraction", [0.01, 0.1, 0.37, 1.0])
@pytest.mark.parametrize("kind", ["normal", "planted", "all_equal"])
def test_topk_matches_reference_with_ties(fraction, kind):
    """Planted ties: the lower index wins among equal magnitudes, as
    ``jax.lax.top_k`` orders them."""
    rng = np.random.default_rng(3)
    x = {"normal": rng.standard_normal((12, 25)).astype(np.float32),
         "planted": _planted(rng, (12, 25), 3),
         "all_equal": np.full((12, 25), -0.75, np.float32)}[kind]
    jv, ji, jr = jcomp.topk_sparsify(jnp.asarray(x), fraction)
    tv, ti, tr = tcomp.topk_sparsify(_t(x), fraction)
    np.testing.assert_array_equal(as_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(as_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(as_np(tr), np.asarray(jr))
    jd = jcomp.topk_densify(jv, ji, x.shape, jnp.float32)
    td = tcomp.topk_densify(tv, ti, x.shape, torch.float32)
    np.testing.assert_array_equal(as_np(td), np.asarray(jd))


def test_topk_index_rows_and_ties():
    mag = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 5.0]])
    assert tcomp.topk_index(mag, 2).tolist() == [[1, 2], [4, 0]]
    assert tcomp.topk_index(mag, 4).tolist() == [[1, 2, 4, 3], [4, 0, 1, 2]]


@pytest.mark.parametrize("method", ["none", "int8", "topk"])
def test_wire_bytes_matches_reference(method):
    shapes = {"a": ((64, 32), "float32"), "b": ((7,), "bfloat16"), "c": ((3, 3, 3), "float32")}
    jt = {k: jnp.zeros(s, d) for k, (s, d) in shapes.items()}
    tt = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
          for k, (s, d) in shapes.items()}
    assert tcomp.wire_bytes(tt, method, 0.05) == jcomp.wire_bytes(jt, method, 0.05)
    with pytest.raises(ValueError):
        tcomp.wire_bytes(tt, "fp8")


# ---- merges ------------------------------------------------------------------------

# (level, policy keywords): every merge the engine has.
MERGES = [("ALL", {}), ("TWO", {}), ("QUORUM", {}), ("ONE", {}), ("CAUSAL", {}),
          ("TCC", {}), ("X_STCC", {}), ("X_STCC", {"compress_inter_pod": "int8"}),
          ("X_STCC", {"compress_inter_pod": "topk", "topk_fraction": 0.2})]
N_MERGES = 4


def _merge_id(m):
    return "/".join([m[0]] + [str(v) for v in m[1].values()])


def _up_masks(p, n):
    """The ``up`` mask of each merge: all live, then a rotating drop."""
    return [None if i % 2 == 0 else np.arange(p) != (i % p) for i in range(n)]


def _drifts(seed, p):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((p, 6, 5)).astype(np.float32),
             "n": {"b": rng.standard_normal((p, 11)).astype(np.float32),
                   "h": rng.standard_normal((p, 4, 3)).astype(np.float32)}}
            for _ in range(N_MERGES + 1)]


def _reference_merge(eng, params, sync, i, up):
    """The reference's merge of the parameters alone (its bookkeeping is
    held apart, below)."""
    level = eng.policy.level.name
    if level in ("ALL", "TWO", "CAUSAL"):
        return eng._mean_merge(params, up), sync
    if level == "QUORUM":
        return eng._quorum_merge(params, jnp.int32(i), up), sync
    if level == "ONE":
        return eng._gossip_merge(params, up), sync
    return eng._xstcc_merge(params, sync, up)


def _run_reference(level, kw, p, masked):
    """N_MERGES merges of the stacked params (eager JAX), each after a
    seeded drift: the params, anchor and residual after each."""
    drifts = _drifts(7 * p, p)
    params = jax.tree.map(jnp.asarray, drifts[0])
    eng = JEngine(jcons.policy_for(level, delta_steps=2, **kw), p)
    sync = eng.init_state(params)
    out = []
    for i, up in enumerate(_up_masks(p, N_MERGES) if masked else [None] * N_MERGES):
        params = jax.tree.map(lambda x, d: x + d, params,
                              jax.tree.map(jnp.asarray, drifts[i + 1]))
        params, sync = _reference_merge(eng, params, sync, i,
                                        None if up is None else jnp.asarray(up))
        out.append((_tree_np(params), None if sync.anchor is None else _tree_np(sync.anchor),
                    None if sync.residual is None else _tree_np(sync.residual)))
    return out


CASES = [(m, p, masked) for m in MERGES for p in (2, 4) for masked in (False, True)]


@pytest.fixture(scope="module")
def reference_merges():
    return {(_merge_id(m), p, masked): _run_reference(m[0], m[1], p, masked)
            for m, p, masked in CASES}


def _close(got, want, p, what):
    if p == 2:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=P4_RTOL, atol=1e-6, err_msg=what)


def _assert_tree_close(got, want, p, what):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        _close(as_np(g), w, p, f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("merge,p,masked", CASES,
                         ids=[f"{_merge_id(m)}-{p}pods-{'up' if u else 'all'}"
                              for m, p, u in CASES])
def test_merge_matches_reference(reference_merges, merge, p, masked):
    """Each merge of a sequence, from the reference's own previous params,
    anchor and residual (so a four-pod sum's last bit does not carry)."""
    level, kw = merge
    want = reference_merges[(_merge_id(merge), p, masked)]
    drifts = _drifts(7 * p, p)
    eng = TEngine(tcons.policy_for(level, delta_steps=2, **kw), p, device=CPU)
    sync = eng.init_state(_tree_t(drifts[0]))
    ups = _up_masks(p, N_MERGES) if masked else [None] * N_MERGES
    for i, (up, (jparams, janchor, jresid)) in enumerate(zip(ups, want)):
        prev = want[i - 1] if i else (drifts[0], None, None)
        params = jax.tree.map(lambda x, d: _t(np.asarray(x) + d), prev[0], drifts[i + 1])
        if i and janchor is not None:
            sync = sync._replace(anchor=_tree_t(prev[1]),
                                 residual=None if prev[2] is None else _tree_t(prev[2]))
        if i and level == "QUORUM":
            sync = sync._replace(merges=torch.tensor(i, dtype=torch.int32))
        params, sync = eng.merge(params, sync, up)
        _assert_tree_close(params, jparams, p, f"merge {i} params")
        if janchor is not None:
            _assert_tree_close(sync.anchor, janchor, p, f"merge {i} anchor")
        if jresid is not None:
            _assert_tree_close(sync.residual, jresid, p, f"merge {i} residual")


# ---- bookkeeping ---------------------------------------------------------------------

BOOK_LEVELS = ("ALL", "TWO", "QUORUM", "ONE", "CAUSAL", "TCC", "X_STCC")
BOOK_CASES = ([(lv, 2, masked) for lv in BOOK_LEVELS for masked in (False, True)]
              + [(lv, 4, True) for lv in ("QUORUM", "CAUSAL", "X_STCC")])


@pytest.fixture(scope="module")
def reference_bookkeeping():
    """Each case's SyncState after each of N_MERGES merges (the reference's
    ``_bookkeep`` under ``jit``: integer protocol state, no f32 sums)."""
    out = {}
    for level, p, masked in BOOK_CASES:
        eng = JEngine(jcons.policy_for(level, delta_steps=2), p,
                      params_template={"w": jnp.zeros((p, 6, 5), jnp.bfloat16)})
        step = jax.jit(eng._bookkeep, static_argnums=1)
        sync = eng.init_state({"w": jnp.zeros((p, 6, 5))})
        states = []
        for up in _up_masks(p, N_MERGES) if masked else [None] * N_MERGES:
            up = jnp.ones(p, bool) if masked and up is None else up
            sync = step(sync, eng.policy.level, None if up is None else jnp.asarray(up))
            states.append(sync)
        out[(level, p, masked)] = states
    return out


@pytest.mark.parametrize("level,p,masked", BOOK_CASES,
                         ids=[f"{lv}-{p}pods-{'up' if u else 'all'}"
                              for lv, p, u in BOOK_CASES])
def test_bookkeeping_matches_reference(reference_bookkeeping, level, p, masked):
    """``_bookkeep``'s state after a sequence of merges: the store's clocks
    and pending ring, the DUOT, the counters and the severity, exactly."""
    eng = TEngine(tcons.policy_for(level, delta_steps=2), p, device=CPU,
                  params_template={"w": torch.empty((p, 6, 5), dtype=torch.bfloat16,
                                                    device="meta")})
    sync = eng.init_state({"w": torch.zeros((p, 6, 5))})
    ups = _up_masks(p, N_MERGES) if masked else [None] * N_MERGES
    for i, (up, want) in enumerate(zip(ups, reference_bookkeeping[(level, p, masked)])):
        up = np.ones(p, bool) if masked and up is None else up
        sync = eng._bookkeep(sync, eng.policy.level, up)
        assert_tree_equal(want.cluster, sync.cluster, f"merge {i} cluster")
        assert_tree_equal(want.duot, sync.duot, f"merge {i} duot")
        for f in ("merges", "violations", "severity", "inter_pod_gb"):
            np.testing.assert_array_equal(as_np(getattr(sync, f)),
                                          np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("level", ["ALL", "X_STCC"])
def test_one_pod_merge_only_counts(level):
    eng = TEngine(tcons.policy_for(level), 1, device=CPU)
    params = {"w": torch.ones((1, 3))}
    sync = eng.init_state(params)
    out, sync = eng.merge(params, sync)
    assert out is params and int(sync.merges) == 1
    assert int(sync.duot.size) == 0 and int(sync.cluster.clock) == 0


def test_payload_bytes_and_merge_wire_bytes_match_reference():
    shapes = {"a": (3, 64, 32), "b": (3, 7)}
    for level, kw in MERGES:
        jt = {k: jax.ShapeDtypeStruct(s, jnp.bfloat16) for k, s in shapes.items()}
        tt = {k: torch.empty(s, dtype=torch.bfloat16, device="meta")
              for k, s in shapes.items()}
        je = JEngine(jcons.policy_for(level, **kw), 3, params_template=jt)
        te = TEngine(tcons.policy_for(level, **kw), 3, params_template=tt, device=CPU)
        assert te.payload_bytes(tt) == je.payload_bytes(jt)
        assert te.merge_wire_bytes(1000.0) == je.merge_wire_bytes(1000.0)
        assert te._wire_gb == je._wire_gb
