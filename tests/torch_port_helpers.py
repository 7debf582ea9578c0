"""Shared helpers of the ``test_torch_*`` files: move state between the
JAX reference and the PyTorch port as numpy arrays, and compare it.
Imports JAX's package only inside the helpers that need it, so that
``test_torch_gpu.py`` can use the rest on a machine without JAX."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.consistency import ConsistencyLevel as TLevel

CPU = "cpu"


def jlevel(level: TLevel):
    from repro.core.consistency import ConsistencyLevel as JLevel

    return JLevel[level.name]


def tlevel(level) -> TLevel:
    return TLevel[level.name]


def jax_to_numpy(tree) -> dict:
    """``{field: np.ndarray}`` of a JAX NamedTuple (nested for StoreState;
    ``None`` fields are left out)."""
    out = {}
    for f in tree._fields:
        v = getattr(tree, f)
        if v is None:
            continue
        out[f] = jax_to_numpy(v) if isinstance(v, tuple) else np.asarray(v)
    return out


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_tree_equal(want, got, context: str = "") -> None:
    """Every field of a JAX NamedTuple equals the port's (dtype-blind
    values, exact)."""
    for f in want._fields:
        w = getattr(want, f)
        if w is None:
            continue
        g = getattr(got, f)
        if isinstance(w, tuple):
            assert_tree_equal(w, g, f"{context}.{f}")
            continue
        np.testing.assert_array_equal(
            np.asarray(w), as_np(g), err_msg=f"{context}.{f} diverged"
        )


# The geo path's one stated tolerance: the reference adds f32 RTTs in an
# order XLA picks, the port forms the same sums exactly from op counts.
GEO_LATENCY_RTOL = 1e-5


def as_lists(x):
    """``x`` with every tuple turned into a list (as JSON gives it back)."""
    if isinstance(x, dict):
        return {k: as_lists(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_lists(v) for v in x]
    return x


def geo_mismatches(want, got, path: str = "") -> list[str]:
    """Fields of a geo result that differ from the reference's (tuples
    and lists alike): exact everywhere except ``mean_latency_ms`` (and
    its per-region list), held within ``GEO_LATENCY_RTOL``."""
    if isinstance(want, dict) and isinstance(got, dict):
        if set(want) != set(got):
            return [f"{path}: keys {sorted(set(want) ^ set(got))}"]
        return [m for k in sorted(want)
                for m in geo_mismatches(want[k], got[k], f"{path}.{k}")]
    if path.endswith("mean_latency_ms"):
        a, b = (v if isinstance(v, list) else [v] for v in (want, got))
        if len(a) != len(b) or not np.allclose(a, b, rtol=GEO_LATENCY_RTOL, atol=0):
            return [f"{path}: {want} vs {got}"]
        return []
    return [] if as_lists(want) == as_lists(got) else [f"{path}: {want} != {got}"]


def placement_inputs(rng, r: int, device):
    """Planner inputs at R resources: the paper topology's 124 candidate
    tables with every 17th candidate invalid and every 9th a copy of its
    left neighbour (tied utilities), demand counts with every 5th row
    zero and every 3rd row scaled to non-integers."""
    from repro_torch.geo import placement as pl
    from repro_torch.geo.topology import PAPER_TOPOLOGY

    tabs = pl.candidate_tables(PAPER_TOPOLOGY, pl.enumerate_candidates(3),
                               resource_gb=1.0 / max(1, r))
    rp, wp, rtt = (tabs[k].copy() for k in ("read_price", "write_price", "read_rtt"))
    meta = tabs["cand_meta"].copy()
    dup = np.arange(1, rp.shape[0], 9)
    for t in (rp, wp, rtt):
        t[dup] = t[dup - 1]
    meta[:, dup] = meta[:, dup - 1]
    meta[1, ::17] = 0.0
    reads = rng.integers(0, 6, (r, 3)).astype(np.float32)
    writes = rng.integers(0, 6, (r, 3)).astype(np.float32)
    reads[::3] *= rng.random(reads[::3].shape).astype(np.float32)
    reads[::5] = 0.0
    writes[::5] = 0.0
    return tuple(torch.as_tensor(x, device=device)
                 for x in (reads, writes, rp, wp, rtt, meta))


def policy_inputs(rng, s: int, device, *, levels=None):
    """``policy_score`` inputs at S sessions over the six policy levels'
    table (CAUSAL's and ONE's data age is inf): SLA_STRICT and
    SLA_RELAXED rows mixed, read fractions with exact 0 and 1, inf latency
    and age bounds on some rows, every 17th row invalid, a quarter of the
    cells unobserved (count 0), and rates formed as the controller forms
    them (f32 count ratios)."""
    from repro_torch.policy import sla

    table = sla.level_table(levels or sla.POLICY_LEVELS, device="cpu")
    n_levels = table.shape[1]
    strict = sla.session_params(sla.SLA_STRICT, s, device="cpu").numpy()
    relaxed = sla.session_params(sla.SLA_RELAXED, s, device="cpu").numpy()
    sess = np.where((rng.random(s) < 0.5)[:, None], strict, relaxed)
    rf = rng.random(s).astype(np.float32)
    rf[::7] = 0.0
    rf[3::7] = 1.0
    sess[:, sla.SP_READ_FRAC] = rf
    sess[::11, sla.SP_MAX_LAT] = np.inf
    sess[5::13, sla.SP_MAX_AGE] = np.inf
    sess[::17, sla.SP_VALID] = 0.0
    reads = rng.integers(0, 200, (s, n_levels))
    reads[rng.random((s, n_levels)) < 0.25] = 0
    denom = np.maximum(reads, 1).astype(np.float32)
    stale = (rng.integers(0, 201, (s, n_levels)) * reads // 200).astype(np.float32) / denom
    viol = (rng.integers(0, 21, (s, n_levels)) * reads // 200).astype(np.float32) / denom
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=device)
                 for x in (sess, table.numpy(), stale, viol, reads.astype(np.float32)))


# The adaptive path's one stated tolerance: the reference sums the (E, S)
# per-epoch f32 costs in f32, in an order XLA picks; the port sums the
# same (bit-equal) costs in f64.
ADAPTIVE_COST_RTOL = 1e-6


def adaptive_mismatches(want: dict, got: dict) -> list[str]:
    """Fields of a ``run_protocol_adaptive`` result that differ from the
    reference's: ``adaptive.cost`` within ``ADAPTIVE_COST_RTOL``, the
    ``choice`` array and every other field exact."""
    bad = []
    if set(want) != set(got):
        return [f"keys {sorted(set(want) ^ set(got))}"]
    for k in want:
        if k == "choice":
            if not np.array_equal(np.asarray(want[k]), np.asarray(got[k])):
                bad.append("choice")
        elif k == "adaptive":
            a, b = want[k], got[k]
            if set(a) != set(b):
                bad.append(f"adaptive keys {sorted(set(a) ^ set(b))}")
                continue
            for kk in a:
                if kk == "cost":
                    if not np.isclose(a[kk], b[kk], rtol=ADAPTIVE_COST_RTOL, atol=0):
                        bad.append(f"adaptive.cost: {a[kk]} vs {b[kk]}")
                elif a[kk] != b[kk]:
                    bad.append(f"adaptive.{kk}: {a[kk]} != {b[kk]}")
        elif want[k] != got[k]:
            bad.append(f"{k}: {want[k]} != {got[k]}")
    return bad
