"""Port's plain op_ingest == ``ref.op_ingest_ref`` == the interpreted
Pallas kernel, bit for bit; the kernel's packed layout is inert."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import op_ingest_ref as j_ref
from repro_torch.kernels import op_ingest as oi
from repro_torch.kernels import ops

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(1)

CADENCES = ("scalar", "apply0", "emulated_pending")


def _inputs(seed, b, cadence):
    """Numpy inputs; ``emulated_pending`` adds emulated apply points and a
    live pending ring, ``apply0`` the merge-every-op cadence."""
    rng = np.random.default_rng(seed)
    i32 = lambda x: np.asarray(x, np.int32)              # noqa: E731
    kw = dict(
        client=i32(rng.integers(0, 6, b)), replica=i32(rng.integers(0, 3, b)),
        resource=i32(rng.integers(0, 5, b)),
        is_write=rng.integers(0, 2, b).astype(bool),
        g0=i32(rng.integers(0, 40, b)), raw0=i32(rng.integers(0, 40, b)),
        floor0=i32(rng.integers(0, 40, b)),
    )
    step0 = int(rng.integers(0, 500))
    if cadence == "apply0":
        kw["op_index"] = i32(step0 + np.arange(b))
        kw["apply_index"] = i32(np.zeros(b))
    elif cadence == "emulated_pending":
        q = 24
        kw["op_index"] = i32(step0 + np.arange(b))
        kw["apply_index"] = i32(step0 + rng.integers(0, 2 * b, b))
        kw.update(
            pend_version=i32(rng.integers(0, 60, q)),
            pend_resource=i32(rng.integers(0, 5, q)),
            pend_live=rng.integers(0, 2, q).astype(bool),
            pend_apply=i32(step0 + rng.integers(0, 2 * b, q)),
        )
    return kw


def _port(kw, **extra):
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    return [x.numpy() for x in ops.op_ingest(**tkw, **extra)]


def _unpacked_ref(packed):
    """Plain version applied to the kernel's padded inputs, sliced back:
    what the CUDA kernel computes, row for row."""
    m, p, b = packed
    out = oi.op_ingest_ref(
        m[:, oi.CLIENT], m[:, oi.REPLICA], m[:, oi.RESOURCE],
        m[:, oi.IS_WRITE] > 0, m[:, oi.GLOBAL0], m[:, oi.RAW0], m[:, oi.FLOOR0],
        op_index=m[:, oi.OPIDX], apply_index=m[:, oi.APPLYIDX],
        pend_version=p[:, oi.PVER], pend_resource=p[:, oi.PRES],
        pend_live=p[:, oi.PLIVE] > 0, pend_apply=p[:, oi.PAPPLY],
    )
    return [x[:b].numpy() for x in out]


@pytest.mark.parametrize("cadence", CADENCES)
@pytest.mark.parametrize("b", [1, 37, 128, 300])
def test_plain_matches_reference_and_pallas(b, cadence):
    kw = _inputs(b * 7 + len(cadence), b, cadence)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    want = [np.asarray(x) for x in j_ref(**jkw)]
    got = _port(kw)
    for name, w, g in zip(("occ", "raw", "floor"), want, got):
        np.testing.assert_array_equal(w, g, err_msg=f"{name} vs ref")
        assert g.dtype == np.int32
    pallas = jops.op_ingest(**jkw, impl="pallas", interpret=True)
    for name, w, g in zip(("occ", "raw", "floor"), pallas, got):
        np.testing.assert_array_equal(np.asarray(w), g, err_msg=f"{name} vs pallas")


@pytest.mark.parametrize("cadence", CADENCES)
@pytest.mark.parametrize("b", [1, 127, 128, 129, 300])
def test_packed_padding_is_inert(b, cadence):
    kw = _inputs(b + 1000, b, cadence)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    packed = oi.pack_ops(**ops_defaults(tkw))
    assert packed.meta.shape[0] % oi.TILE == 0
    assert packed.pend.shape[0] % 8 == 0
    for w, g in zip(_port(kw), _unpacked_ref(packed)):
        np.testing.assert_array_equal(w, g)


def ops_defaults(tkw):
    """The op-index default ``ops.op_ingest`` fills before packing."""
    if "op_index" not in tkw and ("apply_index" in tkw or "pend_apply" in tkw):
        tkw = {**tkw, "op_index": torch.zeros_like(tkw["client"])}
    return tkw


def test_dispatch_rules():
    kw = {k: torch.from_numpy(v) for k, v in _inputs(0, 9, "scalar").items()}
    assert ops.resolve_impl("auto", kw["client"]) == "torch"
    assert ops.resolve_impl(None, kw["client"]) == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        ops.op_ingest(**kw, impl="cuda")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.op_ingest(**kw, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        oi.op_ingest_cuda(oi.pack_ops(**kw))
    before = ops.launch_counts()
    ops.op_ingest(**kw)
    assert ops.launch_counts() == before        # the plain version launches nothing


@pytest.mark.parametrize("bp,qp", [(128, 8), (256, 264), (1024, 2056), (4096, 8200)])
def test_ingest_plan_covers_every_pair_once(bp, qp):
    """Per 32-row tile, the warps' batch slices cut [0, 32 (t + 1)) and the
    pending slices cut [0, qp), disjoint: every (i, j < i) pair and every
    (row, pending slot) pair is tested by exactly one warp."""
    plan = oi.ingest_plan(bp, qp)
    assert plan.shape == (bp // oi.ROWS, oi.WARPS, 4) and plan.dtype == torch.int32
    for t in range(bp // oi.ROWS):
        batch = np.zeros(oi.ROWS * (t + 1), np.int64)
        pend = np.zeros(qp, np.int64)
        for lo, hi, plo, phi in plan[t].tolist():
            batch[lo:hi] += 1
            pend[plo:phi] += 1
        assert (batch == 1).all() and (pend == 1).all()


@pytest.mark.parametrize("cadence", CADENCES)
@pytest.mark.parametrize("b", [1, 127, 128, 129, 300])
def test_chunked_twin_matches_reference(b, cadence):
    """Partials per plan entry, combined by add and max, equal the plain
    version and the JAX ``ref.op_ingest_ref`` bit for bit."""
    kw = _inputs(b * 13 + len(cadence), b, cadence)
    tkw = ops_defaults({k: torch.from_numpy(v) for k, v in kw.items()})
    got = [x.numpy() for x in oi.op_ingest_chunked(oi.pack_ops(**tkw))]
    want = [np.asarray(x) for x in j_ref(**{k: jnp.asarray(v) for k, v in kw.items()})]
    for name, w, g, p in zip(("occ", "raw", "floor"), want, got, _port(kw)):
        np.testing.assert_array_equal(w, g, err_msg=f"{name} vs ref")
        np.testing.assert_array_equal(p, g, err_msg=f"{name} vs plain")
