"""The CUDA kernels against their plain versions on the card.

Marked ``gpu``; each test skips (inside the ``cuda`` fixture) where no
CUDA device is present.  Imports neither JAX nor ``repro``, so it runs
on a machine with only PyTorch:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.consistency import EVAL_LEVELS, ConsistencyLevel
from repro_torch.kernels import ops
from repro_torch.storage import simulator
from repro_torch.storage.ycsb import WORKLOAD_A

pytestmark = pytest.mark.gpu

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_wrappers.json"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(x, dev):
    return torch.as_tensor(np.asarray(x), device=dev)


@pytest.mark.parametrize("b", [1, 8, 128, 129, 1000])
@pytest.mark.parametrize("pending", [False, True])
def test_op_ingest_kernel_matches_plain(cuda, b, pending):
    rng = np.random.default_rng(b)
    kw = dict(
        client=_t(rng.integers(0, 16, b, dtype=np.int32), cuda),
        replica=_t(rng.integers(0, 3, b, dtype=np.int32), cuda),
        resource=_t(rng.integers(0, 24, b, dtype=np.int32), cuda),
        is_write=_t(rng.integers(0, 2, b) > 0, cuda),
        g0=_t(rng.integers(0, 40, b, dtype=np.int32), cuda),
        raw0=_t(rng.integers(0, 40, b, dtype=np.int32), cuda),
        floor0=_t(rng.integers(0, 40, b, dtype=np.int32), cuda),
        op_index=_t(np.arange(b, dtype=np.int32) + 100, cuda),
        apply_index=_t(rng.integers(100, 100 + 2 * b, b, dtype=np.int32), cuda),
    )
    if pending:
        q = 2 * b + 5
        kw.update(
            pend_version=_t(rng.integers(0, 60, q, dtype=np.int32), cuda),
            pend_resource=_t(rng.integers(0, 24, q, dtype=np.int32), cuda),
            pend_live=_t(rng.integers(0, 2, q) > 0, cuda),
            pend_apply=_t(rng.integers(100, 100 + 2 * b, q, dtype=np.int32), cuda),
        )
    got = ops.op_ingest(**kw, impl="cuda")
    want = ops.op_ingest(**kw, impl="torch")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,n", [(100, 16), (2048, 16), (333, 64)])
@pytest.mark.parametrize("delta", [0, 8])
def test_vclock_audit_kernel_matches_plain(cuda, m, n, delta):
    rng = np.random.default_rng(m + n)
    kw = dict(
        vc=_t(rng.integers(0, 25, (m, n), dtype=np.int32), cuda),
        client=_t(rng.integers(0, n, m, dtype=np.int32), cuda),
        kind=_t(rng.integers(0, 2, m, dtype=np.int32), cuda),
        resource=_t(rng.integers(0, 6, m, dtype=np.int32), cuda),
        version=_t(rng.integers(0, 40, m, dtype=np.int32), cuda),
        seq=_t(rng.permutation(m).astype(np.int32), cuda),
        valid=_t(rng.random(m) < 0.9, cuda),
    )
    got = ops.vclock_audit(**kw, delta=delta, impl="cuda")
    want = ops.vclock_audit(**kw, delta=delta, impl="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,c", [(1, 4), (128, 16), (3000, 64)])
def test_vclock_chain_kernel_matches_plain(cuda, b, c):
    rng = np.random.default_rng(b)
    args = (
        _t(rng.integers(0, c, b, dtype=np.int32), cuda),
        _t(rng.integers(0, 3, b, dtype=np.int32), cuda),
        _t(rng.integers(0, 2, b, dtype=np.int32), cuda),
        _t(rng.integers(0, 30, (c, c), dtype=np.int32), cuda),
        _t(rng.integers(0, 30, (3, c), dtype=np.int32), cuda),
    )
    got = ops.vclock_chain(*args, impl="cuda")
    want = ops.vclock_chain(*args, impl="torch")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("level", EVAL_LEVELS, ids=lambda lv: lv.name)
def test_golden_protocol_case_on_the_card(cuda, level):
    golden = json.loads(GOLDEN.read_text())[f"protocol/{level.name}"]
    ops.reset_launch_counts()
    got = simulator.run_protocol(level, WORKLOAD_A, n_ops=600, device=cuda)
    assert got == golden
    counts = ops.launch_counts()
    assert counts["op_ingest"] > 0 and counts["vclock_audit"] == 1
    assert counts["vclock_chain"] == counts["op_ingest"]


def test_entry_points_default_to_the_card(cuda):
    got = simulator.run_protocol(ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=300)
    want = simulator.run_protocol(ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=300,
                                  device="cpu")
    assert got == want
