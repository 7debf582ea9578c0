"""Port's ReplicatedStore == JAX's: apply_batch + merge traces over
rounds, with the cadence emulated where the engine emulates it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.consistency import ConsistencyLevel as JL
from repro.core.replicated_store import ReplicatedStore as JStore
from repro_torch.core.replicated_store import ReplicatedStore as TStore

from test_torch_xstcc import C, P, Q, R, _batch_result_equal, _ops
from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU, assert_tree_equal, tlevel

torch.set_num_threads(1)


@pytest.mark.parametrize("level", [JL.ALL, JL.X_STCC, JL.CAUSAL])
def test_store_trace_matches(level):
    """apply_batch + merge over rounds, cadence emulated where the engine
    emulates it, the DUOT recorded."""
    emulate = level is not JL.CAUSAL
    js = JStore(P, C, R, level=level, pending_cap=Q, duot_cap=64)
    ts = TStore(P, C, R, level=tlevel(level), pending_cap=Q, duot_cap=64,
                device=CPU)
    jst, tst = js.init(), ts.init()
    rng = np.random.default_rng(7)
    for rd in range(3):
        o = _ops(rng, 24)
        step0 = rd * 24 if emulate else None
        jst, jr = js.apply_batch(jst, **{k: jnp.asarray(v) for k, v in o.items()},
                                 op_step0=step0)
        tst, tr = ts.apply_batch(tst, **{k: torch.from_numpy(v) for k, v in o.items()},
                                 op_step0=step0)
        _batch_result_equal(jr, tr, f"{level} round {rd}")
        jst, _ = js.merge(jst)
        tst, _ = ts.merge(tst)
        assert_tree_equal(jst, tst, f"{level} round {rd}")


@pytest.mark.parametrize("seed", range(3))
def test_compact_pend_timeline_matches_dense_reference(seed):
    """The batch-column timeline == the reference's (b+1, R) one, with
    live slots on resources the batch does not touch and dead slots."""
    from repro_torch import convert
    from torch_port_helpers import jax_to_numpy

    rng = np.random.default_rng(seed)
    n_res = 40
    js = JStore(P, C, n_res, level=JL.X_STCC, pending_cap=Q)
    ts = TStore(P, C, n_res, level=tlevel(JL.X_STCC), pending_cap=Q, device=CPU)
    jst = js.init()
    jst, _ = js.apply_batch(jst, **{k: jnp.asarray(v) for k, v in
                                    _ops(rng, 30, n_res=n_res).items()},
                            op_step0=0)
    tst = convert.store_state_from_numpy(jax_to_numpy(jst), device=CPU)
    b, step0 = 20, 30
    res = rng.integers(0, 12, b).astype(np.int32)          # a subset of R
    pend_apply = rng.integers(step0 - 5, step0 + b + 5, Q).astype(np.int32)
    want = js._pend_timeline(jst, jnp.asarray(res), jnp.asarray(pend_apply),
                             jnp.int32(step0), b)
    got = ts._pend_timeline(tst, torch.from_numpy(res),
                            torch.from_numpy(pend_apply), step0, b)
    assert bool(np.asarray(jst.cluster.pend_live).any())
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
