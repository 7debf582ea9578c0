"""Port's op stream, cadence plan and apply-point schedule == JAX's."""

import numpy as np
import pytest
import torch

from repro.core.replicated_store import ReplicatedStore as JStore
from repro.core.replicated_store import merge_cadence as j_merge_cadence
from repro.engine import stream as jstream
from repro.storage import ycsb as jycsb
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import ReplicatedStore as TStore
from repro_torch.core.replicated_store import merge_cadence
from repro_torch.engine import stream as tstream
from repro_torch.storage import ycsb as tycsb

from torch_port_helpers import jlevel

torch.set_num_threads(1)

WORKLOADS = ("WORKLOAD_A", "WORKLOAD_B", "WORKLOAD_C")


@pytest.mark.parametrize("wname", WORKLOADS)
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_ycsb_generate_matches(wname, seed):
    want = jycsb.generate(getattr(jycsb, wname), n_ops=5000, n_keys=97, seed=seed)
    got = tycsb.generate(getattr(tycsb, wname), n_ops=5000, n_keys=97, seed=seed)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k])
        assert want[k].dtype == got[k].dtype


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_op_stream_matches(seed):
    for n_res in (24, 1 << 12):
        want = jstream.op_stream(jycsb.WORKLOAD_A, 3000, 16, n_res, seed)
        got = tstream.op_stream(tycsb.WORKLOAD_A, 3000, 16, n_res, seed)
        for k in jstream.OP_COLS:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
            assert got[k].dtype == np.int32


@pytest.mark.parametrize("level", list(TL))
def test_cadence_plan_and_merge_cadence_match(level):
    for merge_every, delta in ((8, 24), (4, 12), (3, 1)):
        assert merge_cadence(level, merge_every, delta) == j_merge_cadence(
            jlevel(level), merge_every, delta)
        for n_ops, b in ((600, 128), (640, 64), (6000, 128), (5, 128)):
            assert tstream.cadence_plan(level, n_ops, b, merge_every, delta) == \
                jstream.cadence_plan(jlevel(level), n_ops, b, merge_every, delta)


@pytest.mark.parametrize("level", [TL.X_STCC, TL.TCC, TL.CAUSAL, TL.ONE])
@pytest.mark.parametrize("seed", [0, 5])
def test_schedule_stream_matches(level, seed):
    s = tstream.op_stream(tycsb.WORKLOAD_A, 2000, 16, 24, seed)
    for merge_every, delta in ((8, 24), (4, 12)):
        jst = JStore(3, 16, 24, level=jlevel(level), merge_every=merge_every,
                     delta=delta)
        tst = TStore(3, 16, 24, level=level, merge_every=merge_every,
                     delta=delta, device="cpu")
        want = np.asarray(jst.schedule_stream(s["client"], s["home"], s["kind"]))
        got = tst.schedule_stream(s["client"], s["home"], s["kind"])
        np.testing.assert_array_equal(want, got)
        assert got.dtype == np.int32


@pytest.mark.parametrize("level", [TL.X_STCC, TL.CAUSAL, TL.ALL])
def test_batch_inputs_match(level):
    s = tstream.op_stream(tycsb.WORKLOAD_B, 700, 16, 24, 2)
    plan = tstream.cadence_plan(level, 700, 128, 8, 24)
    sub, rem, n_rounds, emulate = plan
    jst = JStore(3, 16, 24, level=jlevel(level))
    tst = TStore(3, 16, 24, level=level, device="cpu")
    jb, jt = jstream.batch_inputs(s, jst, sub, n_rounds, rem, emulate)
    tb, tt = tstream.batch_inputs(s, tst, sub, n_rounds, rem, emulate)
    assert set(tb) == set(jb) - {"step0"}
    for k in tb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(jt[k]), tt[k], err_msg=k)
