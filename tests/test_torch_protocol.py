"""Port's ``run_protocol`` == the golden ``protocol/*`` cases and the live
JAX reference; the lean replay == JAX's lean replay."""

import pytest
import torch

from golden_bridge import load_golden
from repro.engine import EngineConfig as JConfig
from repro.engine import EpochEngine as JEngine
from repro.engine import results as jresults
from repro.storage import simulator as jsim
from repro.storage import ycsb as jycsb
from repro_torch.core.consistency import EVAL_LEVELS
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.engine import results as tresults
from repro_torch.engine.config import EngineConfig as TConfig
from repro_torch.engine.replay import EpochEngine as TEngine
from repro_torch.storage import simulator as tsim
from repro_torch.storage import ycsb as tycsb

from torch_port_helpers import CPU, jlevel

torch.set_num_threads(1)

GOLDEN_KWARGS = {
    **{f"protocol/{lv.name}": (lv, dict(n_ops=600)) for lv in EVAL_LEVELS},
    "protocol/X_STCC/alt": (TL.X_STCC, dict(
        n_ops=640, batch_size=64, merge_every=4, delta=12, seed=3, audit=False,
    )),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_KWARGS))
def test_golden_protocol_case(case):
    level, kw = GOLDEN_KWARGS[case]
    got = tsim.run_protocol(level, tycsb.WORKLOAD_A, device=CPU, **kw)
    assert got == load_golden()[case]


@pytest.mark.parametrize("level", [TL.CAUSAL, TL.X_STCC])
def test_live_reference_at_a_new_seed(level):
    kw = dict(n_ops=900, seed=17, n_resources=40, duot_cap=512)
    want = jsim.run_protocol(jlevel(level), jycsb.WORKLOAD_A, **kw)
    got = tsim.run_protocol(level, tycsb.WORKLOAD_A, device=CPU, **kw)
    assert got == want
    assert got["staleness_rate"] > 0.0


@pytest.mark.parametrize("level", [TL.X_STCC, TL.QUORUM])
def test_lean_replay_matches_reference(level):
    kw = dict(n_ops=1000, batch_size=256, audit=False, lean=True, seed=2)
    jc = JConfig(jlevel(level), **kw)
    want = jresults.assemble(jc, JEngine(jc).replay(jycsb.WORKLOAD_A),
                             jycsb.WORKLOAD_A)
    tc = TConfig(level, **kw)
    got = tresults.assemble_flat(tc, TEngine(tc, device=CPU).replay(tycsb.WORKLOAD_A))
    assert got == want


def test_engine_round_counts():
    """Rounds of the plan: 46 full X_STCC batches + a 112-op tail at the
    defaults; CAUSAL batches at its merge period."""
    tc = TConfig(TL.X_STCC)
    assert TEngine(tc, device=CPU).plan() == (128, 112, 46, True)
    assert TEngine(TConfig(TL.CAUSAL), device=CPU).plan() == (8, 0, 750, False)
