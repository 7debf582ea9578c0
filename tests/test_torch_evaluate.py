"""Port's ``evaluate_level`` == JAX's in every ``LevelMetrics`` field
(cost dict included), for both paper workloads and all six levels."""

import dataclasses

import pytest
import torch

from repro.storage import simulator as jsim
from repro.storage import ycsb as jycsb
from repro_torch.core.consistency import EVAL_LEVELS
from repro_torch.storage import simulator as tsim
from repro_torch.storage import ycsb as tycsb

from torch_port_helpers import CPU, jlevel

torch.set_num_threads(1)


@pytest.mark.parametrize("level", EVAL_LEVELS, ids=lambda lv: lv.name)
@pytest.mark.parametrize("wname", ["WORKLOAD_A", "WORKLOAD_B"])
def test_evaluate_level_matches_reference(wname, level):
    want = jsim.evaluate_level(jlevel(level), getattr(jycsb, wname), engine_ops=600)
    got = tsim.evaluate_level(level, getattr(tycsb, wname), engine_ops=600,
                              device=CPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_models_match_reference():
    """The closed-form latency, throughput and traffic models alone."""
    for level in EVAL_LEVELS:
        jl = jlevel(level)
        for stale in (0.0, 0.17, 0.6):
            for kind in ("read", "write"):
                assert tsim.op_latency_ms(level, kind, tsim.PAPER_CLUSTER, stale) == \
                    jsim.op_latency_ms(jl, kind, jsim.PAPER_CLUSTER, stale)
            for n_threads in (16, 64, 100):
                assert tsim.throughput_model(
                    level, tycsb.WORKLOAD_A, n_threads, tsim.PAPER_CLUSTER, stale
                ) == jsim.throughput_model(
                    jl, jycsb.WORKLOAD_A, n_threads, jsim.PAPER_CLUSTER, stale)
            assert tsim.traffic_gb(level, tycsb.WORKLOAD_B, 10 ** 6,
                                   tsim.PAPER_CLUSTER, stale) == \
                jsim.traffic_gb(jl, jycsb.WORKLOAD_B, 10 ** 6,
                                jsim.PAPER_CLUSTER, stale)
