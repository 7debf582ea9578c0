"""The training cell's harness on the CPU at a tiny size, in f32: the
port's first three steps against the plain reference, the control and the
planted faults that the check must catch, and the model's sizes against
the program's configuration.

    python -m pytest -q xbench/tests
"""

from __future__ import annotations

import json
import pathlib
import sys

import pytest
import torch

XBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = XBENCH.parent
for p in (XBENCH, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import faults  # noqa: E402
import run  # noqa: E402
from drivers import train  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# The training cell, found in BENCHMARK.json or, where it is not listed
# there, made from its configuration and mix files.
CELL = {"name": "train.olmoe.xstcc", "config": "olmoe-1b-7b.xstcc2", "traffic": "train_4k",
        "chips": 1}
if not any(c["name"] == CELL["name"] for c in BENCH["workloads"]):
    BENCH = dict(BENCH, workloads=BENCH["workloads"] + [CELL], end_to_end=BENCH["end_to_end"] + [
        {"name": "train_tokens_s", "unit": "tokens/s", "workloads": [CELL["name"]]}],
        per_layer=BENCH["per_layer"] + [
            {"name": n, "unit": u, "moves": "train_tokens_s", "workloads": [CELL["name"]]}
            for n, u in (("mfu.train", "%"), ("local_step_s.train", "s"),
                         ("sync_step_s.train", "s"), ("idle_share.train", "%"))])
TRAIN_CELLS = [CELL["name"]]
# The cell cut to what a test run holds, in f32 so that the port and the
# reference agree to rounding: 2 layers of width 64, 8 experts (top 2),
# 4 x 64 tokens a step.
TINY = {"config": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                       n_experts=8, top_k=2, d_ff=32, vocab_size=512, dtype="float32",
                       limits={"loss_gap": 1e-5, "update_gap": 1e-4}),
        "traffic": dict(seq_len=64, global_batch=4, trace_steps=2)}
SEED = 2 ** 31 + 99


def tiny_run(cell, trace=False):
    return run.run_cell(BENCH, run.cell_of(BENCH, cell), seed=SEED, seconds=1.0, trace=trace,
                        device=torch.device("cpu"), overrides=TINY)


def sized(cell):
    c = run.cell_of(BENCH, cell)
    cfg = json.loads((XBENCH / "configs" / f"{c['config']}.json").read_text())
    traffic = json.loads((XBENCH / "traffic" / f"{c['traffic']}.json").read_text())
    cfg.update(TINY["config"])
    traffic.update(TINY["traffic"])
    return cfg, traffic


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_port_agrees_with_reference(cell, trace):
    out = tiny_run(cell, trace)
    assert out["correct"], out["checks"]
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    want = ({"mfu.train", "local_step_s.train", "sync_step_s.train", "idle_share.train"}
            if trace else {"train_tokens_s", "setup_s"})
    assert set(out["metrics"]) <= want and (trace or set(out["metrics"]) == want)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_control_fails(cell):
    cfg, traffic = sized(cell)
    for seed in (SEED, 5, 6):
        checks = train.control_checks(cfg, traffic, seed, torch.device("cpu"))
        assert any(v > limit for _, v, limit in checks), checks


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_check_catches_fault(fault):
    with faults.planted("train", fault):
        out = tiny_run(TRAIN_CELLS[0])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_sizes_are_the_programs(cell):
    """The configuration's widths are the program's own for the arch, and
    its FLOP count gives OLMoE-1B-7B's active parameters at 4 layers.  The
    norm's epsilon is the published model's, which the benchmark sets."""
    from repro_torch.configs import get_config

    c = run.cell_of(BENCH, cell)
    cfg = json.loads((XBENCH / "configs" / f"{c['config']}.json").read_text())
    program = get_config(cfg["arch"])
    for k in train.MODEL_KEYS + ("n_kv_heads",):
        if k != "norm_eps":
            assert getattr(program, k) == cfg[k], k
    assert cfg["norm_eps"] == cfg["published"]["rms_norm_eps"]
    traffic = json.loads((XBENCH / "traffic" / f"{c['traffic']}.json").read_text())
    tokens = traffic["global_batch"] * traffic["seq_len"]
    attn = 6 * cfg["n_layers"] * traffic["seq_len"] * cfg["n_heads"] * cfg["head_dim"]
    n_active = (train.step_flops(cfg, traffic) / tokens - attn) / 6
    assert 371e6 < n_active < 373e6


def test_wire_bytes_match_program():
    """The reference's billed bytes of one merge against the program's
    analytic count."""
    from repro_torch.core import policy_for
    from repro_torch.sync.engine import SyncEngine

    cfg, _ = sized(TRAIN_CELLS[0])
    weights = train.make_weights(cfg, 1, torch.device("cpu"))
    stacked = {k: v for k, v in weights.items()}
    from repro_torch.tree import tree_map
    stacked = tree_map(lambda x: x[None].expand((cfg["n_pods"],) + tuple(x.shape)), stacked)
    eng = SyncEngine(policy_for("X_STCC", delta_steps=2, compress_inter_pod="int8"),
                     cfg["n_pods"], params_template=stacked, device="cpu")
    assert eng._wire_gb == train.ref.wire_gb(train._leaves(weights), cfg["n_pods"])
