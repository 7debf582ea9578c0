"""The replay cells' harness on the CPU at a tiny size: the port against
the plain reference, the control and the planted faults that the check
must catch, the result line, and 16,384-op rounds against 4,096-op rounds.

    python -m pytest -q xbench/tests
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

XBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = XBENCH.parent
for p in (XBENCH, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import control  # noqa: E402
import faults  # noqa: E402
import run  # noqa: E402
from drivers import replay  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
REPLAY_CELLS = [c["name"] for c in BENCH["workloads"]
                if json.loads((XBENCH / "configs" / f"{c['config']}.json").read_text())
                ["driver"] == "replay"]
# The cell cut to what a test run holds: 4,000 rows, 20,000 ops in
# rounds of 2,048, the first 2,048 ops audited.
TINY = {"config": {"n_resources": 4000, "batch_size": 2048, "duot_cap": 2048},
        "traffic": {"n_ops": 20000, "trace_rounds": 3}}
SEED = 2 ** 31 + 12345


def tiny_run(cell: str, *, seconds: float = 4.0, trace: bool = False, device="cpu"):
    return run.run_cell(BENCH, run.cell_of(BENCH, cell), seed=SEED, seconds=seconds,
                        trace=trace, device=torch.device(device), overrides=TINY)


def sized(cell: str) -> tuple[dict, dict]:
    c = run.cell_of(BENCH, cell)
    cfg = json.loads((XBENCH / "configs" / f"{c['config']}.json").read_text())
    traffic = json.loads((XBENCH / "traffic" / f"{c['traffic']}.json").read_text())
    cfg.update(TINY["config"])
    traffic.update(TINY["traffic"])
    return cfg, traffic


@pytest.mark.parametrize("cell", REPLAY_CELLS)
def test_port_agrees_with_reference(cell):
    out = run_checked = tiny_run(cell)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in run_checked["checks"].values())
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    out = tiny_run(REPLAY_CELLS[0], trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    assert list(out) == keys + ["checks"]
    want = ({m["name"] for m in run.layer_metrics(BENCH, run.cell_of(BENCH, REPLAY_CELLS[0]))}
            if trace else {"replay_ops_s", "setup_s"})
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", REPLAY_CELLS)
def test_control_fails_every_number(cell):
    cfg, traffic = sized(cell)
    for seed in (SEED, SEED + 1, 7):
        checks = control.control_checks(cfg, traffic, seed)
        assert all(v > limit for _, v, limit in checks), checks


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_check_catches_fault(fault):
    with faults.planted("replay", fault):
        out = tiny_run(REPLAY_CELLS[0])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", REPLAY_CELLS)
def test_batch_16384_equals_4096(cell):
    """A pass's result (rates, severity, reads, dropped writes, bill) does
    not depend on the round size; no write is dropped."""
    cfg, traffic = sized(cell)
    cfg.update(n_resources=5000, duot_cap=4096)
    traffic.update(n_ops=70000)
    results = []
    for b in (4096, 16384):
        drv = replay.Driver(dict(cfg, batch_size=b), traffic, SEED, torch.device("cpu"))
        carry = drv.engine._init_carry(drv.store)
        for i in range(len(drv.rounds)):
            carry = drv._round(carry, i)
        results.append(drv._assemble(carry))
    assert results[0] == results[1]
    assert results[0]["dropped_writes"] == 0
    assert results[0]["n_reads"] == int((drv.stream["kind"] == 0).sum())


def test_snapshot_is_not_mutated():
    """The window holds the carry of its first pass's last round by
    reference: the rounds after it make new tensors and leave it as it
    was."""
    cfg, traffic = sized(REPLAY_CELLS[0])
    drv = replay.Driver(cfg, traffic, SEED, torch.device("cpu"))
    carry = drv.engine._init_carry(drv.store)
    carry = drv._round(carry, 0)
    held = carry
    before = [t.clone() for t in held["st"].cluster] + [held["st"].duot.version.clone()]
    for i in range(1, len(drv.rounds)):
        carry = drv._round(carry, i)
    after = list(held["st"].cluster) + [held["st"].duot.version]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_new_cell_from_new_files(tmp_path):
    """A cell added by new files alone (a traffic mix and a BENCHMARK.json
    entry) runs with no edit to a file the harness has."""
    import shutil
    import subprocess

    shutil.copytree(XBENCH, tmp_path / "xbench", ignore=shutil.ignore_patterns("out",
                                                                                "__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "paper_c.xstcc", "config": "paper-xstcc",
                               "traffic": "paper_c", "chips": 1, "why": "95 % reads"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((XBENCH / "traffic" / "paper_a.json").read_text())
    mix.update(name="paper_c", read_fraction=0.95)
    (tmp_path / "xbench" / "traffic" / "paper_c.json").write_text(json.dumps(mix))
    script = (
        "import json, sys, torch\n"
        "sys.path.insert(0, 'xbench')\n"
        "import run\n"
        "run.fixed_dirs()\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        f"out = run.run_cell(bench, run.cell_of(bench, 'paper_c.xstcc'), seed=5, seconds=2.0,"
        f" trace=False, device=torch.device('cpu'), overrides={TINY!r})\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] > 0


def test_no_card_no_result(capsys):
    """Without a CUDA device a run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", REPLAY_CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_reference_bill_matches_program():
    """The reference's copy of the eq. 5-8 bill against the program's."""
    cfg, traffic = sized(REPLAY_CELLS[0])
    drv = replay.Driver(cfg, traffic, SEED, torch.device("cpu"))
    carry = drv.engine._init_carry(drv.store)
    for i in range(len(drv.rounds)):
        carry = drv._round(carry, i)
    out = drv._assemble(carry)
    want = replay.ref.bill(read_fraction=traffic["read_fraction"], n_operations=traffic["n_ops"],
                           n_threads=cfg["n_clients"], stale_rate=out["staleness_rate"])
    assert all(out["bill"][k] == want[k] for k in out["bill"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", REPLAY_CELLS)
def test_port_agrees_with_reference_on_card(cell, cuda):
    out = tiny_run(cell, device="cuda")
    assert out["correct"], out["checks"]
    assert np.isfinite(out["metrics"]["replay_ops_s"]["value"])


def plain_audit(duot: dict, delta: int) -> dict:
    """The audit by the definition: every ordered pair of entries on one
    resource, happens-before by comparing the whole clocks."""
    ent = np.flatnonzero(duot["valid"])
    n_viol = w_num = w_den = n = 0
    for res in np.unique(duot["resource"][ent]):
        e = ent[duot["resource"][ent] == res]
        e = e[np.argsort(duot["seq"][e])]
        i, j = np.triu_indices(len(e), 1)
        i, j = e[i], e[j]
        vi, vj = duot["vc"][i].astype(np.int64), duot["vc"][j].astype(np.int64)
        hb = (vi <= vj).all(axis=1) & (vi < vj).any(axis=1)
        same = duot["client"][i] == duot["client"][j]
        ki, kj = duot["kind"][i], duot["kind"][j]
        xi, xj = duot["version"][i], duot["version"][j]
        lower, not_higher = xj < xi, xj <= xi
        wr = (ki == 1) & (kj == 0)
        viol = (same & hb & (((ki == 0) & (kj == 0) & lower) | ((ki == 1) & (kj == 1) & not_higher)
                             | (wr & lower) | ((ki == 0) & (kj == 1) & not_higher))
                | (~same & hb & wr & lower))
        timed = wr & ((duot["seq"][j].astype(np.int64) - duot["seq"][i]) > delta) & lower
        other = ~hb & ~wr
        n += len(i)
        n_viol += int(viol.sum() + timed.sum())
        w_num += int(3 * (viol & wr).sum() + 2 * (viol & hb & ~wr).sum()
                     + ((viol | timed) & other).sum())
        w_den += int(3 * wr.sum() + 2 * (hb & ~wr).sum() + other.sum())
    return {"n_audited": n, "n_violations": n_viol,
            "severity": float(np.float32(w_num) / np.float32(max(w_den, 1)))}


@pytest.mark.parametrize("enforce", [True, False])
@pytest.mark.parametrize("read_fraction", [0.5, 0.05])
def test_reference_audit_is_the_definition(enforce, read_fraction, monkeypatch):
    """The reference's audit (happens-before read off one clock component,
    pairs in blocks) equals the audit by its definition, on logs with and
    without session violations."""
    cfg, _ = sized(REPLAY_CELLS[0])
    stream = replay.ycsb.op_stream(n_ops=6144, n_keys=300, n_clients=cfg["n_clients"],
                                   read_fraction=read_fraction, zipf_theta=0.99, seed=SEED,
                                   n_replicas=cfg["n_replicas"])
    rs, _ = replay.replay_reference(dict(cfg, duot_cap=4096), stream, 3,
                                    enforce_sessions=enforce)
    monkeypatch.setattr(replay.ref, "PAIR_BLOCK", 777)
    got = rs.audit()
    assert got == plain_audit(rs.duot, rs.delta)
    assert got["n_violations"] > 0 or enforce
