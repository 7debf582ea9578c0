"""Port's span tracer and report == JAX's: Chrome and JSONL export round
trips, ``validate_chrome``'s rejections, ``stage_flags`` and
``config_hash`` on the same configurations, ``traced_run`` (its result
equals ``EpochEngine.run``'s, and its ``launches`` instant takes the
place of the reference's ``jit_entries``), ``render`` / ``bench_rows``
on the same result dicts, artifacts, and the report CLI's selftest."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.core import availability as jav
from repro.core.replicated_store import DurabilityConfig as JDura
from repro.engine import EngineConfig as JConfig
from repro.geo import topology as jtopo
from repro.gossip.scheduler import GossipConfig as JGossip
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro.obs.metrics import ObsConfig as JObs
from repro_torch.core import availability as tav
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.replay import EpochEngine
from repro_torch.geo import topology as ttopo
from repro_torch.gossip.scheduler import GossipConfig
from repro_torch.obs import report, trace
from repro_torch.obs.metrics import ObsConfig
from repro_torch.storage import simulator as tsim
from repro_torch.storage.ycsb import WORKLOAD_A

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU, jlevel

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _configs(which: str):
    """(reference, port) EngineConfig pairs of one feature mix."""
    def make(cfg, level, av, topo, dura, gossip, obs):
        kw = {
            "flat": dict(),
            "lean": dict(lean=True, audit=False),
            "crash_wal": dict(faults=av.replica_crash(6, 3, 1, 2, 2),
                              durability=dura(snapshot_every=2, wal=True)),
            "geo_faults": dict(topology=topo.PAPER_TOPOLOGY, faults=av.all_up(4, 3),
                               gossip=gossip(cadence=2, hint_cap=4), obs=obs()),
            "sharded_snap": dict(n_shards=2, faults=av.replica_outage(4, 3, 0, 1, 2),
                                 durability=dura(snapshot_every=3)),
            "geo_gossip": dict(topology=topo.PAPER_TOPOLOGY, gossip=gossip(cadence=1)),
        }[which]
        return cfg(level, n_ops=512, **kw)

    return (make(JConfig, jlevel(TL.X_STCC), jav, jtopo, JDura, JGossip, JObs),
            make(EngineConfig, TL.X_STCC, tav, ttopo, DurabilityConfig, GossipConfig,
                 ObsConfig))


MIXES = ("flat", "lean", "crash_wal", "geo_faults", "sharded_snap", "geo_gossip")


@pytest.mark.parametrize("which", MIXES)
def test_stage_flags_match_reference(which):
    jc, tc = _configs(which)
    assert trace.stage_flags(tc) == jtrace.stage_flags(jc)
    assert trace.config_hash(tc) == trace.config_hash(_configs(which)[1])
    assert len(trace.config_hash(tc)) == 16


def test_tracer_round_trips_chrome_and_jsonl(tmp_path):
    t = trace.Tracer("rt")
    with t.span("outer", k=1):
        t.instant("mark", epoch=3)
    t.write_chrome(tmp_path / "t.json")
    t.write_jsonl(tmp_path / "t.jsonl")
    events = trace.load_chrome(tmp_path / "t.json")
    assert [e["name"] for e in events] == ["mark", "outer"]
    assert events[1]["ph"] == "X" and events[1]["dur"] >= 0
    assert events[0]["args"] == {"epoch": 3} and events[0]["s"] == "g"
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in lines] == events
    other = json.loads((tmp_path / "t.json").read_text())["otherData"]
    assert other == {"schema": trace.TRACE_SCHEMA, "run_id": "rt"}
    # The reference's validator accepts the port's export.
    assert jtrace.validate_chrome(t.chrome()) == events


@pytest.mark.parametrize("bad", [
    [],
    {"events": []},
    {"traceEvents": [{"name": "x", "ph": "i", "ts": 0, "pid": 1}]},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 1, "tid": 1}]},
], ids=["not_a_dict", "no_events", "missing_tid", "span_without_dur"])
def test_validate_chrome_rejects_malformed(bad):
    for mod in (trace, jtrace):
        with pytest.raises(ValueError):
            mod.validate_chrome(bad)


@pytest.mark.parametrize("which", ["flat", "crash_wal", "sharded_snap"])
def test_traced_run_equals_run_and_counts_launches(which):
    _, tc = _configs(which)
    want = EpochEngine(tc, device=CPU).run(WORKLOAD_A)
    got, tracer = trace.traced_run(tc, WORKLOAD_A, device=CPU)
    assert got == want
    events = trace.validate_chrome(tracer.chrome())
    names = [e["name"] for e in events]
    assert names == ["config", "stages", "prepare", "execute", "launches", "assemble"]
    (launches,) = [e["args"] for e in events if e["name"] == "launches"]
    engine = EpochEngine(tc, device=CPU)
    sub, rem, n_rounds, _ = engine.plan()
    assert launches["rounds"] == n_rounds + (1 if rem else 0)
    assert launches["shards"] == tc.n_shards and launches["device"] == "cpu"
    # The plain versions launch nothing.
    assert set(launches["counts"]) >= {"op_ingest", "vclock_chain", "digest_compare"}
    assert not any(launches["counts"].values())
    assert events[1]["args"] == trace.stage_flags(tc)


def _obs_results():
    kw = dict(n_ops=512, batch_size=128, device=CPU, obs=ObsConfig())
    return {
        "flat": tsim.run_protocol(TL.X_STCC, WORKLOAD_A, **kw),
        "faulty": tsim.run_protocol_faulty(
            TL.TCC, WORKLOAD_A, schedule=tav.replica_crash(4, 3, 1, 1, 1),
            recovery=DurabilityConfig(snapshot_every=2, wal=True),
            gossip=GossipConfig(cadence=1, hint_cap=4), **kw),
        "causal": tsim.run_protocol(TL.CAUSAL, WORKLOAD_A, **kw),
        "no_obs": {"staleness_rate": 0.0},
    }


def test_render_and_bench_rows_match_reference(tmp_path):
    runs = _obs_results()
    assert report.render(runs) == jreport.render(runs)
    assert "first violating epoch" in report.render(runs)
    assert report.render({"x": {}}) == jreport.render({"x": {}})
    for name in ("flat", "faulty"):
        assert report.bench_rows(name, runs[name]) == jreport.bench_rows(name, runs[name])
    # Artifacts round-trip (underscore keys dropped) and read across packages.
    runs["faulty"]["_state"] = object()
    report.write_artifact(tmp_path / "a.json", runs)
    back = jreport.load_artifact(tmp_path / "a.json")
    assert "_state" not in back["faulty"] and set(back) == set(runs)
    assert report.render(back) == jreport.render(back)
    bad = tmp_path / "b.json"
    bad.write_text(json.dumps({"schema": "other", "runs": {}}))
    with pytest.raises(ValueError, match="schema"):
        report.load_artifact(bad)


def test_report_cli_selftest_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", "--selftest", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "obs selftest OK" in out.stdout and "staleness_age" in out.stdout
    report.write_artifact(tmp_path / "r.json", {"flat": _obs_results()["flat"]})
    assert report.main([str(tmp_path / "r.json")]) == 0
    with pytest.raises(SystemExit):
        report.main([])
