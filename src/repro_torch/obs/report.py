"""Per-run observability reports and the ``repro_torch.obs.report`` CLI
(port of ``repro.obs.report``).

Renders what the obs plane measured — per-level percentile tables,
violation-severity CDFs, counters and the eq. 8 cost attribution — from
result dicts that carry an ``"obs"`` block (``run_protocol*(...,
obs=ObsConfig())``).  Results round-trip through a JSON artifact, so
reports re-render without re-running the engine:

    python -m repro_torch.obs.report artifacts/run.json
    python -m repro_torch.obs.report --selftest              # on the card
    python -m repro_torch.obs.report --selftest --device cpu
"""

from __future__ import annotations

import json
from typing import Any

ARTIFACT_SCHEMA = "repro-obs-report/v1"


# -- artifacts ------------------------------------------------------------


def write_artifact(path, runs: dict[str, dict[str, Any]]) -> None:
    """Persist named run results (underscore keys stripped: engine state
    handles are not JSON)."""
    clean = {
        name: {k: v for k, v in result.items() if not k.startswith("_")}
        for name, result in runs.items()
    }
    with open(path, "w") as f:
        json.dump({"schema": ARTIFACT_SCHEMA, "runs": clean}, f, indent=1)


def load_artifact(path) -> dict[str, dict[str, Any]]:
    with open(path) as f:
        obj = json.load(f)
    if obj.get("schema") != ARTIFACT_SCHEMA:
        raise ValueError(
            f"{path}: schema {obj.get('schema')!r} != {ARTIFACT_SCHEMA!r}"
        )
    return obj["runs"]


# -- bench rows -----------------------------------------------------------


def bench_rows(name: str, result: dict[str, Any]) -> dict[str, float]:
    """The bench rows of one obs-carrying result: ``protocol_p99_<name>``
    (the p99 staleness age) and ``protocol_severity_<name>`` (the p99
    violation severity)."""
    m = result["obs"]["metrics"]
    return {
        f"protocol_p99_{name}": float(m["staleness_age"]["p99"]),
        f"protocol_severity_{name}": float(m["violation_severity"]["p99"]),
    }


# -- rendering ------------------------------------------------------------


def _cdf_points(entry: dict[str, Any], max_points: int = 6) -> list:
    """(edge, cumulative fraction) support points of one histogram."""
    counts = entry["hist"]
    total = entry["count"]
    if total == 0:
        return []
    width = (entry["hi"] - entry["lo"]) / entry["n_bins"]
    points, cum = [], 0
    for i, c in enumerate(counts):
        cum += c
        if c:
            points.append((entry["lo"] + (i + 1) * width, cum / total))
    if len(points) > max_points:
        stride = -(-len(points) // max_points)
        points = points[::stride] + [points[-1]]
    return points


def render(runs: dict[str, dict[str, Any]]) -> str:
    """The human-readable report of named obs-carrying results."""
    lines = ["observability report", "=" * 20, ""]
    named = [(name, r) for name, r in runs.items()
             if isinstance(r, dict) and "obs" in r]
    if not named:
        return "\n".join(lines + ["(no runs carry an obs block)"])

    lines.append("percentiles")
    lines.append(
        f"  {'run':<14} {'metric':<20} {'count':>8} "
        f"{'p50':>9} {'p90':>9} {'p99':>9}"
    )
    for name, r in named:
        for metric, e in r["obs"]["metrics"].items():
            lines.append(
                f"  {name:<14} {metric:<20} {e['count']:>8} "
                f"{e['p50']:>9.1f} {e['p90']:>9.1f} {e['p99']:>9.1f}"
            )
    lines.append("")

    lines.append("violation severity CDF (age -> fraction of violations)")
    for name, r in named:
        pts = _cdf_points(r["obs"]["metrics"]["violation_severity"])
        body = "  ".join(f"<={e:g}: {f:.2f}" for e, f in pts) if pts else "(no violations)"
        lines.append(f"  {name:<14} {body}")
    lines.append("")

    lines.append("counters")
    for name, r in named:
        c = r["obs"]["counters"]
        body = "  ".join(f"{k}={v}" for k, v in sorted(c.items()))
        lines.append(f"  {name:<14} {body}")
    lines.append("")

    lines.append("cost attribution (eq. 8 dollars by subsystem)")
    for name, r in named:
        attr = r["obs"].get("cost_attribution") or {}
        body = "  ".join(f"{k}=${v:.3g}" for k, v in sorted(attr.items()))
        lines.append(f"  {name:<14} {body or '(no cost block)'}")
    lines.append("")

    for name, r in named:
        fve = r["obs"].get("first_violation_epoch")
        if fve is not None:
            lines.append(f"  {name}: first violating epoch = {fve}")
    return "\n".join(lines)


# -- selftest ---------------------------------------------------------------


def selftest(tmpdir=None, n_ops: int = 512, device: str = "cuda") -> str:
    """Obs-on/off identity, a traced replay with a validated Chrome export
    and its launch counts, and a rendered report, end to end on
    ``device``.  Raises on any breach; returns the report."""
    import tempfile
    from pathlib import Path

    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.engine.config import EngineConfig
    from repro_torch.obs import trace as trace_lib
    from repro_torch.obs.metrics import ObsConfig
    from repro_torch.storage.simulator import run_protocol
    from repro_torch.storage.ycsb import WORKLOAD_A

    tmpdir = Path(tmpdir or tempfile.mkdtemp(prefix="obs-selftest-"))
    level = ConsistencyLevel.X_STCC
    kw = dict(n_ops=n_ops, batch_size=128)

    base = run_protocol(level, WORKLOAD_A, device=device, **kw)
    on = run_protocol(level, WORKLOAD_A, device=device, **kw, obs=ObsConfig())
    obs_block = on.pop("obs")
    if base != on:
        raise AssertionError(f"obs=ObsConfig() changed protocol results: {base} != {on}")
    on["obs"] = obs_block

    config = EngineConfig(level, obs=ObsConfig(), **kw)
    result, tracer = trace_lib.traced_run(config, WORKLOAD_A, device=device)
    trace_path = tmpdir / "trace.json"
    tracer.write_chrome(trace_path)
    tracer.write_jsonl(tmpdir / "trace.jsonl")
    events = trace_lib.load_chrome(trace_path)
    names = {e["name"] for e in events}
    for required in ("config", "stages", "execute", "launches"):
        if required not in names:
            raise AssertionError(f"trace missing {required!r} event")
    (launches,) = [e["args"] for e in events if e["name"] == "launches"]
    counts = launches["counts"]
    if launches["device"].startswith("cuda"):
        # One B.1 and one clock-chain launch per round and shard.
        want = launches["rounds"] * launches["shards"]
        got = (counts["op_ingest"], counts["vclock_chain"])
        if got != (want, want):
            raise AssertionError(
                f"replay launched (op_ingest, vclock_chain) = {got}, not {want} each")
    elif any(counts.values()):
        raise AssertionError(f"a CPU replay launched kernels: {counts}")

    artifact = tmpdir / "runs.json"
    write_artifact(artifact, {"flat": on, "traced": result})
    report = render(load_artifact(artifact))
    if "staleness_age" not in report:
        raise AssertionError("report did not render the age table")
    return report


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render observability reports from run artifacts.",
    )
    parser.add_argument(
        "artifacts", nargs="*",
        help="JSON artifacts written by repro_torch.obs.report.write_artifact",
    )
    parser.add_argument(
        "--selftest", action="store_true",
        help="run the obs smoke (identity, trace export, launches, report)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the selftest's replays (default: cuda)",
    )
    args = parser.parse_args(argv)
    if not args.selftest and not args.artifacts:
        parser.error("pass an artifact path or --selftest")
    if args.selftest:
        print(selftest(device=args.device))
        print("\nobs selftest OK")
    for path in args.artifacts:
        print(render(load_artifact(path)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
