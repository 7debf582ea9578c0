"""Run one cell of the benchmark once, and print its result as the last
line of standard output.

    python3 xbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json`` at the
root of the checkout: the cell's configuration (``xbench/configs/<config>
.json``, whose ``driver`` names ``xbench/drivers/<driver>.py``), its
traffic mix (``xbench/traffic/<traffic>.json``) and, with ``--trace 1``,
one reader per per-layer metric (``xbench/metrics/<metric>.py``).

A run is set-up (imports, the CUDA context, the kernels' libraries, the
inputs made from the seed, the warm-up), the measured window of
``--seconds``, then the check of what the window produced against the plain
reference in ``xbench/reference/``, after the device's peak memory is read
and the program's state freed.  ``--trace 1`` records the harness's spans
and a profiler session over part of the window, and reports the per-layer
metrics in place of the end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names the measured process may never hold: the JAX
# package the port was made from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fixed_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds."""
    cache = HERE / "out" / "cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (HERE, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def log(msg: str) -> None:
    print(f"xbench: {msg}", file=sys.stderr, flush=True)


def load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"xbench: no workload {name!r} in BENCHMARK.json")


def layer_metrics(bench: dict, cell: dict) -> list[dict]:
    """The per-layer metrics this cell reports: each per-layer metric lists
    the cells it is read in."""
    return [m for m in bench["per_layer"] if cell["name"] in m["workloads"]]


def e2e_metrics(bench: dict, cell: dict) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def run_cell(bench: dict, cell: dict, *, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None) -> dict:
    """One run of ``cell`` on ``device``: the result line as a dict.
    ``overrides`` ({"config": {...}, "traffic": {...}}) resizes a cell for
    a test on the CPU."""
    import torch

    from lib import trace as trace_lib

    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    if overrides:
        config.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
    driver = load(HERE / "drivers" / f"{config['driver']}.py", f"xbench_driver_{config['driver']}")
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", 0)
    spans = trace_lib.Spans()
    profiler = trace_lib.Profiler(spans) if trace else None
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    drv = driver.Driver(config, traffic, seed, device)
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s")
    win = drv.window(seconds, spans, profiler)
    if profiler is not None:
        profiler.read()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    log(f"window {win['window_s']:.3f} s, {win['attempted']} attempted, peak {peak} B")
    shape = drv.trace_shape()
    t0 = time.perf_counter()
    drv.release()
    checks = drv.check()
    log(f"check {time.perf_counter() - t0:.3f} s")
    correct = all(v <= limit for _, v, limit in checks)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    metrics = {}
    breakdown = None
    if not trace:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in e2e_metrics(bench, cell):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        rec = {"trace": profiler.record, "spans": spans.seconds, "shape": shape,
               "window_s": win["window_s"], "counts": win}
        for m in layer_metrics(bench, cell):
            reader = load(HERE / "metrics" / f"{m['name']}.py", "xbench_metric")
            value = reader.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if profiler.record is not None:
            dev["busy_s"] = trace_lib.busy_seconds(profiler.record)
            dev["window_s"] = trace_lib.window_seconds(profiler.record)
            breakdown = trace_lib.breakdown(profiler.record)
    out = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_dirs()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_of(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"xbench: {args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    result = run_cell(bench, cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"xbench: the measured process loaded {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
