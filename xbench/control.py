"""The control of a cell's check: the plain reference put in the program's
place and judged by the same comparison as a run.  A replay cell's
control breaks one of the configuration's guarantees (reads served
without X-STCC's session floors); a training cell's computes every
product in the nearest precision below the configuration's bf16 (float8
e4m3 operands).  Every number it gives is an upper reading of the
check's limits; the runs of the benchmark never run it.

    python3 xbench/control.py --workload paper_a.xstcc --seeds 11 12 13

Prints one JSON line per seed: the numbers compared, as a run prints them.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from drivers import replay  # noqa: E402
from lib import ycsb  # noqa: E402


def control_outputs(cfg: dict, traffic: dict, stream: dict) -> tuple[dict, list]:
    """What a program that serves reads without the floors would hand the
    check: the counts after each round of a pass, the state after the last,
    the DUOT, and the pass's result (its severity from its own DUOT)."""
    n_rounds = -(-traffic["n_ops"] // cfg["batch_size"])
    rs, counts = replay.replay_reference(cfg, stream, n_rounds, enforce_sessions=False)
    host = {"counters": counts, "state": replay.reference_state(rs), "duot": dict(rs.duot)}
    n_reads = int((stream["kind"] == ycsb.READ).sum())
    stale = rs.stale / max(1, rs.reads)
    result = {"severity": rs.audit()["severity"], "n_reads": n_reads,
              "dropped_writes": rs.dropped, "staleness_rate": stale,
              "violation_rate": rs.viol / max(1, rs.reads),
              "bill": replay.ref.bill(read_fraction=traffic["read_fraction"],
                                      n_operations=traffic["n_ops"],
                                      n_threads=cfg["n_clients"], stale_rate=stale)}
    return host, [result]


def control_checks(cfg: dict, traffic: dict, seed: int) -> list:
    stream = ycsb.op_stream(
        n_ops=traffic["n_ops"], n_keys=cfg["n_resources"], n_clients=cfg["n_clients"],
        read_fraction=traffic["read_fraction"], zipf_theta=traffic["zipf_theta"], seed=seed,
        n_replicas=cfg["n_replicas"])
    host, passes = control_outputs(cfg, traffic, stream)
    return replay.compare(cfg, stream, host, passes, traffic)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    if cfg["driver"] == "train":
        sys.path.insert(0, str(HERE.parent / "src"))
        import torch

        from drivers import train
        checks_of = lambda seed: train.control_checks(cfg, traffic, seed,
                                                      torch.device("cuda", 0))
    else:
        checks_of = lambda seed: control_checks(cfg, traffic, seed)
    for seed in args.seeds:
        checks = checks_of(seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
