"""Faults planted in the program under test, to read how far each of a
cell's checked numbers moves when the timed path is broken underneath:

* ``state_unchanged`` — a step (a replay round, a training step) returns
  its state as it was given;
* ``half_batch`` — half of each batch left out, the mean taken over the
  rest;
* ``exchange_left_out`` — the exchange between replicas left out (the
  replay's boundary merge; the pods' merge and its bookkeeping);
* ``answer_altered`` — one answer altered where it is produced (a replay
  op's version; a training step's last label).

    python3 xbench/faults.py --workload train.olmoe.xstcc --fault half_batch --seeds 1 2 3

runs set-up with the fault planted and the check, on the card, and prints
one JSON line per seed with the numbers compared.  The benchmark's own
runs never plant a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent

FAULTS = ("state_unchanged", "half_batch", "exchange_left_out", "answer_altered")
# ``none`` plants nothing: a run's set-up and check alone, for the sound
# runs' readings.


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """``fault`` planted in the program for the duration of the block."""
    import torch

    undo = []

    def patch(owner, name, value):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == "none":
        pass
    elif driver == "replay":
        from repro_torch.core import replicated_store, xstcc
        from repro_torch.engine.replay import EpochEngine

        orig_round = EpochEngine.round_step
        if fault == "state_unchanged":
            patch(EpochEngine, "round_step", lambda self, store, carry, *a: carry)
        elif fault == "half_batch":
            def half(self, store, carry, ops, m, step0, width, emulate, ys):
                n = width // 2
                return orig_round(self, store, carry, {k: v[:n] for k, v in ops.items()}, m,
                                  step0, n, emulate, ys)
            patch(EpochEngine, "round_step", half)
        elif fault == "exchange_left_out":
            patch(replicated_store.ReplicatedStore, "merge",
                  lambda self, state, **kw: (state, torch.zeros((), dtype=torch.int32)))
        else:
            orig = xstcc.apply_op_batch

            def altered(state, **kw):
                res = orig(state, **kw)
                bump = torch.zeros_like(res.version)
                bump[-1] = 1
                return res._replace(version=res.version + bump)
            patch(xstcc, "apply_op_batch", altered)
    else:
        from repro_torch.train import trainer
        from repro_torch.tree import tree_map

        orig_make = trainer.make_train_fns

        def make(*a, **kw):
            fns = orig_make(*a, **kw)

            def wrap(step):
                def run(state, batch):
                    if fault == "half_batch":
                        n = batch["tokens"].shape[1] // 2
                        batch = {k: v[:, :n] for k, v in batch.items()}
                    elif fault == "answer_altered":
                        labels = batch["labels"].clone()
                        last = labels[-1, -1, -2]
                        labels[-1, -1, -2] = torch.where(last > 0, last - 1, last + 1)
                        batch = dict(batch, labels=labels)
                    elif fault == "state_unchanged":
                        copy = state._replace(
                            params=tree_map(torch.clone, state.params),
                            opt=state.opt._replace(mu=tree_map(torch.clone, state.opt.mu),
                                                   nu=tree_map(torch.clone, state.opt.nu)),
                            sync=state.sync._replace(anchor=tree_map(torch.clone,
                                                                     state.sync.anchor)))
                        return state, step(copy, batch)[1]
                    return step(state, batch)
                return run

            sync_step = fns.local_step if fault == "exchange_left_out" else fns.sync_step
            return fns._replace(local_step=wrap(fns.local_step), sync_step=wrap(sync_step))
        patch(trainer, "make_train_fns", make)
    try:
        yield
    finally:
        for owner, name, value in reversed(undo):
            setattr(owner, name, value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=FAULTS + ("none",), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import run

    run.fixed_dirs()
    import torch

    from lib import trace

    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = run.cell_of(bench, args.workload)
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = run.load(HERE / "drivers" / f"{config['driver']}.py", "xbench_driver")
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        with planted(config["driver"], args.fault):
            drv = driver.Driver(config, traffic, seed, device)
            drv.window(0.0, trace.Spans())
            drv.release()
        checks = drv.check()
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}),
              flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
