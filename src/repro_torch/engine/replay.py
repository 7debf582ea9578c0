"""The epoch engine's flat replay (port of ``repro.engine.replay``).

One round step — op ingest, boundary merge (or the lean merge),
counters — runs once per merge round.  The reference scans it under one
``jit``; here the round loop is Python, the stream and the schedule are
moved to the device once, and the state stays on the device: per round
the host reads only the DUOT size and the merge fixpoint's flags.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import duot as duot_lib
from repro_torch.core.replicated_store import ReplicatedStore
from repro_torch.device import resolve_device
from repro_torch.engine import stream as stream_lib
from repro_torch.engine.config import EngineConfig


class EpochEngine:
    """One workload replay on ``device`` (default ``"cuda"``).

    ``EpochEngine(config).replay(w)`` prepares the op stream, the
    cadence plan and the apply-point schedule on the host, then runs the
    round loop with the state on the device.
    """

    def __init__(self, config: EngineConfig, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)

    def plan(self) -> tuple[int, int, int, bool]:
        c = self.config
        return stream_lib.cadence_plan(
            c.level, c.n_ops, c.batch_size, c.merge_every, c.delta
        )

    def store(self) -> ReplicatedStore:
        c = self.config
        return ReplicatedStore(
            c.n_replicas, c.n_clients, c.n_resources, level=c.level,
            merge_every=c.merge_every, delta=c.delta,
            pending_cap=c.resolved_pending_cap(),
            duot_cap=c.duot_cap, ingest=c.ingest, device=self.device,
        )

    def prepare(self, w) -> dict[str, Any]:
        """Host-side inputs of one replay: stream, plan, schedule."""
        c = self.config
        sub, rem, n_rounds, emulate = self.plan()
        store = self.store()
        stream = stream_lib.op_stream(
            w, c.n_ops, c.n_clients, c.n_resources, c.seed, store.n_replicas
        )
        batched, tail = stream_lib.batch_inputs(
            stream, store, sub, n_rounds, rem, emulate
        )

        def dev(d):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                    for k, v in d.items()}

        return {
            "store": store, "batched": dev(batched),
            "tail": dev(tail), "sub": sub, "rem": rem, "n_rounds": n_rounds,
            "emulate": emulate,
        }

    def round_step(self, store: ReplicatedStore, carry: dict, ops: dict,
                   step0: int, width: int, emulate: bool) -> dict:
        """Ingest one round's ops, merge, and count reads/stale/violations."""
        lean_merge = self.config.lean and emulate
        st, res = store.apply_batch(
            carry["st"], client=ops["client"], replica=ops["home"],
            resource=ops["resource"], kind=ops["kind"],
            op_step0=step0 if emulate else None,
            apply_index=ops.get("apply_idx"),
            record=not self.config.lean,
            with_clocks=not lean_merge,
        )
        if lean_merge:
            st, _ = store.merge(st, timed_only=True, boundary=step0 + width)
        else:
            st, _ = store.merge(st)
        is_read = ops["kind"] == duot_lib.READ
        return {
            "st": st,
            "stale": carry["stale"] + res.stale.sum(),
            "viol": carry["viol"] + res.violation.sum(),
            "reads": carry["reads"] + is_read.sum(),
        }

    def replay(self, w) -> dict[str, Any]:
        """Run the whole workload; returns the :meth:`prepare` dict with
        ``out``, the final carry (``st``, ``stale``, ``viol``, ``reads``)."""
        prep = self.prepare(w)
        store = prep["store"]
        sub, rem, n_rounds = prep["sub"], prep["rem"], prep["n_rounds"]
        z = torch.zeros((), dtype=torch.int64, device=self.device)
        carry = {"st": store.init(), "stale": z, "viol": z, "reads": z}
        batched = prep["batched"]
        for t in range(n_rounds):
            ops = {k: v[t] for k, v in batched.items()}
            carry = self.round_step(store, carry, ops, t * sub, sub,
                                    prep["emulate"])
        if rem:
            carry = self.round_step(store, carry, prep["tail"], n_rounds * sub,
                                    rem, prep["emulate"])
        prep["out"] = carry
        return prep
