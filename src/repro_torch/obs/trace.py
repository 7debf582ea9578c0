"""Host-side span tracing of the engine lifecycle (port of
``repro.obs.trace``).

The device-side plane (:mod:`repro_torch.obs.metrics`) covers what the
protocol did; this module covers what the host did to run it: how long
stream preparation, the round loop and result assembly took, under which
engine configuration, with how many kernel launches.  A :class:`Tracer`
collects spans and instants with microsecond wall-clock timestamps and
exports them as Chrome trace-event JSON (``chrome://tracing`` /
Perfetto) or JSONL.

:func:`traced_run` is the instrumented twin of ``EpochEngine.run``: the
same replay and result, plus a trace with

  * a ``config`` instant — the content hash of the engine config's key;
  * a ``stages`` instant — the feature flags the round step is gated on;
  * ``prepare`` / ``execute`` / ``assemble`` spans (no ``compile`` span:
    the port runs eagerly, its kernels built once per process);
  * a ``launches`` instant — the hand-written kernels' launches during
    the replay (``kernels.ops.launch_counts``), with the rounds and shards
    it ran: on the card one B.1 and one clock-chain launch per round and
    shard (the engine's launch invariant, measured not assumed); on the
    CPU none, as the plain versions launch nothing.  It takes the place
    of the reference's ``jit_entries`` instant.

The chaos harness (``repro_torch.chaos.harness``) appends its nemesis
actions and verdicts to the same tracer.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import time
from typing import Any

# Required keys of every exported trace event.
EVENT_KEYS = ("name", "ph", "ts", "pid", "tid")
TRACE_SCHEMA = "repro-obs-trace/v1"


def config_hash(config) -> str:
    """Content hash of an ``EngineConfig``'s identity (its ``_key()``,
    fault-mask bytes and topology included)."""
    return hashlib.sha256(repr(config._key()).encode()).hexdigest()[:16]


def stage_flags(config) -> dict[str, bool]:
    """The feature gates of one configuration's round step (the sections
    ``engine.replay.EpochEngine`` runs)."""
    gossip, faults = config.gossip, config.faults
    faults_on = faults is not None
    d_on = (
        config.durability is not None and config.durability.enabled
        and faults_on
    )
    return {
        "faults": faults_on,
        "crashes": faults_on and faults.has_crashes,
        "geo": config.topology is not None,
        "gossip": gossip is not None and gossip.enabled,
        "handoff": gossip is not None and gossip.handoff and faults_on,
        "durability": d_on,
        "wal": d_on and config.durability.wal,
        "snapshot": d_on and config.durability.snapshot_every > 0,
        "sharded": config.n_shards > 1,
        "lean": config.lean,
        "obs": config.obs is not None and config.obs.enabled,
    }


class Tracer:
    """Chrome-trace-event collector (complete events and instants).

    Timestamps are microseconds of wall clock since the tracer's birth;
    spans are ``ph="X"`` complete events, instants ``ph="i"``.  One
    process, one thread lane: the engine lifecycle is sequential.
    """

    def __init__(self, run_id: str = "replay"):
        self.run_id = run_id
        self.events: list[dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _event(self, name: str, ph: str, ts: float, **fields) -> dict:
        ev = {"name": name, "ph": ph, "ts": ts, "pid": 1, "tid": 1}
        ev.update(fields)
        self.events.append(ev)
        return ev

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """``with tracer.span("execute"): ...`` — one complete event."""
        t0 = self._now_us()
        try:
            yield self
        finally:
            self._event(name, "X", t0, dur=self._now_us() - t0, args=args)

    def instant(self, name: str, **args) -> None:
        self._event(name, "i", self._now_us(), s="g", args=args)

    # -- export -----------------------------------------------------------

    def chrome(self) -> dict[str, Any]:
        """The Chrome trace-event JSON object."""
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA, "run_id": self.run_id},
        }

    def write_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome(), f, indent=1)

    def write_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")


def validate_chrome(obj: dict[str, Any]) -> list[dict[str, Any]]:
    """Check an exported trace against the event schema; returns the
    events.  Raises ``ValueError`` on the first malformed event."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a Chrome trace-event object")
    events = obj["traceEvents"]
    for i, ev in enumerate(events):
        missing = [k for k in EVENT_KEYS if k not in ev]
        if missing:
            raise ValueError(f"event {i} missing keys {missing}: {ev}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"complete event {i} missing dur: {ev}")
    return events


def load_chrome(path) -> list[dict[str, Any]]:
    """Load and validate a written Chrome trace; returns its events."""
    with open(path) as f:
        return validate_chrome(json.load(f))


def traced_run(engine, w, tracer: Tracer | None = None, *, device="cuda"):
    """``EpochEngine.run`` with the lifecycle traced; ``(result, tracer)``.

    Accepts an ``EpochEngine`` or an ``EngineConfig`` (replayed on
    ``device``).  The ``execute`` span ends once the card has finished
    the round loop (a synchronize), so it holds the device time too.
    """
    import torch

    from repro_torch.engine import results
    from repro_torch.engine.replay import EpochEngine
    from repro_torch.kernels import ops as kernel_ops

    if not isinstance(engine, EpochEngine):
        engine = EpochEngine(engine, device=device)
    c = engine.config
    tracer = tracer or Tracer()
    tracer.instant(
        "config", hash=config_hash(c), level=str(c.level),
        n_ops=c.n_ops, batch_size=c.batch_size, n_shards=c.n_shards,
    )
    tracer.instant("stages", **stage_flags(c))
    with tracer.span("prepare"):
        prep = engine.prepare(w)
    before = kernel_ops.launch_counts()
    with tracer.span("execute", shards=c.n_shards):
        prep = engine.execute(prep)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
    after = kernel_ops.launch_counts()
    tracer.instant(
        "launches", counts={k: after[k] - before[k] for k in after},
        rounds=prep["n_rounds"] + (1 if prep["rem"] else 0),
        shards=c.n_shards, device=str(engine.device),
    )
    with tracer.span("assemble"):
        result = results.assemble(c, prep, w)
    return result, tracer
