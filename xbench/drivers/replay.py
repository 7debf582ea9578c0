"""The replay driver: the paper's evaluation of one consistency level.

One **pass** is one evaluation: a fresh store, the whole op stream replayed
in rounds through ``EpochEngine.round_step`` (op ingest, the boundary
merge, the DUOT record), then ``engine/results.assemble`` (the DUOT audit,
staleness, violations) and the eq. 5–8 bill.  Passes repeat until the
window closes; every round and every assembly inside it counts.

Set-up makes the op stream from the seed (the benchmark's own YCSB
generator), hands it to the program's ``engine/stream.batch_inputs`` (the
apply-point schedule is the program's to derive) and warms up every shape
a pass uses: a full round, the last, shorter round, the assembly.

The check replays the window's first pass, every round of it, through the
plain reference and compares: the stale, violation and read counts after
each round (``round_counts``: rounds that differ); and (``outputs``: cells
and fields that differ) the whole store state and the DUOT after the
pass's last round, and every completed pass's result against the
reference's: the audit's severity, the staleness and violation rates, the
reads, the dropped writes and the eq. 5–8 bill priced from the reference's
staleness.  Every pass replays the same stream, so every pass has the same
answers.  Both are counts with the limit 0.  A window that ends inside
its first pass is compared over the rounds it completed.
"""

from __future__ import annotations

import time

import numpy as np

from lib import ycsb
from reference import replay as ref

class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch

        from repro_torch.core.consistency import ConsistencyLevel
        from repro_torch.engine import stream as stream_lib
        from repro_torch.engine.config import EngineConfig
        from repro_torch.engine.replay import EpochEngine
        from repro_torch.storage.ycsb import Workload as ProgramWorkload

        self.cfg, self.traffic, self.device = config, traffic, device
        n_ops = traffic["n_ops"]
        self.stream = ycsb.op_stream(
            n_ops=n_ops, n_keys=config["n_resources"], n_clients=config["n_clients"],
            read_fraction=traffic["read_fraction"], zipf_theta=traffic["zipf_theta"],
            seed=seed, n_replicas=config["n_replicas"])
        self.level = ConsistencyLevel[config["level"]]
        self.workload = ProgramWorkload(traffic["name"], read_fraction=traffic["read_fraction"],
                                        n_operations=n_ops, zipf_theta=traffic["zipf_theta"],
                                        key_space=config["n_resources"])
        self.config = EngineConfig(
            self.level, n_ops=n_ops, n_clients=config["n_clients"],
            n_resources=config["n_resources"], merge_every=config["merge_every"],
            delta=config["delta"], duot_cap=config["duot_cap"],
            batch_size=config["batch_size"], audit=True)
        self.engine = EpochEngine(self.config, device=device)
        self.store = self.engine.store(self.workload)
        sub, rem, n_rounds, self.emulate = self.engine.plan()
        batched, tail = stream_lib.batch_inputs(self.stream, self.store, sub, n_rounds, rem,
                                                self.emulate)
        batched = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in batched.items()}
        self.rounds = [({k: v[t] for k, v in batched.items()}, t * sub, sub)
                       for t in range(n_rounds)]
        if rem:
            tail = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in tail.items()}
            self.rounds.append((tail, n_rounds * sub, rem))
        self.n_rounds = n_rounds
        self.sync()
        # Warm-up: full rounds, the last round's shape, the assembly.
        carry = self.engine._init_carry(self.store)
        for i in (0, 1, 2, len(self.rounds) - 1):
            carry = self._round(carry, i)
        self._assemble(carry)
        del carry
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def _round(self, carry, i: int):
        ops, step0, width = self.rounds[i]
        ys = {"gossip": [], "obs": [], "tel": []} if i < self.n_rounds else None
        return self.engine.round_step(self.store, carry, ops, None, step0, width,
                                      self.emulate, ys)

    def _assemble(self, carry) -> dict:
        from repro_torch.core import cost_model
        from repro_torch.engine import results
        from repro_torch.storage import simulator as sim
        from repro_torch.storage.cluster import PAPER_CLUSTER as cluster

        out = results.assemble(self.config, {"store": self.store, "out": carry},
                               self.workload)
        w, stale = self.workload, out["staleness_rate"]
        thr, _ = sim.throughput_model(self.level, w, self.config.n_clients, cluster, stale)
        runtime_s = w.n_operations / thr
        inter, intra = sim.traffic_gb(self.level, w, w.n_operations, cluster, stale)
        out["bill"] = cost_model.cost_all(
            nb_instances=cluster.n_nodes, runtime_hours=runtime_s / 3600.0,
            hosted_gb=cluster.total_data_gb_after_replication,
            months=runtime_s / (30 * 24 * 3600.0),
            io_requests=float(w.n_operations) * self.level.write_acks(
                cluster.replication_factor),
            inter_dc_gb=inter, intra_dc_gb=intra).as_dict()
        return out

    # -- the measured window ---------------------------------------------------

    def window(self, seconds: float, spans, profiler=None) -> dict:
        """Passes until ``seconds`` have gone; returns the window's counts.
        With a ``profiler``, the last ``trace_rounds`` rounds of the first
        pass and its assembly are traced, the deadline notwithstanding."""
        trace_from = len(self.rounds) - self.traffic["trace_rounds"]
        self.counters, self.snapshot, self.passes = [], None, []
        self.traced_widths = []
        ops = rounds = 0
        first = True
        t0 = time.perf_counter()
        deadline = t0 + seconds
        done = partial = False
        while not done:
            carry = self.engine._init_carry(self.store)
            partial = True
            for i in range(len(self.rounds)):
                if first and profiler is not None and i == trace_from:
                    profiler.start()
                with spans("round"):
                    carry = self._round(carry, i)
                width = self.rounds[i][2]
                ops += width
                rounds += 1
                if profiler is not None and profiler.active:
                    self.traced_widths.append(width)
                if first:
                    self.counters.append((carry["stale"], carry["viol"], carry["reads"]))
                    if i + 1 == len(self.rounds):
                        # Held, not copied: every round makes new state tensors.
                        self.snapshot = carry
                tracing = profiler is not None and profiler.active
                if time.perf_counter() >= deadline and not tracing:
                    done = True
                    break
            else:
                if profiler is not None and profiler.active:
                    self.sync()
                with spans("assemble"):
                    self.passes.append(self._assemble(carry))
                partial = False
                if profiler is not None and profiler.active:
                    profiler.stop()
                done = time.perf_counter() >= deadline
            first = False
        if profiler is not None and profiler.active:
            profiler.stop()
        self.sync()
        window_s = time.perf_counter() - t0
        dropped = sum(p["dropped_writes"] for p in self.passes)
        if partial:
            dropped += int(carry["st"].cluster.pend_dropped)
        return {"attempted": ops, "failed": dropped, "window_s": window_s,
                "metrics": {"replay_ops_s": ops / window_s}, "rounds": rounds}

    def trace_shape(self) -> dict:
        c = self.cfg
        return {"widths": self.traced_widths, "clients": c["n_clients"],
                "replicas": c["n_replicas"]}

    # -- the check -------------------------------------------------------------

    def release(self) -> None:
        """Copy what the check reads to the host and free the device."""
        import torch

        def host(x):
            return x.cpu().numpy()

        snap = self.snapshot
        self.host = {"counters": host(torch.stack([torch.stack(c) for c in self.counters]))
                     if self.counters else np.zeros((0, 3), np.int64)}
        if snap is not None:
            st = snap["st"]
            cl = st.cluster
            self.host["state"] = {
                "rv": host(cl.replica_version), "rvc": host(cl.replica_vc),
                "svc": host(cl.session_vc), "rf": host(cl.read_floor),
                "wf": host(cl.write_floor), "gv": host(cl.global_version),
                "pend.client": host(cl.pend_client), "pend.resource": host(cl.pend_resource),
                "pend.version": host(cl.pend_version), "pend.vc": host(cl.pend_vc),
                "pend.coord": host(cl.pend_coord), "pend.time": host(cl.pend_time),
                "pend.live": host(cl.pend_live), "pend.applied": host(cl.pend_applied),
                "pend.apply": host(st.pend_apply), "dropped": host(cl.pend_dropped),
                "clock": host(cl.clock)}
            d = st.duot
            self.host["duot"] = {k: host(getattr(d, k)) for k in (
                "client", "kind", "resource", "version", "replica", "seq", "vc", "valid")}
        self.snapshot = self.counters = None
        self.rounds = self.engine = self.store = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list[tuple[str, float, float]]:
        """(name, number, limit) of each comparison with the reference."""
        return compare(self.cfg, self.stream, self.host, self.passes, self.traffic)


def replay_reference(cfg: dict, stream: dict, n_rounds: int, *,
                     enforce_sessions: bool = True) -> tuple[ref.Store, np.ndarray]:
    """The reference store after ``n_rounds`` rounds, and its stale,
    violation and read counts after each."""
    sync_every, delta = ref.cadence(cfg["merge_every"], cfg["delta"])
    rs = ref.Store(n_replicas=cfg["n_replicas"], n_clients=cfg["n_clients"],
                   n_resources=cfg["n_resources"], pending_cap=max(128, 2 * cfg["batch_size"]),
                   duot_cap=cfg["duot_cap"], sync_every=sync_every, delta=delta,
                   enforce_sessions=enforce_sessions)
    b = cfg["batch_size"]
    n = len(stream["client"])
    counts = []
    for t in range(n_rounds):
        lo, hi = t * b, min(n, (t + 1) * b)
        rs.round(stream["client"][lo:hi], stream["home"][lo:hi], stream["resource"][lo:hi],
                 stream["kind"][lo:hi], lo)
        counts.append((rs.stale, rs.viol, rs.reads))
    return rs, np.asarray(counts, np.int64).reshape(-1, 3)


def reference_state(rs: ref.Store) -> dict:
    p = rs.pend
    return {"rv": rs.rv, "rvc": rs.rvc, "svc": rs.svc, "rf": rs.rf, "wf": rs.wf, "gv": rs.gv,
            "pend.client": p["client"], "pend.resource": p["resource"],
            "pend.version": p["version"], "pend.vc": p["vc"], "pend.coord": p["coord"],
            "pend.time": p["time"], "pend.live": p["live"], "pend.applied": p["applied"],
            "pend.apply": p["apply"], "dropped": np.int32(rs.dropped),
            "clock": np.int32(rs.clock)}


def compare(cfg: dict, stream: dict, host: dict, passes: list,
            traffic: dict) -> list[tuple[str, float, float]]:
    n_rounds = len(host["counters"])
    rs, counts = replay_reference(cfg, stream, n_rounds)
    round_counts = int((host["counters"] != counts).any(axis=1).sum())
    state_cells = 0
    if "state" in host:
        want = reference_state(rs)
        state_cells = sum(int(np.count_nonzero(np.asarray(host["state"][k]) != np.asarray(v)))
                          for k, v in want.items())
        state_cells += sum(int(np.count_nonzero(host["duot"][k] != v))
                           for k, v in rs.duot.items())
    pass_fields = 0
    if passes:
        # The whole pass was replayed: the reference's answers for every pass.
        reads = max(1, rs.reads)
        want = {"severity": rs.audit()["severity"], "staleness_rate": rs.stale / reads,
                "violation_rate": rs.viol / reads, "n_reads": rs.reads,
                "dropped_writes": rs.dropped}
        want_bill = ref.bill(read_fraction=traffic["read_fraction"],
                             n_operations=traffic["n_ops"], n_threads=cfg["n_clients"],
                             stale_rate=want["staleness_rate"])
        for p in passes:
            pass_fields += sum(p[k] != v for k, v in want.items())
            # The configuration's guarantees: no write dropped, no session
            # guarantee broken.
            pass_fields += (p["dropped_writes"] != 0) + (p["violation_rate"] != 0)
            pass_fields += sum(p["bill"][k] != want_bill[k] for k in p["bill"])
    return [("round_counts", round_counts, 0), ("outputs", state_cells + pass_fields, 0)]
