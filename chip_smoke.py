#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure ends the run with a
non-zero exit code):

  1. device   — the card's name, count and power limit; no card, no run;
  2. build    — ``nvcc`` builds the nine kernels from ``src/repro_torch/
                csrc`` in parallel; prints seconds, ptxas register /
                shared-memory / spill lines per instantiation and the
                attention kernels' dynamic shared memory;
  3. kernels  — each kernel against its plain PyTorch version on the
                card, outputs exactly equal (bit for bit), at the main
                paths' shapes and beyond; CUDA-event times of both; for
                ``op_ingest`` also the bound at the INT32 rate, the CUDA
                kernels one call runs (``torch.profiler``), and its
                one-CTA kernel against its tile kernels at B = 128..1024
                (the ``SMALL_MAX`` threshold); ``vclock_chain``'s three
                designs (one-CTA walk, max-plus segments, dependence
                levels), each forced, on adversarial mixes at the narrow
                and the wide width, timed on the main path's own mixes
                (the flat WORKLOAD_A batch, the serving read batch) with
                each schedule's serial depth, and walk against segments
                at B = 128..1024; ``histogram`` one CTA and clusters per
                row, int32, bool and no masks; ``vclock_audit``'s designs
                (compact, dense, auto) forced on every audit mix, timed at
                (2048, 16) and at (16384, 64) on the random and the
                one-resource mix with the base share and both bounds (the
                dense count and the floor, at the INT32 rate);
                ``digest_compare`` on two sides and on gathered pairs;
                B.6's ``policy_select`` (the controller's selection from
                its rings, one launch) in both modes at S = 1 .. 1,000,003,
                W in 1, 8, L in 2, 6, the read fraction a value and per
                session, epsilon 0, 1, 0.05, tie and NaN rows, and
                ``AdaptiveController.select`` timed whole at S = 64 and at
                the fleet beside the parent's path (device operations,
                device time, one CUDA kernel); B.7's ``session_check``
                (the routers' admission, one launch) at the six
                session-floor shapes, and a router's whole admission timed
                at 64 and 16,384 sessions beside the parent's path;
     digest   — B.4 per gossip verdict set at (3 x 8) and 65,536 verdicts:
                the whole ``ops.digest_compare_pairs`` call, its kernel, and
                ``ops.digest_compare`` on the gathered rows, the path it
                replaced (the only rows of a parent checkout), with their
                device operations;
  4. golden   — the seven ``protocol/*``, eight fault, seven ``geo/*``,
                six ``sharded/*`` cases and ``faulty/X_STCC/sharded`` of
                ``tests/data/golden_wrappers.json`` on the card (geo: the
                latency fields within rtol 1e-5, the rest exact);
  5. main     — ``evaluate_level`` for WORKLOAD_A/B × six levels at the
                defaults on the card, each equal to the same call on the
                CPU in every field; kernel launch counts of this phase;
  6. faulty   — ``run_protocol_faulty`` for the six levels at the
                defaults with replica 1 down for the middle of the run,
                gossip + hinted handoff, WAL/snapshot durability and the
                obs plane, each equal to the same call on the CPU; kernel
                launch counts of this phase;
     sharded  — ``run_protocol_sharded`` for the six levels (WORKLOAD_A,
                6000 ops, 2 tenant shards, with the audit), each equal to
                the same call on the CPU, and its launch counts; the scalar
                engine ``run_protocol_scalar`` at its defaults (6000 ops,
                one op at a time, the sequential merge) for the six levels,
                each equal to the CPU run, its staleness and violation rates
                beside the batched engine's; the ODG (``odg.build`` and
                ``severity_from_odg``) of the X_STCC run's DUOT (M = 2048),
                equal to the CPU;
     recovery — crash recovery and geo + faults: ``run_protocol_faulty``
                for the six levels with the faulty phase's setting where
                replica 1's outage opens with a crash event (WAL +
                snapshots), and X_STCC with snapshots only and with no
                durability; the six levels on the paper's topology
                composed with the same schedule; the chaos suite (seeds
                0-3, each against its crash-stripped twin); each equal to
                the CPU; ``StoreRecovery`` on the X_STCC run's final state;
                a direct ``store.bootstrap`` with its B.4 launches counted
                and held against the plain version; launch counts;
  7. geo      — ``run_protocol_geo`` for the six levels at the defaults
                on the paper's topology and on a hot-region client skew,
                X_STCC with nearest-peer gossip + WAL/snapshots + obs on
                the paper's topology and on the 12-replica fleet, the
                one-region identity with ``run_protocol``, and the
                placement planner on the run's demand under two SLAs;
                each equal to the same call on the CPU; launch counts;
  8. adaptive — ``run_protocol_adaptive`` for PHASED_RW and PHASED_RWR x
                SLA_RELAXED and SLA_STRICT over the six levels at 6400
                ops, each equal to the same call on the CPU, and one
                ``CadenceController.run_scan`` card vs CPU; launch counts
                (one ``policy_score`` per epoch, no audit); device
                operations per controller epoch, with the parent's
                selection beside them;
  9. serving  — ``ServingEngine`` on the paper's 12-replica fleet with 64
                sessions, X_STCC by default and an ``AdaptiveController``,
                through a seeded schedule (rolling publish, outages, a
                rebuilding replica, external floors, ``route_batch`` and
                ``serve_with_retry`` rounds, ``adapt_sessions`` after each
                epoch), equal to the same script on the CPU in every
                counter, replica, version, region statistic, level and
                floor; a ``ShardedServingRouter`` (4 shards x 16
                sessions) likewise; launch counts (one ``session_floor``
                per guarded ``route_batch``, one ``op_ingest`` and one
                ``vclock_chain`` per store read, one ``policy_score`` per
                epoch, no audit); device operations per ``route_batch``,
                with the parent's admission beside them;
 10. model    — B.8 ``flash_attention`` (an FFMA kernel in f32, a wgmma
                kernel in bf16) against its plain version at the
                reference's FA_CASES and at gemma-2b's and qwen2-7b's full
                attention shapes (atol = rtol 2e-5 in f32, 2e-2 in bf16;
                CUDA-event times of the kernel, the plain version and
                SDPA); gemma-2b's ``forward`` at full width in bf16 (B = 1,
                S = 2048) with the kernel (18 launches) and with the plain
                attention, and in f32 (S = 512) within 1e-3 of each other;
                ``ServingEngine.generate`` on it (3 replicas, 6 requests,
                a failover), its routing equal to the same schedule on the
                CPU on a reduced gemma-2b; in f32, every served step's
                logits within 1e-3 of the kernel ``forward``;
 10b. train   — the training path: ``tests/test_trainer_levels.py``'s setting
                (reduced qwen2-7b, 2 layers, 2 pods, 16 steps, Δ = 4) for the
                five paper levels and TCC, X_STCC with int8 and with top-k,
                and QUORUM at 4 pods, each on the card and on the CPU from the
                same weights and batches: the sync bookkeeping (counters,
                clocks, DUOT) exactly equal, losses within rtol 1e-3, and B.1
                / chain / B.2 launches as predicted (two, two and one per
                causal merge); the six MoE / VLM / hybrid / SSM / audio
                configurations reduced (``FAMILY_TRAIN_CASE``: X_STCC, Δ = 2,
                int8, 2 pods, 4 steps), card against CPU by the same rules;
                gemma-2b at its published widths (bf16, random
                weights) for 6 steps on 2 pods under X_STCC with Δ = 2 and
                int8 compression, batch 4 x 512: finite losses, local- and
                sync-step seconds, tokens/s, peak memory, the sync metrics;
                olmoe-1b-7b, internvl2-2b, zamba2-1.2b, rwkv6-3b and
                whisper-large-v3 at their published widths likewise for 4
                steps (``FAMILY_TRAIN_FULL``; depth cut for olmoe and rwkv6,
                ``FAMILY_TRAIN_CUTS``), with the predicted launches and a
                bound on rwkv6's largest in-chunk decay;
                checkpoints (3 replicas, X_STCC) with a session-guarded
                restore, ``RestartManager``, ``CheckpointRecovery``,
                ``StoreRecovery`` of the pods' replica store against the CPU,
                and ``rescale_train_state`` 2 -> 4 -> 2 keeping the mean;
 10c. mesh    — a one-device mesh (``launch.mesh.make_mesh((1, 1))`` over an
                NCCL process group of one rank): gemma-2b's parameter
                placements all replicated; reduced qwen2-7b's ``sync_step``
                (X_STCC, 2 pods, 4 merges) under ``use_mesh`` equal to the
                same steps with no mesh, bit for bit (losses, parameters,
                clocks, DUOT, merges, violations, severity,
                ``inter_pod_gb``), with B.1 / chain / B.2 launched as
                predicted; the dry run (``launch.dryrun``, meta device) of
                the train phase's gemma-2b setting on that mesh: its
                predicted per-device state must not exceed the train
                phase's measured peak; its step FLOPs over the measured
                local step, against the bf16 peak, printed (not gated);
                (c) gemma-2b's LSE decode on that mesh and (d) the ring,
                the LSE decode and olmoe's dispatch at 16 shards under a
                ``MeshShape`` (``MESH_REGIONS``); (e) gemma-2b, then
                olmoe-1b-7b, internvl2-2b, zamba2-1.2b, rwkv6-3b and
                whisper-large-v3 at full width and cut depth
                (``MESH_FAMILY_LAYERS``), served as SPMD with DTensor
                parameters on that mesh in bf16 with B.8: forward, prefill
                and ``generate`` bit-equal to the same parameters plain,
                B.8's launches per meshed forward equal to plain;
 10d. families — the MoE, VLM, hybrid, SSM and audio families
                (``FAMILIES``): (a) olmoe-1b-7b, internvl2-2b, zamba2-1.2b,
                rwkv6-3b and whisper-large-v3 at full width and depth in
                bf16 (random weights, B = 1, S = 2048; whisper's decoder
                448 over its 1500 frames), ``forward`` with B.8 and with the
                plain attention: finite logits of the right shape, B.8's
                launches one per causal self-attention layer (16 / 24 / 6 /
                0 / 32), walls, init seconds, peak memory; B.8 at each new
                shape against its plain version with its times; (b)
                ``ServingEngine.generate`` on each, 2 replicas, a 128-token
                prompt (after internvl2's 256-position image prefix), 8
                tokens; (c) all six configurations, llama4-maverick
                included, reduced in f32: ``forward``, prefill + decode and
                the served tokens on the card against the CPU (logits atol
                = rtol 1e-4, tokens exact); (d) each family with attention
                at full width, 2 layers (zamba2: one group of 6), f32, S =
                512 (whisper 448): B.8 against the plain attention within
                atol = rtol 1e-3;
 11. scale    — one X_STCC replay at the paper's deployment (64 client
                threads, 5,000,000 rows, 8,000,000 ops, B = 4096) and
                ``admit_batch`` on its final state, the same deployment
                through the fault path (2,000,000 ops, ``SCALE_CUTS``),
                the placement planner over its
                5,000,000 rows x 124 candidates, the geo replay on the
                paper's 12-replica fleet (4 per DC; 4,000,000 ops), the adaptive run
                over the same 64 clients and 5,000,000 rows (ops cut,
                see ``ADAPTIVE_SCALE_CUTS``), the controller over a
                1,000,000-session fleet, and serving at 16,384 sessions
                and through 16 router shards of 4,096 (epochs cut,
                ``SERVING_SCALE_CUTS``), each equal to the
                same run with the plain versions on the card; B.2 on the
                flat run's own DUOT (every design, the bounds), on the same
                entries sorted by resource (a probe of grouped tiles), and
                the split of ``store.audit`` between the kernel and the rest;
                the same deployment split into 4 tenant shards (16
                clients, 1,250,000 rows and 1,000,000 ops each, ops cut:
                ``SHARDED_SCALE_OPS``), each
                shard's counts equal to the unsharded run of that shard;
                the deployment through the crash path (replica 1 crashes
                and rejoins; ops cut, ``CRASH_SCALE_CUTS``), its
                invariants checked and its fleet, after a quiescent tail,
                equal to the crash-stripped twin's;
 12. profile  — ``torch.profiler`` over X_STCC and CAUSAL
                ``run_protocol``, an X_STCC fault run, an X_STCC geo run,
                an adaptive run and the serving schedule: device time by
                kernel, the card's busy share of the unprofiled wall time,
                and each profiled run's own seconds (cuts: the adaptive
                run profiles 800 ops of its 6400-op default,
                ``PROFILE_ADAPTIVE_OPS``, and CAUSAL 1000 ops);
 13. report   — one JSON line ``{"kernels": [...]}``, then the last line
                ``{"ok": true, "device": {...}}``.

``--phases`` runs a subset (a debugging aid; the report lines are
printed only for a full run).  Imports ``repro_torch`` from the
``src`` directory beside this file; never JAX or ``repro``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("device", "build", "kernels", "digest", "golden", "main", "faulty", "sharded",
          "recovery", "geo", "adaptive", "serving", "model", "train", "mesh", "families",
          "scale", "profile")

# H100 SXM peaks (NVIDIA data sheet, as tabulated in the repo's
# measurement notes): HBM bandwidth, and the 32-bit non-tensor-core rate
# used for the integer compare/select work of these kernels.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# The INT32 issue rate: 64 lanes per SM per clock x 132 SMs x 1.98 GHz.
# PEAK_OPS_S (the f32 FMA rate) counts an FMA as two operations, so the
# integer kernels' bounds are also given at this rate (B.1: "bound_ms_int32").
PEAK_INT32_OPS_S = 64 * 132 * 1.98e9

# The scale run: the paper's deployment (§4.1) — 64 YCSB threads, a
# 5,000,000-row table, 8,000,000 ops — in 4096-op batches.
SCALE = dict(n_clients=64, n_resources=5_000_000, batch_size=4096,
             n_ops=8_000_000, duot_cap=16384)
SCALE_CUTS = (
    "cuts of scale: none for the flat run (the paper's 64 threads, "
    "5,000,000 rows, 8,000,000 ops); the fault run replays 2,000,000 ops "
    "(FAULT_SCALE_OPS: 8,000,000 took 93.1-106.3 s on H100 hosts, and the "
    "script 1131.0 s of its 1200 s limit on the slowest; 4,000,000 took "
    "44.0 s, halved again to make room for the families phase); the geo run "
    "replays 4,000,000 ops (GEO_SCALE_OPS: 8,000,000 took 28.5-31.1 s); the "
    "DUOT audit covers the first 16,384 ops (duot_cap), as the engine never "
    "wraps or collects the log"
)
# The fault and geo runs' op counts, cut (listed above) so that the script
# fits its time limit on a slow host; rows and clients are never cut.
FAULT_SCALE_OPS = 2_000_000
GEO_SCALE_OPS = 4_000_000
# The crash run at the same deployment, and its crash-stripped twin.
CRASH_SCALE_OPS = 1_000_000
CRASH_SCALE_CUTS = (
    "cuts of scale: 1,000,000 ops of the paper's 8,000,000 for the crash run "
    "and its twin (two replays of the fault path: 8,000,000 ops took 93.1-106.3 "
    "s on H100 hosts, and 2,000,000 ops 21.3 s each, which took the script to "
    "950 s of its 1200 s limit); clients and rows are not cut"
)
# admit_batch on the flat scale run's final state: this many of its
# 4096-op batches, kernel against plain.
ADMIT_BATCHES = 8

# The planner's candidate universe at the paper's 3 regions:
# enumerate_candidates(3), every split of 1..12 replicas with at most 4
# per region.
N_CANDIDATES = 124

# The sharded scale run: the same deployment as 4 tenant shards of 16
# clients and 1,250,000 rows, with 1,000,000 ops each (cuts of scale: 4,000,000
# of the 8,000,000 ops; at 2,000,000 ops a shard, the run and the four
# per-shard identity runs took 39.4 s of the scale phase on an H100, halved
# to make room for the families' training in the train phase).
SHARDED_SCALE_SHARDS = 4
SHARDED_SCALE_OPS = 4_000_000
# The sharded phase: the golden cases' 2 shards at the defaults' 6000 ops.
SHARDED_SHARDS = 2

# The adaptive phase's size: the reference's bench_policy.py runs.
ADAPTIVE_OPS = 6400
# The adaptive scale run: the paper's 64 threads and 5,000,000 rows.
ADAPTIVE_SCALE = dict(n_clients=64, n_resources=5_000_000, n_ops=16_384)
ADAPTIVE_SCALE_CUTS = (
    "cuts of scale: 16,384 ops of the paper's 8,000,000 (32 epochs of 512, "
    "the default epoch rule's own result). CAUSAL and ONE merge every 8 and "
    "16 ops, so each op costs their telemetry passes a launch-bound round at "
    "R = 5,000,000. 65,536 ops took 85.7-96.7 s of telemetry on H100 hosts "
    "and the whole script then 937.7-1134.0 s of its 1200 s limit, so the "
    "ops were halved; 32,768 ops took 46.7-64.0 s of the scale phase and the "
    "script 1131.0 s on a slow host, so they were halved again. Clients and "
    "rows are not cut"
)
# The controller at fleet width: sessions, epochs, and the CPU check's
# stride over the sessions.
FLEET_SESSIONS = 1_000_000
FLEET_EPOCHS = 32
FLEET_STRIDE = 997

# The serving phase: the paper's 64 client threads as sessions on the
# 12-replica fleet, 8 epochs of 4 rounds; the router at 4 shards x 16.
SERVING = dict(n_sessions=64, n_epochs=8, rounds=4)
ROUTER = dict(n_shards=4, sessions_per_shard=16, n_epochs=8, rounds=4)
# Serving at scale: 16,384 sessions (every one routed once per round),
# and the router at 16 shards x 4,096 sessions.
SERVING_SCALE = dict(n_sessions=16_384, n_epochs=4, rounds=4)
ROUTER_SCALE = dict(n_shards=16, sessions_per_shard=4096, n_epochs=1, rounds=2)
SERVING_SCALE_CUTS = (
    "cuts of depth, not of width: the engine runs its 16,384 sessions for 4 "
    "epochs x 4 rounds (8 epochs took 55.5 s with the plain run's 34.8 s, "
    "halved to make room for the families phase); the router runs 1 epoch x "
    "2 rounds (2 epochs' plain run took 16.3 s), as its plain run walks 16 x "
    "4,096 clock chains per round in Python"
)


def fault_kwargs(n_ops: int, unit: int) -> dict:
    """The fault phases' setting: the golden outage shape stretched to the
    run — replica 1 down for schedule epochs [T/5, 3T/5) of T = ceil(n_ops
    / unit) — with gossip every 2 epochs, 32-hint queues, WAL + snapshots
    every 2 epochs, and the obs plane."""
    from repro_torch.core import availability as av
    from repro_torch.core.replicated_store import DurabilityConfig
    from repro_torch.gossip.scheduler import GossipConfig
    from repro_torch.obs.metrics import ObsConfig

    t = -(-n_ops // unit)
    return dict(
        schedule=av.replica_outage(t, 3, 1, t // 5, 3 * t // 5), schedule_unit=unit,
        gossip=GossipConfig(cadence=2, hint_cap=32),
        recovery=DurabilityConfig(snapshot_every=2, wal=True), obs=ObsConfig(),
    )


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, fn, *args):
    """``fn(*args)``, its wall time logged as ``[time] label``: where the
    script's time limit goes."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = n_ops / PEAK_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILED_CALLS = 10      # calls of one profiling session


def profiled_activities() -> list:
    """What the profiler records: the device's activity only.  Every count
    and time read here is a device row; recording the host's ops as well
    took the adaptive run's profile (133,000 device operations) from 42.0
    to 114.7 s on an H100 host, with the same device rows."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA]
PROFILE_TRIES = 8        # sessions tried before a count is "not measured"


def _device_rows(fn, key: str | None):
    """``torch.profiler``'s device rows (kernels, copies, fills) of
    ``PROFILED_CALLS`` calls of ``fn``, those whose name holds ``key`` if
    given.  Each session traces a warm-up cycle of as many calls first
    and counts only the cycle after it: without one, the profiler was
    seen to drop the first call's kernel of a session, every time, once
    a process had run long enough.  A session whose device operations
    are not a whole multiple of the calls is tried again, up to
    ``PROFILE_TRIES`` times; ``[]`` if none was whole."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=profiled_activities(),
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(PROFILED_CALLS):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not e.key.startswith("ProfilerStep")
                and (key is None or key in e.key)]
        n = sum(e.count for e in rows)
        if n and n % PROFILED_CALLS == 0:
            return rows
        _UNWHOLE.append([(e.key[:80], e.count) for e in rows])
    return []


# The device rows of the last sessions that were not whole (for the
# failure message).
_UNWHOLE: list = []


def cuda_kernels_per_call(fn, key: str | None = None) -> int | None:
    """CUDA kernels (and copies, fills) one call of ``fn`` runs, from
    ``torch.profiler``, those whose name holds ``key`` if given (``None``:
    not measured, the profiler recorded no whole session)."""
    rows = _device_rows(fn, key)
    return sum(e.count for e in rows) // PROFILED_CALLS if rows else None


def device_ops_per_call(fn, key: str) -> tuple[int | None, int | None]:
    """From one profiling session: the device operations (kernels, copies,
    fills) one call of ``fn`` runs, and those whose name holds ``key``
    (``None``: not measured)."""
    rows = _device_rows(fn, None)
    if not rows:
        return None, None
    return (sum(e.count for e in rows) // PROFILED_CALLS,
            sum(e.count for e in rows if key in e.key) // PROFILED_CALLS)


def device_ms_per_call(fn) -> float | None:
    """Device time of one call of ``fn`` (its kernels, copies and fills),
    from ``torch.profiler``: the card's own share of a call whose CUDA-event
    time the host's launch cost may set (``None``: not measured)."""
    rows = _device_rows(fn, None)
    return (sum(e.self_device_time_total for e in rows) / 1e3 / PROFILED_CALLS
            if rows else None)


def require_one_kernel(name: str, kernels: int | None) -> None:
    """Fail unless the profiler saw exactly one CUDA kernel per call."""
    if kernels is None:
        fail(f"{name}: CUDA kernels per call not measured (the profiler recorded "
             f"no whole session in {PROFILE_TRIES} tries; their device rows: "
             f"{_UNWHOLE[-PROFILE_TRIES:]})")
    if kernels != 1:
        fail(f"{name} ran {kernels} CUDA kernels per call, want 1")


def host_bound_ms(fn, iters: int, repeats: int = 5) -> tuple[float, list[float]]:
    """Median and all of ``repeats`` CUDA-event timings of ``fn``: for
    calls whose time is the host's launch cost, which jitters between
    timings more than the kernels do."""
    runs = [cuda_time_ms(fn, iters) for _ in range(repeats)]
    return sorted(runs)[len(runs) // 2], runs


def max_abs_err(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(a, b))


def require_equal(name: str, got, want) -> None:
    import torch

    for k, (x, y) in enumerate(zip(got, want)):
        # On the card when both are there: a 16,384-wide audit is 1 GiB.
        same = x.device == y.device
        if x.shape != y.shape or not torch.equal(x if same else x.cpu(),
                                                 y if same else y.cpu()):
            fail(f"{name}: output {k} differs from the plain version "
                 f"(max abs err {max_abs_err([x], [y])})")


# -- phase 1 ------------------------------------------------------------------


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; device_count={count}")
    log(card)    # name and power limit, as nvidia-smi prints them
    return {"kind": name, "count": count, "smi": card}


# -- phase 2 ------------------------------------------------------------------


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(force=True)
    log(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc, {' '.join(build.NVCC_FLAGS)})")
    for name, info in logs.items():
        log(f"[build] {name}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if re.search(r"registers|spill|smem|Compiling entry", line):
                log(f"[build]   {line.strip()}")
    import torch

    from repro_torch.kernels import flash_attention as fa

    for dtype, kernel in ((torch.float32, "flash_fwd_kernel"),
                          (torch.bfloat16, "flash_bf16_kernel")):
        log(f"[build]   flash_attention :: {kernel}: dynamic smem " + ", ".join(
            f"hd {hd}: {fa.smem_bytes(dtype, hd)} B" for hd in fa.HEAD_DIMS))
    log("[build]   flash_bf16_kernel: ptxas counts the launch bound (384 threads, "
        "1 CTA/SM: 168); setmaxnreg gives the producer warpgroup 24 and each "
        "consumer warpgroup 240")


# -- phase 3 ------------------------------------------------------------------


def _ingest_inputs(rng, b, n_res, *, cadence, pending, device):
    """Random ingest inputs; ``pending`` adds a live pending ring of
    ``max(128, 2B)`` slots, as the engine sizes it."""
    import numpy as np
    import torch

    t = lambda x: torch.as_tensor(x, dtype=torch.int32, device=device)  # noqa: E731
    kw = dict(
        client=t(rng.integers(0, 16, b)), replica=t(rng.integers(0, 3, b)),
        resource=t(rng.integers(0, n_res, b)),
        is_write=torch.as_tensor(rng.integers(0, 2, b), dtype=torch.bool,
                                 device=device),
        g0=t(rng.integers(0, 40, b)), raw0=t(rng.integers(0, 40, b)),
        floor0=t(rng.integers(0, 40, b)),
    )
    step0 = int(rng.integers(0, 10_000))
    if cadence or pending:
        kw["op_index"] = t(step0 + np.arange(b))
    if cadence:
        kw["apply_index"] = t(step0 + rng.integers(0, 2 * b, b))
    if pending:
        q = max(128, 2 * b)
        kw.update(
            pend_version=t(rng.integers(0, 60, q)),
            pend_resource=t(rng.integers(0, n_res, q)),
            pend_live=torch.as_tensor(rng.integers(0, 2, q), dtype=torch.bool,
                                      device=device),
            pend_apply=t(step0 + rng.integers(0, 2 * b, q)),
        )
    return kw


def _audit_inputs(rng, m, n, device, *, mix: str = "random", n_resources: int = 6):
    """Audit inputs: the timed random mix (6 resources, 90 % valid), or one
    of ``tests/torch_port_helpers.AUDIT_MIXES`` (``"one_resource"``: the
    dense mix)."""
    import torch

    from torch_port_helpers import audit_mix

    arrays = audit_mix(mix, rng, m, n, n_resources=n_resources)
    return {k: torch.as_tensor(x, device=device) for k, x in zip(
        ("vc", "client", "kind", "resource", "version", "seq", "valid"), arrays)}


def audit_base_pairs(kw) -> int:
    """Pairs whose code needs the clock compare: both valid, one resource,
    ``seq_i < seq_j`` (counted on the card in row chunks)."""
    valid, res, seq = kw["valid"], kw["resource"], kw["seq"]
    total = 0
    for i0 in range(0, valid.shape[0], 2048):
        sl = slice(i0, i0 + 2048)
        total += int((valid[sl, None] & valid[None, :] & (res[sl, None] == res[None, :])
                      & (seq[sl, None] < seq[None, :])).sum())
    return total


def audit_bounds(m: int, n: int, base: int, fits16: bool) -> dict:
    """B.2's bounds at the INT32 rate, each the larger of its operations
    and the bytes (clocks and six columns read once, the (M, M) int32
    codes written once).  ``floor``: the function's own work, the
    ``base`` pairs only (every other pair's code is 0 by the meta alone),
    each at one add-max per clock component (per two components where
    every value fits int16, ``fits16``: the kernel's ``__viaddmax_s16x2``)
    plus 20 for the row-sum compare and the code; ``reference``: the
    base pairs at the reference's 3N + 20; ``dense``: every pair at
    3N + 20; ``fma``: the dense count at the f32 FMA rate, the bound
    first reported for this kernel."""
    n_bytes = m * n * 4 + m * (5 * 4 + 1) + m * m * 4
    t_bytes = n_bytes / PEAK_BYTES_S

    def at_int32(n_ops):
        t_ops = n_ops / PEAK_INT32_OPS_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    per_pair = ((n + 1) // 2 if fits16 else n) + 20
    return {"floor": at_int32(base * per_pair), "reference": at_int32(base * (3 * n + 20)),
            "dense": at_int32(m * m * (3 * n + 20)),
            "fma": bound_ms(n_bytes, m * m * (3 * n + 20))}


def time_audit(kw, delta: int, iters: int, label: str) -> dict:
    """B.2 on one input set: every design against the plain version, bit
    for bit, and timed (CUDA events; for M <= 4096, where the call is the
    host's launch cost, the median of five means); the plain version's
    time; the base share and both bounds; for M <= 4096 the CUDA kernels
    of one ``ops.vclock_audit`` call and its device time (profiler)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import vclock_audit as va

    m, n = kw["vc"].shape
    want = va.vclock_audit_ref(**kw, delta=delta)
    small = m <= 4096
    design_ms = {}
    for design in va.DESIGNS:
        got = va.vclock_audit_cuda(**kw, delta=delta, design=design)
        require_equal(f"vclock_audit {label} design={design}", [got], [want])
        del got
        call = lambda: va.vclock_audit_cuda(**kw, delta=delta, design=design)  # noqa: E731
        # Small calls are the host's launch cost: medians of five.
        design_ms[design] = (host_bound_ms(call, iters)[0] if small
                             else cuda_time_ms(call, iters))
    del want
    torch.cuda.empty_cache()
    plain = cuda_time_ms(lambda: va.vclock_audit_ref(**kw, delta=delta),
                         max(1, iters // 10), warmup=1)
    base = audit_base_pairs(kw)
    vc = kw["vc"]
    fits16 = n % 4 == 0 and int(vc.min()) >= 0 and int(vc.max()) <= 32767
    bounds = audit_bounds(m, n, base, fits16)
    call = lambda: ops.vclock_audit(**kw, delta=delta)  # noqa: E731
    kernels = cuda_kernels_per_call(call) if small else None
    dev_ms = device_ms_per_call(call) if small else None
    torch.cuda.empty_cache()
    log(f"[audit] {label} (M={m}, N={n}, delta={delta}): base share {base / (m * m):.6f} "
        f"({base} pairs); auto {design_ms['auto']:.6f} ms, dense {design_ms['dense']:.6f}, "
        f"compact {design_ms['compact']:.6f}; plain {plain:.6f} ms; floor "
        f"{bounds['floor'][0]:.6f} ms ({bounds['floor'][1]}; clocks fit int16: "
        f"{fits16}), base pairs at 3N + 20 {bounds['reference'][0]:.6f} ms "
        f"({bounds['reference'][1]}), dense bound "
        f"{bounds['dense'][0]:.6f} ms ({bounds['dense'][1]}) at the INT32 rate, "
        f"{bounds['fma'][0]:.6f} ms at the f32 FMA rate; CUDA kernels per call "
        f"{kernels}, device {dev_ms} ms per call")
    return {"ms": design_ms["auto"], "design_ms": design_ms, "plain_ms": plain,
            "bound": bounds["floor"], "bound_dense": bounds["dense"],
            "bound_reference": bounds["reference"], "bound_fma": bounds["fma"],
            "base_share": base / (m * m),
            "cuda_kernels_per_call": kernels, "device_ms": dev_ms, "err": 0,
            "shape": f"M={m}, N={n}, {label}"}


def _chain_inputs(rng, b, c, device, *, p: int = 3, mix: str = "random"):
    """Chain inputs of one ``tests/torch_port_helpers.chain_mix``, or the
    flat scale run's own first batch (``mix="stream"``: the WORKLOAD_A
    stream at 64 clients, replica = the op's home); the (C, C) session
    clocks are drawn on the device (a 16,384-wide clock is 1 GiB)."""
    import torch

    from torch_port_helpers import chain_mix

    t = lambda x: torch.as_tensor(x, dtype=torch.int32, device=device)  # noqa: E731
    g = torch.Generator(device=device).manual_seed(int(rng.integers(0, 2**31)))
    if mix == "stream":
        from repro_torch.engine.stream import op_stream
        from repro_torch.storage.ycsb import WORKLOAD_A

        ops = op_stream(WORKLOAD_A, b, c, SCALE["n_resources"], 0, p)
        cl, rp, w = ops["client"], ops["home"], ops["kind"]
    else:
        cl, rp, w = chain_mix(mix, rng, b, c, p)
    return dict(
        client=t(cl), replica=t(rp), is_write=t(w),
        session_vc=torch.randint(0, 50, (c, c), generator=g, dtype=torch.int32,
                                 device=device),
        replica_vc=t(rng.integers(0, 50, (p, c))),
    )


# The chain's adversarial checks: (B, C, P) and the designs each forces
# (besides the automatic choice), at the narrow and the wide width.
CHAIN_CHECKS = (
    ((128, 16, 3), ("small", "segments", "levels")),
    ((4096, 64, 3), ("small", "segments", "levels")),
    ((1, 16, 1), ("small", "segments", "levels")),
    ((2500, 40, 12), ("small", "segments", "levels")),
    ((300, 500, 3), ("levels",)),
    ((64, 2100, 12), ("levels",)),
    ((1, 4096, 3), ("levels",)),
)


# session_floor's (P, C, R, B) at the serving scale (12 replicas, 16,384
# sessions, one model, every session once) and on the paper's store (12
# replicas, 64 clients, 5,000,000 rows, one 4096-op batch).
SESSION_FLOOR_SERVING = (12, 16_384, 1, 16_384)
# The chain timed at the serving scale's clock width and batch: one
# component per session, every session once.
CHAIN_WIDE = 16_384
SESSION_FLOOR_PAPER = (12, 64, 5_000_000, 4096)


def _admit_inputs(shape, device, *, seed: int, dup: bool = False):
    """``(rv, rf, wf, client, replica, resource, valid)`` at (P, C, R, B),
    drawn on the device; ``dup`` makes every pair of ops and every third
    op share one (client, resource) cell."""
    import torch

    p, c, r, b = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def ri(hi, size):
        return torch.randint(0, hi, size, generator=g, dtype=torch.int32, device=device)

    rv, rf, wf = ri(40, (p, r)), ri(40, (c, r)), ri(40, (c, r))
    cl, pl, res = ri(c, (b,)), ri(p, (b,)), ri(r, (b,))
    if dup:
        cl[1::2], res[1::2] = cl[0::2][: b // 2], res[0::2][: b // 2]
        cl[2::3], res[2::3] = cl[0], res[0]
    valid = torch.rand((b,), generator=g, device=device) < 0.8
    return rv, rf, wf, cl, pl, res, valid


def time_session_floor(shape, device, iters: int) -> dict:
    """The kernel, its plain version and one ``scatter_reduce_`` (the
    floor update alone) at one shape, with the bound with and without the
    (C, R) copy into the separate output."""
    from repro_torch.kernels import session_floor as sf

    p, c, r, b = shape
    args = _admit_inputs(shape, device, seed=b)[:-1]
    got = sf.session_admit_cuda(*args)
    want = sf.session_admit_ref(*args)
    require_equal(f"session_floor timing {shape}", got, want)
    err = max_abs_err(got, want)
    del got
    ms = cuda_time_ms(lambda: sf.session_admit_cuda(*args), iters)
    plain = cuda_time_ms(lambda: sf.session_admit_ref(*args), iters)
    scratch = args[1].clone().view(-1)
    idx = args[3].long() * r + args[5].long()
    served = want[0]
    scatter = cuda_time_ms(
        lambda: scratch.scatter_reduce_(0, idx, served, "amax"), iters)
    # Per op: 3 index words read, 3 gathered words, 3 output words (adm
    # is a byte) and one atomic read-modify-write; ~10 integer operations.
    op_bytes = b * (3 * 4 + 3 * 4 + (4 + 1 + 4) + 2 * 4)
    copy = 2 * c * r * 4
    del want, scratch, idx, served
    return {"ms": ms, "plain_ms": plain, "bound": bound_ms(op_bytes + copy, b * 10),
            "bound_nocopy": bound_ms(op_bytes, b * 10), "scatter_ms": scatter,
            "err": err, "shape": f"P={p}, C={c}, R={r}, B={b}"}


def parent_select(ctl, state, explore_u, arm, read_frac):
    """The parent's ``AdaptiveController.select`` on the card: the window
    sums and rates, the packed session parameters, the reference-layout
    scorer kernel, ``argmax`` and the exploration ``where`` (~39 device
    operations)."""
    import torch

    from repro_torch.kernels import policy_score as ps
    from repro_torch.policy import sla

    stale, viol, count = ctl.aggregate(state)
    sess = sla.session_params(ctl.target_sla, ctl.n_sessions, read_frac=read_frac,
                              device=ctl.device)
    util, _ = ps.policy_score_cuda(sess, ctl.table, stale, viol, count)
    greedy = torch.argmax(util, dim=1).to(torch.int32)
    return torch.where(explore_u < ctl.epsilon(state), arm, greedy)


def time_select(s: int, iters: int) -> dict:
    """B.6 per controller selection at S sessions (W = 8, L = 6, per-session
    read fractions): the whole ``AdaptiveController.select``, the kernel
    alone, the parent's path (``parent_select``) and the plain version, the
    device operations of each call, device time and the byte bound.  Calls
    that the host's launch cost sets are medians of five CUDA-event
    means."""
    import numpy as np

    from repro_torch.kernels import policy_score as ps
    from repro_torch.policy.controller import AdaptiveController
    from repro_torch.policy.sla import SLA_RELAXED, sla_bounds
    from torch_port_helpers import select_inputs

    ctl = AdaptiveController(s, SLA_RELAXED, device="cuda")
    bounds = sla_bounds(ctl.target_sla)
    inp = select_inputs(np.random.default_rng(s), s, ctl.window, ctl.device)
    state = ctl.init()._replace(stale_win=inp["stale_win"], viol_win=inp["viol_win"],
                                reads_win=inp["reads_win"], ptr=9, epoch=3)
    rings = (state.stale_win, state.viol_win, state.reads_win)
    u, arm, rf = inp["explore_u"], inp["arm"], inp["read_frac"]
    eps = ctl.epsilon(state)
    call = lambda: ctl.select(state, u, arm, read_frac=rf)  # noqa: E731
    parent = lambda: parent_select(ctl, state, u, arm, rf)  # noqa: E731
    draws = dict(read_frac=rf, explore_u=u, arm=arm, epsilon=eps)
    got, want = call(), ps.policy_select_ref(*rings, ctl.table, bounds, **draws)
    require_equal(f"select S={s}", [got], [want])
    require_equal(f"select S={s} against the parent's path", [got], [parent()])
    ms, runs = host_bound_ms(call, iters)
    kernel_ms, _ = host_bound_ms(
        lambda: ps.policy_select_cuda(*rings, ctl.table, bounds, **draws), iters)
    parent_ms, parent_runs = host_bound_ms(parent, iters)
    plain = cuda_time_ms(lambda: ps.policy_select_ref(*rings, ctl.table, bounds, **draws),
                         max(1, iters // 10))
    kernels = cuda_kernels_per_call(call)
    require_one_kernel(f"AdaptiveController.select at S={s}", kernels)
    parent_ops = cuda_kernels_per_call(parent)
    dev_ms = device_ms_per_call(call)
    w, _, n_levels = state.stale_win.shape
    # The rings read once; per session the draws, the read fraction and the
    # choice; ~20 operations per cell and 3 adds per slot.
    bnd = bound_ms(3 * w * s * n_levels * 4 + 16 * s, s * n_levels * (20 + 3 * w))
    log(f"[kernels] select S={s}, W={w}, L={n_levels}: AdaptiveController.select "
        f"{ms:.6f} ms (median of " + " / ".join(f"{r:.6f}" for r in runs)
        + f"), its kernel alone {kernel_ms:.6f} ms, device {dev_ms} ms; CUDA kernels "
        f"per call {kernels}; the parent's path {parent_ms:.6f} ms (median of "
        + " / ".join(f"{r:.6f}" for r in parent_runs) + f"; {parent_ops} device "
        f"operations per call); plain {plain:.6f} ms; bound {bnd[0]:.6f} ms ({bnd[1]})")
    return {"ms": kernel_ms, "whole_call_ms": ms, "runs": runs, "parent_path_ms": parent_ms,
            "parent_path_ops": parent_ops, "device_ms": dev_ms,
            "cuda_kernels_per_call": kernels, "plain_ms": plain, "bound": bnd,
            "err": max_abs_err([got], [want]), "shape": f"S={s}, W={w}, L={n_levels}"}


def parent_admission(store, state, index):
    """The parent's router admission on the card, from the host (2, B)
    index: two index copies and casts, a zero resource, ``admit_batch``
    (the (C, R) floor copy, the kernel), a cast and a stack; the routers
    then copy ``[admissible, floor]`` to the host."""
    import torch

    dev = state.cluster.read_floor.device
    sid_t = torch.as_tensor(index[0].astype("int64"), device=dev).to(torch.int32)
    pref_t = torch.as_tensor(index[1].astype("int64"), device=dev).to(torch.int32)
    _, _, adm, floor = store.admit_batch(state, client=sid_t, replica=pref_t,
                                         resource=torch.zeros_like(sid_t))
    return torch.stack([adm.to(torch.int32), floor])


def time_admission(shape, iters: int) -> dict:
    """B.7 per router admission at (P, C, R, B): the whole check as
    ``route_batch`` makes it (the host index in, the kernel, ``[admissible,
    floor]`` back to the host), the kernel alone, the parent's path
    (``parent_admission``) and the plain version, with their device
    operations and the bound."""
    import numpy as np
    import torch

    from repro_torch.core.replicated_store import ReplicatedStore
    from repro_torch.kernels import session_floor as sf

    p, c, r, b = shape
    rv, rf, wf, cl, pl, _, _ = _admit_inputs(shape, "cuda", seed=b)
    store = ReplicatedStore(p, c, r, device="cuda")
    st = store.init()
    st = st._replace(cluster=st.cluster._replace(replica_version=rv, read_floor=rf,
                                                 write_floor=wf))
    index = np.stack([cl.cpu().numpy(), pl.cpu().numpy()]).astype(np.int32)
    index_t = torch.as_tensor(index, device="cuda")
    call = lambda: store.session_check(st, index).cpu().numpy()  # noqa: E731
    parent = lambda: parent_admission(store, st, index).cpu().numpy()  # noqa: E731
    got, want = call(), sf.session_check_ref(rv, rf, wf, index_t).cpu().numpy()
    if not (np.array_equal(got, want) and np.array_equal(got, parent())):
        fail(f"session_check timing {shape}: differs from the plain version or the "
             "parent's path")
    ms, runs = host_bound_ms(call, iters)
    kernel_ms, _ = host_bound_ms(lambda: sf.session_check_cuda(rv, rf, wf, index_t), iters)
    parent_ms, parent_runs = host_bound_ms(parent, iters)
    plain = cuda_time_ms(lambda: sf.session_check_ref(rv, rf, wf, index_t), iters)
    dev_ops, kernels = device_ops_per_call(call, "session_check_kernel")
    require_one_kernel(f"router admission at {shape}", kernels)
    parent_ops = cuda_kernels_per_call(parent)
    dev_ms = device_ms_per_call(call)
    # Per op: 2 index words, 3 gathered words, 2 output words; ~8 integer
    # operations.
    bnd = bound_ms(b * 7 * 4, b * 8)
    log(f"[kernels] router admission (P, C, R, B) = {shape}: the whole check "
        f"{ms:.6f} ms (median of " + " / ".join(f"{x:.6f}" for x in runs)
        + f"; {dev_ops} device operations per call, {kernels} CUDA kernel), its kernel "
        f"alone {kernel_ms:.6f} ms, device {dev_ms} ms; the parent's path "
        f"{parent_ms:.6f} ms (median of " + " / ".join(f"{x:.6f}" for x in parent_runs)
        + f"; {parent_ops} device operations per call); plain {plain:.6f} ms; bound "
        f"{bnd[0]:.6f} ms ({bnd[1]})")
    return {"ms": kernel_ms, "whole_call_ms": ms, "runs": runs, "parent_path_ms": parent_ms,
            "parent_path_ops": parent_ops, "device_ops": dev_ops, "device_ms": dev_ms,
            "cuda_kernels_per_call": kernels, "plain_ms": plain, "bound": bnd, "err": 0,
            "shape": f"P={p}, C={c}, R={r}, B={b}"}


def parent_plan_placement(topology, reads, writes, sla):
    """The parent's ``plan_placement`` on the card, op for op: six input
    copies, the (R, K) grid kernel, ``argmax``, two gathers and three
    copies out, then the host cost and the result -> a
    ``PlacementResult``."""
    import numpy as np
    import torch

    from repro_torch.geo import placement as pl
    from repro_torch.kernels import placement_score as pls

    tables = pl.plan_tables(topology, reads)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to("cuda")

    util, feas = pls.placement_score_cuda(
        t(reads), t(writes), *(t(tables[k]) for k in (
            "read_price", "write_price", "read_rtt", "cand_meta")),
        max_latency_ms=float(sla.max_read_latency_ms))
    choice_t = torch.argmax(util, dim=1, keepdim=True)
    utility = torch.gather(util, 1, choice_t)[:, 0].cpu().numpy()
    feasible = torch.gather(feas, 1, choice_t)[:, 0].cpu().numpy().astype(bool)
    del util, feas
    choice = choice_t[:, 0].cpu().numpy().astype(np.int32)
    cand = tables["candidates"]
    return pl.PlacementResult(
        choice=choice, counts=cand[choice], utility=utility.astype(np.float32),
        feasible=feasible.astype(bool),
        cost=pl.chosen_cost(tables, choice, reads, writes), candidates=cand)


PLAN_FIELDS = ("choice", "counts", "utility", "feasible", "cost")


def plans_differ(a, b) -> list[str]:
    """The fields of two ``PlacementResult``s that differ, floats bit for
    bit."""
    import numpy as np

    def bits(x):
        return x.view(np.int32) if x.dtype == np.float32 else x

    return [f for f in PLAN_FIELDS if getattr(a, f).dtype != getattr(b, f).dtype
            or not np.array_equal(bits(getattr(a, f)), bits(getattr(b, f)))]


def plan_device_ops(fn) -> tuple[int | None, int | None, int | None]:
    """From one profiling session: the device operations one call of
    ``fn`` runs, its CUDA kernels (no copy or fill) and its
    ``placement_select`` kernels (``None``: not measured)."""
    rows = _device_rows(fn, None)
    if not rows:
        return None, None, None

    def per_call(keep):
        return sum(e.count for e in rows if keep(e.key)) // PROFILED_CALLS

    return (per_call(lambda k: True),
            per_call(lambda k: not k.startswith(("Memcpy", "Memset"))),
            per_call(lambda k: "placement_select" in k))


def time_plan_select(r: int, iters: int) -> dict:
    """B.5's fused select (``placement_select_cuda``) at R resources x the
    124 candidates, G = 3: the kernel, its plain version, the parent's
    device path on the same inputs (the grid kernel, ``argmax``, two
    gathers), the device time and the bound by operations and by bytes.
    At the geo path's R = 24 also one ``plan_placement`` on the paper's
    topology: its wall, its device operations (at most four; one copy in,
    one kernel, one copy out) and the parent's (``parent_plan_placement``)."""
    import numpy as np
    import torch

    from repro_torch.geo import placement as pl
    from repro_torch.geo.topology import PAPER_TOPOLOGY
    from repro_torch.kernels import placement_score as pls
    from repro_torch.policy.sla import SLA_RELAXED
    from torch_port_helpers import placement_inputs

    args = placement_inputs(np.random.default_rng(r), r, torch.device("cuda"))
    call = lambda: pls.placement_select_cuda(*args, max_latency_ms=10.0)  # noqa: E731
    got = call()
    want = pls.placement_select_ref(*args, max_latency_ms=10.0)
    require_equal(f"placement_select timing R={r}", [got], [want])

    def parent_device():
        util, feas = pls.placement_score_cuda(*args, max_latency_ms=10.0)
        choice = torch.argmax(util, dim=1, keepdim=True)
        return choice, torch.gather(util, 1, choice), torch.gather(feas, 1, choice)

    ms = cuda_time_ms(call, iters)
    parent_ms = cuda_time_ms(parent_device, iters)
    plain = cuda_time_ms(
        lambda: pls.placement_select_ref(*args, max_latency_ms=10.0),
        max(1, iters // 10), warmup=1)
    kernels = cuda_kernels_per_call(call)
    require_one_kernel(f"placement_select at R={r}", kernels)
    dev_ms = device_ms_per_call(call)
    k, g = args[2].shape
    n_bytes = 2 * r * g * 4 + (3 * k * g + 2 * k) * 4 + 3 * r * 4
    # What the function needs, each once: per cell the cost's 2G FMAs (two
    # operations each), the violation count (and, popc), the penalty's
    # product, the utility's subtraction and the argmax's compare; per row
    # the demand's G sums and G tests; per candidate its G latency tests
    # and the validity test.
    n_ops = r * k * (4 * g + 5) + 2 * r * g + k * (g + 1)
    out = {"ms": ms, "plain_ms": plain, "bound": bound_ms(n_bytes, n_ops),
           "bound_bytes_ms": n_bytes / PEAK_BYTES_S * 1e3,
           "bound_operations_ms": n_ops / PEAK_OPS_S * 1e3,
           "err": max_abs_err([got], [want]), "parent_device_ms": parent_ms,
           "cuda_kernels_per_call": kernels, "device_ms": dev_ms,
           "shape": f"R={r}, K={k}, G={g}"}
    log(f"[kernels] placement_select R={r}: kernel {ms:.6f} ms (device {dev_ms} ms), "
        f"the parent's device path (grid kernel, argmax, gathers) {parent_ms:.6f} ms; "
        f"bound {out['bound_operations_ms']:.6f} ms by operations, "
        f"{out['bound_bytes_ms']:.6f} ms by bytes")
    if r != 24:
        return out
    reads, writes = (a.cpu().numpy() for a in args[:2])
    plan = lambda: pl.plan_placement(PAPER_TOPOLOGY, reads, writes,  # noqa: E731
                                     SLA_RELAXED, device="cuda")
    parent = lambda: parent_plan_placement(PAPER_TOPOLOGY, reads,  # noqa: E731
                                           writes, SLA_RELAXED)
    differ = plans_differ(plan(), parent())
    if differ:
        fail(f"plan_placement R={r}: {differ} differ from the parent's path")
    ops_n, kern_n, sel_n = plan_device_ops(plan)
    if ops_n is None:
        fail(f"plan_placement R={r}: device operations not measured "
             f"({_UNWHOLE[-PROFILE_TRIES:]})")
    if sel_n != 1 or kern_n != 1 or ops_n > 4:
        fail(f"plan_placement R={r}: {ops_n} device operations per call, {kern_n} "
             f"CUDA kernels, {sel_n} placement_select; want <= 4, 1, 1")
    parent_ops, parent_kernels, _ = plan_device_ops(parent)
    whole, runs = host_bound_ms(plan, 10)
    parent_whole, parent_runs = host_bound_ms(parent, 10)
    log(f"[kernels] plan_placement R={r} (paper topology, SLA_RELAXED): "
        f"{ops_n} device operations per call ({kern_n} CUDA kernel), wall "
        f"{whole:.6f} ms (median of " + " / ".join(f"{x:.6f}" for x in runs)
        + f"); the parent's path {parent_ops} device operations ({parent_kernels} "
        f"CUDA kernels), {parent_whole:.6f} ms (median of "
        + " / ".join(f"{x:.6f}" for x in parent_runs) + "); results bit-equal")
    out.update(whole_call_ms=whole, runs=runs, parent_path_ms=parent_whole,
               parent_path_ops=parent_ops, device_ops=ops_n)
    return out


def _digest_table(rng, p, k, m, device):
    """A (P, K, 4) digest table (extreme components, so the differences
    overflow; replica 1 equal to replica 0) and (M, 2) int64 pairs on the
    card, every third a self pair."""
    import numpy as np
    import torch

    extremes = np.asarray([2**31 - 1, -(2**31), 0, 1, -1, 7], np.int64)
    tab = rng.choice(extremes, (p, k, 4)) + rng.integers(-3, 4, (p, k, 4))
    tab = ((tab + 2**31) % 2**32 - 2**31).astype(np.int32)
    if p > 1:
        tab[1] = tab[0]
    pairs = rng.integers(0, p, (m, 2))
    pairs[::3, 1] = pairs[::3, 0]
    return (torch.as_tensor(tab, device=device),
            torch.as_tensor(pairs, dtype=torch.int64, device=device))


def _hist_inputs(rng, m, b, n_bins, device):
    """Ages in [-50, 1200) against [0, 1024): both edge bins saturate;
    1e9, -1e9 and NaN columns; random masks and one empty row."""
    import numpy as np
    import torch

    from repro_torch.kernels import histogram as hg

    v = rng.integers(-50, 1200, (m, b)).astype(np.float32)
    v[:, ::9] = 1e9
    v[:, 1::9] = -1e9
    v[:, 2::9] = np.nan
    mask = rng.integers(0, 2, (m, b)).astype(np.int32)
    if m > 1:
        mask[-1] = 0
    params = hg.metric_params(0.0, 1024.0, n_bins, device=device).expand(m, 2)
    return (torch.as_tensor(v, device=device), torch.as_tensor(mask, device=device),
            params.contiguous())


def _bits_equal(a, b) -> bool:
    """Same shape and the same bits (f32 compared as int32), on the card."""
    import torch

    if a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def check_select(dev) -> None:
    """B.6's selection from the controller's three rings, both modes,
    against its plain version: S in 1 .. the fleet, W in 1, 8 (the ring
    pointer wrapped), six and two levels, the read fraction a value and
    per session, every row valid and a mask, epsilon 0, 1 and 0.05; tie
    rows (levels 0 and 1 equal) and NaN rows (the first NaN leads)."""
    import numpy as np
    import torch

    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.kernels import policy_score as ps
    from repro_torch.policy.controller import AdaptiveController
    from repro_torch.policy.sla import SLA_RELAXED, SLA_STRICT, sla_bounds
    from torch_port_helpers import f32_same, select_inputs

    two = (ConsistencyLevel.ONE, ConsistencyLevel.X_STCC)
    n_checked = 0
    eps_values = (0.0, 1.0, float(np.float32(0.05)))
    for s in (1, 16, 64, 129, FLEET_SESSIONS + 3):
        for w in (1, 8):
            for levels in (None, two):
                inp = select_inputs(np.random.default_rng(s + w), s, w, dev, levels=levels)
                rings = [inp[k] for k in ("stale_win", "viol_win", "reads_win", "table")]
                sla = SLA_STRICT if (s + w) % 2 else SLA_RELAXED
                bounds = sla_bounds(AdaptiveController(1, sla, device=dev).target_sla)
                for rf in (0.5, inp["read_frac"]):
                    for valid in (None, inp["valid"]):
                        kw = dict(read_frac=rf, valid=valid)
                        for eps in eps_values:
                            draws = dict(explore_u=inp["explore_u"], arm=inp["arm"],
                                         epsilon=eps)
                            got = ps.policy_select_cuda(*rings, bounds, **kw, **draws)
                            want = ps.policy_select_ref(*rings, bounds, **kw, **draws)
                            require_equal(f"policy_select S={s} W={w} L="
                                          f"{rings[3].shape[1]} eps={eps}", [got], [want])
                        got = ps.policy_select_cuda(*rings, bounds, **kw)
                        want = ps.policy_select_ref(*rings, bounds, **kw)
                        if not (f32_same(got[0], want[0]) and torch.equal(got[1], want[1])):
                            fail(f"policy_select scores S={s} W={w}: differ from the "
                                 "plain version")
                        n_checked += len(eps_values) + 1
                del inp, rings, got, want
    torch.cuda.empty_cache()
    log(f"[kernels] policy_select: {n_checked} cases equal (choices exactly, utilities "
        f"bit for bit with any NaN equal to any NaN; S in 1,16,64,129,"
        f"{FLEET_SESSIONS + 3} x W in 1,8 (ring pointer wrapped) x L in 6,2 x read "
        "fraction a value and per session x all / partly valid x epsilon 0, 1, 0.05 "
        "and the scores mode; tie and NaN rows)")


def phase_kernels() -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import digest_compare as dc
    from repro_torch.kernels import histogram as hg
    from repro_torch.kernels import op_ingest as oi
    from repro_torch.kernels import ops
    from repro_torch.kernels import placement_score as pls
    from repro_torch.kernels import policy_score as ps
    from repro_torch.kernels import session_floor as sf
    from repro_torch.kernels import vclock_audit as va
    from repro_torch.kernels import vclock_chain as vch
    from torch_port_helpers import placement_inputs, policy_inputs

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    timings = {}

    # op_ingest: main-path batch sizes, ragged sizes, all cadence inputs.
    n_checked = 0
    for b in (8, 16, 37, 128, 300, 1000, 4096):
        n_res = 24 if b <= 128 else 512
        for cadence, pending in ((False, False), (True, False),
                                 (False, True), (True, True)):
            kw = _ingest_inputs(rng, b, n_res, cadence=cadence,
                                pending=pending, device=dev)
            got = ops.op_ingest(**kw, impl="cuda")
            want = ops.op_ingest(**kw, impl="torch")
            torch.cuda.synchronize()
            require_equal(f"op_ingest B={b} cadence={cadence} "
                          f"pending={pending}", got, want)
            n_checked += 1
    log(f"[kernels] op_ingest: {n_checked} cases equal "
        "(B in 8,16,37,128,300,1000,4096 x apply_index/live pending ring)")

    def time_ingest(b, q_live):
        kw = _ingest_inputs(np.random.default_rng(b), b, 24 if b <= 128 else 4096,
                            cadence=True, pending=q_live, device=dev)
        packed = oi.pack_ops(**kw)
        got = oi.op_ingest_cuda(packed)
        want = ops.op_ingest(**kw, impl="torch")
        require_equal(f"op_ingest timing B={b}", got, want)
        iters = 200 if b <= 128 else 20
        ms = cuda_time_ms(lambda: oi.op_ingest_cuda(packed), iters)
        plain = cuda_time_ms(lambda: ops.op_ingest(**kw, impl="torch"), iters)
        q = packed.pend.shape[0]
        pairs = b * (b - 1) / 2
        n_bytes, n_ops = b * 9 * 4 + q * 4 * 4 + b * 3 * 4, pairs * 13 + 4 * b * q
        bnd = bound_ms(n_bytes, n_ops)
        bnd_int = max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_INT32_OPS_S) * 1e3
        kernels = cuda_kernels_per_call(lambda: oi.op_ingest_cuda(packed), "ingest")
        log(f"[kernels] op_ingest B={b}, Qp={q}: {ms:.6f} ms, plain {plain:.6f} ms; "
            f"bound {bnd[0]:.6f} ms at the f32 FMA rate ({bnd[1]}), {bnd_int:.6f} ms "
            f"at the INT32 rate; CUDA kernels per call {kernels}")
        return {"ms": ms, "plain_ms": plain, "bound": bnd, "bound_int32": bnd_int,
                "cuda_kernels_per_call": kernels,
                "err": max_abs_err(got, want), "shape": f"B={b}, Qp={q}"}

    timings["op_ingest"] = time_ingest(128, False)
    timings["op_ingest@4096"] = time_ingest(4096, True)
    require_one_kernel("op_ingest at B=128", timings["op_ingest"]["cuda_kernels_per_call"])

    # The one-CTA kernel against the tile kernels on either side of
    # SMALL_MAX: the measurement behind the threshold.
    small_max = oi.SMALL_MAX
    for b in (128, 256, 512, 1024):
        kw = _ingest_inputs(np.random.default_rng(b + 1), b, 24 if b <= 128 else 512,
                            cadence=True, pending=True, device=dev)
        packed = oi.pack_ops(**kw)
        want = ops.op_ingest(**kw, impl="torch")
        row = []
        for limit in (1024, 0):               # one CTA, then the tiles
            oi.SMALL_MAX = limit
            require_equal(f"op_ingest B={b} SMALL_MAX={limit}",
                          oi.op_ingest_cuda(packed), want)
            row.append(cuda_time_ms(lambda: oi.op_ingest_cuda(packed), 200))
        oi.SMALL_MAX = small_max
        log(f"[kernels] op_ingest B={b}, Qp={packed.pend.shape[0]}: one CTA {row[0]:.6f} ms, "
            f"tiles {row[1]:.6f} ms (SMALL_MAX = {oi.SMALL_MAX})")

    # vclock_audit: the main path's (2048, 16), a wider clock, ragged M, an
    # odd clock width and one wider than a staged chunk; every mix, every
    # design.
    from torch_port_helpers import AUDIT_MIXES

    n_checked = 0
    for m, n in ((2048, 16), (4096, 64), (1000, 16), (300, 3), (500, 100)):
        for mix in AUDIT_MIXES:
            kw = _audit_inputs(rng, m, n, dev, mix=mix)
            for delta in (0, 8, 96):
                want = ops.vclock_audit(**kw, delta=delta, impl="torch")
                for design in va.DESIGNS:
                    got = ops.vclock_audit(**kw, delta=delta, impl="cuda", design=design)
                    torch.cuda.synchronize()
                    require_equal(f"vclock_audit {mix} M={m} N={n} delta={delta} "
                                  f"design={design}", [got], [want])
                    n_checked += 1
    log(f"[kernels] vclock_audit: {n_checked} cases equal ((M,N) in (2048,16),(4096,64),"
        f"(1000,16),(300,3),(500,100) x mixes {', '.join(AUDIT_MIXES)} x delta in "
        f"0,8,96 x designs {', '.join(va.DESIGNS)})")

    timings["vclock_audit"] = time_audit(
        _audit_inputs(np.random.default_rng(2048), 2048, 16, dev), 8, 50, "random")
    require_one_kernel("vclock_audit at (2048, 16)",
                       timings["vclock_audit"]["cuda_kernels_per_call"])
    for mix, label in (("random", "random"), ("one_resource", "dense")):
        timings[f"vclock_audit@16384/{label}"] = time_audit(
            _audit_inputs(np.random.default_rng(16384), 16384, 64, dev, mix=mix), 8, 5,
            label)
    # Between the two: where the designs cross (the auto threshold); and
    # no base pair at all (every tile skips the compare: what the kernel
    # costs without it).
    for r in (2, 3):
        time_audit(_audit_inputs(np.random.default_rng(16384), 16384, 64, dev,
                                 n_resources=r), 8, 5, f"{r} resources")
    time_audit(_audit_inputs(np.random.default_rng(16384), 16384, 64, dev,
                             mix="distinct_resources"), 8, 5, "distinct resources")
    torch.cuda.empty_cache()

    # vclock_chain: every design the shape allows, forced, and the
    # automatic one, on every adversarial mix, narrow and wide.
    from torch_port_helpers import CHAIN_MIXES

    n_checked = 0
    for (b, c, p), designs in CHAIN_CHECKS:
        for mix in CHAIN_MIXES:
            bb = min(b, c) if mix == "reads_once" else b
            kw = _chain_inputs(rng, bb, c, dev, p=p, mix=mix)
            want = vch.vclock_chain_ref(**kw)
            for design in (None,) + designs:
                got = vch.vclock_chain_cuda(**kw, design=design)
                torch.cuda.synchronize()
                require_equal(f"vclock_chain {mix} B={bb} C={c} P={p} design={design}",
                              got, want)
                n_checked += 1
            del kw, want, got
    torch.cuda.empty_cache()
    log(f"[kernels] vclock_chain: {n_checked} cases equal ((B,C,P) in "
        f"{', '.join(str(k) for k, _ in CHAIN_CHECKS)} x mixes {', '.join(CHAIN_MIXES)} "
        "x the automatic and every forced design)")

    def time_chain(b, c, iters, *, p=3, mix="random", design=None):
        kw = _chain_inputs(np.random.default_rng(b), b, c, dev, p=p, mix=mix)
        got = vch.vclock_chain_cuda(**kw, design=design)
        want = vch.vclock_chain_ref(**kw)
        require_equal(f"vclock_chain timing B={b} C={c} {mix}", got, want)
        err = max_abs_err(got, want)
        del got, want
        design = design or vch.design_for(b, c, p)
        ms, runs = host_bound_ms(lambda: vch.vclock_chain_cuda(**kw, design=design),
                                 iters, 5 if b * c <= 2**20 else 1)
        plain = cuda_time_ms(lambda: vch.vclock_chain_ref(**kw),
                             max(1, iters // 20), warmup=1)
        bnd = bound_ms(3 * b * 4 + 2 * (c * c + p * c) * 4 + b * c * 4, b * c * 4)
        depth = vch.serial_depth(design, kw["client"], kw["replica"], kw["is_write"],
                                 c, p)
        small = b * c <= 2**20
        kernels = cuda_kernels_per_call(
            lambda: vch.vclock_chain_cuda(**kw, design=design)) if small else None
        dev_ms = device_ms_per_call(
            lambda: vch.vclock_chain_cuda(**kw, design=design)) if small else None
        del kw
        torch.cuda.empty_cache()
        return {"ms": ms, "runs": runs, "device_ms": dev_ms, "plain_ms": plain,
                "bound": bnd, "err": err, "depth": depth, "design": design,
                "cuda_kernels_per_call": kernels, "shape": f"B={b}, C={c}, P={p}, {mix}"}

    timings["vclock_chain"] = time_chain(128, 16, 200)
    require_one_kernel("vclock_chain at (128, 16)",
                       timings["vclock_chain"]["cuda_kernels_per_call"])
    timings["vclock_chain@4096"] = time_chain(4096, 64, 50)
    timings["vclock_chain@4096/workload_a"] = time_chain(4096, 64, 50, mix="stream")
    # The one-CTA walk against the segment design on either side of
    # SMALL_MAX: the measurement behind the threshold.
    # Host-bound at these sizes, so the device times decide.
    for c in (16, 64):
        for b in (128, 256, 512, 1024):
            row = [time_chain(b, c, 100, design=d) for d in ("small", "segments")]
            log(f"[kernels] vclock_chain B={b}, C={c}: one-CTA walk {row[0]['ms']:.6f} "
                f"ms (device {row[0]['device_ms']} ms), segments {row[1]['ms']:.6f} ms "
                f"(device {row[1]['device_ms']} ms) (SMALL_MAX = {vch.SMALL_MAX})")

    # digest_compare: two sides' rows (ops.digest_compare on the card) at
    # the fault path's 3 pairs x 8 ranges and wider, and the gathered
    # pairs (what gossip_round runs) at M x K = 1, 24, 255, 257, 65,536;
    # overflowing and equal rows, self pairs.
    for m in (24, 1024, 65536, 1, 257):
        dig, _ = _digest_table(rng, 3, m, 1, dev)
        side_a, side_b = dig[0], dig[2].clone()
        side_b[::4] = side_a[::4]                          # equal rows
        require_equal(f"digest_compare M={m}", ops.digest_compare(side_a, side_b),
                      ops.digest_compare(side_a.cpu(), side_b.cpu(), impl="torch"))
    for p, k, m in ((2, 1, 1), (3, 8, 3), (5, 17, 15), (4, 1, 257), (64, 1024, 64)):
        dig, pairs = _digest_table(np.random.default_rng(m * k), p, k, m, dev)
        a, b = pairs[:, 0], pairs[:, 1]
        require_equal(f"digest_compare_pairs M={m} K={k}",
                      dc.digest_compare_pairs_cuda(dig, a, b, pairs.tolist()),
                      dc.digest_compare_pairs_ref(dig, a, b))
    torch.cuda.synchronize()
    log("[kernels] digest_compare: two sides' rows equal at M in 24,1024,65536,1,257; "
        "gathered pairs equal at M x K in 1, 24, 255, 257, 65536 (overflowing and "
        "equal rows, self pairs)")

    # histogram: the fault path's (2, B) op rows and (1, 3) hint depths,
    # wide rows to (3, 65536); empty rows, saturated edges, NaN, masks.
    n_checked = 0
    for m, b in ((2, 128), (2, 4096), (1, 3), (3, 65536), (2, 1), (1, 1025), (2, 4097)):
        for n_bins in (4, 64):
            vals, mask, params = _hist_inputs(rng, m, b, n_bins, dev)
            want = hg.histogram_ref(vals, mask, params, n_bins=n_bins)
            nomask = hg.histogram_ref(vals, None, params, n_bins=n_bins)
            cached = hg.row_params(0.0, 1024.0, n_bins, m, dev)
            for msk, prm, ref in ((mask, params, want), (mask > 0, cached, want),
                                  (None, params, nomask)):
                require_equal(f"histogram M={m} B={b} bins={n_bins}",
                              [hg.histogram_cuda(vals, msk, prm, n_bins=n_bins)], [ref])
                run = torch.full_like(ref, 3)
                hg.histogram_cuda(vals, msk, prm, n_bins=n_bins, out=run)
                require_equal(f"histogram accumulate M={m} B={b}", [run], [ref + 3])
                n_checked += 2
    torch.cuda.synchronize()
    log(f"[kernels] histogram: {n_checked} cases equal ((M,B) in (2,128),"
        "(2,4096),(1,3),(3,65536),(2,1),(1,1025),(2,4097) x bins 4,64 x int32 / bool / "
        "no mask, per-row and cached params x writing / accumulating)")

    def time_hist(m, b, n_bins, iters):
        """The engine's call (counts added into a running (M, n_bins)
        buffer, which then holds every call's counts exactly), and beside
        it a call that allocates and writes its output."""
        vals, mask, params = _hist_inputs(np.random.default_rng(b), m, b, n_bins, dev)
        got = hg.histogram_cuda(vals, mask, params, n_bins=n_bins)
        want = hg.histogram_ref(vals, mask, params, n_bins=n_bins)
        require_equal(f"histogram timing M={m} B={b}", [got], [want])
        run = torch.zeros_like(want)
        ms, runs = host_bound_ms(
            lambda: hg.histogram_cuda(vals, mask, params, n_bins=n_bins, out=run), iters)
        require_equal(f"histogram timing M={m} B={b}, accumulated", [run],
                      [want * len(runs) * (iters + 3)])
        write_ms, _ = host_bound_ms(
            lambda: hg.histogram_cuda(vals, mask, params, n_bins=n_bins), iters)
        plain = cuda_time_ms(lambda: hg.histogram_ref(vals, mask, params, n_bins=n_bins),
                             iters)
        bnd = bound_ms(m * b * 8 + m * 8 + m * n_bins * 4, m * b * 8)
        kernels = cuda_kernels_per_call(
            lambda: hg.histogram_cuda(vals, mask, params, n_bins=n_bins, out=run))
        require_one_kernel(f"histogram at ({m}, {b})", kernels)
        dev_ms = device_ms_per_call(
            lambda: hg.histogram_cuda(vals, mask, params, n_bins=n_bins, out=run))
        log(f"[kernels] histogram M={m}, B={b}: accumulating {ms:.6f} ms, writing a new "
            f"output {write_ms:.6f} ms (medians of five timings)")
        return {"ms": ms, "runs": runs, "device_ms": dev_ms, "write_ms": write_ms,
                "plain_ms": plain, "bound": bnd, "err": max_abs_err([got], [want]),
                "cuda_kernels_per_call": kernels,
                "shape": f"M={m}, B={b}, bins={n_bins}"}

    timings["histogram"] = time_hist(2, 128, 64, 200)
    timings["histogram@4096"] = time_hist(2, 4096, 64, 200)
    # Rows wider than any driven path's (its batches are at most 4096 ops)
    # on the same one CTA per row: what a wide row costs without a cluster.
    timings["histogram@65536"] = time_hist(3, 65536, 64, 50)

    # placement_score: the geo phase's R = 24, ragged tails, 65,536 and
    # the paper's 5,000,000 rows; SLA bound 10 ms and none.
    n_checked = 0
    for r in (24, 1, 257, 65537, 65536, SCALE["n_resources"]):
        args = placement_inputs(np.random.default_rng(r), r, dev)
        for max_lat in (10.0, math.inf):
            got = pls.placement_score_cuda(*args, max_latency_ms=max_lat)
            want = pls.placement_score_ref(*args, max_latency_ms=max_lat)
            torch.cuda.synchronize()
            if not all(_bits_equal(g, w) for g, w in zip(got, want)):
                fail(f"placement_score R={r} max_lat={max_lat}: differs from "
                     f"the plain version (max abs err {_placement_err(got, want)})")
            # The fused select against the plain selection from that grid.
            sel = pls.placement_select_cuda(*args, max_latency_ms=max_lat)
            require_equal(f"placement_select R={r} max_lat={max_lat}", [sel],
                          [pls.select_from_grid(*want)])
            n_checked += 1
            del got, want, sel
    torch.cuda.empty_cache()
    log(f"[kernels] placement_score and placement_select: {n_checked} cases each "
        f"bit-equal ((R, K, G) = (R, {N_CANDIDATES}, 3), R in 24,1,257,65537,65536,"
        f"{SCALE['n_resources']} x max_lat 10, inf; invalid, tied and zero-demand "
        "cells; the select against argmax and gathers of the plain grid)")

    def time_placement(r, iters):
        args = placement_inputs(np.random.default_rng(r), r, dev)
        reads, writes, rp, wp, rtt, meta = args
        got = pls.placement_score_cuda(*args, max_latency_ms=10.0)
        want = pls.placement_score_ref(*args, max_latency_ms=10.0)
        if not all(_bits_equal(g, w) for g, w in zip(got, want)):
            fail(f"placement_score timing R={r}: differs from the plain version")
        err = _placement_err(got, want)
        del got, want
        ms = cuda_time_ms(
            lambda: pls.placement_score_cuda(*args, max_latency_ms=10.0), iters)
        plain = cuda_time_ms(
            lambda: pls.placement_score_ref(*args, max_latency_ms=10.0),
            max(1, iters // 10), warmup=1)
        # The closest single PyTorch call: the cost term alone as one
        # f32 product (TF32 off).  It rounds differently (no per-region
        # FMA order) and computes no feasibility.
        torch.backends.cuda.matmul.allow_tf32 = False
        m1 = torch.cat([reads, writes], dim=1)
        m2 = torch.cat([rp, wp], dim=1).T.contiguous()
        store = meta[0][None, :]
        lib = cuda_time_ms(lambda: torch.addmm(store, m1, m2), iters)
        k, g = rp.shape
        bnd = bound_ms(2 * r * g * 4 + 3 * k * g * 4 + 2 * k * 4 + r * k * 8,
                       r * k * (8 * g + 1))
        torch.cuda.empty_cache()
        return {"ms": ms, "plain_ms": plain, "bound": bnd, "err": err,
                "addmm_ms": lib, "shape": f"R={r}, K={k}, G={g}"}

    timings["placement_score"] = time_placement(24, 200)
    timings[f"placement_score@{SCALE['n_resources']}"] = time_placement(
        SCALE["n_resources"], 20)
    timings["placement_select"] = time_plan_select(24, 200)
    timings[f"placement_select@{SCALE['n_resources']}"] = time_plan_select(
        SCALE["n_resources"], 20)

    # policy_score: the adaptive run's S = 64, ragged widths and a fleet
    # of 1,000,003 sessions (a multiple of no block), over the six levels
    # and a two-level table; count-0 cells, invalid rows, rf 0 and 1, inf
    # bounds, SLA_STRICT and SLA_RELAXED rows.
    from repro_torch.core.consistency import ConsistencyLevel

    two = (ConsistencyLevel.ONE, ConsistencyLevel.X_STCC)
    n_checked = 0
    for s in (64, 1, 16, 129, 1000, FLEET_SESSIONS + 3):
        for levels in (None, two):
            args = policy_inputs(np.random.default_rng(s), s, dev, levels=levels)
            got = ps.policy_score_cuda(*args)
            want = ps.policy_score_ref(*args)
            torch.cuda.synchronize()
            if not all(_bits_equal(g, w) for g, w in zip(got, want)):
                fail(f"policy_score S={s} L={args[1].shape[1]}: differs from "
                     f"the plain version (max abs err {_placement_err(got, want)})")
            n_checked += 1
    log(f"[kernels] policy_score: {n_checked} cases bit-equal (S in 64,1,16,129,"
        f"1000,{FLEET_SESSIONS + 3} x L in 6,2; count-0 cells, invalid rows, rf "
        "0 and 1, inf bounds, SLA_STRICT and SLA_RELAXED rows)")

    def time_policy(s, iters):
        args = policy_inputs(np.random.default_rng(s), s, dev)
        got = ps.policy_score_cuda(*args)
        want = ps.policy_score_ref(*args)
        if not all(_bits_equal(g, w) for g, w in zip(got, want)):
            fail(f"policy_score timing S={s}: differs from the plain version")
        err = _placement_err(got, want)
        ms = cuda_time_ms(lambda: ps.policy_score_cuda(*args), iters)
        plain = cuda_time_ms(lambda: ps.policy_score_ref(*args), max(1, iters // 10),
                             warmup=1)
        n_levels = args[1].shape[1]
        bnd = bound_ms(s * ps.SP_COLS * 4 + ps.LVL_COLS * n_levels * 4
                       + 3 * s * n_levels * 4 + 2 * s * n_levels * 4,
                       s * n_levels * 20)
        return {"ms": ms, "plain_ms": plain, "bound": bnd, "err": err,
                "shape": f"S={s}, L={n_levels}"}

    timings["policy_score/reference_layout"] = time_policy(64, 200)
    timings[f"policy_score/reference_layout@{FLEET_SESSIONS + 3}"] = time_policy(
        FLEET_SESSIONS + 3, 50)

    check_select(dev)
    timings["policy_score"] = time_select(64, 200)
    timings[f"policy_score@{FLEET_SESSIONS + 3}"] = time_select(FLEET_SESSIONS + 3, 50)
    torch.cuda.empty_cache()

    # vclock_chain at the serving scale's one component per session: the
    # random mix and the serving read batch (reads only, each session
    # once, 12 replicas).
    timings[f"vclock_chain@{CHAIN_WIDE}x{CHAIN_WIDE}"] = time_chain(CHAIN_WIDE,
                                                                  CHAIN_WIDE, 5)
    timings[f"vclock_chain@{CHAIN_WIDE}x{CHAIN_WIDE}/serving_reads"] = time_chain(
        CHAIN_WIDE, CHAIN_WIDE, 10, p=12, mix="reads_once")

    # session_floor: the reference tests' shapes, the serving phase's
    # (P, C, R, B) = (12, 64, 1, 64), the serving scale's 16,384 sessions
    # and the paper's store (64 clients x 5,000,000 rows); both enforce
    # settings, distinct and duplicate (c, r) pairs, all ops valid and a
    # partly valid batch; the routers' check alone (session_check) at the
    # same shapes, all and partly valid, the resource 0 and given.
    n_checked = n_check = 0
    for shape in ((2, 3, 4, 10), (4, 16, 8, 100), (8, 64, 1, 256), (12, 64, 1, 64),
                  SESSION_FLOOR_SERVING, SESSION_FLOOR_PAPER):
        for dup in (False, True):
            args = _admit_inputs(shape, dev, seed=n_checked, dup=dup)
            for enforce in (True, False):
                for valid in (None, args[-1]):
                    got = sf.session_admit_cuda(*args[:-1], enforce=enforce, valid=valid)
                    want = sf.session_admit_ref(*args[:-1], enforce=enforce, valid=valid)
                    torch.cuda.synchronize()
                    require_equal(f"session_floor {shape} dup={dup} enforce={enforce} "
                                  f"valid={valid is not None}", got, want)
                    n_checked += 1
                    del got, want
            index = torch.stack([args[3], args[4]])
            for valid in (None, args[-1]):
                for resource in (None, args[5]):
                    got = sf.session_check_cuda(*args[:3], index, resource=resource,
                                                valid=valid)
                    want = sf.session_check_ref(*args[:3], index, resource=resource,
                                                valid=valid)
                    require_equal(f"session_check {shape} dup={dup} valid="
                                  f"{valid is not None} resource={resource is not None}",
                                  [got], [want])
                    n_check += 1
            del args, index
    torch.cuda.empty_cache()
    log(f"[kernels] session_floor: {n_checked} cases equal ((P,C,R,B) in (2,3,4,10),"
        f"(4,16,8,100),(8,64,1,256),(12,64,1,64),{SESSION_FLOOR_SERVING},"
        f"{SESSION_FLOOR_PAPER} x distinct/duplicate (c, r) x enforce x all/partly valid)")
    log(f"[kernels] session_check: {n_check} cases equal (the same shapes x "
        "distinct/duplicate (c, r) x all/partly valid x resource 0 / given)")
    timings["session_floor/admit"] = time_session_floor((12, 64, 1, 64), dev, 200)
    timings["session_floor/admit@16384"] = time_session_floor(SESSION_FLOOR_SERVING,
                                                              dev, 100)
    timings[f"session_floor/admit@{SCALE['n_resources']}"] = time_session_floor(
        SESSION_FLOOR_PAPER, dev, 20)
    timings["session_floor"] = time_admission((12, 64, 1, 64), 200)
    timings["session_floor@16384"] = time_admission(SESSION_FLOOR_SERVING, 100)
    torch.cuda.empty_cache()

    for key, t in timings.items():
        extra = (f", addmm (cost term only, not bit-exact) {t['addmm_ms']:.6f} ms"
                 if "addmm_ms" in t else "")
        if "scatter_ms" in t:
            extra += (f", scatter_reduce_ (floor update only) {t['scatter_ms']:.6f} ms, "
                      f"bound without the (C, R) copy {t['bound_nocopy'][0]:.6f} ms "
                      f"({t['bound_nocopy'][1]})")
        if "runs" in t and len(t["runs"]) > 1:
            extra += (", median of " + " / ".join(f"{r:.6f}" for r in t["runs"])
                      + f" ms; device time {t['device_ms']} ms per call (profiler)")
        if "depth" in t:
            extra += f", design {t['design']}, serial depth {t['depth']} steps"
        if "bound_bytes_ms" in t:
            extra += (f", bound by operations {t['bound_operations_ms']:.6f} ms, by "
                      f"bytes {t['bound_bytes_ms']:.6f} ms, the parent's device path "
                      f"{t['parent_device_ms']:.6f} ms")
        if "cuda_kernels_per_call" in t:
            extra += f", CUDA kernels per call {t['cuda_kernels_per_call']}"
        if "parent_path_ms" in t:
            extra += (f", whole call {t['whole_call_ms']:.6f} ms, the parent's path "
                      f"{t['parent_path_ms']:.6f} ms ({t['parent_path_ops']} device "
                      "operations)")
        log(f"[kernels] time {key} ({t['shape']}): kernel {t['ms']:.6f} ms, "
            f"plain {t['plain_ms']:.6f} ms, bound {t['bound'][0]:.6f} ms "
            f"({t['bound'][1]}), max_abs_err {t['err']}{extra}")
    return timings


# B.4's timed shapes (P, K, M): the fault path's 3 replicas x 8 ranges x 3
# pairs (24 verdicts), and 64 replicas x 1024 ranges x 64 pairs (65,536).
DIGEST_SHAPES = ((3, 8, 3), (64, 1024, 64))


def phase_digest() -> dict:
    """B.4 per gossip verdict set: the whole call as ``gossip_round`` makes
    it (``ops.digest_compare_pairs``; before it, ``ops.digest_compare`` on
    the gathered rows, timed here too, so that run in a parent checkout
    this phase times that path), the kernel alone, the plain version, the
    device operations of each call and the bound.  Calls are the host's
    launch cost: medians of five CUDA-event means."""
    import numpy as np
    import torch

    from repro_torch.kernels import digest_compare as dc
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gathered = hasattr(ops, "digest_compare_pairs")
    timings = {}
    for p, k, m in DIGEST_SHAPES:
        dig, pairs = _digest_table(np.random.default_rng(m * k), p, k, m, dev)
        a, b = pairs[:, 0], pairs[:, 1]
        host = pairs.tolist()
        iters = 200 if m * k <= 1024 else 50
        gather_path = lambda: ops.digest_compare(dig[a], dig[b])  # noqa: E731
        gather_ms, _ = host_bound_ms(gather_path, iters)
        gather_ops = cuda_kernels_per_call(gather_path)
        row = (f"[digest] (P, K, M) = ({p}, {k}, {m}), {m * k} verdicts: "
               f"ops.digest_compare(dig[a], dig[b]) {gather_ms:.6f} ms ({gather_ops} "
               f"device operations per call)")
        if not gathered:
            log(row)
            continue
        call = lambda: ops.digest_compare_pairs(dig, a, b, host_pairs=host)  # noqa: E731
        got, want = call(), dc.digest_compare_pairs_ref(dig, a, b)
        require_equal(f"digest_compare_pairs timing M={m} K={k}", got, want)
        require_equal(f"digest_compare_pairs vs the gathered path M={m} K={k}", got,
                      gather_path())
        ms, runs = host_bound_ms(call, iters)
        kernel_ms, _ = host_bound_ms(
            lambda: dc.digest_compare_pairs_cuda(dig, a, b, host), iters)
        # The flags' allocation alone: what a buffer held by the caller
        # would save of the call.
        alloc_ms, _ = host_bound_ms(
            lambda: torch.empty((3, m, k), dtype=torch.bool, device=dev), iters)
        kernels = cuda_kernels_per_call(call)
        require_one_kernel(f"ops.digest_compare_pairs at M x K = {m * k}", kernels)
        dev_ms = device_ms_per_call(call)
        plain = cuda_time_ms(lambda: dc.digest_compare_pairs_ref(dig, a, b), iters)
        # Two int4 digests and (amortised) two indices read, three flags
        # written per verdict; ~24 integer operations.
        bnd = bound_ms(m * k * 32 + m * 16 + 3 * m * k, m * k * 24)
        log(f"{row}; ops.digest_compare_pairs {ms:.6f} ms (median of "
            + " / ".join(f"{r:.6f}" for r in runs)
            + f"), its kernel alone {kernel_ms:.6f} ms, the flags' allocation alone "
            f"{alloc_ms:.6f} ms, device {dev_ms} ms; CUDA "
            f"kernels per call {kernels}; plain {plain:.6f} ms; bound {bnd[0]:.6f} ms "
            f"({bnd[1]})")
        key = "digest_compare" if m * k == 24 else f"digest_compare@{m * k}"
        timings[key] = {"ms": kernel_ms, "whole_call_ms": ms, "runs": runs,
                        "gather_path_ms": gather_ms, "gather_path_ops": gather_ops,
                        "alloc_ms": alloc_ms, "device_ms": dev_ms,
                        "cuda_kernels_per_call": kernels, "plain_ms": plain,
                        "bound": bnd, "err": max_abs_err(got, want),
                        "shape": f"P={p}, K={k}, M={m} pairs"}
    return timings


def _placement_err(got, want) -> float:
    """Largest |difference| over both outputs (utility as f32 values)."""
    du = (got[0].double() - want[0].double()).abs().max()
    df = (got[1].long() - want[1].long()).abs().max()
    return max(float(du), float(df)) if got[0].numel() else 0.0


# -- phase 4 ------------------------------------------------------------------


def phase_golden() -> None:
    from repro_torch.core.consistency import EVAL_LEVELS, ConsistencyLevel
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import WORKLOAD_A
    from torch_port_helpers import GEO_LATENCY_RTOL, geo_mismatches

    path = ROOT / "tests" / "data" / "golden_wrappers.json"
    golden = json.loads(path.read_text())
    cases = {f"protocol/{lv.name}": (lv, dict(n_ops=600)) for lv in EVAL_LEVELS}
    x = EVAL_LEVELS[0]
    cases["protocol/X_STCC/alt"] = (x, dict(
        n_ops=640, batch_size=64, merge_every=4, delta=12, seed=3,
        audit=False,
    ))
    for name, (lv, kw) in cases.items():
        got = sim.run_protocol(lv, WORKLOAD_A, device="cuda", **kw)
        if got != golden[name]:
            fail(f"golden {name}: {got} != {golden[name]}")
        log(f"[golden] {name}: equal {got}")

    from repro_torch.core import availability as av
    from repro_torch.core.replicated_store import DurabilityConfig
    from repro_torch.gossip.scheduler import GossipConfig

    outage = dict(schedule=av.replica_outage(5, 3, 1, 1, 3), schedule_unit=128)
    faults = {f"faulty_allup/{lv.name}": (lv, {}) for lv in EVAL_LEVELS}
    faults["faulty/X_STCC/outage"] = (x, dict(
        **outage, gossip=GossipConfig(cadence=2, hint_cap=32),
        recovery=DurabilityConfig(snapshot_every=2, wal=True)))
    faults["faulty/CAUSAL/outage"] = (ConsistencyLevel.CAUSAL, dict(**outage, audit=False))
    for name, (lv, kw) in faults.items():
        got = sim.run_protocol_faulty(lv, WORKLOAD_A, n_ops=600, device="cuda", **kw)
        if got != golden[name]:
            fail(f"golden {name}: {got} != {golden[name]}")
        log(f"[golden] {name}: equal {json.dumps(got, sort_keys=True)}")

    geo = {f"geo/{lv.name}": (lv, {}) for lv in EVAL_LEVELS}
    geo["geo/X_STCC/gossip_recovery"] = (x, dict(
        gossip=GossipConfig(cadence=2, hint_cap=32),
        recovery=DurabilityConfig(snapshot_every=2, wal=True)))
    for name, (lv, kw) in geo.items():
        got = sim.run_protocol_geo(lv, WORKLOAD_A, n_ops=600, device="cuda", **kw)
        bad = geo_mismatches(golden[name], got)
        if bad:
            fail(f"golden {name}: {bad[:8]}")
        log(f"[golden] {name}: equal (latency within rtol {GEO_LATENCY_RTOL}: "
            f"mean_latency_ms {got['mean_latency_ms']} vs golden "
            f"{golden[name]['mean_latency_ms']})")

    sharded = {f"sharded/{lv.name}": (sim.run_protocol_sharded, lv, dict(n_shards=2))
               for lv in EVAL_LEVELS}
    sharded["faulty/X_STCC/sharded"] = (sim.run_protocol_faulty, x, dict(
        **outage, n_shards=2, audit=False))
    for name, (fn, lv, kw) in sharded.items():
        got = fn(lv, WORKLOAD_A, n_ops=600, device="cuda", **kw)
        if json.loads(json.dumps(got)) != golden[name]:
            fail(f"golden {name}: {got} != {golden[name]}")
        log(f"[golden] {name}: equal {json.dumps(got, sort_keys=True)}")


# -- phase 5 ------------------------------------------------------------------


def phase_main() -> dict:
    import torch

    from repro_torch.core.consistency import EVAL_LEVELS
    from repro_torch.kernels import ops
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import WORKLOAD_A, WORKLOAD_B

    combos = [(w, lv) for w in (WORKLOAD_A, WORKLOAD_B) for lv in EVAL_LEVELS]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    on_card = [sim.evaluate_level(lv, w, device="cuda") for w, lv in combos]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    log(f"[main] evaluate_level x{len(combos)} on the card: {wall:.3f} s; "
        f"launches {launches}")
    for w, lv in combos:
        got = on_card.pop(0)
        want = sim.evaluate_level(lv, w, device="cpu")
        if dataclasses.asdict(got) != dataclasses.asdict(want):
            fail(f"evaluate_level {w.name} {lv.name}: card {got} != cpu {want}")
        row = dataclasses.asdict(got)
        for k, v in row.items():
            if isinstance(v, float) and not math.isfinite(v):
                fail(f"evaluate_level {w.name} {lv.name}: {k} is {v}")
        log(f"[main] {json.dumps(row, sort_keys=True)}")
    missing = [k for k, ph in LAUNCH_PHASE.items() if ph == "main" and launches[k] == 0]
    if missing:
        fail(f"main path never launched kernels {missing}")
    return launches


# -- phase 6 ------------------------------------------------------------------


def _diff_keys(got: dict, want: dict, prefix: str = "") -> list[str]:
    out = []
    for k in sorted(set(got) | set(want)):
        a, b = got.get(k), want.get(k)
        if isinstance(a, dict) and isinstance(b, dict):
            out += _diff_keys(a, b, f"{prefix}{k}.")
        elif a != b:
            out.append(f"{prefix}{k}: card {a} != cpu {b}")
    return out


def phase_faulty() -> dict:
    import torch

    from repro_torch.core.consistency import EVAL_LEVELS
    from repro_torch.kernels import ops
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import WORKLOAD_A

    kw = fault_kwargs(6000, 128)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    on_card = [sim.run_protocol_faulty(lv, WORKLOAD_A, device="cuda", **kw)
               for lv in EVAL_LEVELS]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    log(f"[faulty] run_protocol_faulty x{len(EVAL_LEVELS)} on the card "
        f"(replica 1 down for schedule epochs [9, 28) of 47): {wall:.3f} s; "
        f"launches {launches}")
    for lv, got in zip(EVAL_LEVELS, on_card):
        want = sim.run_protocol_faulty(lv, WORKLOAD_A, device="cpu", **kw)
        if got != want:
            fail(f"faulty {lv.name}: card != cpu: {_diff_keys(got, want)[:8]}")
        for k in ("staleness_rate", "violation_rate", "severity"):
            if not (math.isfinite(got[k]) and 0.0 <= got[k] <= 1.0):
                fail(f"faulty {lv.name}: {k} = {got[k]} is not a rate")
        g, r, o = got["gossip"], got["recovery"], got["obs"]
        log(f"[faulty] {lv.name}: staleness {got['staleness_rate']}, violation "
            f"{got['violation_rate']}, severity {got['severity']}, failovers "
            f"{got['failovers']}, anti_entropy_events {got['anti_entropy_events']}, "
            f"propagation_events {got['propagation_events']}, gossip repairs "
            f"{g['repair_events']} (hints enq/drop/deliv {g['hints']['enqueued']}/"
            f"{g['hints']['dropped']}/{g['hints']['delivered']}), wal_records "
            f"{r['wal_records']}, snapshot_cells {r['snapshot_cells']}, p99 age "
            f"{o['metrics']['staleness_age']['p99']}, total cost {got['cost']['total']}")
    missing = [k for k in FAULT_KERNELS if launches[k] == 0]
    if missing:
        fail(f"fault path never launched kernels {missing}")
    return launches


# The kernels the fault path must launch (all but the planner's).
FAULT_KERNELS = ("op_ingest", "vclock_audit", "vclock_chain", "digest_compare",
                 "histogram")


# -- phase 6b -----------------------------------------------------------------


# The kernels the sharded path must launch: each shard's rounds (B.1, the
# chain) and each shard's audit (B.2).
SHARDED_KERNELS = ("op_ingest", "vclock_chain", "vclock_audit")


def phase_sharded() -> dict:
    import torch

    from repro_torch.core import audit as audit_lib
    from repro_torch.core import duot as duot_lib
    from repro_torch.core import odg
    from repro_torch.core.consistency import EVAL_LEVELS, ConsistencyLevel
    from repro_torch.engine.config import EngineConfig
    from repro_torch.engine.replay import EpochEngine
    from repro_torch.kernels import ops
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import WORKLOAD_A

    kw = dict(n_shards=SHARDED_SHARDS, audit=True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    on_card = [sim.run_protocol_sharded(lv, WORKLOAD_A, device="cuda", **kw)
               for lv in EVAL_LEVELS]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    log(f"[sharded] run_protocol_sharded x{len(EVAL_LEVELS)} on the card (6000 ops, "
        f"{SHARDED_SHARDS} shards, audit): {wall:.3f} s; launches {launches}")
    missing = [k for k in SHARDED_KERNELS if launches[k] == 0]
    if missing:
        fail(f"sharded path never launched kernels {missing}")
    for lv, got in zip(EVAL_LEVELS, on_card):
        want = sim.run_protocol_sharded(lv, WORKLOAD_A, device="cpu", **kw)
        if got != want:
            fail(f"sharded {lv.name}: card != cpu: {_diff_keys(got, want)[:8]}")
        for k in ("staleness_rate", "violation_rate", "severity"):
            if not (math.isfinite(got[k]) and 0.0 <= got[k] <= 1.0):
                fail(f"sharded {lv.name}: {k} = {got[k]} is not a rate")
        log(f"[sharded] {lv.name}: equal to the CPU; staleness {got['staleness_rate']}, "
            f"violation {got['violation_rate']}, severity {got['severity']}, n_reads "
            f"{got['n_reads']}, per_shard {got['per_shard']}")

    # The scalar engine, one op at a time, beside the batched engine.
    for lv in EVAL_LEVELS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sim.run_protocol_scalar(lv, WORKLOAD_A, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = sim.run_protocol_scalar(lv, WORKLOAD_A, device="cpu")
        cpu_wall = time.perf_counter() - t0
        if got != want:
            fail(f"scalar {lv.name}: card {got} != cpu {want}")
        batched = sim.run_protocol(lv, WORKLOAD_A, device="cuda")
        log(f"[sharded] scalar {lv.name} (6000 ops): {wall:.3f} s on the card, "
            f"{cpu_wall:.3f} s on the CPU, equal; staleness {got['staleness_rate']} "
            f"(batched {batched['staleness_rate']}), violation {got['violation_rate']} "
            f"(batched {batched['violation_rate']}), severity {got['severity']} "
            f"(batched {batched['severity']}), n_reads {got['n_reads']}")

    # The ODG of the X_STCC run's DUOT.
    prep = EpochEngine(EngineConfig(ConsistencyLevel.X_STCC), device="cuda").replay(
        WORKLOAD_A)
    duot, delta = prep["out"]["st"].duot, prep["store"].delta

    def graph(table):
        g = odg.build(table)
        return g, odg.severity_from_odg(g, audit_lib.audit(table, delta=delta).violation)

    g_card, sev_card = graph(duot)
    g_cpu, sev_cpu = graph(duot_lib.Duot(*(t.cpu() for t in duot)))
    for name in g_cpu._fields:
        if not torch.equal(getattr(g_card, name).cpu(), getattr(g_cpu, name)):
            fail(f"odg.build: {name} edges differ between the card and the CPU")
    if sev_card.cpu().numpy().tobytes() != sev_cpu.numpy().tobytes():
        fail(f"severity_from_odg: card {float(sev_card)} != cpu {float(sev_cpu)}")
    build_ms = cuda_time_ms(lambda: odg.build(duot), 5)
    sev_ms = cuda_time_ms(lambda: odg.severity_from_odg(g_card, g_card.timed), 5)
    counts = {k: int(v) for k, v in odg.edge_counts(g_card).items()}
    log(f"[sharded] odg at M = {duot.capacity}: build {build_ms:.6f} ms, "
        f"severity_from_odg {sev_ms:.6f} ms (CUDA events); edges {counts}; "
        f"severity {float(sev_card)} (audit severity "
        f"{float(audit_lib.audit(duot, delta=delta).severity)}); equal to the CPU")
    return launches


# -- phase 6c -----------------------------------------------------------------


# The kernels the recovery path must launch: B.4 in bootstrap and gossip,
# B.1 and the chain every round, B.2 in each run's audit, B.3 in the obs
# plane.
RECOVERY_KERNELS = ("op_ingest", "vclock_audit", "vclock_chain", "digest_compare",
                    "histogram")
CHAOS_SEEDS = range(4)


def crash_kwargs(n_ops: int, unit: int) -> dict:
    """``fault_kwargs`` with replica 1's outage opened by a crash event: it
    loses its volatile state at schedule epoch T/5 and rebuilds (WAL
    replay, then peer bootstrap) when it comes back at 3T/5."""
    from repro_torch.core import availability as av

    kw = fault_kwargs(n_ops, unit)
    t = kw["schedule"].n_epochs
    kw["schedule"] = av.replica_crash(t, 3, 1, t // 5, 3 * t // 5 - t // 5)
    return kw


def _tree_to(tree, device):
    """A state tree (NamedTuples of tensors) moved to ``device``."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_to(v, device) for v in tree))
    return tree.to(device)


def _recovery_line(r: dict) -> str:
    return ", ".join(f"{k} {r[k]}" for k in (
        "crashes", "rejoins", "rows_lost", "wal_replayed", "snapshot_cells_read",
        "bootstrap_cells", "bootstrap_pending", "recovery_gb"))


def phase_recovery() -> dict:
    """Crash runs (six levels, WAL + snapshots; X_STCC with snapshots only
    and with no durability), geo + faults (six levels on the paper's
    topology under the same schedule), the chaos suite, ``StoreRecovery``
    and a direct ``store.bootstrap``, each on the card against the CPU."""
    import numpy as np
    import torch

    from repro_torch.chaos import run_chaos_suite
    from repro_torch.chaos.harness import _quiesce
    from repro_torch.core.consistency import EVAL_LEVELS, ConsistencyLevel
    from repro_torch.core.replicated_store import DurabilityConfig
    from repro_torch.engine.config import EngineConfig
    from repro_torch.engine.replay import EpochEngine
    from repro_torch.geo.topology import PAPER_TOPOLOGY
    from repro_torch.kernels import ops
    from repro_torch.runtime import StoreRecovery
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import WORKLOAD_A

    x = ConsistencyLevel.X_STCC
    kw = crash_kwargs(6000, 128)
    sched = kw["schedule"]
    runs = [(lv.name, lv, kw) for lv in EVAL_LEVELS] + [
        (f"X_STCC/{name}", x, dict(kw, recovery=rec))
        for name, rec in (("snapshots", DurabilityConfig(snapshot_every=2)),
                          ("no_durability", None))]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    on_card = [sim.run_protocol_faulty(lv, WORKLOAD_A, device="cuda", _return_state=True,
                                       **k) for _, lv, k in runs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    log(f"[recovery] run_protocol_faulty x{len(runs)} on the card (replica 1 crashes at "
        f"schedule epoch {sched.n_epochs // 5} of {sched.n_epochs}, rejoins at "
        f"{3 * sched.n_epochs // 5}): {wall:.3f} s; launches {launches}")
    missing = [k for k in RECOVERY_KERNELS if launches[k] == 0]
    if missing:
        fail(f"recovery path never launched kernels {missing}")
    states = {}
    for (name, lv, k), got in zip(runs, on_card):
        states[name] = (got.pop("_store"), got.pop("_state"))
        want = sim.run_protocol_faulty(lv, WORKLOAD_A, device="cpu", **k)
        if got != want:
            fail(f"crash run {name}: card != cpu: {_diff_keys(got, want)[:8]}")
        for key in ("staleness_rate", "violation_rate", "severity"):
            if not (math.isfinite(got[key]) and 0.0 <= got[key] <= 1.0):
                fail(f"crash run {name}: {key} = {got[key]} is not a rate")
        if got["crash_epochs"] == [] or got["recovery"]["rejoins"] != 1:
            fail(f"crash run {name}: crash_epochs {got['crash_epochs']}, recovery "
                 f"{got['recovery']}")
        log(f"[recovery] {name}: equal to the CPU; staleness {got['staleness_rate']}, "
            f"violation {got['violation_rate']}, crash_epochs {got['crash_epochs']}, "
            f"{_recovery_line(got['recovery'])}, total cost {got['cost']['total']}")

    # Geo + faults: the paper's topology composed with the same schedule.
    geo_kw = dict(faults=sched, schedule_unit=kw["schedule_unit"], gossip=kw["gossip"],
                  durability=kw["recovery"], obs=kw["obs"], topology=PAPER_TOPOLOGY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    geo_card = [EpochEngine(EngineConfig(lv, **geo_kw), device="cuda").run(WORKLOAD_A)
                for lv in EVAL_LEVELS]
    torch.cuda.synchronize()
    geo_wall = time.perf_counter() - t0
    log(f"[recovery] geo + faults x{len(EVAL_LEVELS)} on the card: {geo_wall:.3f} s")
    for lv, got in zip(EVAL_LEVELS, geo_card):
        want = EpochEngine(EngineConfig(lv, **geo_kw), device="cpu").run(WORKLOAD_A)
        if got != want:
            fail(f"geo + faults {lv.name}: card != cpu: {_diff_keys(got, want)[:8]}")
        g = got["geo"]
        log(f"[recovery] geo + faults {lv.name}: equal to the CPU; staleness "
            f"{got['staleness_rate']}, traffic_events {g['traffic_events']}, "
            f"network_geo {g['network_geo']}, mean_latency_ms {g['mean_latency_ms']}, "
            f"{_recovery_line(got['recovery'])}")

    # The chaos suite: nemesis schedules, invariants, twin convergence.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    suite = run_chaos_suite(seeds=CHAOS_SEEDS, device="cuda")
    torch.cuda.synchronize()
    chaos_wall = time.perf_counter() - t0
    cpu_suite = run_chaos_suite(seeds=CHAOS_SEEDS, device="cpu")
    if not suite["ok"] or suite != cpu_suite:
        fail(f"chaos suite: ok {suite['ok']}, equal to the CPU {suite == cpu_suite}: "
             f"{[r for r in suite['runs'] if not r['ok']]}")
    log(f"[recovery] chaos suite x{suite['n_seeds']} on the card: {chaos_wall:.3f} s; "
        f"ok, equal to the CPU; crashes {suite['n_crashes']}, cadences "
        f"{[r['gossip_cadence'] for r in suite['runs']]}")

    # StoreRecovery on the X_STCC run's final state after a quiescent tail
    # (WAL: nothing lost; the bootstrap source holds the whole frontier).
    store, state = states["X_STCC"]
    state = _quiesce(store, state)
    down = np.asarray([False, True, False])
    full = dict(up=np.ones(3, bool), link=np.ones((3, 3), bool))
    st_card, out_card = StoreRecovery(store).recover(state, down, **full)
    # The store's methods follow the state's device.
    st_cpu, out_cpu = StoreRecovery(store).recover(_tree_to(state, "cpu"), down, **full)
    if out_card != out_cpu or out_card.partial or _store_diff(st_card, st_cpu):
        fail(f"StoreRecovery: card {out_card} != cpu {out_cpu}")
    log(f"[recovery] StoreRecovery on the X_STCC run's quiesced final state: {out_card}; "
        f"equal to the CPU")

    # Bootstrap's B.4: the amnesiac store's state, replica 1 crashed again.
    store, state = states["X_STCC/no_durability"]
    state, _ = store.crash(state, down)
    boot = dict(targets=down, n_ranges=8, **full)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    st_k, tel_k = store.bootstrap(state, **boot)
    boot_launches = ops.launch_counts()["digest_compare"]
    if boot_launches == 0:
        fail("bootstrap never launched digest_compare")
    st_p, tel_p = store.bootstrap(state, impl="torch", **boot)
    boot_ms, _ = host_bound_ms(lambda: store.bootstrap(state, **boot), 10)
    plain_ms, _ = host_bound_ms(lambda: store.bootstrap(state, impl="torch", **boot), 10)
    diff = _store_diff(st_k, st_p)
    tel_diff = [k for k in tel_k if not torch.equal(tel_k[k], tel_p[k])]
    from repro_torch.gossip import digest as digest_lib
    from repro_torch.kernels import digest_compare as dc

    dig = digest_lib.range_digests(state.cluster.replica_version, 8)
    a, b = (torch.tensor([i], device="cuda") for i in (1, 2))
    flags = ops.digest_compare_pairs(dig, a, b, host_pairs=[(1, 2)])
    plain = dc.digest_compare_pairs_ref(dig, a, b)
    if diff or tel_diff or not torch.equal(flags, plain):
        fail(f"bootstrap: kernel != plain: state {diff[:4]}, telemetry {tel_diff}, "
             f"flags equal {torch.equal(flags, plain)}")
    log(f"[recovery] bootstrap (replica 1 from replica {int(tel_k['source'][1])}): "
        f"{boot_ms:.6f} ms whole call (plain verdicts {plain_ms:.6f} ms; CUDA events, "
        f"median of 5 x 10 calls); digest_compare launches {boot_launches}; cells "
        f"{int(tel_k['cells'].sum())}, pending {int(tel_k['pend'].sum())}, ranges "
        f"{int(tel_k['ranges'].sum())}; state, telemetry and verdicts equal to the "
        f"plain version")
    return launches


# -- phase 7 ------------------------------------------------------------------


HOT_SKEW = (0,) * 11 + (1, 1, 1) + (2, 2)
LOCAL_READS_MS = 1.0      # the second SLA of examples/geo_placement.py


def geo_topologies() -> dict:
    """The geo phase's topologies: the paper's 3 regions, the same with
    the hot-region client skew, and the paper's 12-replica fleet."""
    from repro_torch.geo import placement as pl
    from repro_torch.geo.topology import PAPER_TOPOLOGY

    return {
        "paper": PAPER_TOPOLOGY,
        "hot": dataclasses.replace(PAPER_TOPOLOGY, client_region=HOT_SKEW),
        "fleet12": pl.fleet_topology(PAPER_TOPOLOGY,
                                     pl.static_counts(PAPER_TOPOLOGY, 4)),
    }


def _plan_summary(plan) -> dict:
    return {"total_cost": plan.total_cost, "n_feasible": plan.n_feasible,
            "choices": plan.choice.tolist(), "utility": plan.utility.tolist(),
            "cost": plan.cost.tolist(), "feasible": plan.feasible.tolist()}


def phase_geo() -> dict:
    import numpy as np
    import torch

    from repro_torch.core.consistency import EVAL_LEVELS, ConsistencyLevel
    from repro_torch.core.replicated_store import DurabilityConfig
    from repro_torch.engine import stream as engine_stream
    from repro_torch.geo import placement as pl
    from repro_torch.geo.topology import single_region
    from repro_torch.gossip.scheduler import GossipConfig
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import ObsConfig
    from repro_torch.policy.sla import SLA, SLA_RELAXED
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import WORKLOAD_A

    topos = geo_topologies()
    x = ConsistencyLevel.X_STCC
    extras = dict(gossip=GossipConfig(cadence=2, peer="nearest"),
                  recovery=DurabilityConfig(snapshot_every=2, wal=True),
                  obs=ObsConfig())
    runs = [(f"{t}/{lv.name}", lv, dict(topology=topos[t]))
            for t in ("paper", "hot") for lv in EVAL_LEVELS]
    runs += [(f"{t}/X_STCC/nearest+durability+obs", x,
              dict(topology=topos[t], **extras)) for t in ("paper", "fleet12")]
    one = single_region(3)
    slas = (SLA_RELAXED, SLA("local-reads", max_read_latency_ms=LOCAL_READS_MS))
    paper = topos["paper"]
    stream = engine_stream.op_stream(WORKLOAD_A, 6000, 16, 24, 0, paper.n_replicas)
    reads, writes = pl.region_demand(stream["client"], stream["kind"],
                                     stream["resource"], paper, 24)

    def planner(device):
        out = {}
        for sla in slas:
            plan = pl.plan_placement(paper, reads, writes, sla, device=device)
            static = pl.evaluate_counts(paper, pl.static_counts(paper, 4), reads,
                                        writes, sla, device=device)
            out[sla.name] = {"plan": _plan_summary(plan), "static": {
                k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in static.items()}}
        return out

    # The counts cover the geo runs and the planner only; the one-region
    # identity's geo and flat runs come after they are read.
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    on_card = {name: sim.run_protocol_geo(lv, WORKLOAD_A, device="cuda", **kw)
               for name, lv, kw in runs}
    plans = planner("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    log(f"[geo] {len(runs)} run_protocol_geo + planner x{len(slas)} SLAs on the "
        f"card: {wall:.3f} s; launches {launches}")
    missing = [k for k in GEO_KERNELS if launches[k] == 0]
    if missing:
        fail(f"geo path never launched kernels {missing}")
    for name, lv, kw in runs:
        got = on_card[name]
        want = sim.run_protocol_geo(lv, WORKLOAD_A, device="cpu", **kw)
        if got != want:
            fail(f"geo {name}: card != cpu: {_diff_keys(got, want)[:8]}")
        for k in ("staleness_rate", "violation_rate", "severity"):
            if not (math.isfinite(got[k]) and 0.0 <= got[k] <= 1.0):
                fail(f"geo {name}: {k} = {got[k]} is not a rate")
        if not math.isfinite(got["mean_latency_ms"]) or got["dropped_writes"]:
            fail(f"geo {name}: mean_latency_ms {got['mean_latency_ms']}, "
                 f"dropped_writes {got['dropped_writes']}")
        line = (f"[geo] {name}: staleness {got['staleness_rate']}, violation "
                f"{got['violation_rate']}, severity {got['severity']}, traffic "
                f"{got['traffic_events']}, mean_latency_ms {got['mean_latency_ms']}, "
                f"total_geo {got['cost']['total_geo']}")
        if "gossip" in got:
            line += (f", gossip repairs {got['gossip']['repair_events']}, "
                     f"durable_gb {got['durability']['durable_gb']}, p99 latency "
                     f"{got['obs']['metrics']['read_latency_ms']['p99']}")
        log(line)
    single = {lv.name: sim.run_protocol_geo(lv, WORKLOAD_A, topology=one,
                                            device="cuda")
              for lv in EVAL_LEVELS}
    flat = {lv.name: sim.run_protocol(lv, WORKLOAD_A, device="cuda")
            for lv in EVAL_LEVELS}
    keys = ("staleness_rate", "violation_rate", "severity", "n_reads", "dropped_writes")
    for lv in EVAL_LEVELS:
        a = {k: single[lv.name][k] for k in keys}
        b = {k: flat[lv.name][k] for k in keys}
        if a != b:
            fail(f"geo single_region(3) {lv.name}: {a} != run_protocol {b}")
        if flat[lv.name] != sim.run_protocol(lv, WORKLOAD_A, device="cpu"):
            fail(f"geo: run_protocol {lv.name} card != cpu")
    log("[geo] single_region(3): protocol metrics equal run_protocol's for the "
        "six levels")
    want = planner("cpu")
    if plans != want:
        fail(f"geo planner: card != cpu: {_diff_keys(plans, want)[:8]}")
    for name, p in plans.items():
        log(f"[geo] planner {name}: plan ${p['plan']['total_cost']} "
            f"({p['plan']['n_feasible']}/24 feasible) vs static 4-per-DC "
            f"${p['static']['total_cost']} ({p['static']['n_feasible']}/24)")
    return launches


# The kernels the geo phase must launch: the planner's select (one launch
# per plan and per static baseline) and the replay's five.  The (R, K)
# grid kernel is on no path since the planner selects on the card; the
# kernels phase still holds it against its plain version.
GEO_KERNELS = ("placement_select", "op_ingest", "vclock_chain", "vclock_audit",
               "digest_compare", "histogram")


# -- phase 8 ------------------------------------------------------------------


def adaptive_equal(got: dict, want: dict) -> list[str]:
    """Fields of two ``run_protocol_adaptive`` results that differ (the
    ``choice`` arrays compared whole; every other field exactly)."""
    import numpy as np

    bad = [] if np.array_equal(got["choice"], want["choice"]) else ["choice"]
    rest = lambda d: {k: v for k, v in d.items() if k != "choice"}  # noqa: E731
    return bad + _diff_keys(rest(got), rest(want))


def telemetry_rounds(n_ops: int, epoch_size: int) -> int:
    """Telemetry rounds of one adaptive run over the six policy levels: an
    emulated level runs one round per epoch, CAUSAL and ONE one per merge."""
    from repro_torch.core.replicated_store import merge_cadence
    from repro_torch.policy.sla import POLICY_LEVELS

    rounds = 0
    for lv in POLICY_LEVELS:
        sync_every, _ = merge_cadence(lv, 8, 24)
        emulate = sync_every == 1 or lv.is_timed
        rounds += n_ops // (epoch_size if emulate else sync_every)
    return rounds


def cadence_telemetry(seed: int, n_epochs: int, n_arms: int) -> dict:
    """Seeded per-arm gossip telemetry: GB (real-valued), stale and read
    counts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"gb": (rng.random((n_epochs, n_arms)) * 3e-3).astype(np.float32),
            "stale": rng.integers(0, 50, (n_epochs, n_arms)),
            "reads": rng.integers(50, 100, n_epochs)}


def phase_adaptive() -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.policy.controller import CadenceController
    from repro_torch.policy.sla import SLA_RELAXED, SLA_STRICT
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import PHASED_RW, PHASED_RWR

    runs = [(w, sla) for w in (PHASED_RW, PHASED_RWR)
            for sla in (SLA_RELAXED, SLA_STRICT)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    on_card = [sim.run_protocol_adaptive(w, sla, n_ops=ADAPTIVE_OPS, device="cuda")
               for w, sla in runs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    n_ops, epoch = on_card[0]["n_ops"], on_card[0]["epoch_size"]
    epochs = n_ops // epoch
    rounds = len(runs) * telemetry_rounds(n_ops, epoch)
    log(f"[adaptive] run_protocol_adaptive x{len(runs)} on the card ({n_ops} ops, "
        f"{epochs} epochs of {epoch}, six levels): {wall:.3f} s; launches {launches}")
    want_launches = {"policy_score": len(runs) * epochs, "op_ingest": rounds,
                     "vclock_chain": rounds, "vclock_audit": 0}
    bad = {k: (launches[k], v) for k, v in want_launches.items() if launches[k] != v}
    if bad:
        fail(f"adaptive launch counts (got, want): {bad}")
    for (w, sla), got in zip(runs, on_card):
        want = sim.run_protocol_adaptive(w, sla, n_ops=ADAPTIVE_OPS, device="cpu")
        diff = adaptive_equal(got, want)
        if diff:
            fail(f"adaptive {w.name} {sla.name}: card != cpu: {diff[:8]}")
        a = got["adaptive"]
        for k in ("staleness_rate", "violation_rate"):
            if not (math.isfinite(a[k]) and 0.0 <= a[k] <= 1.0):
                fail(f"adaptive {w.name} {sla.name}: {k} = {a[k]} is not a rate")
        if got["choice"].shape != (epochs, 16) or not math.isclose(
                sum(a["level_share"].values()), 1.0):
            fail(f"adaptive {w.name} {sla.name}: choice {got['choice'].shape}, "
                 f"level_share {a['level_share']}")
        log(f"[adaptive] {w.name} {sla.name}: cost {a['cost']}, staleness "
            f"{a['staleness_rate']}, violation {a['violation_rate']}, level_share "
            f"{a['level_share']}, cheapest feasible static "
            f"{got['cheapest_feasible_static']} "
            f"{ {k: v['cost'] for k, v in got['static'].items()} }")

    tel = cadence_telemetry(3, 40, 5)
    states, traces = {}, {}
    for dev in ("cuda", "cpu"):
        st, tr = CadenceController(eps0=0.3, device=dev).run_scan(3, tel)
        states[dev], traces[dev] = st, {k: v.cpu() for k, v in tr.items()}
    for k in traces["cpu"]:
        if not _bits_equal(traces["cuda"][k], traces["cpu"][k]):
            fail(f"CadenceController.run_scan: trace {k} card != cpu")
    for f in ("gb_win", "stale_win", "reads_win", "played_win"):
        if not _bits_equal(getattr(states["cuda"], f).cpu(), getattr(states["cpu"], f)):
            fail(f"CadenceController.run_scan: {f} card != cpu")
    log(f"[adaptive] CadenceController.run_scan (40 epochs, 5 arms): card == cpu; "
        f"arms {np.bincount(traces['cpu']['arm'].numpy(), minlength=5).tolist()}")
    log_epoch_ops()
    return launches


def log_epoch_ops() -> None:
    """Device operations per controller epoch (profiler): ``run_scan`` at the
    adaptive phase's 16 sessions over 4 and over 2 epochs, the difference
    per epoch, once as it is and once with the parent's selection
    (``parent_select``) in place of ``select``."""
    import torch

    from repro_torch.policy.controller import AdaptiveController, make_draws
    from repro_torch.policy.sla import POLICY_LEVELS, SLA_RELAXED

    s, n_levels = 16, len(POLICY_LEVELS)
    g = torch.Generator(device="cuda").manual_seed(1)
    reads = torch.randint(0, 64, (4, s), generator=g, device="cuda").to(torch.float32)
    tel = {"stale": (torch.rand((4, s, n_levels), generator=g, device="cuda")
                     * reads[..., None]).floor(),
           "viol": torch.zeros((4, s, n_levels), device="cuda"), "reads": reads,
           "writes": reads.flip(0)}
    draws = make_draws(1, (4, s), n_levels, device="cuda")
    out = {}
    for path in ("select", "parent"):
        ctl = AdaptiveController(s, SLA_RELAXED, device="cuda")
        if path == "parent":
            ctl.select = lambda st, u, arm, read_frac=0.5, c=ctl: parent_select(
                c, st, u, arm, read_frac)
        counts = {}
        for e in (2, 4):
            part = {k: v[:e] for k, v in tel.items()}
            run = lambda: ctl.run_scan(0, part, draws=tuple(d[:e] for d in draws))  # noqa: E731
            counts[e] = device_ops_per_call(run, "policy_kernel")
        if None in (x for pair in counts.values() for x in pair):
            log(f"[adaptive] device operations per controller epoch ({path}): not "
                "measured (the profiler recorded no whole session)")
            continue
        out[path] = [(counts[4][i] - counts[2][i]) / 2 for i in range(2)]
    if len(out) == 2:
        log(f"[adaptive] device operations per controller epoch (run_scan, S=16, L="
            f"{n_levels}; profiler, 4 epochs less 2): {out['select'][0]:.2f}, of which "
            f"{out['select'][1]:.2f} the scorer kernel; with the parent's selection "
            f"{out['parent'][0]:.2f} ({out['parent'][1]:.2f})")


# -- phase 9 ------------------------------------------------------------------


class _NoModel:
    """The serving phases route and count; they compute with no model."""

    prefill = decode_step = None


def run_serving(device, *, n_sessions: int, n_epochs: int, rounds: int,
                impl: str = "auto"):
    """The serving schedule on the 12-replica fleet: ``n_sessions``
    sessions, X_STCC by default, an ``AdaptiveController`` (SLA_RELAXED,
    eps0 0.1, seeded draws).  Returns ``(engine, api, log)``."""
    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.policy.controller import AdaptiveController
    from repro_torch.policy.sla import SLA_RELAXED
    from repro_torch.serve import ServingEngine
    from torch_port_helpers import PortServingApi, plain, serving_script

    eng = ServingEngine(_NoModel(), ConsistencyLevel.X_STCC, max_replicas=12,
                        max_sessions=n_sessions, impl=impl, device=device)
    eng.set_topology(geo_topologies()["fleet12"])
    eng.attach_controller(AdaptiveController(n_sessions, SLA_RELAXED, eps0=0.1,
                                             impl=impl, device=device), seed=0)
    api = PortServingApi()
    log = serving_script(api, eng, seed=0, n_epochs=n_epochs, rounds=rounds,
                         n_sessions=n_sessions)
    return eng, api, plain(log)


def run_router(device, *, n_shards: int, sessions_per_shard: int, n_epochs: int,
               rounds: int, impl: str = "auto"):
    """The router schedule over the 12 replicas, ages binned one version
    wide; returns ``(router, log)``."""
    from repro_torch.serve import ShardedServingRouter
    from torch_port_helpers import PortServingApi, plain, router_script

    router = ShardedServingRouter(n_shards, sessions_per_shard, max_replicas=12,
                                  age_hi=64.0, impl=impl, device=device)
    log = router_script(PortServingApi(), router, seed=0, n_epochs=n_epochs, rounds=rounds)
    return router, plain(log)


def _store_diff(a, b, prefix: str = "") -> list[str]:
    """Fields of two port store states (or lists of them, one per shard)
    that differ, compared on the first one's device."""
    import torch

    if isinstance(a, list):
        return [d for k, (x, y) in enumerate(zip(a, b))
                for d in _store_diff(x, y, f"{prefix}{k}.")]
    out = []
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            if (x is None) != (y is None):
                out.append(prefix + f)
        elif isinstance(x, tuple):
            out += _store_diff(x, y, f"{prefix}{f}.")
        elif x.shape != y.shape or not torch.equal(x, y.to(x.device)):
            out.append(prefix + f)
    return out


def serving_counts(log: list, api) -> tuple[int, int]:
    """(store reads, serve_with_retry serves) of one schedule: every
    completed ``route_batch`` and every served ``serve_with_retry`` (an
    int in the log) reads the store once."""
    serves = sum(isinstance(x, int) for x in log)
    return api.ok_batches + serves, serves


def phase_serving() -> dict:
    import torch

    from repro_torch.kernels import ops
    from torch_port_helpers import serving_counters

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng, api, slog = run_serving("cuda", **SERVING)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    reads, serves = serving_counts(slog, api)
    want = {"session_floor": api.guarded_batches, "op_ingest": reads,
            "vclock_chain": reads, "policy_score": SERVING["n_epochs"],
            "vclock_audit": 0}
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad or api.guarded_batches == 0:
        fail(f"serving launch counts (got, want): {bad}, guarded batches "
             f"{api.guarded_batches}")
    c_eng, _, c_log = run_serving("cpu", **SERVING)
    if slog != c_log:
        bad = [i for i, (a, b) in enumerate(zip(slog, c_log)) if a != b]
        fail(f"serving: card log != cpu log at steps {bad[:8]}")
    got, ref = serving_counters(eng), serving_counters(c_eng)
    diff = _diff_keys(got, ref)
    if diff:
        fail(f"serving: card != cpu: {diff[:8]}")
    diff = _store_diff(eng._st, c_eng._st)
    if diff:
        fail(f"serving: store state card != cpu in {diff[:8]}")
    counters = {k: got[k] for k in ("stale_serves", "total_serves", "reroutes",
                                    "failovers", "retries", "timeouts", "downgrades",
                                    "retry_wait_ms")}
    if min(counters[k] for k in ("total_serves", "reroutes", "failovers", "retries")) <= 0:
        fail(f"serving: the schedule left a path unexercised: {counters}")
    share = {lv: sum(1 for x in got["levels"].values() if x == lv)
             for lv in sorted(set(got["levels"].values()))}
    log(f"[serving] ServingEngine {SERVING} on the 12-replica fleet: card "
                f"{wall:.3f} s, {reads} store reads ({api.ok_batches} route_batch, "
                f"{serves} serve_with_retry), launches {launches}; card == cpu in "
                f"every counter, replica, version, region statistic, level, floor "
                f"and the store state; {counters}")
    rs = got["region_stats"]
    log(f"[serving] region_stats serves {rs['serves']}, stale {rs['stale']}, "
        f"mean_latency_ms {rs['mean_latency_ms']}, p50 {rs['p50_latency_ms']}, "
        f"p99 {rs['p99_latency_ms']}; final levels {share}")

    ops.reset_launch_counts()
    router, r_log = run_router("cuda", **ROUTER)
    r_launches = ops.launch_counts()
    c_router, c_r_log = run_router("cpu", **ROUTER)
    if r_log != c_r_log:
        fail("serving: router card log != cpu log")
    diff = _diff_keys(serving_counters(router), serving_counters(c_router))
    diff += _store_diff(router._st, c_router._st)
    if diff:
        fail(f"serving: router card != cpu: {diff[:8]}")
    if r_launches["session_floor"] == 0:
        fail(f"serving: the router never launched session_floor: {r_launches}")
    rc = serving_counters(router)
    log(f"[serving] ShardedServingRouter {ROUTER}: card == cpu; age_stats "
        f"{rc['age_stats']}, reroutes {rc['reroutes']}, failovers {rc['failovers']}, "
        f"stale {rc['stale_serves']}/{rc['total_serves']}; launches {r_launches}")
    log_route_ops()
    return launches


def log_route_ops() -> None:
    """Device operations per ``route_batch`` (profiler) of the serving
    phase's engine (64 X_STCC sessions on the 12-replica fleet, every
    replica live), and of its admission alone; then the same with the
    parent's admission (``parent_admission``) in place of the store's
    check."""
    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.serve import ServeSession, ServingEngine

    out = {}
    for path in ("check", "parent"):
        eng = ServingEngine(_NoModel(), ConsistencyLevel.X_STCC, max_replicas=12,
                            max_sessions=SERVING["n_sessions"], device="cuda")
        eng.set_topology(geo_topologies()["fleet12"])
        for v in range(12):
            eng.publish(None, 1 + v % 3)
        if path == "parent":
            store = eng._store
            store.session_check = lambda st, index, **kw: parent_admission(store, st, index)
        sessions = [ServeSession(i) for i in range(SERVING["n_sessions"])]
        run = lambda: eng.route_batch(sessions)  # noqa: E731
        key = "session_check_kernel" if path == "check" else "session_admit_kernel"
        out[path] = device_ops_per_call(run, key)
    log(f"[serving] device operations per route_batch ({SERVING['n_sessions']} "
        f"sessions; profiler; None: not measured): {out['check'][0]}, with "
        f"{out['check'][1]} session_check kernel; with the parent's admission "
        f"{out['parent'][0]} ({out['parent'][1]} admit kernel)")


# -- phase 10 -----------------------------------------------------------------

# B.8's shapes: tests/test_kernels.py's FA_CASES, then the full attention
# of gemma-2b (MQA, head_dim 256) at the model phase's S = 2048 and at
# 4096 in bf16 and f32, and of qwen2-7b (a query-head group of 7).
# (b, h, hkv, s, hd, causal, window, dtype)
FA_CASES = (
    (2, 4, 2, 256, 64, True, 0, "float32"),
    (1, 2, 1, 128, 128, True, 0, "float32"),
    (1, 4, 4, 256, 64, False, 0, "float32"),
    (2, 2, 2, 256, 64, True, 64, "float32"),
    (1, 8, 2, 384, 64, True, 0, "bfloat16"),
    (1, 1, 1, 128, 256, True, 0, "float32"),
    (1, 8, 1, 2048, 256, True, 0, "bfloat16"),
    (1, 8, 1, 4096, 256, True, 0, "bfloat16"),
    (1, 8, 1, 4096, 256, True, 0, "float32"),
    (1, 28, 4, 4096, 128, True, 0, "bfloat16"),
)
# The main path's shape: gemma-2b's forward at B = 1, S = 2048, bf16.
FA_MAIN = (1, 8, 1, 2048, 256, True, 0, "bfloat16")
PEAK_BF16_OPS_S = 989e12   # bf16 tensor cores, dense
MODEL = dict(arch="gemma-2b", seq=2048, f32_seq=512, prompt=128, tokens=16)
MODEL_CUTS = ("cuts of scale: none in width (gemma-2b's 18 layers, d_model 2048, "
              "8 query heads over 1 KV head of 256, d_ff 16384, 256,000 tokens); "
              "batch 1; random weights from seeds 0 and 1")


def fa_work(case) -> tuple[int, int]:
    """(bytes, FLOP) of one attention call: q, k, v read once and the
    output written once; 4 hd FLOP (QK^T and PV) per visible (query, key)
    pair, counting the pairs the mask leaves."""
    b, h, hkv, s, hd, causal, window, dtype = case
    size = 2 if dtype == "bfloat16" else 4
    n_bytes = size * hd * (2 * b * h * s + 2 * b * hkv * s)
    if not causal:
        pairs = s * s
    else:
        w = window if window > 0 else s
        pairs = sum(min(i + 1, w) for i in range(s))
    return n_bytes, 4 * hd * pairs * b * h


def _fa_inputs(case, dev):
    import torch

    b, h, hkv, s, hd, _, _, dtype = case
    g = torch.Generator(device=dev).manual_seed(s * hd + h)
    dt = getattr(torch, dtype)
    return [torch.randn(shape, generator=g, device=dev).to(dt)
            for shape in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd))]


def _sdpa(q, k, v, causal: bool, window: int):
    """One PyTorch call computing the same function (the yardstick; the
    port never calls it)."""
    import torch
    import torch.nn.functional as F

    if causal and window > 0:
        s = q.shape[2]
        i = torch.arange(s, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)


def time_flash(case, dev) -> dict:
    """B.8 at one shape: the kernel against its plain version on the same
    inputs (atol = rtol = 2e-5 in f32, 2e-2 in bf16); CUDA-event times
    of the kernel, the plain version and SDPA; the bound."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    *_, causal, window, dtype = case
    q, k, v = _fa_inputs(case, dev)
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"flash_attention {case}: kernel differs from the plain version "
             f"(max abs err {err}, tolerance {tol})")
    n_bytes, n_ops = fa_work(case)
    iters = 5 if case[3] >= 2048 else 50
    peak = PEAK_BF16_OPS_S if dtype == "bfloat16" else PEAK_OPS_S
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / peak
    out = {
        "err": err, "match": True, "shape": str(case),
        "ms": cuda_time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, window=window), iters),
        "plain_ms": cuda_time_ms(lambda: fa.flash_attention_ref(
            q, k, v, causal=causal, window=window), iters),
        "library_ms": cuda_time_ms(lambda: _sdpa(q, k, v, causal, window), iters),
        "bound": (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"),
        "bytes": n_bytes, "flop": n_ops,
    }
    del q, k, v, got, want
    return out


class _Recorder:
    """A model whose prefill and decode keep every logits tensor they
    return (the served path's logits, read back after ``generate``)."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def prefill(self, params, batch):
        logits, cache = self.model.prefill(params, batch)
        self.logits.append(logits[:, -1])
        return logits, cache

    def decode_step(self, params, cache, tokens):
        logits, cache = self.model.decode_step(params, cache, tokens)
        self.logits.append(logits[:, -1])
        return logits, cache


def _to(tree, **kw):
    if isinstance(tree, dict):
        return {k: _to(v, **kw) for k, v in tree.items()}
    return tree.to(**kw)


def run_model_serving(device, cfg, params_ab, prompts):
    """The model-serving schedule (``tests/torch_port_helpers``) on
    ``device``: returns ``(log, counters, engine)``."""
    from repro_torch.serve import ServeSession, ServingEngine
    from repro_torch.models import build_model
    from torch_port_helpers import (MODEL_SERVING, model_serving_counters,
                                    model_serving_script)

    eng = ServingEngine(build_model(cfg), device=device)
    max_seq = MODEL["prompt"] + MODEL["tokens"]
    log = model_serving_script(
        eng, params_ab, lambda i: {"tokens": prompts[i].to(device), "max_seq": max_seq},
        ServeSession, n_tokens=MODEL["tokens"], **MODEL_SERVING)
    return log, model_serving_counters(eng), eng


def phase_model() -> tuple[dict, dict]:
    """B.8 against its plain version (a), gemma-2b's forward at full width
    with and without the kernel (b), and ``ServingEngine.generate`` on it
    (c).  Returns ``(timings, launches)``; the launches are those of (b)'s
    kernel forward, the main path of this slice."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ServeSession, ServingEngine
    from torch_port_helpers import MODEL_SERVING

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    # (a) the kernel at every listed shape.
    timings = {}
    for case in FA_CASES:
        t = time_flash(case, dev)
        key = "flash_attention" if case == FA_MAIN else f"flash_attention@{case}"
        timings[key] = t
        log(f"[model] flash_attention {case}: kernel {t['ms']:.6f} ms, plain "
            f"{t['plain_ms']:.6f} ms, SDPA {t['library_ms']:.6f} ms, bound "
            f"{t['bound'][0]:.6f} ms ({t['bound'][1]}; {t['bytes']} B, {t['flop']} FLOP), "
            f"max_abs_err {t['err']}")
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_phase

    # (b) gemma-2b's forward at full width.
    base = get_config(MODEL["arch"])
    log(f"[model] {MODEL['arch']}: {base.param_count()} parameters; {MODEL_CUTS}")
    flash = build_model(dataclasses.replace(base, use_flash_kernel=True))
    plain = build_model(base)
    t0 = time.perf_counter()
    params = flash.init(0, device=dev)
    params_b = flash.init(1, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, base.vocab_size, (1, MODEL["seq"]), generator=g, device=dev,
                           dtype=torch.int32)

    def wall(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps

    with torch.inference_mode():
        ops.reset_launch_counts()
        lg_flash, _ = flash.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if launches["flash_attention"] != base.n_layers:
            fail(f"model: forward launched flash_attention {launches['flash_attention']} "
                 f"times, want {base.n_layers}")
        (lg_flash, _), flash_s = wall(lambda: flash.forward(params, {"tokens": tokens}))
        (lg_plain, _), plain_s = wall(lambda: plain.forward(params, {"tokens": tokens}))
        if lg_flash.shape != (1, MODEL["seq"], base.vocab_size) or not torch.isfinite(
                lg_flash).all():
            fail(f"model: bf16 logits {tuple(lg_flash.shape)} not finite or misshapen")
        bf16_diff = float((lg_flash.float() - lg_plain.float()).abs().max())
        scale = float(lg_plain.float().abs().max())
        del lg_flash, lg_plain
        log(f"[model] forward bf16 B=1 S={MODEL['seq']}: kernel {flash_s:.4f} s, plain "
            f"attention {plain_s:.4f} s; max |logit diff| {bf16_diff} (max |logit| "
            f"{scale}); init of two param sets {init_s:.3f} s; launches {launches}")
        log_profile("model", f"forward bf16 S={MODEL['seq']} with the kernel",
                    lambda: flash.forward(params, {"tokens": tokens}), flash_s)

        # f32: the kernel against the plain attention within 1e-3.
        f32 = dataclasses.replace(base, dtype="float32")
        params32 = _to(params, dtype=torch.float32)
        tok32 = tokens[:, :MODEL["f32_seq"]]
        ops.reset_launch_counts()
        lg32, _ = build_model(dataclasses.replace(f32, use_flash_kernel=True)).forward(
            params32, {"tokens": tok32})
        n32 = ops.launch_counts()["flash_attention"]
        ref32, _ = build_model(f32).forward(params32, {"tokens": tok32})
        torch.cuda.synchronize()
        err32 = float((lg32 - ref32).abs().max())
        if n32 != base.n_layers or not torch.allclose(lg32, ref32, atol=1e-3, rtol=1e-3):
            fail(f"model: f32 forward S={MODEL['f32_seq']} kernel vs plain attention: "
                 f"max abs err {err32}, launches {n32}")
        del lg32, ref32
        log(f"[model] forward f32 B=1 S={MODEL['f32_seq']}: logits within atol = rtol = "
            f"1e-3 of the plain attention (max abs err {err32}); {n32} launches")

        # (c) serving: the schedule on the bf16 model, against the CPU's on a
        # reduced gemma-2b (routing does not depend on the model).
        prompts = [torch.randint(0, base.vocab_size, (1, MODEL["prompt"]), generator=g,
                                 device=dev, dtype=torch.int32)
                   for _ in range(MODEL_SERVING["n_requests"])]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_log, counters, s_eng = run_model_serving(dev, base, (params, params_b), prompts)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        s_launches = ops.launch_counts()
        small = reduced(base)
        sp = [build_model(small).init(s, device="cpu") for s in (0, 1)]
        cpu_prompts = [(p.cpu() % small.vocab_size) for p in prompts]
        c_log, c_counters, _ = run_model_serving(torch.device("cpu"), small, sp, cpu_prompts)
        if [r for _, r in s_log] != [r for _, r in c_log] or counters != c_counters:
            fail(f"model serving: card {counters} {[r for _, r in s_log]} != cpu "
                 f"{c_counters} {[r for _, r in c_log]}")
        for toks, _ in s_log:
            if len(toks[0]) != MODEL["tokens"] or not all(
                    0 <= t < base.vocab_size for t in toks[0]):
                fail(f"model serving: bad tokens {toks}")
        if s_launches["op_ingest"] == 0:
            fail(f"model serving never read the store through op_ingest: {s_launches}")
        n_tok = MODEL_SERVING["n_requests"] * MODEL["tokens"]
        log(f"[model] ServingEngine X_STCC, 3 replicas (versions 1-3, params A/B/A), "
            f"{MODEL_SERVING['n_requests']} requests x prompt {MODEL['prompt']} + "
            f"{MODEL['tokens']} tokens, replica {MODEL_SERVING['fail_replica']} down after "
            f"request {MODEL_SERVING['fail_after']}: {serve_s:.3f} s ({n_tok / serve_s:.1f} "
            f"tokens/s); replicas {[r for _, r in s_log]}, counters {counters} == cpu "
            f"(reduced); launches {s_launches}")
        one = {"tokens": prompts[0], "max_seq": MODEL["prompt"] + MODEL["tokens"]}
        _, one_s = wall(lambda: s_eng.generate(ServeSession(1), one, MODEL["tokens"]), 1)
        log_profile("model", f"one generate (prompt {MODEL['prompt']}, {MODEL['tokens']} "
                    "tokens) after the schedule",
                    lambda: s_eng.generate(ServeSession(1), one, MODEL["tokens"]), one_s)

        # f32: each served step's logits against the kernel forward over the
        # same tokens (later positions are padding: the mask is causal).
        rec = _Recorder(build_model(dataclasses.replace(f32, use_flash_kernel=True)))
        eng = ServingEngine(rec, device=dev)
        eng.publish(params32, version=1)
        max_seq = MODEL["prompt"] + MODEL["tokens"]
        out, _ = eng.generate(ServeSession(0), {"tokens": prompts[0], "max_seq": max_seq},
                              MODEL["tokens"])
        seq = torch.zeros((1, 256), dtype=torch.int32, device=dev)
        seq[:, :MODEL["prompt"]] = prompts[0]
        seq[:, MODEL["prompt"]:max_seq] = out
        ops.reset_launch_counts()
        full, _ = rec.model.forward(params32, {"tokens": seq})
        torch.cuda.synchronize()
        steps = torch.stack(rec.logits, dim=1)                # (1, tokens, V)
        want = full[:, MODEL["prompt"] - 1:max_seq - 1]
        dec_err = float((steps - want).abs().max())
        if ops.launch_counts()["flash_attention"] != base.n_layers or not torch.allclose(
                steps, want, atol=1e-3, rtol=1e-3):
            fail(f"model: f32 decode logits vs the kernel forward: max abs err {dec_err}")
        del params32, full, steps, want
    torch.cuda.empty_cache()
    log(f"[model] f32 generate: {MODEL['tokens']} served steps' logits within atol = "
        f"rtol = 1e-3 of the kernel forward (max abs err {dec_err}); phase "
        f"{time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f} s); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    return timings, launches


# -- phase 10b ----------------------------------------------------------------


# The full-width training run: gemma-2b at its published widths (random
# weights, bf16, remat "full"), 2 pods, X_STCC with Δ = 2 and int8
# compression, a global batch of 4 x 512 tokens (2 sequences per pod).
TRAIN_FULL = dict(arch="gemma-2b", pods=2, delta=2, compress="int8", global_batch=4,
                  seq=512, steps=6)
TRAIN_FULL_CUTS = ("cuts of scale: none in width (gemma-2b's 18 layers, d_model 2048, "
                   "8 heads of 256, MQA, d_ff 16384, vocab 256,000); 6 steps")
TRAIN_KERNELS = ("op_ingest", "vclock_chain", "vclock_audit")
# The full-width run's peak device memory (bytes) and mean local-step
# seconds, which the mesh phase holds its dry run against.
TRAIN_MEASURED: dict = {}
# The families' training at their published widths: bf16, random weights,
# remat "full" where the arch has it (the transformer families), 2 pods,
# X_STCC with Δ = 2 and int8 compression, 4 steps; a global batch of
# 4 x 512 tokens (internvl2: 256 image positions, then 256 tokens;
# whisper: 2 x 448 decoder tokens over 1500 frames).  Depth is cut where
# two pods' training state leaves too little of the card for the rest.
FAMILY_TRAIN_FULL = dict(archs=("olmoe-1b-7b", "internvl2-2b", "zamba2-1.2b", "rwkv6-3b",
                                "whisper-large-v3"),
                         pods=2, delta=2, compress="int8", steps=4, seq=512,
                         global_batch=4, whisper_seq=448, whisper_batch=2,
                         layers={"olmoe-1b-7b": 5, "rwkv6-3b": 24})
FAMILY_TRAIN_CUTS = (
    "cuts of scale: none in width; depth: olmoe-1b-7b 5 of its 16 layers and "
    "rwkv6-3b 24 of its 32, where two pods' parameters, gradients and AdamW "
    "moments (each line's 'state at full depth') leave too little of the card "
    "for activations and the merge (at 4 and 20 layers they peaked at 49.7 and "
    "53.1 GiB on an H100); internvl2-2b, zamba2-1.2b and "
    "whisper-large-v3 at full depth; whisper at batch 2 x 448 (its encoder keeps "
    "1500 frames of activations per sequence, unrematerialized as in the "
    "reference); 4 steps")


def _train_counts(case, counts: dict) -> dict:
    """The kernel launches of a training run, and the ones it should make."""
    from torch_port_helpers import expected_train_launches

    want = dict.fromkeys(counts, 0) | expected_train_launches(case)
    return {k: (counts[k], want[k]) for k in counts if counts[k] or want[k]}


def _train_step_parts(trainer, state) -> dict:
    """Seconds of one pod's gradient, its AdamW update, a merge, and the
    merge's protocol bookkeeping alone (each between synchronizations;
    the state is updated as by a step)."""
    import torch

    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, tree_map

    def timed_sync(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    batch = {k: v[0] for k, v in trainer.batch_for(state.step).items()}
    pod = tree_map(lambda x: x[0], state.params)
    wrt = tree_map(lambda x: x.detach().requires_grad_(), pod)

    def grad():
        with torch.enable_grad():
            loss, _ = trainer.model.loss(wrt, batch)
        return torch.autograd.grad(loss, leaves(wrt))

    grads, t_grad = timed_sync(grad)
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), wrt)
    del wrt, grads
    opt = adamw.AdamWState(tree_map(lambda x: x[0], state.opt.mu),
                           tree_map(lambda x: x[0], state.opt.nu), state.opt.count)
    _, t_adamw = timed_sync(lambda: adamw.apply(pod, gtree, opt, trainer.opt_cfg))
    del gtree
    engine = trainer.fns.engine
    with torch.no_grad():
        (_, sync), t_merge = timed_sync(lambda: engine.merge(state.params, state.sync))
        _, t_book = timed_sync(lambda: engine._bookkeep(sync, engine.policy.level))
    return {"grad": t_grad, "adamw": t_adamw, "merge": t_merge, "bookkeep": t_book}


def _rwkv6_cum_bound(params) -> float:
    """An upper bound on the largest ``-cum`` of any 128-token chunk of
    the WKV time-mix: ``-log w_t = exp(w0 + tanh(x A) B) <= exp(w0 +
    sum_j |B_j|)`` per channel.  ``exp(-cum)`` overflows f32 above 88.7."""
    import torch

    from repro_torch.models.rwkv6 import CHUNK

    rw = params["blocks"]["rwkv"]
    rate = torch.exp(rw["decay_w0"].float() + rw["decay_b"].float().abs().sum(-2))
    return float(CHUNK * rate.max())


def _family_train_full(arch: str, dev) -> None:
    """One family at its published widths in ``Trainer`` (see
    ``FAMILY_TRAIN_FULL``): finite losses and grad norms, the predicted
    launches; step seconds, tokens/s and peak memory logged."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import policy_for
    from repro_torch.data import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_state_bytes
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import leaves, tree_map
    from torch_port_helpers import expected_train_launches

    f = FAMILY_TRAIN_FULL
    cfg = get_config(arch)
    full_layers, full_state = cfg.n_layers, train_state_bytes(cfg, f["pods"])
    if arch in f["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=f["layers"][arch])
    seq = f["whisper_seq"] if cfg.is_encdec else f["seq"]
    gb = f["whisper_batch"] if cfg.is_encdec else f["global_batch"]
    t_fam = time.perf_counter()
    tr = Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=gb),
                 AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=f["steps"]),
                 policy_for("X_STCC", delta_steps=f["delta"], compress_inter_pod=f["compress"]),
                 TrainerConfig(n_steps=f["steps"], n_pods=f["pods"], log_every=1), device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_peak = torch.cuda.max_memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = tr.run(state)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = tr.history
    want = expected_train_launches(("X_STCC", f["pods"], f["steps"], {}), delta=f["delta"])
    extra = ""
    if cfg.family == "ssm":
        bound = max(_rwkv6_cum_bound(tree_map(lambda x, i=i: x[i], state.params))
                    for i in range(f["pods"]))
        extra = (f"; the largest -cum of a 128-token chunk is at most {bound:.6f} "
                 "(exp(-cum) overflows f32 above 88.7)")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
        fail(f"train {arch} at full width: losses {[h['loss'] for h in hist]}, grad norms "
             f"{[h['grad_norm'] for h in hist]}{extra}")
    if any(counts[k] != want[k] for k in want):
        fail(f"train {arch} at full width: launches {counts}, predicted {want}")
    local = [h["sec"] for h in hist[1:] if not h["synced"]]
    synced = [h["sec"] for h in hist[1:] if h["synced"]]
    tokens = gb * seq
    n_params = sum(x[0].numel() for x in leaves(state.params))
    remat = cfg.remat if cfg.family in ("dense", "moe", "vlm") else "none, as the reference"
    log(f"[train] {arch} at published widths ({cfg.n_layers} of {full_layers} layers, "
        f"{n_params} parameters, bf16, f32 moments, remat {remat}), {f['pods']} pods, "
        f"X_STCC Δ = {f['delta']} {f['compress']}, batch {gb} x "
        f"{seq}: state {train_state_bytes(cfg, f['pods']) / 2**30:.1f} GiB (at full depth "
        f"{full_state / 2**30:.1f} GiB); init {init_s:.3f} s (allocated after init "
        f"{state_peak} B), {f['steps']} steps "
        f"{run_s:.3f} s; step seconds {[round(h['sec'], 6) for h in hist]} (synced "
        f"{[h['synced'] for h in hist]}); local step {sum(local) / len(local):.6f} s "
        f"({tokens * len(local) / sum(local):.1f} tokens/s), sync step "
        f"{sum(synced) / len(synced):.6f} s ({tokens * len(synced) / sum(synced):.1f} "
        f"tokens/s), first step {hist[0]['sec']:.6f} s; losses "
        f"{[round(h['loss'], 6) for h in hist]}; grad norms "
        f"{[round(h['grad_norm'], 6) for h in hist]}; inter_pod_gb "
        f"{hist[-1]['inter_pod_gb']}, violations {hist[-1]['violations']}; launches "
        f"{ {k: counts[k] for k in TRAIN_KERNELS} }; max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB){extra}")
    del state, tr
    torch.cuda.empty_cache()
    log(f"[time] train {arch} at published widths: {time.perf_counter() - t_fam:.1f} s")


def phase_train() -> dict:
    """The training path: (a) ``tests/test_trainer_levels.py``'s setting on
    the card and on the CPU (same weights, same batches), bookkeeping equal
    and losses within ``TRAIN_LOSS_RTOL``, launches as predicted; (b) the
    full-width gemma-2b run; (c) checkpoints, restarts, crash recovery and
    the elastic rescale on the card.  Returns (a)'s launches."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointStore, SessionToken
    from repro_torch.configs import get_config
    from repro_torch.core import ConsistencyLevel, policy_for
    from repro_torch.data import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.models import abstract_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (CheckpointRecovery, FailurePolicy, RestartManager,
                                     StoreRecovery, rescale_train_state)
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    from repro_torch.tree import tree_map
    from torch_port_helpers import (TRAIN_CASES, TRAIN_LOSS_RTOL, expected_train_launches,
                                    history_mismatches, port_trainer, record_mismatches,
                                    sync_record, train_case_id)

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    # (a) every level, card against CPU.
    total = dict.fromkeys(ops.launch_counts(), 0)
    for case in TRAIN_CASES:
        name = train_case_id(case)
        card, cpu = port_trainer(case, dev), port_trainer(case, "cpu")
        params = cpu.model.init(0, device="cpu")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st_card = card.run(card.init_state(params))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        st_cpu = cpu.run(cpu.init_state(params))
        bad = history_mismatches(cpu.history, card.history) + record_mismatches(
            sync_record(st_cpu.sync), sync_record(st_card.sync))
        if bad:
            fail(f"train {name}: card != cpu: {bad[:8]}")
        checked = _train_counts(case, counts)
        if any(got != want for got, want in checked.values()):
            fail(f"train {name}: launches (got, predicted) {checked}")
        for k, v in counts.items():
            total[k] += v
        h = card.history[-1]
        log(f"[train] {name}: {wall:.3f} s on the card, {len(card.history)} logged steps; "
            f"loss {card.history[0]['loss']:.6f} -> {h['loss']:.6f} (cpu {cpu.history[-1]['loss']:.6f}, "
            f"rtol {TRAIN_LOSS_RTOL}); merges {int(st_card.sync.merges)}, violations "
            f"{h.get('violations')}, severity {h.get('severity')}, inter_pod_gb "
            f"{h.get('inter_pod_gb')}; bookkeeping equal to the CPU; launches "
            f"(got, predicted) {checked}")
    # (a) the six family configurations reduced, card against CPU.
    from torch_port_helpers import FAMILY_ARCHS, FAMILY_TRAIN, FAMILY_TRAIN_CASE, family_trainer

    for arch in FAMILY_ARCHS:
        card, cpu = family_trainer(arch, dev), family_trainer(arch, "cpu")
        params = cpu.model.init(0, device="cpu")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st_card = card.run(card.init_state(params))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        st_cpu = cpu.run(cpu.init_state(params))
        bad = history_mismatches(cpu.history, card.history) + record_mismatches(
            sync_record(st_cpu.sync), sync_record(st_card.sync))
        if bad or not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                          for h in card.history):
            fail(f"train {arch} reduced: card != cpu or not finite: {bad[:8]}")
        want = dict.fromkeys(counts, 0) | expected_train_launches(
            FAMILY_TRAIN_CASE, delta=FAMILY_TRAIN["delta"])
        checked = {k: (counts[k], want[k]) for k in counts if counts[k] or want[k]}
        if any(got != w for got, w in checked.values()):
            fail(f"train {arch} reduced: launches (got, predicted) {checked}")
        for k, v in counts.items():
            total[k] += v
        err = max(abs(c["loss"] - w["loss"]) / abs(w["loss"])
                  for c, w in zip(card.history, cpu.history))
        log(f"[train] {arch} reduced, {train_case_id(FAMILY_TRAIN_CASE)} Δ = 2: {wall:.3f} s "
            f"on the card; losses {[round(h['loss'], 6) for h in card.history]} (largest "
            f"relative difference from the CPU {err:.3e}, rtol {TRAIN_LOSS_RTOL}); grad norms "
            f"{[round(h['grad_norm'], 6) for h in card.history]}; bookkeeping equal to the "
            f"CPU; launches (got, predicted) {checked}")
    t_a = time.perf_counter() - t_phase

    # (b) gemma-2b at full width.
    cfg = get_config(TRAIN_FULL["arch"])
    full = Trainer(
        cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_FULL["seq"],
                        global_batch=TRAIN_FULL["global_batch"]),
        AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=TRAIN_FULL["steps"]),
        policy_for("X_STCC", delta_steps=TRAIN_FULL["delta"],
                   compress_inter_pod=TRAIN_FULL["compress"]),
        TrainerConfig(n_steps=TRAIN_FULL["steps"], n_pods=TRAIN_FULL["pods"], log_every=1),
        device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = full.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = full.run(state)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = full.history
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses) or sum(h["synced"] for h in hist) < 2:
        fail(f"train full width: losses {losses}, synced {[h['synced'] for h in hist]}")
    want = expected_train_launches(("X_STCC", TRAIN_FULL["pods"], TRAIN_FULL["steps"], {}),
                                   delta=TRAIN_FULL["delta"])
    if any(counts[k] != want[k] for k in want):
        fail(f"train full width: launches {counts}, predicted {want}")
    local = [h["sec"] for h in hist[1:] if not h["synced"]]
    synced = [h["sec"] for h in hist[1:] if h["synced"]]
    TRAIN_MEASURED.update(peak=peak, local_s=sum(local) / len(local))
    tokens = TRAIN_FULL["global_batch"] * TRAIN_FULL["seq"]
    n_params = cfg.param_count()
    log(f"[train] {cfg.name} at full width ({n_params} parameters, bf16, f32 moments, "
        f"remat {cfg.remat}), {TRAIN_FULL['pods']} pods, X_STCC Δ = {TRAIN_FULL['delta']} "
        f"{TRAIN_FULL['compress']}, batch {TRAIN_FULL['global_batch']} x {TRAIN_FULL['seq']}: "
        f"init {init_s:.3f} s, {TRAIN_FULL['steps']} steps {run_s:.3f} s; step seconds "
        f"{[round(h['sec'], 6) for h in hist]} (synced {[h['synced'] for h in hist]}); "
        f"local step {sum(local) / len(local):.6f} s ({tokens * len(local) / sum(local):.1f} "
        f"tokens/s), sync step {sum(synced) / len(synced):.6f} s "
        f"({tokens * len(synced) / sum(synced):.1f} tokens/s), first step {hist[0]['sec']:.6f} s; "
        f"losses {losses}; inter_pod_gb {hist[-1]['inter_pod_gb']}, violations "
        f"{hist[-1]['violations']}, severity {hist[-1]['severity']}; launches "
        f"{ {k: counts[k] for k in TRAIN_KERNELS} }; max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB); {TRAIN_FULL_CUTS}")
    # Where a step's time goes: one more step taken apart (pod 0's
    # forward + backward, its AdamW update, then the merge).
    parts = _train_step_parts(full, state)
    log(f"[train] {cfg.name} full width, one step taken apart (host clock around "
        f"synchronized work): pod 0 forward + backward {parts['grad']:.6f} s, its AdamW "
        f"update {parts['adamw']:.6f} s, the int8 merge with its bookkeeping "
        f"{parts['merge']:.6f} s (of which _bookkeep {parts['bookkeep']:.6f} s)")
    del state, full
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    log(f"[train] families at published widths: {FAMILY_TRAIN_CUTS}")
    for arch in FAMILY_TRAIN_FULL["archs"]:
        _family_train_full(arch, dev)
    t_b = time.perf_counter() - t_b

    # (c) checkpoints and recovery at the reduced size.
    case = ("X_STCC", 2, 8, {})
    tr, cpu = port_trainer(case, dev), port_trainer(case, "cpu")
    with tempfile.TemporaryDirectory() as root:
        store = CheckpointStore(root, n_replicas=3, level=ConsistencyLevel.X_STCC,
                                device=dev)
        tr.ckpt_store, tr.ckpt_session = store, SessionToken(client_id=0)
        tr.tcfg.ckpt_every = 4
        params = cpu.model.init(0, device="cpu")
        state = tr.run(tr.init_state(params))
        cpu_state = cpu.run(cpu.init_state(params))
        # A lagging replica: the reader that saw the newest save is rerouted.
        lagged = CheckpointStore(root, n_replicas=3, level=ConsistencyLevel.X_STCC,
                                 propagation_lag_s=3600.0, device=dev)
        version = lagged.save(tree_map(lambda x: x[0], state.params), 9, tr.ckpt_session)
        template = abstract_params(tr.model)
        reader = SessionToken(client_id=2, read_floor=version)
        got, v_read, rerouted = lagged.restore(template, reader)
        if v_read != version or not rerouted or not all(
                torch.equal(a, b[0]) for a, b in zip(leaves(got), leaves(state.params))):
            fail(f"train checkpoints: session-guarded restore gave v{v_read} "
                 f"(saved v{version}), rerouted {rerouted}")
        lagged.propagate(now=1e18)
        mgr = RestartManager(store, FailurePolicy(max_restarts=2))
        params_r, step = mgr.recover(template, SessionToken(client_id=1))
        outcome = mgr.last_outcome
        _, direct = CheckpointRecovery(store).recover(template, SessionToken(client_id=2))
        if step != 9 or outcome.partial or direct != outcome or not all(
                torch.equal(a, b[0]) for a, b in zip(leaves(params_r), leaves(state.params))):
            fail(f"train checkpoints: RestartManager step {step}, outcome {outcome}, "
                 f"CheckpointRecovery {direct}")
        restored, r_step = tr.restore_checkpoint()
    # The pods' replica store: replica 1 crashes and rebuilds from its peer.
    full_mask = dict(up=np.ones(2, bool), link=np.ones((2, 2), bool))
    down = np.array([False, True])
    rec = []
    for t, st in ((tr, state), (cpu, cpu_state)):
        s = t.fns.engine._store
        rec.append(StoreRecovery(s).recover(s.wrap(st.sync.cluster, st.sync.duot), down,
                                            **full_mask))
    (st_card, out_card), (st_cpu, out_cpu) = rec
    if out_card != out_cpu or out_card.partial or _store_diff(st_card, st_cpu):
        fail(f"train StoreRecovery: card {out_card} != cpu {out_cpu}")
    # Elastic: 2 -> 4 -> 2 pods keeps the parameters' mean.
    mean0 = [x.float().mean(0) for x in leaves(state.params)]
    s4, e4 = rescale_train_state(state, tr.fns.engine, 4)
    s2, e2 = rescale_train_state(s4, e4, 2)
    err = max(float((x.float().mean(0) - m).abs().max())
              for m, x in zip(mean0, leaves(s2.params)))
    if not all(torch.allclose(x.float().mean(0), m, rtol=1e-6, atol=1e-7)
               for m, x in zip(mean0, leaves(s2.params))) or e4.n_pods != 4:
        fail(f"train elastic: the mean moved by {err}")
    log(f"[train] checkpoints (3 replicas, X_STCC) on the card: session-guarded restore "
        f"rerouted to v{v_read}; RestartManager step {step}, {outcome}; CheckpointRecovery "
        f"equal; Trainer.restore_checkpoint step {r_step}; StoreRecovery {out_card} equal to "
        f"the CPU; rescale 2 -> 4 -> 2 pods: the mean within {err} (rtol 1e-6); phase "
        f"{time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f} s, the families at "
        f"published widths {t_b:.1f} s)")
    return total


# -- phase 10c ----------------------------------------------------------------


# The mesh's collective regions: gemma-2b at its published widths in f32
# (one kv head: "dp" attention on a 16-way model axis), decoding after a
# prompt and running its forward; olmoe-1b-7b's MoE layer at T = 16 x 256
# on 16 data shards.
MESH_REGIONS = dict(arch="gemma-2b", prompt=128, steps=16, seq=512, model=16,
                    moe_arch="olmoe-1b-7b", moe_layers=2, moe_batch=16, moe_seq=256,
                    data=16)
# (e)'s families served as SPMD: full width, depth cut (``MESH_FAMILY_LAYERS``),
# bf16 with B.8, B = 1: a forward over ``seq`` tokens (whisper's decoder
# ``whisper_seq`` over its 1500 frames), the prompt's prefill and a
# ``tokens``-token ``generate``.
MESH_FAMILIES = dict(seq=2048, whisper_seq=448, prompt=128, tokens=4)
MESH_FAMILY_LAYERS = {"olmoe-1b-7b": 2, "internvl2-2b": 2, "zamba2-1.2b": 6, "rwkv6-3b": 2,
                      "whisper-large-v3": 2}
MESH_CUTS = ("cuts of scale: none in width (gemma-2b's 18 layers at d_model 2048 in f32, "
             "B = 1; olmoe-1b-7b's 64 experts, top-8, d_model 2048, d_ff 1024); olmoe's "
             "depth cut to 2 of its 16 layers (the check is one MoE layer's, the forward "
             "only drives the path); (d)'s 16-way axes are a MeshShape, every shard on "
             "the one card; ring attention needs 2 or more ranks, which one card cannot "
             "give under NCCL; (e)'s SPMD runs on the (1, 1) mesh, where every "
             "placement is replicated: TP and FSDP shards over 2 or more ranks, and a "
             "ring between cards, are held only on the CPU (gloo), one card giving one "
             "NCCL rank; (e)'s families at full width, depth cut to olmoe-1b-7b 2 of 16 "
             "layers, internvl2-2b 2 of 24, zamba2-1.2b 6 of 38 (one group: 6 Mamba2 "
             "layers, one shared attention site), rwkv6-3b 2 of 32, whisper-large-v3 2 of "
             "32 decoder and 2 of 32 encoder layers (every layer of a family has the same "
             "shapes and placements, so one or two show each; DTensor's host cost grows "
             "with depth); llama4-maverick (128 experts of 5120 x 8192, more than one "
             "H100 holds) served as SPMD only reduced, on the CPU; (a'') gemma-2b's training on "
             "DTensors at full width, depth cut to 2 of 18 layers (every layer has the same "
             "shapes and placements), one local and one sync step, 4 x 512 tokens; (a‴) the "
             "five families' training on DTensors at full width, depth cut as (e)'s, one local "
             "and one sync step, 4 x 512 tokens (whisper 2 x 448); llama4-maverick trains on "
             "DTensors only reduced, on the CPU (its experts exceed one H100); training "
             "over 2 or more ranks (TP / FSDP shards, pods split over 'pod') is held only on "
             "the CPU (gloo); (g) use_devices on the one rank takes the sequential branch: "
             "one shard per rank needs 2 or more ranks")


# (a'') training on DTensors at full width: gemma-2b in f32 (d_model 2048,
# vocab 256,000), 2 of its 18 layers, 2 pods, X_STCC with Δ = 1 and int8.
MESH_TRAIN = dict(arch="gemma-2b", layers=2, pods=2, delta=1, compress="int8",
                  global_batch=4, seq=512)
# (g) use_devices on one rank.
MESH_DEVICES = dict(level="TCC", n_shards=2, n_ops=6000)


def _mesh_decode(model, params, toks, mesh):
    """``MESH_REGIONS``' prefill and decode steps under ``mesh``: the
    steps' logits and the regions run (``torch_mesh_cases``)."""
    from repro_torch.models import sharding
    from torch_mesh_cases import count_regions, decode_logits

    r = MESH_REGIONS
    with count_regions() as calls, sharding.use_mesh(mesh):
        out = decode_logits(model, params, {"tokens": toks}, r["prompt"], r["steps"],
                            r["prompt"] + r["steps"])
    return out, dict(calls)


def _mesh_regions_stacked(gemma, dev: dict, xla) -> None:
    """(d) The regions with every shard on this card (a ``MeshShape``):
    the LSE decode at P = 16 against the plain decode, the ring forward
    at P = 16 against the plain attention, and olmoe's MoE layer on 16
    data shards against 16 no-mesh calls on the blocks."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, common, moe, sharding
    from repro_torch.models.sharding import MeshShape
    from torch_mesh_cases import count_regions, moe_input, record_dispatch

    r = MESH_REGIONS
    cfg, params, toks = gemma
    cuda = torch.device("cuda")
    n = cfg.n_layers
    stacked = MeshShape({"data": 1, "model": r["model"]})
    lse = build_model(dataclasses.replace(cfg, decode_comm="lse_shardmap"))
    t0 = time.perf_counter()
    got, calls = _mesh_decode(lse, params, toks, stacked)
    torch.cuda.synchronize()
    t_lse = time.perf_counter() - t0
    err = float((got - xla).abs().max())
    # The prompt's prefill takes the ring too ("dp" mode, the axis divides it).
    if calls != {"ring": n, "lse": n * r["steps"]} or not torch.allclose(
            got, xla, atol=1e-3, rtol=1e-3):
        fail(f"mesh: the LSE decode over {stacked} vs the plain decode: max abs err {err}, "
             f"regions {calls}")
    log(f"[mesh] (d) {cfg.name} f32 prefill (the ring, P = {r['model']}) and LSE decode, "
        f"{r['steps']} steps after a {r['prompt']}-token prompt, cache "
        f"{r['prompt'] + r['steps']} slots over {stacked} (P = {r['model']}): logits within "
        f"atol = rtol = 1e-3 of the plain prefill and decode (max abs err {err}); regions "
        f"{calls}; {t_lse:.3f} s")

    model = build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(11)
    seq = torch.randint(0, cfg.vocab_size, (1, r["seq"]), generator=g, device=cuda,
                        dtype=torch.int32)
    with torch.inference_mode():
        plain = model.forward(params, {"tokens": seq})[0]
        t0 = time.perf_counter()
        with count_regions() as calls, sharding.use_mesh(stacked):
            ring = model.forward(params, {"tokens": seq})[0]
        torch.cuda.synchronize()
        t_ring = time.perf_counter() - t0
    err = float((ring - plain).abs().max())
    if calls != {"ring": n, "lse": 0} or not torch.isfinite(ring).all() or not torch.allclose(
            ring, plain, atol=1e-3, rtol=1e-3):
        fail(f"mesh: the ring forward over {stacked} vs the plain attention: max abs err "
             f"{err}, regions {calls}")
    log(f"[mesh] (d) {cfg.name} f32 forward B = 1, S = {r['seq']} over {stacked}: the ring "
        f"(P = {r['model']}, 'dp' mode) in all {n} layers, logits within atol = rtol = 1e-3 "
        f"of the plain attention (max abs err {err}); {t_ring:.3f} s")
    del plain, ring
    torch.cuda.empty_cache()

    ocfg = dataclasses.replace(get_config(r["moe_arch"]), dtype="float32",
                               n_layers=r["moe_layers"])
    omodel = build_model(ocfg)
    oparams = omodel.init(0, device=cuda)
    layer = common.layer(oparams["moe_blocks"]["moe"], 0)
    case = dict(b=r["moe_batch"], s=r["moe_seq"])
    x = torch.from_numpy(moe_input(ocfg, case)).to(cuda)
    data = MeshShape({"data": r["data"], "model": r["model"]})
    with torch.inference_mode():
        with record_dispatch() as split:
            with sharding.use_mesh(data):
                t0 = time.perf_counter()
                y, aux = moe.moe(x, layer, ocfg)
                torch.cuda.synchronize()
                t_moe = time.perf_counter() - t0
            blocks = [moe.moe(x[i:i + 1], layer, ocfg)[0] for i in range(r["moe_batch"])]
        with record_dispatch() as whole:
            y_whole, aux_whole = moe.moe(x, layer, ocfg)
        with record_dispatch() as fwd, sharding.use_mesh(data):
            logits = omodel.forward(oparams, {"tokens": torch.zeros(
                (r["moe_batch"], r["moe_seq"]), dtype=torch.int32, device=cuda)})[0]
        torch.cuda.synchronize()
    (_, cap, _, se, st, _, pos), per = split[0], split[1:]
    bad = [k for k, a, b in (("experts", se, torch.cat([q[3] for q in per])),
                             ("tokens", st, torch.cat([q[4] for q in per])),
                             ("positions", pos, torch.cat([q[6] for q in per])))
           if not torch.equal(a, b)]
    if [q[1] for q in per] != [cap] * r["moe_batch"] or se.shape[0] != r["data"]:
        bad.append(f"capacities {cap} vs {[q[1] for q in per]}, shards {se.shape[0]}")
    y_blocks = torch.cat(blocks)
    err = float((y - y_blocks).abs().max())
    if bad or not torch.allclose(y, y_blocks, atol=1e-4, rtol=1e-4):
        fail(f"mesh: {ocfg.name}'s MoE layer on {r['data']} data shards vs {r['moe_batch']} "
             f"no-mesh calls on the blocks: {bad}, yt max abs err {err}")
    if not torch.isfinite(logits).all() or [q[6].shape[0] for q in fwd] != [r["data"]] * len(
            fwd) or len(fwd) != ocfg.n_layers:
        fail(f"mesh: {ocfg.name}'s forward over {data}: logits finite "
             f"{bool(torch.isfinite(logits).all())}, shards per dispatch "
             f"{[q[6].shape[0] for q in fwd]}")
    slots = pos.numel()
    dropped, dropped_whole = int((pos >= cap).sum()), int((whole[0][6] >= whole[0][1]).sum())
    log(f"[mesh] (d) {ocfg.name} f32 MoE layer, T = {r['moe_batch']} x {r['moe_seq']} over "
        f"{data}: {r['data']} shards, capacity {cap} per shard ({whole[0][1]} without the "
        f"split); routing and kept/dropped slots equal to {r['moe_batch']} no-mesh calls on "
        f"the blocks, yt within atol = rtol = 1e-4 (max abs err {err}); dropped share "
        f"{dropped / slots:.6f} ({dropped} of {slots} slots) with the split, "
        f"{dropped_whole / slots:.6f} ({dropped_whole}) without; aux {float(aux):.6f} "
        f"(without the split {float(aux_whole):.6f}); {t_moe:.3f} s; the {ocfg.n_layers}-layer "
        f"forward over the mesh routed {len(fwd)} layers on {r['data']} shards; "
        f"{MESH_CUTS}; {dev['smi']}")
    del oparams, layer, x, y, y_blocks, y_whole, logits
    torch.cuda.empty_cache()


def _mesh_spmd(mesh, gemma, dev: dict) -> int:
    """(e) gemma-2b served as SPMD on the (1, 1) NCCL mesh, at the model
    phase's settings (``MODEL``), DTensor parameters from
    ``sharding.distribute_params`` against the same parameters plain:
    the bf16 forward at S = ``MODEL["seq"]`` and the f32 forward at
    ``MODEL["f32_seq"]`` (both through B.8), the prompt's bf16 prefill
    (logits and cache) and a bf16 ``generate`` of ``MODEL["tokens"]``
    tokens (tokens and every step's logits).  Bit-equal wanted (one rank:
    no partial sums); otherwise each check prints its max abs error and
    must hold within the model phase's atol = rtol = 1e-3.  B.8 must
    launch ``n_layers`` times per meshed forward.  The meshed and plain
    bf16 forwards' walls and device operations per forward are logged;
    returns B.8's launches in the counted meshed forward."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_model, sharding
    from repro_torch.serve import ServeSession, ServingEngine

    t_e = time.perf_counter()
    cfg32, params32, _ = gemma
    cuda = torch.device("cuda")
    bf = dataclasses.replace(cfg32, dtype="bfloat16", use_flash_kernel=True)
    f32 = dataclasses.replace(cfg32, use_flash_kernel=True)
    params_bf = _to(params32, dtype=torch.bfloat16)
    with sharding.use_mesh(mesh):
        placed_bf = sharding.distribute_params(params_bf, bf)
        placed_32 = sharding.distribute_params(params32, f32)
    model_bf, model_32 = build_model(bf), build_model(f32)
    g = torch.Generator(device=cuda).manual_seed(7)
    seq = torch.randint(0, cfg32.vocab_size, (1, MODEL["seq"]), generator=g, device=cuda,
                        dtype=torch.int32)
    prompt = seq[:, :MODEL["prompt"]]
    max_seq = MODEL["prompt"] + MODEL["tokens"]

    def meshed(fn):
        def run():
            with sharding.use_mesh(mesh):
                return fn()
        return run

    def whole(x):
        return x.full_tensor() if sharding.is_dtensor(x) else x

    def wall(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    results = []

    def check(name, plain, got):
        got = whole(got)
        err = float((got.float() - plain.float()).abs().max())
        equal = bool(torch.equal(got, plain))
        results.append(f"{name} {'bit-equal' if equal else f'max abs err {err}'}")
        if not equal and not torch.allclose(got.float(), plain.float(), atol=1e-3, rtol=1e-3):
            fail(f"mesh (e): {name} on DTensors vs plain: max abs err {err}, beyond atol = "
                 f"rtol = 1e-3")

    def fwd_bf(params):
        return model_bf.forward(params, {"tokens": seq})[0]

    with torch.no_grad():
        plain = fwd_bf(params_bf)
        ops.reset_launch_counts()
        got = meshed(lambda: fwd_bf(placed_bf))()
        torch.cuda.synchronize()
        launches = ops.launch_counts()["flash_attention"]
        if launches != cfg32.n_layers:
            fail(f"mesh (e): the meshed bf16 forward launched flash_attention {launches} "
                 f"times, want {cfg32.n_layers}")
        check(f"bf16 forward S={MODEL['seq']}", plain, got)
        del plain, got
        plain_s = wall(lambda: fwd_bf(params_bf))
        mesh_s = wall(meshed(lambda: fwd_bf(placed_bf)))
        ops_plain, fa_plain = device_ops_per_call(lambda: fwd_bf(params_bf), "flash")
        ops_mesh, fa_mesh = device_ops_per_call(meshed(lambda: fwd_bf(placed_bf)), "flash")
        tok32 = seq[:, :MODEL["f32_seq"]]
        check(f"f32 forward S={MODEL['f32_seq']}",
              model_32.forward(params32, {"tokens": tok32})[0],
              meshed(lambda: model_32.forward(placed_32, {"tokens": tok32})[0])())
        batch = {"tokens": prompt, "max_seq": max_seq}
        lp, cp = model_bf.prefill(params_bf, batch)
        lm, cm = meshed(lambda: model_bf.prefill(placed_bf, batch))()
        check(f"bf16 prefill logits ({MODEL['prompt']}-token prompt)", lp, lm)
        check("bf16 prefill cache k", cp["k"], cm["k"])
        check("bf16 prefill cache v", cp["v"], cm["v"])
        del lp, cp, lm, cm
        outs = []
        for params, on_mesh in ((params_bf, False), (placed_bf, True)):
            rec = _Recorder(model_bf)
            eng = ServingEngine(rec, device=cuda)
            eng.publish(params, version=1)

            def run(eng=eng):
                return eng.generate(ServeSession(0), batch, MODEL["tokens"])

            t0 = time.perf_counter()
            toks, _ = meshed(run)() if on_mesh else run()
            torch.cuda.synchronize()
            outs.append((toks, torch.stack([whole(x) for x in rec.logits]),
                         time.perf_counter() - t0, eng.logit_gathers))
        (t_plain, lg_plain, gen_plain_s, _), (t_mesh, lg_mesh, gen_mesh_s, gathers) = outs
        if not torch.equal(t_plain, t_mesh) or gathers != MODEL["tokens"]:
            fail(f"mesh (e): generate on DTensors {t_mesh.tolist()} vs plain "
                 f"{t_plain.tolist()}, {gathers} logit gathers (want {MODEL['tokens']})")
        check(f"bf16 generate's {MODEL['tokens']} steps' logits", lg_plain, lg_mesh)
    del params_bf, placed_bf, placed_32
    torch.cuda.empty_cache()
    log(f"[mesh] (e) {cfg32.name} served as SPMD on the (1, 1) NCCL mesh, DTensor parameters "
        f"(distribute_params; every placement replicated on one rank): "
        f"{'; '.join(results)}; generate's tokens equal, {gathers} logit gathers; B.8 "
        f"launched {launches} times per meshed forward; bf16 forward S={MODEL['seq']} wall "
        f"{mesh_s:.4f} s meshed vs {plain_s:.4f} s plain, device operations per forward "
        f"{ops_mesh} meshed ({fa_mesh} flash) vs {ops_plain} plain ({fa_plain} flash); "
        f"generate of {MODEL['tokens']} tokens {gen_mesh_s:.3f} s meshed vs "
        f"{gen_plain_s:.3f} s plain; {time.perf_counter() - t_e:.1f} s; {MESH_CUTS}; "
        f"{dev['smi']}")
    return launches


def _mesh_families(mesh, dev: dict) -> int:
    """(e) the MoE, VLM, hybrid, SSM and audio families served as SPMD on
    the (1, 1) NCCL mesh, each at full width and cut depth
    (``MESH_FAMILY_LAYERS``) in bf16 with B.8, DTensor parameters from
    ``sharding.distribute_params`` against the same parameters plain: the
    forward, the prompt's prefill (logits and every cache leaf) and a
    ``generate`` (tokens and every step's logits), each bit-equal (one
    rank: no partial sums).  B.8 must launch as often per meshed forward
    as per plain forward, once per causal self-attention layer.  Logs
    each family's meshed and plain walls; returns B.8's launches in the
    counted meshed forwards."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, sharding
    from repro_torch.serve import ServeSession, ServingEngine
    from torch_port_helpers import causal_attention_layers, family_inputs, torch_batch

    f = MESH_FAMILIES
    cuda = torch.device("cuda")
    total = 0

    def whole(x):
        return x.full_tensor() if sharding.is_dtensor(x) else x

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for arch, n_layers in MESH_FAMILY_LAYERS.items():
        t_arch = time.perf_counter()
        base = get_config(arch)
        over = dict(n_layers=n_layers, use_flash_kernel=True, dtype="bfloat16")
        if base.is_encdec:
            over["n_encoder_layers"] = n_layers
        cfg = dataclasses.replace(base, **over)
        model = build_model(cfg)
        params = model.init(0, device=cuda)
        with sharding.use_mesh(mesh):
            placed = sharding.distribute_params(params, cfg)
        s = f["whisper_seq"] if cfg.is_encdec else f["seq"]
        batch = torch_batch(family_inputs(cfg, 1, s, 7), cuda, dtype=torch.bfloat16)
        batch.pop("labels")
        prompt = dict(batch, tokens=batch["tokens"][:, :f["prompt"] + cfg.n_vis_tokens],
                      max_seq=f["prompt"] + cfg.n_vis_tokens + f["tokens"])
        want = causal_attention_layers(cfg)
        bad = []

        def check(name, plain, got):
            if not torch.equal(whole(got), plain):
                err = float((whole(got).float() - plain.float()).abs().max())
                bad.append(f"{name} max abs err {err}")

        with torch.no_grad():
            ops.reset_launch_counts()
            (plain, _), plain_s = wall(lambda: model.forward(params, batch))
            plain_launches = ops.launch_counts()["flash_attention"]
            ops.reset_launch_counts()
            with sharding.use_mesh(mesh):
                (got, _), first_s = wall(lambda: model.forward(placed, batch))
            launches = ops.launch_counts()["flash_attention"]
            check("forward", plain, got)
            del plain, got
            _, plain_s = wall(lambda: model.forward(params, batch))
            with sharding.use_mesh(mesh):
                _, mesh_s = wall(lambda: model.forward(placed, batch))
            lp, cp = model.prefill(params, prompt)
            with sharding.use_mesh(mesh):
                lm, cm = model.prefill(placed, prompt)
            check("prefill logits", lp, lm)
            cache_keys = sorted(cp)
            for k in cache_keys:
                check(f"prefill cache {k}", cp[k], cm[k])
            del lp, cp, lm, cm
            outs = []
            for p, on_mesh in ((params, False), (placed, True)):
                rec = _Recorder(model)
                eng = ServingEngine(rec, device=cuda)
                eng.publish(p, version=1)

                def run(eng=eng):
                    return eng.generate(ServeSession(0), prompt, f["tokens"])

                if on_mesh:
                    with sharding.use_mesh(mesh):
                        (toks, _), gen_s = wall(run)
                else:
                    (toks, _), gen_s = wall(run)
                outs.append((toks, torch.stack([whole(x) for x in rec.logits]), gen_s,
                             eng.logit_gathers))
        (t_plain, lg_plain, gen_plain_s, _), (t_mesh, lg_mesh, gen_mesh_s, gathers) = outs
        check(f"generate's {f['tokens']} steps' logits", lg_plain, lg_mesh)
        if not torch.equal(t_plain, t_mesh) or gathers != f["tokens"]:
            bad.append(f"generate tokens {t_mesh.tolist()} vs plain {t_plain.tolist()}, "
                       f"{gathers} logit gathers")
        if launches != plain_launches or launches != want:
            bad.append(f"B.8 launched {launches} times per meshed forward, {plain_launches} "
                       f"plain, want {want}")
        if bad:
            fail(f"mesh (e) {arch} ({n_layers} layers) on DTensors vs plain: {bad}")
        total += launches
        log(f"[mesh] (e) {arch} ({n_layers} of {base.n_layers} layers, full width, bf16, "
            f"B.8) served as SPMD on the (1, 1) NCCL mesh: forward S={s}, the "
            f"{f['prompt']}-token prompt's prefill (logits, caches {cache_keys}) "
            f"and generate's {f['tokens']} tokens and logits bit-equal to plain; "
            f"{gathers} logit gathers; B.8 {launches} launches per meshed forward "
            f"({plain_launches} plain); forward wall {mesh_s:.4f} s meshed (first "
            f"{first_s:.4f}) vs {plain_s:.4f} s plain; generate {gen_mesh_s:.3f} s meshed vs "
            f"{gen_plain_s:.3f} s plain; {time.perf_counter() - t_arch:.1f} s; {dev['smi']}")
        del params, placed, batch, prompt, outs
        torch.cuda.empty_cache()
    return total


def _train_steps_on(trainer, params, mesh) -> tuple[dict, dict]:
    """``trainer``'s local step then its sync step from ``params`` (one
    pod's tree) on the state ``init_state`` places under ``use_mesh(mesh)``
    (``None``: plain tensors), each step timed between synchronizations:
    (the run's record: metrics as numpy, step walls, peak bytes, launches,
    whether the parameters are DTensors, the sync bookkeeping; the state's
    tensors by name, on the card)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import sharding
    from repro_torch.tree import items
    from torch_port_helpers import as_np, state_trees, sync_record

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with sharding.use_mesh(mesh):
        state = trainer.init_state(params)
        walls, metrics = [], []
        for step, fn in enumerate((trainer.fns.local_step, trainer.fns.sync_step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, mt = fn(state, trainer.batch_for(step))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            metrics.append({k: as_np(v) for k, v in mt.items()})
    run = dict(metrics=metrics, walls=walls, peak=torch.cuda.max_memory_allocated(),
               counts=ops.launch_counts(), sync=sync_record(state.sync),
               placed=all(sharding.is_dtensor(v) for _, v in items(state.params)))
    tensors = {f"{t}/{k}": v for t, tree in state_trees(state).items() for k, v in items(tree)}
    return run, tensors


def _state_differ(tensors: dict, record: dict) -> list[str]:
    """The names whose tensor (on the card; a DTensor made whole) is not
    the one in ``record`` (on the host) bit for bit, compared on the card
    one tensor at a time; a name missing from either side too."""
    import torch

    from repro_torch.models import sharding

    out = sorted(set(tensors) ^ set(record))
    for k, v in tensors.items():
        w = sharding.local(sharding.replicate(v)) if sharding.is_dtensor(v) else v
        if k in record and not torch.equal(w, record[k].to(w.device)):
            out.append(k)
    return out


def _mesh_train_pair(mesh, trainer, params, label: str) -> dict:
    """``trainer``'s local and sync step from ``params`` on plain tensors,
    then on the state placed on the (1, 1) ``mesh`` (DTensors), each run's
    state freed before the next (the plain run's tensors wait on the
    host).  On one rank every placement is replicated, so the runs must be
    equal bit for bit: metrics, parameters, moments, anchor and
    bookkeeping; B.1, the chain and B.2 launched as one merge predicts in
    each.  Returns both runs' records and the count of tensors compared."""
    import numpy as np
    import torch

    from torch_port_helpers import expected_train_launches, record_mismatches

    want = expected_train_launches(("X_STCC", MESH_TRAIN["pods"], 1, {}), delta=1)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        run, tensors = _train_steps_on(trainer, params, m)
        if run["placed"] != (m is not None):
            fail(f"mesh: {label} {name}: DTensor parameters {run['placed']}")
        if any(run["counts"][k] != n for k, n in want.items()):
            fail(f"mesh: {label} {name}: launches {run['counts']}, predicted {want}")
        if m is None:
            record = {k: v.cpu() for k, v in tensors.items()}
        else:
            differ = _state_differ(tensors, record)
        runs[name] = run
        del tensors
        torch.cuda.empty_cache()
    plain, meshed = runs["plain"], runs["mesh"]
    bad = [f"step {i} {k}" for i, (a, b) in enumerate(zip(plain["metrics"], meshed["metrics"]))
           for k in a if not np.array_equal(a[k], b[k])]
    bad += differ + record_mismatches(plain["sync"], meshed["sync"])
    if bad:
        fail(f"mesh: {label} on DTensors != plain: {bad[:8]}")
    return dict(plain=plain, mesh=meshed, tensors=len(record), launches=want)


def _mesh_train_full(mesh, dev: dict) -> None:
    """(a'') ``MESH_TRAIN``: gemma-2b at full width in f32, depth cut, a
    local and a sync step on the state placed on the (1, 1) NCCL ``mesh``
    (DTensors) against the same steps on plain tensors, bit for bit
    (:func:`_mesh_train_pair`)."""
    from repro_torch.configs import get_config
    from repro_torch.core import policy_for
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    t_all = time.perf_counter()
    f = MESH_TRAIN
    cfg = dataclasses.replace(get_config(f["arch"]), dtype="float32", n_layers=f["layers"])
    trainer = Trainer(
        cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=f["seq"],
                        global_batch=f["global_batch"]),
        AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=4),
        policy_for("X_STCC", delta_steps=f["delta"], compress_inter_pod=f["compress"]),
        TrainerConfig(n_steps=2, n_pods=f["pods"]), device="cuda")
    params = trainer.model.init(0, device="cuda")
    r = _mesh_train_pair(mesh, trainer, params, "(a'')")
    del params
    p0, p1 = r["plain"], r["mesh"]
    log(f"[mesh] (a'') {cfg.name} f32 at full width, {f['layers']} of "
        f"{get_config(f['arch']).n_layers} layers "
        f"({cfg.param_count()} parameters per pod), {f['pods']} pods, X_STCC Δ = {f['delta']} "
        f"{f['compress']}, batch {f['global_batch']} x {f['seq']}: local step "
        f"{p1['walls'][0]:.6f} s meshed against {p0['walls'][0]:.6f} s plain, sync step "
        f"{p1['walls'][1]:.6f} s against {p0['walls'][1]:.6f} s; peak {p1['peak']} B meshed "
        f"({p1['peak'] / 2**30:.2f} GiB), {p0['peak']} B plain ({p0['peak'] / 2**30:.2f} "
        f"GiB); losses {[float(x['loss']) for x in p1['metrics']]}, grad norms "
        f"{[float(x['grad_norm']) for x in p1['metrics']]}: equal bit for bit (metrics, "
        f"{r['tensors']} tensors of parameters, moments and anchor, clocks, DUOT, counters); "
        f"launches per run {r['launches']}; {time.perf_counter() - t_all:.1f} s; {dev['smi']}")


def _mesh_train_families(mesh, dev: dict) -> None:
    """(a‴) the train phase's five families (``FAMILY_TRAIN_FULL``: bf16,
    remat as there, 4 x 512 tokens, whisper 2 x 448 over its 1500 frames)
    at (e)'s depth (``MESH_FAMILY_LAYERS``), ``MESH_TRAIN``'s 2 pods and
    X_STCC with Δ = 1 and int8, through ``Trainer`` (its batches' image
    prefix and frames): a local and a sync step on the state placed on the
    (1, 1) NCCL ``mesh`` against the same steps on plain tensors
    (:func:`_mesh_train_pair`, bit for bit).  Logs each family's meshed
    and plain step walls and peaks."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import policy_for
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    f, m = FAMILY_TRAIN_FULL, MESH_TRAIN
    t_all = time.perf_counter()
    for arch in f["archs"]:
        t_arch = time.perf_counter()
        base = get_config(arch)
        n_layers = MESH_FAMILY_LAYERS[arch]
        over = dict(n_layers=n_layers)
        if base.is_encdec:
            over["n_encoder_layers"] = n_layers
        cfg = dataclasses.replace(base, **over)
        seq = f["whisper_seq"] if cfg.is_encdec else f["seq"]
        gb = f["whisper_batch"] if cfg.is_encdec else f["global_batch"]
        trainer = Trainer(
            cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=gb),
            AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=4),
            policy_for("X_STCC", delta_steps=m["delta"], compress_inter_pod=m["compress"]),
            TrainerConfig(n_steps=2, n_pods=m["pods"]), device="cuda")
        params = trainer.model.init(0, device="cuda")
        r = _mesh_train_pair(mesh, trainer, params, f"(a‴) {arch}")
        del params, trainer
        torch.cuda.empty_cache()
        p0, p1 = r["plain"], r["mesh"]
        if not all(math.isfinite(float(x[k])) for x in p1["metrics"]
                   for k in ("loss", "grad_norm")):
            fail(f"mesh: (a‴) {arch}: metrics {p1['metrics']}")
        remat = cfg.remat if cfg.family in ("dense", "moe", "vlm") else "none, as the reference"
        log(f"[mesh] (a‴) {arch} {cfg.dtype} at full width, {n_layers} of {base.n_layers} layers "
            f"({cfg.param_count()} parameters per pod), remat {remat}, {m['pods']} pods, "
            f"X_STCC Δ = {m['delta']} {m['compress']}, batch {gb} x {seq}: local step "
            f"{p1['walls'][0]:.6f} s meshed against {p0['walls'][0]:.6f} s plain, sync step "
            f"{p1['walls'][1]:.6f} s against {p0['walls'][1]:.6f} s; peak {p1['peak']} B "
            f"meshed ({p1['peak'] / 2**30:.2f} GiB), {p0['peak']} B plain "
            f"({p0['peak'] / 2**30:.2f} GiB); losses {[float(x['loss']) for x in p1['metrics']]}"
            f", grad norms {[float(x['grad_norm']) for x in p1['metrics']]}: equal bit for bit "
            f"(metrics, {r['tensors']} tensors of parameters, moments and anchor, clocks, "
            f"DUOT, counters); launches per run {r['launches']}; "
            f"{time.perf_counter() - t_arch:.1f} s; {dev['smi']}")
    log(f"[time] mesh (a‴) the five families' training: {time.perf_counter() - t_all:.1f} s")


def _mesh_use_devices(dev: dict) -> None:
    """(g) ``run_protocol_sharded`` with ``use_devices=True`` under a
    one-rank {"shard": 1} NCCL mesh against ``use_devices=False``,
    exactly: one rank is fewer than the shards, so the replay takes the
    sequential branch (``replay.shard_group`` is ``None``), as the
    reference does with fewer devices than shards."""
    import numpy as np
    import torch

    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.engine import EngineConfig, replay
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding
    from repro_torch.storage.simulator import run_protocol_sharded
    from repro_torch.storage.ycsb import WORKLOAD_A
    from torch_mesh_cases import flatten

    g = MESH_DEVICES
    level = ConsistencyLevel[g["level"]]
    kw = dict(n_shards=g["n_shards"], n_ops=g["n_ops"], audit=True, device="cuda")
    t0 = time.perf_counter()
    base = run_protocol_sharded(level, WORKLOAD_A, use_devices=False, **kw)
    shard_mesh = make_mesh((1,), ("shard",))
    with sharding.use_mesh(shard_mesh):
        group = replay.shard_group(EngineConfig(level, n_shards=g["n_shards"],
                                                use_devices=True))
        got = run_protocol_sharded(level, WORKLOAD_A, use_devices=True, **kw)
    torch.cuda.synchronize()
    flat_base, flat_got = {}, {}
    flatten("r", base, flat_base)
    flatten("r", got, flat_got)
    bad = [k for k in flat_base if k not in flat_got
           or not np.array_equal(np.asarray(flat_base[k]), np.asarray(flat_got[k]))]
    if group is not None or bad or sorted(flat_base) != sorted(flat_got):
        fail(f"mesh: (g) use_devices on one rank != use_devices=False: {bad[:8]}, "
             f"group {group}")
    log(f"[mesh] (g) run_protocol_sharded {g['level']} {g['n_shards']} shards, "
        f"{g['n_ops']} ops, use_devices=True under {shard_mesh}: 1 rank < {g['n_shards']} "
        f"shards, so the sequential branch (shard_group None); result equal to "
        f"use_devices=False in all {len(flat_base)} fields (staleness "
        f"{got['staleness_rate']}, severity {got['severity']}); "
        f"{time.perf_counter() - t0:.1f} s")


def phase_mesh(dev: dict) -> dict:
    """(a) A (1, 1) mesh over an NCCL process group of one rank:
    gemma-2b's placements all replicated, and reduced qwen2-7b's
    ``sync_step`` under the mesh equal to the same steps without it, bit
    for bit, its kernels launched as predicted, then (a') on the state
    placed on the mesh (DTensors), bit for bit, (a'') gemma-2b's training
    at full width on DTensors against plain tensors
    (:func:`_mesh_train_full`), (a‴) the other five families' training
    likewise (:func:`_mesh_train_families`) and (g) ``use_devices`` on one
    rank
    (:func:`_mesh_use_devices`); (b) the dry run of the
    train phase's gemma-2b setting on that mesh against the train phase's
    measured peak (``TRAIN_MEASURED``): predicted state <= measured peak;
    (c) gemma-2b at full width in f32 decoding with
    ``decode_comm="lse_shardmap"`` on that mesh (its ``pmax`` / ``psum``
    NCCL all-reduces) against the plain decode; (d) the collective regions
    at 16 shards on the card, under a ``MeshShape``
    (:func:`_mesh_regions_stacked`); (e) gemma-2b served as SPMD with
    DTensor parameters on the NCCL mesh (:func:`_mesh_spmd`), then the
    other five families (:func:`_mesh_families`).  Returns B.8's launches
    in (e)'s counted meshed forwards."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.cost_model import PAPER_PRICING
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import abstract_params, build_model, sharding
    from repro_torch.tree import items, leaves
    from torch_port_helpers import (MESH_STEP_CASE, mesh_step_launches, mesh_step_mismatches,
                                    mesh_sync_steps, port_trainer, train_case_id)

    if not TRAIN_MEASURED:
        fail("the mesh phase holds its dry run against the train phase's gemma-2b run: "
             "run the train phase before it")
    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = get_config(TRAIN_FULL["arch"])
        with sharding.use_mesh(mesh):
            placed = sharding.param_placements(abstract_params(build_model(cfg)), cfg)
        sharded = [p for p, pl in items(placed) if not all(isinstance(x, Replicate) for x in pl)]
        if sharded:
            fail(f"mesh: on a (1, 1) mesh {cfg.name}'s leaves {sharded[:8]} are not replicated")
        # (a) the sync steps under the mesh and without it.
        params = port_trainer(MESH_STEP_CASE, "cpu").model.init(0, device="cpu")
        t0 = time.perf_counter()
        plain = mesh_sync_steps(cuda, params)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        on_mesh = mesh_sync_steps(cuda, params, mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts, want = ops.launch_counts(), mesh_step_launches()
        bad = mesh_step_mismatches(plain, on_mesh)
        if bad:
            fail(f"mesh: sync_step under the (1, 1) mesh != without it: {bad[:8]}")
        if any(counts[k] != n for k, n in want.items()):
            fail(f"mesh: launches {counts}, predicted {want}")
        # (a') the same steps on the state placed on the mesh (DTensors).
        ops.reset_launch_counts()
        t3 = time.perf_counter()
        on_dtensors = mesh_sync_steps(cuda, params, mesh, placed=True)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        counts_p = ops.launch_counts()
        bad = mesh_step_mismatches(plain, on_dtensors)
        if bad or not all(map(sharding.is_dtensor, leaves(on_dtensors[1].params))):
            fail(f"mesh: sync_step on the DTensor state != the plain steps: {bad[:8]}")
        if any(counts_p[k] != n for k, n in want.items()):
            fail(f"mesh: (a') launches {counts_p}, predicted {want}")
        log(f"[mesh] (a') reduced qwen2-7b {train_case_id(MESH_STEP_CASE)}, sync_step x "
            f"{MESH_STEP_CASE[2]} on the DTensor state (init_state under the mesh): "
            f"{t4 - t3:.3f} s, plain {t1 - t0:.3f} s; equal bit for bit to the plain steps "
            f"(losses, grad norms, parameters, moments, clocks, DUOT, counters); launches "
            f"{ {k: counts_p[k] for k in want} } (predicted {want})")
        del on_dtensors
        _mesh_train_full(mesh, dev)
        _mesh_train_families(mesh, dev)
        _mesh_use_devices(dev)
        steps, state = on_mesh
        log(f"[mesh] {mesh}: {len(list(items(placed)))} leaves of {cfg.name} all replicated; "
            f"reduced qwen2-7b {train_case_id(MESH_STEP_CASE)}, sync_step x "
            f"{MESH_STEP_CASE[2]}: under the mesh {t2 - t1:.3f} s, without {t1 - t0:.3f} s; "
            f"losses {[float(m['loss']) for m in steps]}, merges {int(state.sync.merges)}, "
            f"violations {int(state.sync.violations)}, severity {float(state.sync.severity)}, "
            f"inter_pod_gb {float(state.sync.inter_pod_gb)}: equal bit for bit (losses, "
            f"parameters, clocks, DUOT, counters); launches "
            f"{ {k: counts[k] for k in want} } (predicted {want})")
        # (b) the dry run of the train phase's setting against its measurement.
        f = TRAIN_FULL
        shape = ShapeSpec(f"train_{f['global_batch']}x{f['seq']}", f["seq"],
                          f["global_batch"], "train")
        t0 = time.perf_counter()
        res = dry_run(cfg, shape, mesh, pods=f["pods"], pricing=PAPER_PRICING,
                      program="local", policy="X_STCC", delta=f["delta"],
                      compress=f["compress"])
        t_dry = time.perf_counter() - t0
        # (c) gemma-2b's LSE decode on the NCCL mesh against the plain decode.
        r = MESH_REGIONS
        gcfg = dataclasses.replace(get_config(r["arch"]), dtype="float32")
        gparams = build_model(gcfg).init(0, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(5)
        toks = torch.randint(0, gcfg.vocab_size, (1, r["prompt"] + r["steps"]), generator=g,
                             device=cuda, dtype=torch.int32)
        xla, _ = _mesh_decode(build_model(gcfg), gparams, toks, None)
        t0 = time.perf_counter()
        nccl, calls = _mesh_decode(
            build_model(dataclasses.replace(gcfg, decode_comm="lse_shardmap")), gparams,
            toks, mesh)
        torch.cuda.synchronize()
        t_nccl = time.perf_counter() - t0
        # (e) the dense transformer, then every other family, served as SPMD
        # on the mesh.
        launches = _mesh_spmd(mesh, (gcfg, gparams, toks), dev)
        t0 = time.perf_counter()
        launches += _mesh_families(mesh, dev)
        log(f"[mesh] (e) the five families {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    mem, roof = res["memory"], res["roofline"]
    predicted, peak = mem["used_bytes_per_device"], TRAIN_MEASURED["peak"]
    local_s = TRAIN_MEASURED["local_s"]
    achieved = res["flops"] / local_s
    log(f"[mesh] dry run of {cfg.name} as the train phase runs it ({f['pods']} pods on the "
        f"(1, 1) mesh, X_STCC Δ = {f['delta']} {f['compress']}, batch {f['global_batch']} x "
        f"{f['seq']}, remat {cfg.remat}; {t_dry:.1f} s on the meta device): predicted state "
        f"{predicted} B ({predicted / 2**30:.2f} GiB: parameters "
        f"{mem['params_bytes'] / 2**30:.2f}, one pod's gradients "
        f"{mem['grads_bytes'] / 2**30:.2f}, AdamW moments {mem['opt_bytes'] / 2**30:.2f}, "
        f"int8 anchor {mem['sync_bytes'] / 2**30:.2f}, batch {mem['batch_bytes']} B), "
        f"measured peak {peak} B ({peak / 2**30:.2f} GiB); step FLOPs {res['flops']:.6e} "
        f"(both pods' local step), measured local step {local_s:.6f} s: "
        f"{achieved / 1e12:.1f} TFLOP/s, {achieved / res['rates']['peak_flops']:.4f} of the "
        f"{res['rates']['peak_flops'] / 1e12:.0f} TFLOP/s bf16 peak (not gated); roofline step "
        f"{roof['step_time_s']:.6f} s ({roof['dominant']}-bound: compute "
        f"{roof['compute_s']:.6f} s, memory {roof['memory_s']:.6f} s at the unfused byte "
        f"count {roof['bytes_per_device']:.6e}); {dev['smi']}")
    if predicted > peak:
        fail(f"mesh: the dry run predicts {predicted} B of state per device, more than the "
             f"train phase's measured peak {peak} B")
    err = float((nccl - xla).abs().max())
    if calls != {"ring": 0, "lse": gcfg.n_layers * r["steps"]} or not torch.allclose(
            nccl, xla, atol=1e-3, rtol=1e-3):
        fail(f"mesh: the LSE decode on the NCCL mesh vs the plain decode: max abs err {err}, "
             f"regions {calls}")
    log(f"[mesh] (c) {gcfg.name} f32 ({gcfg.param_count()} parameters) LSE decode on the "
        f"(1, 1) NCCL mesh, {r['steps']} steps after a {r['prompt']}-token prompt: "
        f"{calls['lse']} regions, each a pmax and two psums as NCCL all-reduces over one "
        f"rank; logits within atol = rtol = 1e-3 of the plain decode (max abs err {err}); "
        f"{t_nccl:.3f} s")
    _mesh_regions_stacked((gcfg, gparams, toks), dev, xla)
    del gparams
    torch.cuda.empty_cache()
    log(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention": launches}


# -- phase 10d ----------------------------------------------------------------

# The families phase: the MoE, VLM, hybrid, SSM and audio families at full
# width and depth, bf16, random weights from the port's initializer, B = 1.
FAMILIES = dict(archs=("olmoe-1b-7b", "internvl2-2b", "zamba2-1.2b", "rwkv6-3b",
                       "whisper-large-v3"),
                seq=2048, whisper_seq=448, prompt=128, tokens=8, replicas=2,
                f32_layers=2, f32_seq=512)
FAMILIES_CUTS = ("cuts of scale: none in width or depth for (a) and (b) (each "
                 "configuration's published layers and widths, batch 1; whisper's "
                 "decoder at its 448 positions over its 1500 frames); (d) runs 2 "
                 "layers (zamba2: one group of 6, one shared site) in f32 at S = 512 "
                 "(whisper 448); llama4-maverick (~400 B parameters, more than one "
                 "H100 holds) runs only reduced, in (c)")
# B.8 at each family's causal self-attention shape, bf16:
# (b, h, hkv, s, hd, causal, window, dtype).
FAMILY_FA_CASES = {
    "olmoe-1b-7b": (1, 16, 16, 2048, 128, True, 0, "bfloat16"),
    "internvl2-2b": (1, 16, 8, 2048, 128, True, 0, "bfloat16"),
    "zamba2-1.2b": (1, 32, 32, 2048, 64, True, 0, "bfloat16"),
    "whisper-large-v3": (1, 20, 20, 448, 64, True, 0, "bfloat16"),
}


def _family_full(arch: str, dev) -> int:
    """(a) and (b) for one configuration at full width; returns B.8's
    launches in its counted ``forward``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ServeSession, ServingEngine
    from torch_port_helpers import causal_attention_layers, family_inputs, torch_batch

    cfg = get_config(arch)
    s = FAMILIES["whisper_seq"] if cfg.is_encdec else FAMILIES["seq"]
    want = causal_attention_layers(cfg)
    flash = build_model(dataclasses.replace(cfg, use_flash_kernel=True))
    plain = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = [flash.init(r, device=dev) for r in range(FAMILIES["replicas"])]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = torch_batch(family_inputs(cfg, 1, s, 7), dev, dtype=torch.bfloat16)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.inference_mode():
        ops.reset_launch_counts()
        (lg_flash, _), first_s = wall(lambda: flash.forward(params[0], batch))
        counts = ops.launch_counts()
        if counts["flash_attention"] != want or sum(counts.values()) != want:
            fail(f"families {arch}: forward launched {counts}, want {want} flash_attention")
        (lg_flash, _), flash_s = wall(lambda: flash.forward(params[0], batch))
        plain.forward(params[0], batch)
        (lg_plain, _), plain_s = wall(lambda: plain.forward(params[0], batch))
        if lg_flash.shape != (1, s, cfg.vocab_size) or not torch.isfinite(lg_flash).all():
            fail(f"families {arch}: bf16 logits {tuple(lg_flash.shape)} not finite or "
                 "misshapen")
        diff = float((lg_flash.float() - lg_plain.float()).abs().max())
        scale = float(lg_plain.float().abs().max())
        del lg_flash, lg_plain
        log(f"[families] {arch}: {cfg.param_count()} parameters; forward bf16 B=1 S={s}: "
            f"B.8 {flash_s:.4f} s (first {first_s:.4f}), plain attention {plain_s:.4f} s; "
            f"max |logit diff| {diff} (max |logit| {scale}); init of "
            f"{FAMILIES['replicas']} param sets {init_s:.3f} s; launches {counts}")

        # (b) serving: 2 replicas, one request per replica's session.
        eng = ServingEngine(flash, device=dev)
        for r, p in enumerate(params):
            eng.publish(p, version=r + 1)
        prompt = FAMILIES["prompt"] + cfg.n_vis_tokens
        max_seq = prompt + FAMILIES["tokens"]
        reqs = []
        for i in range(FAMILIES["replicas"]):
            inp = family_inputs(cfg, 1, prompt, 200 + i)
            del inp["labels"]
            reqs.append({**torch_batch(inp, dev, dtype=torch.bfloat16), "max_seq": max_seq})
        ops.reset_launch_counts()
        outs, serve_s = wall(lambda: [eng.generate(ServeSession(i), req, FAMILIES["tokens"])
                                      for i, req in enumerate(reqs)])
        for toks, _ in outs:
            if toks.shape != (1, FAMILIES["tokens"]) or not bool(
                    ((toks >= 0) & (toks < cfg.vocab_size)).all()):
                fail(f"families {arch} serving: bad tokens {toks.tolist()}")
        n_tok = FAMILIES["replicas"] * FAMILIES["tokens"]
        log(f"[families] {arch}: ServingEngine X_STCC, {FAMILIES['replicas']} replicas, "
            f"{len(reqs)} requests x prompt {prompt} ({cfg.n_vis_tokens} image positions) "
            f"+ {FAMILIES['tokens']} tokens: {serve_s:.3f} s ({n_tok / serve_s:.1f} "
            f"tokens/s); replicas {[int(r) for _, r in outs]}; launches "
            f"{ops.launch_counts()}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B")
    del params, eng, outs, batch, reqs
    torch.cuda.empty_cache()
    return want


def phase_families() -> tuple[dict, dict]:
    """B.8 at each family's attention shape; (a) + (b) for the five
    configurations at full width (``_family_full``); (c) the six reduced
    configurations on the card against the CPU; (d) B.8 against the plain
    attention in f32 at full width.  Returns ``(timings, launches)``; the
    launches are B.8's in (a)'s counted forwards, this slice's main path."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from torch_port_helpers import (FAMILY_ARCHS, FAMILY_TOL, causal_attention_layers,
                                    family_inputs, family_mismatches, family_outputs,
                                    family_serving, torch_batch, tree_to)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    log(f"[families] {FAMILIES_CUTS}")

    timings = {}
    for arch, case in FAMILY_FA_CASES.items():
        t = time_flash(case, dev)
        timings[f"flash_attention@{arch}"] = t
        log(f"[families] flash_attention {case} ({arch}): kernel {t['ms']:.6f} ms, plain "
            f"{t['plain_ms']:.6f} ms, SDPA {t['library_ms']:.6f} ms, bound "
            f"{t['bound'][0]:.6f} ms ({t['bound'][1]}; {t['bytes']} B, {t['flop']} FLOP), "
            f"max_abs_err {t['err']}")
    torch.cuda.empty_cache()

    # (a) + (b): the counts are set to 0 before each counted forward and read
    # after it; the phase's launches are their sum.
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for arch in FAMILIES["archs"]:
        t0 = time.perf_counter()
        n = _family_full(arch, dev)
        launches["flash_attention"] += n
        if arch in FAMILY_FA_CASES:
            timings[f"flash_attention@{arch}"]["launches"] = n
        log(f"[time] families {arch}: {time.perf_counter() - t0:.1f} s")

    # (c) the six configurations reduced, in f32: card against CPU.
    t0 = time.perf_counter()
    errs = {}
    for arch in FAMILY_ARCHS:
        cfg = reduced(get_config(arch))
        card = build_model(dataclasses.replace(cfg, use_flash_kernel=True))
        cpu = build_model(cfg)
        params = [cpu.init(seed, device="cpu") for seed in (0, 1)]
        with torch.inference_mode():
            got = family_outputs(card, tree_to(params[0], dev), cfg, dev)
            want = family_outputs(cpu, params[0], cfg, "cpu")
            bad = family_mismatches(got, want)
            served = family_serving(card, params, cfg, dev)
            served_cpu = family_serving(cpu, params, cfg, "cpu")
        if bad or served != served_cpu:
            fail(f"families {arch} reduced: card != cpu: {bad}; served {served} vs "
                 f"{served_cpu}")
        errs[arch] = max(float((got[k] - want[k]).abs().max()) for k in want)
    log(f"[families] (c) reduced f32, card == CPU (logits within atol = rtol {FAMILY_TOL}, "
        f"served tokens and routing exact): max abs err {errs} "
        f"({time.perf_counter() - t0:.1f} s)")

    # (d) B.8 against the plain attention in f32 at full width.
    t0 = time.perf_counter()
    for arch, case in FAMILY_FA_CASES.items():
        base = get_config(arch)
        over = dict(dtype="float32", n_layers=base.attn_every or FAMILIES["f32_layers"])
        if base.is_encdec:
            over["n_encoder_layers"] = FAMILIES["f32_layers"]
        cfg = dataclasses.replace(base, **over)
        s = FAMILIES["whisper_seq"] if cfg.is_encdec else FAMILIES["f32_seq"]
        plain = build_model(cfg)
        params = plain.init(0, device=dev)
        batch = torch_batch(family_inputs(cfg, 1, s, 9), dev)
        with torch.inference_mode():
            ops.reset_launch_counts()
            got, _ = build_model(dataclasses.replace(cfg, use_flash_kernel=True)).forward(
                params, batch)
            n = ops.launch_counts()["flash_attention"]
            want, _ = plain.forward(params, batch)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if n != causal_attention_layers(cfg) or not torch.allclose(got, want, atol=1e-3,
                                                                   rtol=1e-3):
            fail(f"families {arch}: f32 forward S={s} B.8 vs plain attention: max abs err "
                 f"{err}, launches {n}")
        log(f"[families] (d) {arch} f32, {cfg.n_layers} layers, S={s}: logits within atol = "
            f"rtol = 1e-3 of the plain attention (max abs err {err}); {n} launches")
        del params, got, want
        torch.cuda.empty_cache()
    log(f"[families] (d) {time.perf_counter() - t0:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return timings, launches


# -- phase 11 -----------------------------------------------------------------


def phase_scale() -> dict:
    import torch

    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.engine import results as engine_results
    from repro_torch.engine.config import EngineConfig
    from repro_torch.engine.replay import EpochEngine
    from repro_torch.kernels import ops
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import WORKLOAD_A

    log(f"[scale] X_STCC WORKLOAD_A {SCALE}")
    log(f"[scale] {SCALE_CUTS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # run_protocol's three steps, written out to keep the final state for
    # admit_batch below.
    config = EngineConfig(ConsistencyLevel.X_STCC, **SCALE)
    prep = EpochEngine(config, device="cuda").replay(WORKLOAD_A)
    out = engine_results.assemble(config, prep, WORKLOAD_A)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for k in ("staleness_rate", "violation_rate", "severity"):
        if not (math.isfinite(out[k]) and 0.0 <= out[k] <= 1.0):
            fail(f"scale run: {k} = {out[k]} is not a rate")
    if out["n_reads"] <= 0:
        fail("scale run served no reads")
    if any(launches[k] == 0 for k, ph in LAUNCH_PHASE.items() if ph == "main"):
        fail(f"scale run never launched a kernel: {launches}")
    log(f"[scale] wall {wall:.3f} s (stream, schedule, replay, audit); "
        f"{SCALE['n_ops'] / wall:.1f} ops/s; staleness {out['staleness_rate']}; "
        f"violation {out['violation_rate']}; severity {out['severity']}; "
        f"n_reads {out['n_reads']}; dropped_writes {out['dropped_writes']}; "
        f"max_memory_allocated {peak} B; launches {launches}")
    del out
    timed("scale admit", scale_admit, prep)
    timings = timed("scale audit", scale_audit, prep)
    del prep
    torch.cuda.empty_cache()

    # The same deployment through the fault path.
    fault = dict(SCALE, n_ops=FAULT_SCALE_OPS)
    kw = fault_kwargs(fault["n_ops"], fault["batch_size"])
    log(f"[scale] fault run: X_STCC WORKLOAD_A {fault}, schedule_unit "
        f"{kw['schedule_unit']}, replica 1 down for schedule epochs "
        f"[{kw['schedule'].n_epochs // 5}, {3 * kw['schedule'].n_epochs // 5}) of "
        f"{kw['schedule'].n_epochs}, {kw['gossip']}, {kw['recovery']}, {kw['obs']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = sim.run_protocol_faulty(ConsistencyLevel.X_STCC, WORKLOAD_A, device="cuda",
                                  **fault, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for k in ("staleness_rate", "violation_rate", "severity"):
        if not (math.isfinite(out[k]) and 0.0 <= out[k] <= 1.0):
            fail(f"scale fault run: {k} = {out[k]} is not a rate")
    if out["n_reads"] <= 0 or out["dropped_writes"] != 0:
        fail(f"scale fault run: n_reads {out['n_reads']}, dropped_writes "
             f"{out['dropped_writes']}")
    missing = [k for k in FAULT_KERNELS if launches[k] == 0]
    if missing:
        fail(f"scale fault run never launched kernels {missing}")
    g, r = out["gossip"], out["recovery"]
    log(f"[scale] fault run wall {wall:.3f} s; {fault['n_ops'] / wall:.1f} ops/s; "
        f"staleness {out['staleness_rate']}; violation {out['violation_rate']}; "
        f"severity {out['severity']}; n_reads {out['n_reads']}; failovers "
        f"{out['failovers']}; anti_entropy_events {out['anti_entropy_events']}; "
        f"propagation_events {out['propagation_events']}; gossip rounds "
        f"{g['rounds']}, pairs {g['pairs_exchanged']}, ranges_diffed "
        f"{g['ranges_diffed']}, repair_events {g['repair_events']}, gap_repaired "
        f"{g['gap_repaired']}; hints {g['hints']}; wal_records {r['wal_records']}; "
        f"snapshot_cells {r['snapshot_cells']}; obs p50/p99 age "
        f"{out['obs']['metrics']['staleness_age']['p50']}/"
        f"{out['obs']['metrics']['staleness_age']['p99']}; max_memory_allocated "
        f"{peak} B; launches {launches}")
    del out
    torch.cuda.empty_cache()
    timed("scale planner", scale_planner)
    timed("scale geo", scale_geo)
    torch.cuda.empty_cache()
    timed("scale adaptive", scale_adaptive)
    timed("scale controller", scale_fleet_controller)
    torch.cuda.empty_cache()
    timed("scale serving", scale_serving)
    torch.cuda.empty_cache()
    timed("scale sharded", scale_sharded)
    torch.cuda.empty_cache()
    timed("scale crash", scale_crash)
    return timings


def scale_crash() -> None:
    """The paper's deployment through the crash path: replica 1 crashes
    and rejoins (WAL + snapshots, gossip, obs); ``check_invariants`` on the
    result; the crash-stripped twin; and, after a quiescent anti-entropy
    tail, the rebuilt fleet equal to the twin's bit for bit."""
    import numpy as np
    import torch

    from repro_torch.chaos import check_invariants
    from repro_torch.chaos.harness import _fleet_signature, _quiesce
    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.kernels import ops
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import WORKLOAD_A

    x = ConsistencyLevel.X_STCC
    crash = dict(SCALE, n_ops=CRASH_SCALE_OPS)
    kw = crash_kwargs(crash["n_ops"], crash["batch_size"])
    t = kw["schedule"].n_epochs
    log(f"[scale] crash run: X_STCC WORKLOAD_A {crash}, schedule_unit "
        f"{kw['schedule_unit']}, replica 1 crashes at schedule epoch {t // 5} of {t} "
        f"and rejoins at {3 * t // 5}, {kw['gossip']}, {kw['recovery']}, {kw['obs']}")
    log(f"[scale] {CRASH_SCALE_CUTS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = sim.run_protocol_faulty(x, WORKLOAD_A, device="cuda", _return_state=True,
                                  **crash, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    breaches = check_invariants(out, x, crashed=True)
    if breaches:
        fail(f"scale crash run: invariants {breaches}")
    if out["n_reads"] <= 0 or out["dropped_writes"] != 0:
        fail(f"scale crash run: n_reads {out['n_reads']}, dropped_writes "
             f"{out['dropped_writes']}")
    missing = [k for k in RECOVERY_KERNELS if launches[k] == 0]
    if missing:
        fail(f"scale crash run never launched kernels {missing}")
    log(f"[scale] crash run wall {wall:.3f} s; {crash['n_ops'] / wall:.1f} ops/s; "
        f"staleness {out['staleness_rate']}; violation {out['violation_rate']}; "
        f"severity {out['severity']}; n_reads {out['n_reads']}; crash_epochs "
        f"{out['crash_epochs']}; {_recovery_line(out['recovery'])}; invariants hold; "
        f"max_memory_allocated {peak} B; launches {launches}")
    sig = _fleet_signature(_quiesce(out.pop("_store"), out.pop("_state")))
    del out
    torch.cuda.empty_cache()
    twin_kw = dict(kw, schedule=kw["schedule"].strip_crashes(), obs=None)
    t0 = time.perf_counter()
    twin = sim.run_protocol_faulty(x, WORKLOAD_A, device="cuda", _return_state=True,
                                   **crash, **twin_kw)
    torch.cuda.synchronize()
    twin_wall = time.perf_counter() - t0
    twin_sig = _fleet_signature(_quiesce(twin.pop("_store"), twin.pop("_state")))
    diverged = [k for k in sig if not np.array_equal(sig[k], twin_sig[k])]
    if diverged:
        fail(f"scale crash run: the rebuilt fleet differs from its twin in {diverged}")
    log(f"[scale] crash-stripped twin wall {twin_wall:.3f} s; after the quiescent "
        f"tail the rebuilt fleet equals the twin's (replica_version, replica_vc, "
        f"global_version)")


def scale_sharded() -> None:
    """The paper's deployment as ``SHARDED_SCALE_SHARDS`` tenant shards,
    and each shard's counts against the unsharded run of that shard
    (seed ``s``): the reference's own per-shard identity."""
    import torch

    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.engine import results as engine_results
    from repro_torch.engine.config import EngineConfig
    from repro_torch.engine.replay import EpochEngine
    from repro_torch.kernels import ops
    from repro_torch.storage.ycsb import WORKLOAD_A

    n = SHARDED_SCALE_SHARDS
    scale = dict(SCALE, n_ops=SHARDED_SCALE_OPS)
    config = EngineConfig(ConsistencyLevel.X_STCC, **scale, n_shards=n, audit=False)
    log(f"[scale] sharded: X_STCC WORKLOAD_A {scale}, {n} shards of "
        f"{config.shard_clients} clients, {config.shard_resources} rows, "
        f"{config.shard_ops} ops; ops cut to {SHARDED_SCALE_OPS} of {SCALE['n_ops']} "
        "(SHARDED_SCALE_OPS)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    prep = EpochEngine(config, device="cuda").replay(WORKLOAD_A)
    out = engine_results.assemble(config, prep, WORKLOAD_A)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del prep
    for k in ("staleness_rate", "violation_rate"):
        if not (math.isfinite(out[k]) and 0.0 <= out[k] <= 1.0):
            fail(f"sharded scale run: {k} = {out[k]} is not a rate")
    if out["n_reads"] <= 0 or launches["op_ingest"] == 0 or launches["vclock_chain"] == 0:
        fail(f"sharded scale run: n_reads {out['n_reads']}, launches {launches}")
    log(f"[scale] sharded wall {wall:.3f} s; {scale['n_ops'] / wall:.1f} ops/s; "
        f"staleness {out['staleness_rate']}; violation {out['violation_rate']}; "
        f"n_reads {out['n_reads']}; dropped_writes {out['dropped_writes']}; per_shard "
        f"{out['per_shard']}; max_memory_allocated {peak} B; launches {launches}")
    torch.cuda.empty_cache()
    for s in range(n):
        one = EngineConfig(ConsistencyLevel.X_STCC, n_clients=config.shard_clients,
                           n_resources=config.shard_resources, n_ops=config.shard_ops,
                           batch_size=SCALE["batch_size"], duot_cap=SCALE["duot_cap"],
                           seed=s, audit=False)
        t0 = time.perf_counter()
        single = EpochEngine(one, device="cuda").replay(WORKLOAD_A)["out"]
        counts = {k: int(single[k]) for k in ("stale", "viol", "reads")}
        t_one = time.perf_counter() - t0
        shard = {k: out["per_shard"][k][s] for k in counts}
        if shard != counts:
            fail(f"sharded scale run: shard {s} {shard} != its unsharded run {counts}")
        log(f"[scale] shard {s}: {shard} equal to its unsharded run ({t_one:.3f} s)")
        del single
        torch.cuda.empty_cache()


def scale_audit(prep: dict) -> dict:
    """B.2 on the flat scale run's own DUOT (its first 16,384 ops, 64
    clients), every design against the plain version and timed; then the
    split of ``store.audit`` between the kernel and the rest
    (``core/audit._assemble_result``'s dense passes over the codes)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import vclock_audit as va

    store, st = prep["store"], prep["out"]["st"]
    duot, delta = st.duot, store.delta or 0
    kw = dict(vc=duot.vc, client=duot.client, kind=duot.kind, resource=duot.resource,
              version=duot.version, seq=duot.seq, valid=duot.valid)
    t = time_audit(kw, delta, 5, "the flat scale run's DUOT")
    kernel = cuda_time_ms(lambda: ops.audit_duot(duot, delta=delta), 5)
    # A probe of tiles grouped by resource: the same entries sorted by
    # (resource, seq), so the hot key's base pairs fill whole tiles and
    # the other tiles hold almost none.  The codes are the DUOT's,
    # permuted (checked); the kernel alone is timed, the permutation not.
    order = torch.argsort(duot.seq, stable=True)
    order = order[torch.argsort(duot.resource[order], stable=True)]
    grouped = {k: v[order].contiguous() for k, v in kw.items()}
    want = ops.audit_duot(duot, delta=delta)[order][:, order]
    grouped_ms = {}
    for design in va.DESIGNS:
        require_equal(f"vclock_audit on the DUOT sorted by resource, design={design}",
                      [va.vclock_audit_cuda(**grouped, delta=delta, design=design)],
                      [want])
        grouped_ms[design] = cuda_time_ms(
            lambda: va.vclock_audit_cuda(**grouped, delta=delta, design=design), 5)
    del want, grouped
    log(f"[scale] probe: the DUOT sorted by (resource, seq): auto "
        f"{grouped_ms['auto']:.6f} ms, dense {grouped_ms['dense']:.6f}, compact "
        f"{grouped_ms['compact']:.6f} (unsorted: auto {t['ms']:.6f}); codes equal "
        f"to the DUOT's, permuted")
    whole = cuda_time_ms(lambda: store.audit(st, delta=delta), 3, warmup=1)
    log(f"[scale] store.audit at M = {duot.capacity}: {whole:.6f} ms, of which the "
        f"kernel {kernel:.6f} ms and the code decode + _assemble_result "
        f"{whole - kernel:.6f} ms (CUDA events)")
    torch.cuda.empty_cache()
    return {"vclock_audit@16384/scale_duot": dict(t, store_audit_ms=whole,
                                                  grouped_probe_ms=grouped_ms)}


def scale_admit(prep: dict) -> None:
    """``admit_batch`` on the flat scale run's final state (64 clients x
    5,000,000 rows): its first ``ADMIT_BATCHES`` 4096-op batches, chained,
    through the kernel and through the plain version, equal in served
    versions, admissibility and the whole state."""
    import torch

    from repro_torch.kernels import ops

    store, st = prep["store"], prep["out"]["st"]
    batched = prep["batched"][0]
    batches = [{"client": batched["client"][t],
                "replica": batched["home"][t],
                "resource": batched["resource"][t]}
               for t in range(ADMIT_BATCHES)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    walls = {}
    states = {}
    for impl in ("auto", "torch"):
        ops.reset_launch_counts()
        s, outs = st, []
        start.record()
        for kw in batches:
            s, served, adm, floor = store.admit_batch(s, impl=impl, **kw)
            outs.append((served, adm, floor))
        end.record()
        torch.cuda.synchronize()
        walls[impl] = start.elapsed_time(end) / ADMIT_BATCHES
        states[impl] = (s, outs, ops.launch_counts()["session_floor"])
    (sk, ok, nk), (sp, op, npl) = states["auto"], states["torch"]
    if nk != ADMIT_BATCHES or npl != 0:
        fail(f"scale admit_batch: {nk} kernel launches, {npl} for the plain run")
    for t, (k, p) in enumerate(zip(ok, op)):
        if not all(torch.equal(a, b) for a, b in zip(k, p)):
            fail(f"scale admit_batch: batch {t} differs between kernel and plain")
    diff = _store_diff(sk, sp)
    if diff:
        fail(f"scale admit_batch: state differs in {diff}")
    adm = sum(int(b.sum()) for _, b, _ in ok)
    raised = int((sk.cluster.read_floor != st.cluster.read_floor).sum())
    log(f"[scale] admit_batch on the flat run's final state (C={store.n_clients}, "
        f"R={store.n_resources}), {ADMIT_BATCHES} batches of "
        f"{batches[0]['client'].shape[0]} ops: kernel {walls['auto']:.6f} ms, plain "
        f"{walls['torch']:.6f} ms per batch (CUDA events); {adm} of "
        f"{ADMIT_BATCHES * batches[0]['client'].shape[0]} admissible, {raised} "
        "floors raised; served, admissible and state equal to the plain version")


def scale_serving() -> None:
    """Serving at scale: the schedule at 16,384 sessions on the 12-replica
    fleet and the router at 16 shards x 4,096 sessions, each through the
    kernels and through the plain versions on the card, equal in every
    field."""
    import torch

    from repro_torch.kernels import ops
    from torch_port_helpers import serving_counters

    log(f"[scale] serving: ServingEngine {SERVING_SCALE} on the 12-replica fleet; "
        f"router {ROUTER_SCALE}")
    log(f"[scale] {SERVING_SCALE_CUTS}")
    # Every clock chain the kernel run makes: (B, C, P, design).
    from repro_torch.kernels import vclock_chain as vch

    chain_calls = []
    launch_chain = vch.vclock_chain_cuda

    def recorded_chain(client, replica, is_write, session_vc, replica_vc, **kw):
        b, c, p = client.shape[0], session_vc.shape[0], replica_vc.shape[0]
        chain_calls.append((b, c, p, kw.get("design") or vch.design_for(b, c, p)))
        return launch_chain(client, replica, is_write, session_vc, replica_vc, **kw)

    runs = {}
    for impl in ("auto", "torch"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        vch.vclock_chain_cuda = recorded_chain
        t0 = time.perf_counter()
        try:
            eng, api, slog = run_serving("cuda", impl=impl, **SERVING_SCALE)
            torch.cuda.synchronize()
        finally:
            vch.vclock_chain_cuda = launch_chain
        runs[impl] = dict(eng=eng, api=api, log=slog, wall=time.perf_counter() - t0,
                          peak=torch.cuda.max_memory_allocated(),
                          launches=ops.launch_counts())
    by_shape = {}
    for call in chain_calls:
        by_shape[call] = by_shape.get(call, 0) + 1
    log(f"[scale] serving engine: {len(chain_calls)} clock chains, by (B, C, P, design): "
        + ", ".join(f"{k} x {n}" for k, n in sorted(by_shape.items())))
    k, p = runs["auto"], runs["torch"]
    if k["log"] != p["log"]:
        fail("scale serving: kernel log != plain log")
    diff = _diff_keys(serving_counters(k["eng"]), serving_counters(p["eng"]))
    diff += _store_diff(k["eng"]._st, p["eng"]._st)
    if diff:
        fail(f"scale serving: kernel run != plain run: {diff[:8]}")
    reads, serves = serving_counts(k["log"], k["api"])
    kl = k["launches"]
    if (kl["session_floor"] != k["api"].guarded_batches or kl["op_ingest"] != reads
            or kl["vclock_chain"] != reads
            or kl["policy_score"] != SERVING_SCALE["n_epochs"]
            or sum(p["launches"].values()) != 0):
        fail(f"scale serving: launches {kl} (plain {p['launches']}), want "
             f"{k['api'].guarded_batches} session_floor, {reads} op_ingest")
    c = serving_counters(k["eng"])
    counters = {f: c[f] for f in ("stale_serves", "total_serves", "reroutes",
                                  "failovers", "retries", "timeouts", "downgrades",
                                  "retry_wait_ms")}
    n_rb = k["api"].ok_batches
    log(f"[scale] serving engine: kernels {k['wall']:.3f} s ({n_rb} route_batch of "
        f"{SERVING_SCALE['n_sessions']} sessions, {serves} serve_with_retry, "
        f"{SERVING_SCALE['n_epochs']} adapt_sessions; "
        f"{k['wall'] / max(1, n_rb) * 1e3:.1f} ms per round on average), plain "
        f"{p['wall']:.3f} s; peaks {k['peak']} / {p['peak']} B; launches {kl}; "
        f"{counters}; region p99 {c['region_stats']['p99_latency_ms']}; equal in "
        "every field and the store state")
    del runs, k, p
    torch.cuda.empty_cache()

    rruns = {}
    for impl in ("auto", "torch"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        router, rlog = run_router("cuda", impl=impl, **ROUTER_SCALE)
        torch.cuda.synchronize()
        rruns[impl] = (router, rlog, time.perf_counter() - t0, ops.launch_counts())
    (rk, lk, wk, nk), (rp, lp, wp, _) = rruns["auto"], rruns["torch"]
    diff = [] if lk == lp else ["log"]
    diff += _diff_keys(serving_counters(rk), serving_counters(rp))
    diff += _store_diff(rk._st, rp._st)
    if diff:
        fail(f"scale router: kernel run != plain run: {diff[:8]}")
    rc = serving_counters(rk)
    log(f"[scale] router {ROUTER_SCALE}: kernels {wk:.3f} s, plain {wp:.3f} s; "
        f"launches {nk}; age_stats {rc['age_stats']}; stale "
        f"{rc['stale_serves']}/{rc['total_serves']}; equal in every field")


def scale_planner() -> None:
    """The placement planner over the scale deployment: R = 5,000,000
    resources x 124 candidates x 3 regions, with the 8,000,000-op stream's
    demand, under SLA_RELAXED; against the static 4-per-DC placement."""
    import numpy as np
    import torch

    from repro_torch.engine import stream as engine_stream
    from repro_torch.geo import placement as pl
    from repro_torch.geo.topology import PAPER_TOPOLOGY
    from repro_torch.kernels import ops
    from repro_torch.policy.sla import SLA_RELAXED
    from repro_torch.storage.ycsb import WORKLOAD_A

    r = SCALE["n_resources"]
    t0 = time.perf_counter()
    stream = engine_stream.op_stream(WORKLOAD_A, SCALE["n_ops"], SCALE["n_clients"],
                                     r, 0, PAPER_TOPOLOGY.n_replicas)
    reads, writes = pl.region_demand(stream["client"], stream["kind"],
                                     stream["resource"], PAPER_TOPOLOGY, r)
    del stream
    demand_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    plan = pl.plan_placement(PAPER_TOPOLOGY, reads, writes, SLA_RELAXED,
                             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()
    static = pl.evaluate_counts(PAPER_TOPOLOGY, pl.static_counts(PAPER_TOPOLOGY, 4),
                                reads, writes, SLA_RELAXED, device="cuda")
    if (plan.choice.shape != (r,) or launches["placement_select"] != 1
            or launches["placement_score"] != 0):
        fail(f"scale planner: choice {plan.choice.shape}, launches {launches} "
             "(want placement_select 1, placement_score 0)")
    # The wall taken apart: the same steps as plan_placement, one at a time.
    split = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables = pl.plan_tables(PAPER_TOPOLOGY, reads)
    split["host tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ins = pl.device_inputs(reads, writes, tables, "cuda")
    torch.cuda.synchronize()
    split["H2D (reads, writes, the tables: three copies)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = ops.placement_select(*ins, max_latency_ms=SLA_RELAXED.max_read_latency_ms)
    torch.cuda.synchronize()
    split["kernel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = out.cpu().numpy()
    split["D2H"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cost = pl.chosen_cost(tables, out[0], reads, writes)
    split["host cost"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = tables["candidates"][out[0]]
    split["host counts"] = time.perf_counter() - t0
    del ins
    if not (np.array_equal(out[0], plan.choice) and np.array_equal(
            out[1], plan.utility.view(np.int32)) and np.array_equal(
            cost.view(np.int32), plan.cost.view(np.int32))
            and np.array_equal(counts, plan.counts)):
        fail("scale planner: the split steps differ from plan_placement")
    # The parent's path on the same demand, in turns with this one (parent,
    # change, parent after the first, cold call above): walls and peaks.
    walls = {"change": [wall], "parent": []}
    parent_peak = 0
    for side in ("parent", "change", "parent"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if side == "change":
            pl.plan_placement(PAPER_TOPOLOGY, reads, writes, SLA_RELAXED, device="cuda")
        else:
            parent = parent_plan_placement(PAPER_TOPOLOGY, reads, writes, SLA_RELAXED)
        torch.cuda.synchronize()
        walls[side].append(time.perf_counter() - t0)
        if side == "parent":
            parent_peak = torch.cuda.max_memory_allocated()
    differ = plans_differ(plan, parent)
    if differ:
        fail(f"scale planner: {differ} differ from the parent's path")
    del parent
    torch.cuda.empty_cache()
    if not (math.isfinite(plan.total_cost) and plan.total_cost > 0):
        fail(f"scale planner: total cost {plan.total_cost}")
    # Wherever the static placement is feasible, the plan (which searched
    # it) is feasible and no costlier.
    both = static["feasible"]
    if not plan.feasible[both].all() or (
            plan.cost[both] > static["cost"][both]).any():
        fail("scale planner: a plan is costlier than the static placement")
    # The plan against the plain scoring's plan on the card (every row)
    # and against the CPU's plan on every 997th row (argmax and gathers on
    # another device): choice, counts, utility, feasibility and cost.
    t0 = time.perf_counter()
    plain = pl.plan_placement(PAPER_TOPOLOGY, reads, writes, SLA_RELAXED,
                              impl="torch", device="cuda")
    plain_s = time.perf_counter() - t0
    rows = slice(None, None, 997)
    cpu = pl.plan_placement(PAPER_TOPOLOGY, reads[rows], writes[rows], SLA_RELAXED,
                            resource_gb=pl._resource_gb(pl.PAPER_CLUSTER, reads),
                            device="cpu")
    for label, want, sel in (("plain", plain, slice(None)), ("cpu", cpu, rows)):
        for f in ("choice", "counts", "utility", "feasible", "cost"):
            a, b = getattr(plan, f)[sel], getattr(want, f)
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            if not np.array_equal(a, b):
                fail(f"scale planner: {f} differs from the {label} plan on "
                     f"{int((a != b).sum())} rows")
    counts, n = np.unique(plan.counts, axis=0, return_counts=True)
    top = sorted(zip(n.tolist(), map(tuple, counts.tolist())), reverse=True)[:4]
    log(f"[scale] planner R={r} K={plan.candidates.shape[0]} G=3 SLA_RELAXED: "
        f"demand {demand_s:.3f} s (host), plan_placement wall {wall:.3f} s ("
        + ", ".join(f"{k} {v:.6f} s" for k, v in split.items())
        + f"); max_memory_allocated {peak} B; in turns (change cold, parent, "
        f"change, parent) walls change {' / '.join(f'{w:.3f}' for w in walls['change'])}"
        f" s, the parent's path (grid, argmax, gathers) "
        f"{' / '.join(f'{w:.3f}' for w in walls['parent'])} s, its "
        f"max_memory_allocated {parent_peak} B, results bit-equal; feasible {plan.n_feasible}/{r}; total cost "
        f"${plan.total_cost} vs static 4-per-DC ${static['total_cost']} "
        f"({static['n_feasible']}/{r} feasible); top placements {top}; "
        f"launches {launches}; choice/counts/utility/feasible/cost bit-equal to "
        f"the plain scoring's plan on the card ({plain_s:.3f} s) on all {r} rows "
        f"and to the CPU's plan on {cpu.choice.shape[0]} rows (every 997th)")


def scale_geo() -> None:
    """The geo replay at the paper's deployment: X_STCC over the
    12-replica fleet (4 per DC, RF 12 as in the paper's Fig. 7)."""
    import torch

    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.kernels import ops
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import WORKLOAD_A

    fleet = geo_topologies()["fleet12"]
    geo = dict(SCALE, n_ops=GEO_SCALE_OPS)
    log(f"[scale] geo run: X_STCC WORKLOAD_A {geo} on the 12-replica fleet "
        f"{fleet.replica_region} (GEO_SCALE_OPS, see SCALE_CUTS)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = sim.run_protocol_geo(ConsistencyLevel.X_STCC, WORKLOAD_A, topology=fleet,
                               device="cuda", **geo)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for k in ("staleness_rate", "violation_rate", "severity"):
        if not (math.isfinite(out[k]) and 0.0 <= out[k] <= 1.0):
            fail(f"scale geo run: {k} = {out[k]} is not a rate")
    if out["n_reads"] <= 0 or out["dropped_writes"] != 0:
        fail(f"scale geo run: n_reads {out['n_reads']}, dropped_writes "
             f"{out['dropped_writes']}")
    if any(launches[k] == 0 for k in ("op_ingest", "vclock_chain", "vclock_audit")):
        fail(f"scale geo run never launched a kernel: {launches}")
    c = out["cost"]
    log(f"[scale] geo run wall {wall:.3f} s; {geo['n_ops'] / wall:.1f} ops/s; "
        f"staleness {out['staleness_rate']}; violation {out['violation_rate']}; "
        f"severity {out['severity']}; n_reads {out['n_reads']}; traffic "
        f"{out['traffic_events']}; mean_latency_ms {out['mean_latency_ms']}; bill "
        f"network_geo ${c['network_geo']}, network_scalar ${c['network_scalar']}, "
        f"total ${c['total']}, total_geo ${c['total_geo']}; max_memory_allocated "
        f"{peak} B; launches {launches}")


def scale_adaptive() -> None:
    """The adaptive run over the paper's 64 clients and 5,000,000 rows
    (ops cut, see ``ADAPTIVE_SCALE_CUTS``): the telemetry pass of the six
    levels, the controller with the kernel, and the same controller with
    the plain scorer on the same telemetry and draws."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.policy.controller import AdaptiveController
    from repro_torch.policy.sla import SLA_RELAXED
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import PHASED_RW

    log(f"[scale] adaptive run: PHASED_RW SLA_RELAXED {ADAPTIVE_SCALE}, six levels")
    log(f"[scale] {ADAPTIVE_SCALE_CUTS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tel = sim.adaptive_telemetry(PHASED_RW, device="cuda", **ADAPTIVE_SCALE)
    torch.cuda.synchronize()
    tel_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = sim.run_protocol_adaptive(PHASED_RW, SLA_RELAXED, telemetry=tel,
                                    device="cuda", **ADAPTIVE_SCALE)
    torch.cuda.synchronize()
    ctrl_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    epoch, t = tel["epoch_size"], tel["telemetry"]
    epochs = tel["n_ops"] // epoch
    if not (t["reads"].sum(axis=1) + t["writes"].sum(axis=1) == epoch).all():
        fail("scale adaptive: an epoch's reads + writes differ from the epoch size")
    rounds = telemetry_rounds(tel["n_ops"], epoch)
    if (launches["policy_score"] != epochs or launches["op_ingest"] != rounds
            or launches["vclock_audit"] != 0):
        fail(f"scale adaptive: launches {launches}, want {epochs} policy_score and "
             f"{rounds} op_ingest")
    # The same controller with the plain scorer, on the same telemetry and
    # draws: the result and the whole trace bit for bit.
    plain = sim.run_protocol_adaptive(PHASED_RW, SLA_RELAXED, telemetry=tel,
                                      impl="torch", device="cuda", **ADAPTIVE_SCALE)
    diff = adaptive_equal(out, plain)
    if diff:
        fail(f"scale adaptive: kernel result != plain result: {diff[:8]}")
    traces = [AdaptiveController(ADAPTIVE_SCALE["n_clients"], SLA_RELAXED, eps0=0.02,
                                 impl=impl, device="cuda").run_scan(0, t)[1]
              for impl in ("auto", "torch")]
    for k in traces[0]:
        if not _bits_equal(traces[0][k], traces[1][k]):
            fail(f"scale adaptive: trace {k} differs between the kernel and the "
                 "plain scorer")
    if not np.array_equal(traces[0]["choice"].cpu().numpy(), out["choice"]):
        fail("scale adaptive: run_scan's choice differs from the run's")
    a = out["adaptive"]
    log(f"[scale] adaptive run: telemetry {tel_s:.3f} s ({rounds} rounds), "
        f"controller + result {ctrl_s:.3f} s, wall {tel_s + ctrl_s:.3f} s; "
        f"{tel['n_ops']} ops, {epochs} epochs of {epoch}; max_memory_allocated "
        f"{peak} B; launches {launches}; cost {a['cost']}, staleness "
        f"{a['staleness_rate']}, violation {a['violation_rate']}, level_share "
        f"{a['level_share']}; cheapest feasible static "
        f"{out['cheapest_feasible_static']} at "
        f"{ {k: v['cost'] for k, v in out['static'].items()} }; result and "
        "trace bit-equal to the plain scorer's on the card")


def scale_fleet_controller() -> None:
    """The controller at fleet width: 1,000,000 sessions over 32 epochs
    of seeded synthetic telemetry on the card; every 997th session
    against the same run on the CPU (sessions are independent rows)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.policy.controller import AdaptiveController, make_draws
    from repro_torch.policy.sla import POLICY_LEVELS, SLA_RELAXED

    s, e, n_levels = FLEET_SESSIONS, FLEET_EPOCHS, len(POLICY_LEVELS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    reads = torch.randint(0, 64, (e, s), generator=g, device=dev)
    writes = torch.randint(0, 64, (e, s), generator=g, device=dev)
    top = (reads[..., None] + 1).to(torch.float32)
    stale = (torch.rand((e, s, n_levels), generator=g, device=dev) * top).floor()
    viol = (torch.rand((e, s, n_levels), generator=g, device=dev) ** 4 * top).floor()
    tel = {"stale": stale, "viol": viol, "reads": reads, "writes": writes}
    draws = make_draws(0, (e, s), n_levels, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ctrl = AdaptiveController(s, SLA_RELAXED, device=dev)
    state, trace = ctrl.run_scan(0, tel, draws=draws)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()
    if launches["policy_score"] != e:
        fail(f"scale controller: {launches['policy_score']} policy_score launches, "
             f"want {e}")
    rows = torch.arange(0, s, FLEET_STRIDE, device=dev)
    sub = {k: v[:, rows].cpu() for k, v in tel.items()}
    c_state, c_trace = AdaptiveController(rows.numel(), SLA_RELAXED, device="cpu").run_scan(
        0, sub, draws=tuple(d[:, rows].cpu() for d in draws))
    for k in c_trace:
        if not _bits_equal(trace[k][:, rows].cpu(), c_trace[k]):
            fail(f"scale controller: trace {k} differs from the CPU's")
    for f in ("stale_win", "viol_win", "reads_win"):
        if not _bits_equal(getattr(state, f)[:, rows].cpu(), getattr(c_state, f)):
            fail(f"scale controller: {f} differs from the CPU's")
    share = torch.bincount(trace["choice"].reshape(-1).long(), minlength=n_levels)
    log(f"[scale] controller S={s} L={n_levels} E={e} (synthetic telemetry): run_scan "
        f"wall {wall:.3f} s ({wall / e * 1e3:.3f} ms per epoch); "
        f"max_memory_allocated {peak} B; launches {launches}; choices per level "
        f"{share.tolist()}; trace and windows bit-equal to the CPU's on "
        f"{rows.numel()} sessions (every {FLEET_STRIDE}th)")


# -- phase 12 -----------------------------------------------------------------


# The profiled adaptive run's stream: an eighth of its 6400-op default
# (cuts of scale: the profile phase only). At the default the run made
# 402,318 device operations in 8.66 s unprofiled, the most of the
# profiled runs, in a phase of 346.1 s on an H100; a quarter (1600 ops)
# took 42.2 s of an 82.6-s phase, halved again to make room for the
# families' training.  Each profiled run logs its own seconds.
PROFILE_ADAPTIVE_OPS = 800


def log_profile(tag: str, label: str, run, wall: float, rounds: int = 0) -> None:
    """Profile one call of ``run`` and log its device time by kernel, the
    card's busy share of ``wall`` (the unprofiled wall time) and the
    device operations (kernels, copies, fills) it ran, per round when
    ``rounds`` is given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=profiled_activities()) as prof:
        run()
        torch.cuda.synchronize()
    # Device-side rows only (kernels, copies, fills): the host-op rows
    # repeat the time of the kernels they launched.
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    if not rows:
        log(f"[{tag}] {label}: wall {wall:.4f} s unprofiled; "
            "torch.profiler recorded no device time (busy share not measured)")
        return
    busy = sum(r[0] for r in rows) / 1e6
    n_ops = sum(r[1] for r in rows)
    per_round = f" ({n_ops / rounds:.2f} per round of {rounds})" if rounds else ""
    log(f"[{tag}] {label}: wall {wall:.4f} s "
        f"unprofiled; device kernel time {busy:.4f} s; busy share "
        f"{busy / wall:.4f}; idle share {1 - busy / wall:.4f}; {n_ops} device "
        f"operations{per_round}")
    for us, count, key in rows[:8]:
        log(f"[{tag}]   {us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")


def phase_profile() -> None:
    import torch

    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.policy.sla import SLA_RELAXED
    from repro_torch.storage import simulator as sim
    from repro_torch.storage.ycsb import PHASED_RW, WORKLOAD_A

    # CAUSAL's rounds are all alike; 1000 ops (125 rounds) keep the
    # profiler's own overhead small (2000 ops took 49.3 s of the phase).
    fault_kw = fault_kwargs(6000, 128)
    # (label, run, rounds): the fault run's 6000 ops in 128-op rounds.
    runs = (
        ("X_STCC run_protocol(n_ops=6000)", lambda: sim.run_protocol(
            ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=6000, device="cuda"), 0),
        ("CAUSAL run_protocol(n_ops=1000)", lambda: sim.run_protocol(
            ConsistencyLevel.CAUSAL, WORKLOAD_A, n_ops=1000, device="cuda"), 0),
        ("X_STCC run_protocol_faulty(n_ops=6000, outage+gossip+hints+wal+obs)",
         lambda: sim.run_protocol_faulty(ConsistencyLevel.X_STCC, WORKLOAD_A,
                                         device="cuda", **fault_kw), -(-6000 // 128)),
        ("X_STCC run_protocol_geo(n_ops=6000, PAPER_TOPOLOGY)",
         lambda: sim.run_protocol_geo(ConsistencyLevel.X_STCC, WORKLOAD_A,
                                      device="cuda"), 0),
        (f"run_protocol_adaptive(PHASED_RW, SLA_RELAXED, n_ops={PROFILE_ADAPTIVE_OPS})",
         lambda: sim.run_protocol_adaptive(PHASED_RW, SLA_RELAXED,
                                           n_ops=PROFILE_ADAPTIVE_OPS, device="cuda"), 0),
        (f"ServingEngine schedule {SERVING} on the 12-replica fleet",
         lambda: run_serving("cuda", **SERVING), 0),
    )
    for label, run, rounds in runs:
        t_start = time.perf_counter()
        run()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log_profile("profile", label, run, wall, rounds)
        log(f"[time] profile {label}: {time.perf_counter() - t_start:.1f} s "
            "(warm-up, unprofiled and profiled runs)")


# -- main ---------------------------------------------------------------------


REPLACES = {
    "op_ingest": ("src/repro_torch/csrc/op_ingest.cu",
                  "src/repro/kernels/op_ingest.py:283"),
    "vclock_audit": ("src/repro_torch/csrc/vclock_audit.cu",
                     "src/repro/kernels/vclock_audit.py:92"),
    "vclock_chain": ("src/repro_torch/csrc/vclock_chain.cu",
                     "src/repro/core/xstcc.py:357"),
    "digest_compare": ("src/repro_torch/csrc/digest_compare.cu",
                       "src/repro/kernels/digest_compare.py:101"),
    "histogram": ("src/repro_torch/csrc/histogram.cu",
                  "src/repro/kernels/histogram.py:114"),
    "placement_score": ("src/repro_torch/csrc/placement_score.cu",
                        "src/repro/kernels/placement_score.py:71"),
    # The same Pallas kernel, fused with the planner's argmax and gathers.
    "placement_select": ("src/repro_torch/csrc/placement_score.cu",
                         "src/repro/kernels/placement_score.py:71"),
    "policy_score": ("src/repro_torch/csrc/policy_score.cu",
                     "src/repro/kernels/policy_score.py:91"),
    "session_floor": ("src/repro_torch/csrc/session_floor.cu",
                      "src/repro/kernels/session_floor.py:99"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:103"),
}
# The path whose launch counts each kernel reports: the flat main path
# for the first slice's kernels, the fault path for gossip and obs, the
# geo path for the planner's select (and the (R, K) grid kernel, which no
# path launches since the planner selects on the card: it reads 0), the
# adaptive path for the policy scorer, the
# serving path for the session-floor admission, the model's forward for
# the attention kernel.
LAUNCH_PHASE = {"op_ingest": "main", "vclock_audit": "main", "vclock_chain": "main",
                "digest_compare": "faulty", "histogram": "faulty",
                "placement_score": "geo", "placement_select": "geo",
                "policy_score": "adaptive",
                "session_floor": "serving", "flash_attention": "model"}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    # The tests' JAX-free helpers: the geo comparison rule and the planner
    # inputs are written once, there.
    sys.path.insert(0, str(ROOT / "tests"))

    t_start = time.perf_counter()

    def run(phase: str, fn, default=None):
        return timed(phase, fn) if phase in phases else default

    dev = phase_device()
    run("build", phase_build)
    timings = run("kernels", phase_kernels, {})
    timings.update(run("digest", phase_digest, {}))
    run("golden", phase_golden)
    launches = {"main": run("main", phase_main, {}),
                "faulty": run("faulty", phase_faulty, {}),
                "sharded": run("sharded", phase_sharded, {}),
                "recovery": run("recovery", phase_recovery, {}),
                "geo": run("geo", phase_geo, {}),
                "adaptive": run("adaptive", phase_adaptive, {}),
                "serving": run("serving", phase_serving, {})}
    if "model" in phases:
        model_timings, launches["model"] = run("model", phase_model)
        timings.update(model_timings)
    launches["train"] = run("train", phase_train, {})
    if "mesh" in phases:
        launches["mesh"] = timed("mesh", phase_mesh, dev)
    if "families" in phases:
        fam_timings, launches["families"] = run("families", phase_families)
        timings.update(fam_timings)
    timings.update(run("scale", phase_scale, {}))
    run("profile", phase_profile)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if phases != list(PHASES):
        return
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[LAUNCH_PHASE[name]][name],
            # The sharded phase's launches: B.1 and the chain once per shard
            # per round, B.2 once per shard's audit.
            "sharded_launches": launches["sharded"][name],
            # The recovery phase's crash runs: B.4 in bootstrap and gossip.
            "recovery_launches": launches["recovery"][name],
            # The train phase's fifteen reduced runs (nine levels, six
            # families): B.1 and the chain twice per
            # merge, B.2 once per causal merge.
            "train_launches": launches["train"][name],
            "max_abs_err": t["err"], "match": t.get("match", t["err"] == 0),
            "shape": t["shape"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            # SDPA for the attention; no single PyTorch call computes any
            # of the other functions.
            "library_ms": t.get("library_ms"),
        })
        if name == "flash_attention" and "mesh" in launches:
            # The mesh phase's (e): B.8 in the counted meshed forwards of the
            # six families served as SPMD on the (1, 1) NCCL mesh.
            kernels[-1]["mesh_launches"] = launches["mesh"][name]
        if name == "flash_attention" and "families" in launches:
            # The families phase: B.8 in the counted full-width forwards, and
            # the kernel at each family's attention shape.
            kernels[-1]["families_launches"] = launches["families"][name]
            kernels[-1]["families"] = {}
            for arch in FAMILY_FA_CASES:
                u = timings[f"flash_attention@{arch}"]
                kernels[-1]["families"][arch] = {
                    "shape": u["shape"], "launches": u["launches"], "ms": u["ms"],
                    "plain_ms": u["plain_ms"], "library_ms": u["library_ms"],
                    "bound_ms": u["bound"][0], "bound_by": u["bound"][1],
                    "max_abs_err": u["err"]}
        if "addmm_ms" in t:
            kernels[-1]["addmm_cost_term_ms"] = t["addmm_ms"]
        if "scatter_ms" in t:
            kernels[-1]["scatter_reduce_floor_only_ms"] = t["scatter_ms"]
            kernels[-1]["bound_ms_without_copy"] = t["bound_nocopy"][0]
        if "bound_int32" in t:
            # bound_ms counts B.1's integer work at the f32 FMA rate (67 T/s);
            # this one at the INT32 issue rate (~16.7 T op/s).
            kernels[-1]["bound_ms_int32"] = t["bound_int32"]
        if "cuda_kernels_per_call" in t:
            kernels[-1]["cuda_kernels_per_call"] = t["cuda_kernels_per_call"]
        if "depth" in t:
            kernels[-1]["design"] = t["design"]
            kernels[-1]["serial_depth"] = t["depth"]
        if "write_ms" in t:
            # ms is the engine's accumulating call; this one allocates.
            kernels[-1]["write_ms"] = t["write_ms"]
        if t.get("device_ms") is not None:
            kernels[-1]["device_ms_per_call"] = t["device_ms"]
        if "whole_call_ms" in t:
            # B.4, B.6, B.7: ms is the kernel alone; this the whole call the
            # main path makes (gossip_round, AdaptiveController.select, a
            # router's admission), and the path it replaced on the same
            # inputs.
            kernels[-1]["whole_call_ms"] = t["whole_call_ms"]
            for k in ("gather_path_ms", "parent_path_ms", "parent_path_ops",
                      "device_ops"):
                if k in t:
                    kernels[-1][k] = t[k]
        if "bound_bytes_ms" in t:
            # B.5's select: both bounds; the parent's device path (the grid
            # kernel, argmax, gathers) on the same inputs; the scale's row.
            kernels[-1].update(bound_operations_ms=t["bound_operations_ms"],
                               bound_bytes_ms=t["bound_bytes_ms"],
                               parent_device_ms=t["parent_device_ms"])
            u = timings[f"placement_select@{SCALE['n_resources']}"]
            kernels[-1][str(SCALE["n_resources"])] = {
                k: u[k] for k in ("shape", "ms", "device_ms", "plain_ms",
                                  "parent_device_ms", "bound_operations_ms",
                                  "bound_bytes_ms")}
            kernels[-1][str(SCALE["n_resources"])].update(
                bound_ms=u["bound"][0], bound_by=u["bound"][1], max_abs_err=u["err"])
        for key in (f"policy_score@{FLEET_SESSIONS + 3}", "session_floor@16384"):
            if key.split("@")[0] == name:
                u = timings[key]
                kernels[-1][key.split("@")[1]] = {
                    k: u[k] for k in ("ms", "whole_call_ms", "parent_path_ms",
                                      "parent_path_ops", "device_ms", "plain_ms")}
                kernels[-1][key.split("@")[1]].update(bound_ms=u["bound"][0],
                                                       bound_by=u["bound"][1])
        if "design_ms" in t:
            # B.2: bound_ms is the floor (base pairs only, one add-max per
            # component); the reference's 3N + 20 count, over the base pairs
            # and over every pair, beside it, all at the INT32 rate.
            kernels[-1]["design_ms"] = t["design_ms"]
            kernels[-1]["bound_ms_reference_count"] = t["bound_reference"][0]
            kernels[-1]["bound_ms_dense_int32"] = t["bound_dense"][0]
            kernels[-1]["base_share"] = t["base_share"]
            for key in ("vclock_audit@16384/random", "vclock_audit@16384/dense",
                        "vclock_audit@16384/scale_duot"):
                u = timings[key]
                kernels[-1][key.split("@")[1]] = {
                    "design_ms": u["design_ms"], "plain_ms": u["plain_ms"],
                    "bound_ms": u["bound"][0], "bound_by": u["bound"][1],
                    "bound_ms_reference_count": u["bound_reference"][0],
                    "bound_ms_dense_int32": u["bound_dense"][0],
                    "base_share": u["base_share"]}
    log(dev["smi"])    # the card's name and power limit again, beside the numbers
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"],
    }}), flush=True)


if __name__ == "__main__":
    main()
