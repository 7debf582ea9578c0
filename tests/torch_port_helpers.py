"""Shared helpers of the ``test_torch_*`` files: move state between the
JAX reference and the PyTorch port as numpy arrays, and compare it.
Imports JAX's package only inside the helpers that need it, so that
``test_torch_gpu.py`` can use the rest on a machine without JAX."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.consistency import ConsistencyLevel as TLevel

CPU = "cpu"


def jlevel(level: TLevel):
    from repro.core.consistency import ConsistencyLevel as JLevel

    return JLevel[level.name]


def tlevel(level) -> TLevel:
    return TLevel[level.name]


def jax_to_numpy(tree) -> dict:
    """``{field: np.ndarray}`` of a JAX NamedTuple (nested for StoreState;
    ``None`` fields are left out)."""
    out = {}
    for f in tree._fields:
        v = getattr(tree, f)
        if v is None:
            continue
        out[f] = jax_to_numpy(v) if isinstance(v, tuple) else np.asarray(v)
    return out


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_tree_equal(want, got, context: str = "") -> None:
    """Every field of a JAX NamedTuple equals the port's (dtype-blind
    values, exact)."""
    for f in want._fields:
        w = getattr(want, f)
        if w is None:
            continue
        g = getattr(got, f)
        if isinstance(w, tuple):
            assert_tree_equal(w, g, f"{context}.{f}")
            continue
        np.testing.assert_array_equal(
            np.asarray(w), as_np(g), err_msg=f"{context}.{f} diverged"
        )


def reference_draws(seed: int, n_epochs: int, shape: tuple, n_arms: int):
    """The reference controllers' exploration draws: ``PRNGKey(seed)``,
    split once per epoch, the epoch key split into explore and arm keys
    (the key chain of ``run_scan`` and of the serving engine's
    ``adapt_sessions``)."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    us, arms = [], []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        k_explore, k_arm = jax.random.split(sub)
        us.append(np.asarray(jax.random.uniform(k_explore, shape)))
        arms.append(np.asarray(jax.random.randint(k_arm, shape, 0, n_arms, jnp.int32)))
    return np.stack(us), np.stack(arms)


# The geo path's one stated tolerance: the reference adds f32 RTTs in an
# order XLA picks, the port forms the same sums exactly from op counts.
GEO_LATENCY_RTOL = 1e-5


def as_lists(x):
    """``x`` with every tuple turned into a list (as JSON gives it back)."""
    if isinstance(x, dict):
        return {k: as_lists(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_lists(v) for v in x]
    return x


def geo_mismatches(want, got, path: str = "") -> list[str]:
    """Fields of a geo result that differ from the reference's (tuples
    and lists alike): exact everywhere except ``mean_latency_ms`` (and
    its per-region list), held within ``GEO_LATENCY_RTOL``."""
    if isinstance(want, dict) and isinstance(got, dict):
        if set(want) != set(got):
            return [f"{path}: keys {sorted(set(want) ^ set(got))}"]
        return [m for k in sorted(want)
                for m in geo_mismatches(want[k], got[k], f"{path}.{k}")]
    if path.endswith("mean_latency_ms"):
        a, b = (v if isinstance(v, list) else [v] for v in (want, got))
        if len(a) != len(b) or not np.allclose(a, b, rtol=GEO_LATENCY_RTOL, atol=0):
            return [f"{path}: {want} vs {got}"]
        return []
    return [] if as_lists(want) == as_lists(got) else [f"{path}: {want} != {got}"]


def placement_inputs(rng, r: int, device):
    """Planner inputs at R resources: the paper topology's 124 candidate
    tables with every 17th candidate invalid and every 9th a copy of its
    left neighbour (tied utilities), demand counts with every 5th row
    zero and every 3rd row scaled to non-integers."""
    from repro_torch.geo import placement as pl
    from repro_torch.geo.topology import PAPER_TOPOLOGY

    tabs = pl.candidate_tables(PAPER_TOPOLOGY, pl.enumerate_candidates(3),
                               resource_gb=1.0 / max(1, r))
    rp, wp, rtt = (tabs[k].copy() for k in ("read_price", "write_price", "read_rtt"))
    meta = tabs["cand_meta"].copy()
    dup = np.arange(1, rp.shape[0], 9)
    for t in (rp, wp, rtt):
        t[dup] = t[dup - 1]
    meta[:, dup] = meta[:, dup - 1]
    meta[1, ::17] = 0.0
    reads = rng.integers(0, 6, (r, 3)).astype(np.float32)
    writes = rng.integers(0, 6, (r, 3)).astype(np.float32)
    reads[::3] *= rng.random(reads[::3].shape).astype(np.float32)
    reads[::5] = 0.0
    writes[::5] = 0.0
    return tuple(torch.as_tensor(x, device=device)
                 for x in (reads, writes, rp, wp, rtt, meta))


def policy_inputs(rng, s: int, device, *, levels=None):
    """``policy_score`` inputs at S sessions over the six policy levels'
    table (CAUSAL's and ONE's data age is inf): SLA_STRICT and
    SLA_RELAXED rows mixed, read fractions with exact 0 and 1, inf latency
    and age bounds on some rows, every 17th row invalid, a quarter of the
    cells unobserved (count 0), and rates formed as the controller forms
    them (f32 count ratios)."""
    from repro_torch.policy import sla

    table = sla.level_table(levels or sla.POLICY_LEVELS, device="cpu")
    n_levels = table.shape[1]
    strict = sla.session_params(sla.SLA_STRICT, s, device="cpu").numpy()
    relaxed = sla.session_params(sla.SLA_RELAXED, s, device="cpu").numpy()
    sess = np.where((rng.random(s) < 0.5)[:, None], strict, relaxed)
    rf = rng.random(s).astype(np.float32)
    rf[::7] = 0.0
    rf[3::7] = 1.0
    sess[:, sla.SP_READ_FRAC] = rf
    sess[::11, sla.SP_MAX_LAT] = np.inf
    sess[5::13, sla.SP_MAX_AGE] = np.inf
    sess[::17, sla.SP_VALID] = 0.0
    reads = rng.integers(0, 200, (s, n_levels))
    reads[rng.random((s, n_levels)) < 0.25] = 0
    denom = np.maximum(reads, 1).astype(np.float32)
    stale = (rng.integers(0, 201, (s, n_levels)) * reads // 200).astype(np.float32) / denom
    viol = (rng.integers(0, 21, (s, n_levels)) * reads // 200).astype(np.float32) / denom
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=device)
                 for x in (sess, table.numpy(), stale, viol, reads.astype(np.float32)))


def f32_same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same bits (f32 compared as int32), except that a
    NaN equals any NaN: a NaN's payload is the backend's own (x86 makes a
    negative quiet NaN, XLA a positive one)."""
    nan = torch.isnan(b)
    return bool(a.shape == b.shape and torch.equal(torch.isnan(a), nan) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def select_inputs(rng, s: int, w: int, device, *, levels=None, wraps: int = 1) -> dict:
    """The controller's selection inputs at S sessions over a W-slot
    window, as ``ops.policy_select`` takes them: the three (W, S, L) f32
    count rings filled by ``W + wraps`` epochs recorded at the ring
    pointer (which wraps), a quarter of the cells unobserved each epoch;
    the level table with column 1 a copy of column 0, and every 5th row's
    counts at level 1 a copy of level 0's (a tie); every 7th row's stale
    counts NaN at levels 1 and L - 1 (the first NaN leads); per-session
    read fractions with exact 0 and 1; a mask with every 17th row
    invalid; and the draws ``explore_u`` (f32) and ``arm`` (int32)."""
    from repro_torch.obs.metrics import window_init, window_record
    from repro_torch.policy import sla

    table = sla.level_table(levels or sla.POLICY_LEVELS, device="cpu")
    table[:, 1] = table[:, 0]
    n_levels = table.shape[1]
    rings = [window_init(w, (s, n_levels)) for _ in range(3)]
    i32 = np.int32
    for t in range(w + wraps):
        reads = rng.integers(0, 200, (s, n_levels), dtype=i32)
        reads[rng.random((s, n_levels), dtype=np.float32) < 0.25] = 0
        stale = rng.integers(0, 201, (s, n_levels), dtype=i32) * reads // 200
        viol = rng.integers(0, 21, (s, n_levels), dtype=i32) * reads // 200
        for x in (reads, stale, viol):
            x[::5, 1] = x[::5, 0]
        reads[::7, 1] = reads[::7, n_levels - 1] = 7
        stale = stale.astype(np.float32)
        stale[::7, 1] = stale[::7, n_levels - 1] = np.nan
        for win, x in zip(rings, (stale, viol, reads)):
            window_record(win, t, torch.from_numpy(x.astype(np.float32)))
    rf = rng.random(s).astype(np.float32)
    rf[::7] = 0.0
    rf[3::7] = 1.0
    valid = np.ones(s, np.float32)
    valid[::17] = 0.0
    out = dict(stale_win=rings[0], viol_win=rings[1], reads_win=rings[2], table=table,
               read_frac=rf, valid=valid, explore_u=rng.random(s).astype(np.float32),
               arm=rng.integers(0, n_levels, s).astype(np.int32))
    return {k: torch.as_tensor(v).to(device) for k, v in out.items()}


# The adaptive path's one stated tolerance: the reference sums the (E, S)
# per-epoch f32 costs in f32, in an order XLA picks; the port sums the
# same (bit-equal) costs in f64.
ADAPTIVE_COST_RTOL = 1e-6


# The clock-chain mixes: (client, replica, is_write) int32 arrays of B ops
# over C clients and P replicas.  "reads_once" needs B <= C.
CHAIN_MIXES = ("one_client", "one_replica_writes", "reads_once", "reads_repeat",
               "random", "workload_a")


def chain_mix(name: str, rng, b: int, c: int, p: int):
    """One clock-chain mix: all ops from one client; all writes to one
    replica; reads only, each client once; reads only with repeats;
    random; and the flat path's WORKLOAD_A shape (uniform clients, home
    replica ``client % P`` moved for 30% of ops, half updates)."""
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    if name == "one_client":
        return (i32(np.full(b, rng.integers(0, c))), i32(rng.integers(0, p, b)),
                i32(rng.integers(0, 2, b)))
    if name == "one_replica_writes":
        return i32(rng.integers(0, c, b)), i32(np.zeros(b)), i32(np.ones(b))
    if name == "reads_once":
        return i32(rng.permutation(c)[:b]), i32(rng.integers(0, p, b)), i32(np.zeros(b))
    if name == "reads_repeat":
        return i32(rng.integers(0, c, b)), i32(rng.integers(0, p, b)), i32(np.zeros(b))
    if name == "random":
        return (i32(rng.integers(0, c, b)), i32(rng.integers(0, p, b)),
                i32(rng.integers(0, 2, b)))
    if name == "workload_a":
        cl = rng.integers(0, c, b)
        move = rng.random(b) < 0.30
        home = (cl % p + np.where(move, rng.integers(1, 3, b), 0)) % p
        return i32(cl), i32(home), i32(rng.random(b) < 0.5)
    raise ValueError(f"unknown chain mix {name!r}")


# The audit mixes: one resource (most pairs need the clock compare),
# every entry its own resource (no pair does), no valid entry, one clock
# for every entry (no happens-before either way), random resources, and
# random resources with a few clocks above int16 in their upper half of
# components (the kernel's int16-pair staging must fall back there).
AUDIT_MIXES = ("one_resource", "distinct_resources", "all_invalid", "equal_clocks",
               "random", "large_clocks")


def audit_mix(name: str, rng, m: int, n: int, *, n_resources: int = 5):
    """numpy audit inputs ``(vc, client, kind, resource, version, seq,
    valid)`` of M entries over N clients: clocks in [0, 25), 90 % valid,
    distinct seqs, ``n_resources`` resources for ``"random"``."""
    vc = rng.integers(0, 25, (m, n)).astype(np.int32)
    client = rng.integers(0, n, m).astype(np.int32)
    kind = rng.integers(0, 2, m).astype(np.int32)
    resource = rng.integers(0, n_resources, m).astype(np.int32)
    version = rng.integers(0, 40, m).astype(np.int32)
    seq = rng.permutation(m).astype(np.int32)
    valid = rng.random(m) < 0.9
    if name == "one_resource":
        resource[:] = 0
    elif name == "distinct_resources":
        resource = np.arange(m, dtype=np.int32)
    elif name == "all_invalid":
        valid[:] = False
    elif name == "equal_clocks":
        vc[:] = vc[0]
    elif name == "large_clocks":
        vc[rng.random(m) < 0.05, n // 2:] += 40_000
    elif name != "random":
        raise ValueError(f"unknown audit mix {name!r}")
    return vc, client, kind, resource, version, seq, valid


def adaptive_mismatches(want: dict, got: dict) -> list[str]:
    """Fields of a ``run_protocol_adaptive`` result that differ from the
    reference's: ``adaptive.cost`` within ``ADAPTIVE_COST_RTOL``, the
    ``choice`` array and every other field exact."""
    bad = []
    if set(want) != set(got):
        return [f"keys {sorted(set(want) ^ set(got))}"]
    for k in want:
        if k == "choice":
            if not np.array_equal(np.asarray(want[k]), np.asarray(got[k])):
                bad.append("choice")
        elif k == "adaptive":
            a, b = want[k], got[k]
            if set(a) != set(b):
                bad.append(f"adaptive keys {sorted(set(a) ^ set(b))}")
                continue
            for kk in a:
                if kk == "cost":
                    if not np.isclose(a[kk], b[kk], rtol=ADAPTIVE_COST_RTOL, atol=0):
                        bad.append(f"adaptive.cost: {a[kk]} vs {b[kk]}")
                elif a[kk] != b[kk]:
                    bad.append(f"adaptive.{kk}: {a[kk]} != {b[kk]}")
        elif want[k] != got[k]:
            bad.append(f"{k}: {want[k]} != {got[k]}")
    return bad


# -- serving ----------------------------------------------------------------------

SERVING_COUNTERS = ("stale_serves", "total_serves", "reroutes", "failovers", "retries",
                    "timeouts", "downgrades", "retry_wait_ms")
ROUTER_COUNTERS = ("stale_serves", "total_serves", "reroutes", "failovers")


def attempt(fn, *args, **kwargs):
    """``fn(...)``'s value, or ``("raise", type name, message)`` for a
    routing failure (``RuntimeError``, ``ServeTimeout`` included).  The
    port's ``RoutingError`` is logged as the ``RuntimeError`` the
    reference raises in its place."""
    try:
        return fn(*args, **kwargs)
    except RuntimeError as e:
        name = type(e).__name__
        return ("raise", "RuntimeError" if name == "RoutingError" else name, str(e))


def plain(x):
    """``x`` with arrays, tensors and tuples as (nested) Python lists."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if hasattr(x, "shape"):
        return as_np(x).tolist()
    return x


def serving_counters(unit) -> dict:
    """What a serving engine or router of either package has counted:
    its counters, per-session telemetry and levels, replica versions and
    health, region statistics and histogram counts, or (a router) its
    age statistics.  The store state is compared apart."""
    if hasattr(unit, "age_stats"):
        out = {k: getattr(unit, k) for k in ROUTER_COUNTERS}
        out["age_stats"] = unit.age_stats()
        out["age_counts"] = unit._age_hist.counts.tolist()
        out["versions"] = unit._versions.tolist()
        return out
    out = {k: getattr(unit, k) for k in SERVING_COUNTERS}
    out["sess"] = [unit._sess_stale.tolist(), unit._sess_viol.tolist(),
                   unit._sess_serves.tolist()]
    out["levels"] = {s: lv.name for s, lv in sorted(unit.session_levels.items())}
    out["replicas"] = [r.version for r in unit.replicas]
    out["up"] = [unit.replica_up.tolist(), unit.replica_rebuilding.tolist()]
    if unit._topology is not None:
        out["region_stats"] = unit.region_stats()
        out["region_counts"] = [h.counts.tolist() for h in unit._region_hist]
    if unit._controller is not None:
        st = unit._ctl_state
        out["controller"] = {f: plain(getattr(st, f)) for f in
                             ("stale_win", "viol_win", "reads_win", "ptr", "epoch")}
    return out


class PortServingApi:
    """The schedules' adapter for the port's engine and router (either
    device).  Counts the ``route_batch`` calls that carry a guarded
    session (each launches ``session_floor`` once on the card) and those
    that complete (each is one store read)."""

    def __init__(self):
        self.guarded_batches = 0
        self.ok_batches = 0

    @staticmethod
    def session(i: int):
        from repro_torch.serve import ServeSession

        return ServeSession(i)

    @staticmethod
    def policy(**kw):
        from repro_torch.serve import RetryPolicy

        return RetryPolicy(**kw)

    def route_batch(self, eng, sessions, preferred=None):
        self.guarded_batches += any(eng.level_for(s.session_id).is_session_guarded
                                    for s in sessions)
        rep, srv = eng.route_batch(sessions, preferred=preferred)
        self.ok_batches += 1
        return rep.tolist(), srv.tolist()

    @staticmethod
    def router_route(router, sid, preferred=None):
        rep, srv = router.route(sid, preferred=preferred)
        return rep.tolist(), srv.tolist()


def serving_script(api, eng, *, seed: int, n_epochs: int, rounds: int,
                   n_sessions: int, retries_per_round: int = 4) -> list:
    """A seeded serving schedule over ``eng`` (either package's engine,
    driven through ``api``: ``session(i)``, ``route_batch(eng, sessions,
    preferred)``, ``policy(**kw)``).  Every replica starts at version 1.
    Each epoch publishes a new version on one replica (a rolling
    publish), takes up to two replicas down, raises an eighth of the
    sessions' external floors to the previous version, and runs
    ``rounds`` of ``route_batch`` over every session (nearest or random
    preferred replicas), each followed by ``serve_with_retry`` for a few
    sessions.  Then a few late requests arrive with floors at the newest
    version, whose replica is rebuilding every third epoch from the
    first: they retry, then degrade (odd session ids) or time out (even
    ones).  The epoch ends with ``adapt_sessions`` when a controller is
    attached.  Returns the log of what every call returned."""
    rng = np.random.default_rng(seed)
    n = eng.max_replicas
    for _ in range(n):
        eng.publish(None, 1)
    sessions = [api.session(i) for i in range(n_sessions)]
    log = []
    version = 1
    for e in range(n_epochs):
        version += 1
        newest = e % n
        eng.publish(None, version, replica=newest)
        up = np.ones(n, bool)
        up[rng.choice(n, int(rng.integers(0, 3)), replace=False)] = False
        eng.set_replica_health(up)
        for s in rng.choice(n_sessions, max(1, n_sessions // 8), replace=False):
            sessions[s].read_floor = max(sessions[s].read_floor, version - 1)

        def serve(late: bool):
            for s in rng.choice(n_sessions, retries_per_round, replace=False).tolist():
                if late:
                    sessions[s].read_floor = version
                pol = api.policy(max_retries=2, degrade=bool(s % 2), seed=e)
                log.append(attempt(eng.serve_with_retry, sessions[s], policy=pol))

        for k in range(rounds):
            pref = None if k % 2 == 0 else rng.integers(0, n, n_sessions).tolist()
            log.append(attempt(api.route_batch, eng, sessions, pref))
            serve(late=False)
        if e % 3 == 0:
            eng.mark_rebuilding(newest)
        serve(late=True)
        eng.finish_rebuilding(newest)
        if eng._controller is not None:
            levels = eng.adapt_sessions()
            log.append([levels[s].name for s in range(n_sessions)])
    log.append([s.read_floor for s in sessions])
    return log


def router_script(api, router, *, seed: int, n_epochs: int, rounds: int) -> list:
    """A seeded schedule over a ``ShardedServingRouter`` of either package
    (routed through ``api.router_route(router, sid, preferred)``): every
    replica starts at version 1; each epoch installs a new version on one
    replica and takes up to two replicas down, then routes every
    shard-local session once per round (nearest-by-id or random preferred
    replicas) and records the age statistics."""
    rng = np.random.default_rng(seed)
    n = router.max_replicas
    s, b = router.n_shards, router.sessions_per_shard
    for r in range(n):
        router.install(r, 1)
    log = []
    for e in range(n_epochs):
        router.install(e % n, e + 2)
        up = np.ones(n, bool)
        up[rng.choice(n, int(rng.integers(0, 3)), replace=False)] = False
        router.set_replica_health(up)
        for k in range(rounds):
            sid = np.stack([rng.permutation(b) for _ in range(s)])
            pref = None if k % 2 == 0 else rng.integers(0, n, (s, b))
            log.append(attempt(api.router_route, router, sid, pref))
        log.append(router.age_stats())
    return log


# The model-serving schedule: 3 replicas publish two distinct parameter
# sets as versions 1-3 (A, B, A); 6 requests over 3 sessions; replica 0
# fails after the third request, so session 0's next request fails over.
MODEL_SERVING = dict(n_requests=6, n_sessions=3, fail_after=3, fail_replica=0)
MODEL_SERVING_COUNTERS = ("stale_serves", "total_serves", "reroutes", "failovers")


def model_serving_script(eng, params_ab, prompt, session, *, n_tokens: int,
                         n_requests: int, n_sessions: int, fail_after: int,
                         fail_replica: int) -> list:
    """Run the model-serving schedule on ``eng`` (either package's engine).
    ``params_ab`` is the pair of parameter sets, ``prompt(i)`` request
    ``i``'s batch (with ``max_seq``), ``session(i)`` a new session.
    Returns ``[(tokens as lists, replica), ...]`` per request."""
    a, b = params_ab
    for version, params in enumerate((a, b, a), start=1):
        eng.publish(params, version=version)
    sessions = [session(i) for i in range(n_sessions)]
    out = []
    for i in range(n_requests):
        if i == fail_after:
            eng.fail_replica(fail_replica)
        toks, replica = eng.generate(sessions[i % n_sessions], prompt(i), n_tokens)
        out.append((as_np(toks).tolist(), int(replica)))
    return out


def model_serving_counters(eng) -> dict:
    """The routing counters the model-serving schedule is held to."""
    out = {k: getattr(eng, k) for k in MODEL_SERVING_COUNTERS}
    out["replicas"] = [r.version for r in eng.replicas]
    return out


# The model families besides dense: the six configurations of the MoE,
# VLM, hybrid, SSM and audio families.  (arch, number of causal
# self-attention layers a forward runs, i.e. B.8's launches with
# ``use_flash_kernel``): olmoe 16, internvl2 24, zamba2 one per shared
# site, rwkv6 none, whisper's decoder 32; llama4-maverick 48.
FAMILY_ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b", "internvl2-2b",
                "zamba2-1.2b", "rwkv6-3b", "whisper-large-v3")


def causal_attention_layers(cfg) -> int:
    """B.8 launches of one ``forward`` with ``use_flash_kernel``."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    return cfg.n_layers


def family_inputs(cfg, b: int, s: int, seed: int) -> dict:
    """One batch as numpy arrays, drawn from ``seed``: tokens and labels
    (B, S) int32, and the stub prefix of the VLM (``vis_embeds``) or the
    audio frames (``frames``), f32 standard normal."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": toks, "labels": toks.copy()}
    if cfg.n_vis_tokens:
        out["vis_embeds"] = rng.standard_normal((b, cfg.n_vis_tokens, cfg.d_model),
                                                dtype=np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((b, cfg.n_frames, cfg.d_model),
                                            dtype=np.float32)
    return out


def torch_batch(np_batch: dict, device, dtype=None) -> dict:
    """``family_inputs``' batch on ``device``; float inputs cast to ``dtype``."""
    out = {}
    for k, v in np_batch.items():
        t = torch.from_numpy(v).to(device)
        out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return out


# The card-against-CPU check of each family at its reduced f32 config:
# forward over ``seq`` tokens, prefill of the first ``prefill`` and
# ``steps`` decode steps; the serving schedule with ``prompt``-token
# prompts and ``tokens`` served tokens.  Lengths meet the chunk rules of
# the hybrid (16) and the SSM (128) families.
FAMILY_CHECK = dict(seq=32, prefill=16, steps=4, prompt=16, tokens=4)
# Card against CPU, f32 with TF32 off: logits within atol = rtol 1e-4.
FAMILY_TOL = 1e-4


def tree_to(tree, device, dtype=None):
    """A parameter tree on ``device``; float leaves cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype if tree.is_floating_point() else None)


def family_outputs(model, params, cfg, device, check=FAMILY_CHECK) -> dict:
    """``forward``'s logits, and prefill's then each decode step's
    last-position logits, on ``device``; returned on the CPU."""
    batch = torch_batch(family_inputs(cfg, 2, check["seq"], 0), device)
    k = check["prefill"]
    out = {"forward": model.forward(params, batch)[0]}
    pre = {n: (v[:, :k] if n in ("tokens", "labels") else v) for n, v in batch.items()}
    lg, cache = model.prefill(params, {**pre, "max_seq": check["seq"]})
    steps = [lg[:, -1]]
    for t in range(k, k + check["steps"]):
        lg, cache = model.decode_step(params, cache, batch["tokens"][:, t:t + 1])
        steps.append(lg[:, -1])
    out["serve"] = torch.stack(steps, dim=1)
    return {n: v.float().cpu() for n, v in out.items()}


def family_serving(model, params_ab, cfg, device, check=FAMILY_CHECK):
    """The model-serving schedule on ``device`` with the family's own
    inputs (the VLM's image prefix, the audio frames): ``(log, counters)``."""
    from repro_torch.serve import ServeSession, ServingEngine

    prompts = []
    for i in range(MODEL_SERVING["n_requests"]):
        p = family_inputs(cfg, 1, check["prompt"], 100 + i)
        del p["labels"]
        prompts.append(p)
    eng = ServingEngine(model, device=device)
    max_seq = check["prompt"] + check["tokens"]
    log = model_serving_script(
        eng, [tree_to(p, device) for p in params_ab],
        lambda i: {**torch_batch(prompts[i], device), "max_seq": max_seq}, ServeSession,
        n_tokens=check["tokens"], **MODEL_SERVING)
    return log, model_serving_counters(eng)


def family_mismatches(card: dict, cpu: dict, tol: float = FAMILY_TOL) -> list[str]:
    """The outputs of ``family_outputs`` that differ beyond ``tol``."""
    return [f"{n}: max abs err {float((card[n] - cpu[n]).abs().max())}"
            for n in cpu if card[n].shape != cpu[n].shape
            or not torch.allclose(card[n], cpu[n], atol=tol, rtol=tol)]


# The training path's cases: ``tests/test_trainer_levels.py``'s setting
# (reduced qwen2-7b with 2 layers, 2 pods, 16 steps, Δ = 4, batch 8 x 32
# tokens): (level, pods, steps, policy keywords).
TRAIN_CASES = (
    ("ONE", 2, 16, {}), ("QUORUM", 2, 16, {}), ("ALL", 2, 16, {}),
    ("CAUSAL", 2, 16, {}), ("X_STCC", 2, 16, {}), ("TCC", 2, 16, {}),
    ("X_STCC", 2, 16, {"compress_inter_pod": "int8"}),
    ("X_STCC", 2, 16, {"compress_inter_pod": "topk"}),
    ("QUORUM", 4, 8, {}),
)
# Losses of two runs that differ only in the order autograd or XLA sum in.
TRAIN_LOSS_RTOL = 1e-3


def train_case_id(case) -> str:
    level, pods, _, kw = case
    return "/".join([level, f"{pods}pods"] + [str(v) for v in kw.values()])


def port_trainer(case, device):
    """The port's ``Trainer`` for one of ``TRAIN_CASES``."""
    from repro_torch import configs
    from repro_torch.core import policy_for
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    level, pods, steps, kw = case
    cfg = configs.reduced(configs.get_config("qwen2-7b"), n_layers=2)
    return Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8),
                   AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=32),
                   policy_for(level, delta_steps=4, **kw),
                   TrainerConfig(n_steps=steps, n_pods=pods, log_every=4),
                   device=device)


def sync_record(sync) -> dict:
    """The bookkeeping of a port ``SyncState`` as numpy: the counters, the
    clocks and the DUOT."""
    return {"merges": as_np(sync.merges), "violations": as_np(sync.violations),
            "severity": as_np(sync.severity), "inter_pod_gb": as_np(sync.inter_pod_gb),
            "cluster": {f: as_np(getattr(sync.cluster, f)) for f in sync.cluster._fields},
            "duot": {f: as_np(getattr(sync.duot, f)) for f in sync.duot._fields}}


def record_mismatches(want: dict, got: dict, path: str = "") -> list[str]:
    """Keys of two ``sync_record``s (or nested dicts of arrays) that differ."""
    out = []
    for k in want:
        if isinstance(want[k], dict):
            out += record_mismatches(want[k], got[k], f"{path}{k}/")
        elif not np.array_equal(np.asarray(want[k]), np.asarray(got[k])):
            out.append(path + k)
    return out


def history_mismatches(want: list[dict], got: list[dict]) -> list[str]:
    """Where two training histories differ: the bookkeeping exactly, the
    losses within ``TRAIN_LOSS_RTOL``."""
    out = []
    if [h["step"] for h in want] != [h["step"] for h in got]:
        return ["steps"]
    for w, g in zip(want, got):
        for k in ("synced", "inter_pod_gb", "violations", "severity"):
            if w.get(k) != g.get(k):
                out.append(f"step {w['step']} {k}: {w.get(k)} != {g.get(k)}")
        if abs(w["loss"] - g["loss"]) > TRAIN_LOSS_RTOL * abs(w["loss"]):
            out.append(f"step {w['step']} loss: {w['loss']} != {g['loss']}")
    return out


def expected_train_launches(case, delta: int = 4) -> dict:
    """Kernel launches of a training run (one of ``TRAIN_CASES``, or the
    like with Δ = ``delta``): per merge, B.1 and the clock chain twice
    (the write and the read batch), B.2 once for the causal levels; no
    merge ever with one pod."""
    level, pods, steps, kw = case
    period = 1 if level in ("ALL", "TWO", "QUORUM", "CAUSAL") else delta
    merges = steps // period if pods > 1 else 0
    causal = level in ("CAUSAL", "TCC", "X_STCC")
    return {"op_ingest": 2 * merges, "vclock_chain": 2 * merges,
            "vclock_audit": merges if causal else 0}


# The families' training check: each reduced configuration of
# ``FAMILY_ARCHS`` in ``Trainer`` under X_STCC with Δ = 2 and int8
# compression, 2 pods, 4 steps, a global batch of 4 x 16 tokens (16 fits
# the hybrid's 16-token and the SSM's 128-token chunks and follows the
# VLM's 8-position image prefix).
FAMILY_TRAIN_CASE = ("X_STCC", 2, 4, {"compress_inter_pod": "int8"})
FAMILY_TRAIN = dict(delta=2, seq=16, global_batch=4, lr=1e-3, warmup_steps=2,
                    total_steps=8)


def family_trainer(arch: str, device, **over):
    """The port's ``Trainer`` for the reduced ``arch`` (config overrides
    ``over``) under ``FAMILY_TRAIN_CASE``; every step logged."""
    from repro_torch import configs
    from repro_torch.core import policy_for
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    level, pods, steps, kw = FAMILY_TRAIN_CASE
    t = FAMILY_TRAIN
    cfg = configs.reduced(configs.get_config(arch), **over)
    return Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                                   global_batch=t["global_batch"]),
                   AdamWConfig(lr=t["lr"], warmup_steps=t["warmup_steps"],
                               total_steps=t["total_steps"]),
                   policy_for(level, delta_steps=t["delta"], **kw),
                   TrainerConfig(n_steps=steps, n_pods=pods, log_every=1),
                   device=device)


# The one-device mesh check: reduced qwen2-7b's ``sync_step`` under
# ``use_mesh`` of a (1, 1) mesh against the same steps with no mesh, bit
# for bit (``chip_smoke.py``'s mesh phase and the gpu test): X_STCC, 2
# pods, a merge at each of 4 steps.
MESH_STEP_CASE = ("X_STCC", 2, 4, {})


def mesh_sync_steps(device, params, mesh=None, placed: bool = False
                    ) -> tuple[list[dict], object]:
    """``MESH_STEP_CASE``'s trainer started from ``params`` (one pod's
    tree) taking ``sync_step`` at every step, under ``use_mesh(mesh)``
    when ``mesh`` is given (with ``placed``, on the state ``init_state``
    places on it: DTensor leaves): each step's metrics (tensors as numpy)
    and the final state."""
    import contextlib

    from repro_torch.models import sharding

    trainer = port_trainer(MESH_STEP_CASE, device)
    with sharding.use_mesh(mesh if placed else None):
        state = trainer.init_state(params)
    steps = []
    with sharding.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for step in range(MESH_STEP_CASE[2]):
            state, metrics = trainer.fns.sync_step(state, trainer.batch_for(step))
            steps.append({k: as_np(v) for k, v in metrics.items()})
    return steps, state


def mesh_step_launches() -> dict:
    """The kernels ``mesh_sync_steps`` launches: per merge B.1 and the
    chain twice, B.2 once."""
    n = MESH_STEP_CASE[2]
    return {"op_ingest": 2 * n, "vclock_chain": 2 * n, "vclock_audit": n}


def mesh_local_sync(trainer, params, mesh=None) -> tuple[list[dict], object]:
    """``trainer``'s local step then its sync step from ``params`` (one
    pod's tree) on the batches ``batch_for`` gives (with their frames or
    image prefix), on the state ``init_state`` places on ``mesh`` (DTensor
    leaves) when it is given: each step's metrics (tensors as numpy) and
    the final state."""
    from repro_torch.models import sharding

    steps = []
    with sharding.use_mesh(mesh):
        state = trainer.init_state(params)
        for step, fn in enumerate((trainer.fns.local_step, trainer.fns.sync_step)):
            state, metrics = fn(state, trainer.batch_for(step))
            steps.append({k: as_np(v) for k, v in metrics.items()})
    return steps, state


def state_trees(state) -> dict:
    """A training state's tensor trees by name: the parameters, AdamW's
    moments, the compression anchor and residual (those it has)."""
    trees = {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu,
             "anchor": state.sync.anchor, "residual": state.sync.residual}
    return {k: v for k, v in trees.items() if v is not None}


def whole_cpu(x) -> torch.Tensor:
    """A tensor, or a DTensor made whole, on the host."""
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).cpu()


def mesh_step_mismatches(want, got) -> list[str]:
    """Where two ``mesh_sync_steps`` runs differ, bit for bit: every
    metric of every step, the parameters, moments, compression state
    (DTensors made whole) and the sync bookkeeping."""
    from repro_torch.tree import items

    (m_want, s_want), (m_got, s_got) = want, got
    out = [f"step {i} {k}" for i, (a, b) in enumerate(zip(m_want, m_got)) for k in a
           if not np.array_equal(a[k], b[k])]
    trees_want, trees_got = state_trees(s_want), state_trees(s_got)
    if sorted(trees_want) != sorted(trees_got):
        return out + ["state trees"]
    for name, tree in trees_want.items():
        out += [f"{name}/{p}" for (p, a), (_, b) in zip(items(tree), items(trees_got[name]))
                if not torch.equal(whole_cpu(a), whole_cpu(b))]
    return out + record_mismatches(sync_record(s_want.sync), sync_record(s_got.sync))
