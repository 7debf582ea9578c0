"""Batched serving engine with session-guarantee-aware replica routing
(port of ``repro.serve.engine``).

Serving replicas (pods) each hold a parameter snapshot at some version;
request *sessions* must see monotonically fresh models (MR) and their own
effects (RYW).  The router is the X-STCC client-side check: a replica is
admissible for a session iff its version is at least the session's
floor; weaker levels skip the check, and stale serves become observable.

All floor and version bookkeeping lives in a
:class:`repro_torch.core.replicated_store.ReplicatedStore` on the device
(replicas = snapshot servers, clients = sessions, one resource = the
model): publishes are ``install``\\ s, serves are batched session reads,
and :meth:`ServingEngine.route_batch` runs the admission check through
the ``session_floor`` kernel.  Routing decisions stay on the host in
numpy, as in the reference: the freshest live replica breaks ties to the
lowest index, and the geo argmins to the first.  A batch brings its
admission and its read results to the host once each.

Consistency is per session: the engine's ``level`` is the default, and
:meth:`ServingEngine.set_session_level` or an attached
:class:`repro_torch.policy.controller.AdaptiveController`
(:meth:`~ServingEngine.attach_controller` /
:meth:`~ServingEngine.adapt_sessions`) moves sessions between levels
while they share the one store.

The engine holds no model code: :meth:`~ServingEngine.prefill` and
:meth:`~ServingEngine.decode` call the caller's ``model.prefill(params,
batch)`` and ``model.decode_step(params, cache, tokens)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.core.replicated_store import ReplicatedStore
from repro_torch.device import resolve_device
from repro_torch.models import sharding
from repro_torch.obs.metrics import HostHistogram


@dataclasses.dataclass
class ServeSession:
    session_id: int
    read_floor: int = 0  # min model version this session may observe


@dataclasses.dataclass
class ReplicaSnapshot:
    params: Any
    version: int


class RoutingError(RuntimeError):
    """No replica can take the request: none published, none live, or
    none fresh enough for the session's floor.  The only failure that
    :meth:`ServingEngine.serve_with_retry` backs off and retries; any
    other error (a failed kernel launch among them) propagates."""


class ServeTimeout(RuntimeError):
    """A request exhausted its retry/backoff budget without a serve."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Client-side retry/timeout/backoff contract for routed serves.

    A request that cannot be admitted (no live replica, or none fresh
    enough for the session's floor) waits out a jittered exponential
    backoff and retries, up to ``max_retries`` attempts or until the
    cumulative simulated wait would pass ``timeout_ms``.  When the budget
    runs out, ``degrade=True`` admits the request once on the freshest
    live replica with floor enforcement off, and ``degrade=False``
    raises :class:`ServeTimeout`.  Waits are simulated (summed in the
    engine's ``retry_wait_ms``, never slept), and the jitter comes from
    ``np.random.default_rng(seed + session_id)``, as in the reference.
    """

    max_retries: int = 3
    base_backoff_ms: float = 5.0
    backoff_mult: float = 2.0
    jitter: float = 0.5
    timeout_ms: float = 1000.0
    degrade: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.base_backoff_ms <= 0 or self.backoff_mult < 1.0:
            raise ValueError("base_backoff_ms must be > 0 and backoff_mult >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def backoff_ms(self, attempt: int, rng: np.random.Generator) -> float:
        """The jittered wait before retry ``attempt`` (0-indexed)."""
        base = self.base_backoff_ms * self.backoff_mult ** attempt
        if self.jitter:
            base *= 1.0 + self.jitter * float(rng.uniform(-1.0, 1.0))
        return base


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a sequence) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ServingEngine:
    """Routes sessions to snapshot replicas under per-session levels, on
    ``device`` (``"cuda"`` unless the caller asks for the CPU).  ``impl``
    picks the store's kernels (``"auto"``, ``"cuda"`` or ``"torch"``, see
    ``kernels.ops``); an attached controller keeps its own."""

    def __init__(
        self,
        model,
        level: ConsistencyLevel = ConsistencyLevel.X_STCC,
        max_replicas: int = 8,
        max_sessions: int = 64,
        *,
        impl: str = "auto",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model
        self.level = level
        self.replicas: list[ReplicaSnapshot] = []
        self.max_replicas = max_replicas
        self.max_sessions = max_sessions
        self.stale_serves = 0
        self.total_serves = 0
        self.reroutes = 0
        self.failovers = 0
        # Retry/backoff telemetry (serve_with_retry).
        self.retries = 0
        self.timeouts = 0
        self.downgrades = 0
        self.retry_wait_ms = 0.0
        # Vocab-sharded logits gathered for the greedy argmax (SPMD only).
        self.logit_gathers = 0
        # Liveness: a down replica is inadmissible for every session; a
        # rebuilding one is reachable but serves nothing.
        self.replica_up = np.ones(max_replicas, bool)
        self.replica_rebuilding = np.zeros(max_replicas, bool)
        # Region-aware routing (set_topology).
        self._topology = None
        self._session_region: np.ndarray | None = None
        self._rtt_np: np.ndarray | None = None
        self._replica_region_np: np.ndarray | None = None
        self._region_stale: np.ndarray | None = None
        self._region_serves: np.ndarray | None = None
        self._region_lat_ms: np.ndarray | None = None
        self._region_hist: list[HostHistogram] | None = None
        # Per-session level overrides and serve telemetry since the last
        # controller consultation.
        self.session_levels: dict[int, ConsistencyLevel] = {}
        self._sess_stale = np.zeros(max_sessions, np.int64)
        self._sess_viol = np.zeros(max_sessions, np.int64)
        self._sess_serves = np.zeros(max_sessions, np.int64)
        self._controller = None
        self._ctl_state = None
        self._ctl_gen: torch.Generator | None = None
        self._ctl_draws = None
        self._ctl_epoch = 0
        self._store = ReplicatedStore(
            max_replicas, max_sessions, 1, level=level, pending_cap=max_sessions,
            ingest=impl, device=self.device,
        )
        self._st = self._store.init()
        self._prefill = model.prefill
        self._decode = model.decode_step

    def _sid(self, session: ServeSession) -> int:
        if session.session_id < 0:
            # A negative id would wrap onto another session's floor.
            raise ValueError(f"session_id {session.session_id} < 0")
        if session.session_id >= self.max_sessions:
            # Aliasing would make colliding sessions share one floor.
            raise RuntimeError(
                f"session_id {session.session_id} >= max_sessions "
                f"{self.max_sessions}; raise max_sessions"
            )
        return session.session_id

    def _i32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).to(torch.int32)

    # -- replica management -----------------------------------------------------

    def publish(self, params, version: int, replica: int | None = None):
        """Install a parameter snapshot on one replica (or append new)."""
        snap = ReplicaSnapshot(params=params, version=version)
        if replica is None or replica >= len(self.replicas):
            if len(self.replicas) >= self.max_replicas:
                raise RuntimeError(
                    f"more than max_replicas={self.max_replicas} replicas"
                )
            self.replicas.append(snap)
            replica = len(self.replicas) - 1
        else:
            self.replicas[replica] = snap
        self._st = self._store.install(self._st, replica=replica, resource=0,
                                       version=version)

    def publish_everywhere(self, params, version: int):
        for r in range(len(self.replicas)):
            self.replicas[r] = ReplicaSnapshot(params, version)
            self._st = self._store.install(self._st, replica=r, resource=0,
                                           version=version)

    @property
    def latest_version(self) -> int:
        return max((r.version for r in self.replicas), default=0)

    # -- replica health -----------------------------------------------------------

    def set_replica_health(self, health) -> None:
        """Drive the liveness mask from a health source: an object with
        an ``alive()`` vector, or a boolean sequence of per-replica
        liveness."""
        if hasattr(health, "alive"):
            health = health.alive()
        up = np.asarray(health, bool)
        if up.shape[0] > self.max_replicas:
            raise ValueError(
                f"health covers {up.shape[0]} replicas, engine has "
                f"max_replicas={self.max_replicas}"
            )
        self.replica_up[: up.shape[0]] = up

    def fail_replica(self, replica: int) -> None:
        self.replica_up[replica] = False

    def heal_replica(self, replica: int) -> None:
        self.replica_up[replica] = True

    def mark_rebuilding(self, replica: int) -> None:
        """Take a replica out of serving while it restores: requests that
        target it fail over as a down replica's would."""
        self.replica_rebuilding[replica] = True

    def finish_rebuilding(self, replica: int) -> None:
        """Re-admit a rebuilt replica into serving."""
        self.replica_rebuilding[replica] = False

    def _up(self) -> np.ndarray:
        """Serving-admissible mask: live and not mid-rebuild."""
        n = len(self.replicas)
        up = self.replica_up[:n] & ~self.replica_rebuilding[:n]
        if not up.any():
            raise RoutingError("no live replica to serve from")
        return up

    # -- region-aware routing -------------------------------------------------------

    def set_topology(self, topology, session_region=None) -> None:
        """Make routing region-aware.

        ``topology`` is a :class:`repro_torch.geo.topology.RegionTopology`
        covering this engine's replica slots; ``session_region`` pins
        sessions to regions (default: the topology's client-population
        assignment).  A session's default target becomes the nearest
        replica by RTT, reroutes prefer the nearest admissible replica,
        and per-region latency/staleness telemetry accumulates
        (:meth:`region_stats`).
        """
        if topology.n_replicas < self.max_replicas:
            raise ValueError(
                f"topology places {topology.n_replicas} replicas, engine "
                f"has max_replicas={self.max_replicas}"
            )
        if session_region is None:
            reg = topology.client_region_of(np.arange(self.max_sessions))
        else:
            reg = np.asarray(session_region, np.int32)
            if reg.shape[0] != self.max_sessions:
                raise ValueError(
                    f"session_region covers {reg.shape[0]} sessions, "
                    f"engine has {self.max_sessions}"
                )
        self._topology = topology
        self._session_region = reg.astype(np.int32)
        self._rtt_np = np.asarray(topology.rtt_ms, np.float64)
        self._replica_region_np = topology.regions()
        g = topology.n_regions
        self._region_stale = np.zeros(g, np.int64)
        self._region_serves = np.zeros(g, np.int64)
        self._region_lat_ms = np.zeros(g, np.float64)
        # RTTs are bounded by the matrix, so the top bin saturates only
        # if the topology is later mutated.
        lat_hi = max(1.0, float(self._rtt_np.max()) * 1.5)
        self._region_hist = [HostHistogram(0.0, lat_hi) for _ in range(g)]

    def _geo_rtts(self, session_ids, n: int) -> np.ndarray:
        """(B, n) RTT from each session's region to replicas ``0..n-1``."""
        sregs = self._session_region[np.asarray(session_ids, np.int64)]
        return self._rtt_np[sregs][:, self._replica_region_np[:n]]

    def _geo_preferred(self, session_id: int, n: int) -> int:
        """Nearest replica by RTT, liveness-ignorant: a down nearest
        replica counts as a failover before routing moves on."""
        return int(np.argmin(self._geo_rtts([session_id], n)[0]))

    def _geo_failover(self, session_id: int, up: np.ndarray) -> int:
        """Nearest *live* replica by RTT from the session's region."""
        rtts = self._geo_rtts([session_id], up.shape[0])[0]
        return int(np.argmin(np.where(up, rtts, np.inf)))

    def _geo_reroute(self, session_id: int, floor: int, up: np.ndarray) -> int:
        """Nearest live *admissible* replica; freshest live fallback."""
        versions = np.asarray([r.version for r in self.replicas])
        adm = up & (versions >= floor)
        if not adm.any():
            return _freshest_replica(self.replicas, up)
        rtts = self._geo_rtts([session_id], up.shape[0])[0]
        return int(np.argmin(np.where(adm, rtts, np.inf)))

    def _note_serve(self, session_id: int, replica: int, stale: int) -> None:
        """Per-region serve telemetry (no-op without a topology)."""
        if self._topology is None:
            return
        sreg = int(self._session_region[session_id])
        rreg = int(self._replica_region_np[replica])
        self._region_serves[sreg] += 1
        self._region_stale[sreg] += stale
        lat = float(self._rtt_np[sreg, rreg])
        self._region_lat_ms[sreg] += lat
        self._region_hist[sreg].observe([lat])

    def region_stats(self) -> dict[str, list[float]]:
        """Per-region serving telemetry (requires :meth:`set_topology`):
        serves, stale serves, their rate, mean RTT latency and the p50/p99
        of per-region fixed-bin latency histograms."""
        if self._topology is None:
            raise RuntimeError("no topology set (call set_topology)")
        serves = np.maximum(1, self._region_serves)
        return {
            "serves": self._region_serves.tolist(),
            "stale": self._region_stale.tolist(),
            "staleness_rate": (self._region_stale / serves).tolist(),
            "mean_latency_ms": (self._region_lat_ms / serves).tolist(),
            "p50_latency_ms": [h.percentile(50) for h in self._region_hist],
            "p99_latency_ms": [h.percentile(99) for h in self._region_hist],
        }

    # -- per-session consistency ---------------------------------------------------

    def level_for(self, session_id: int) -> ConsistencyLevel:
        """The session's effective consistency level (default: engine's)."""
        return self.session_levels.get(session_id, self.level)

    def set_session_level(self, session_id: int, level: ConsistencyLevel):
        """Move one session to a different consistency level online."""
        if session_id >= self.max_sessions:
            raise RuntimeError(
                f"session_id {session_id} >= max_sessions {self.max_sessions}"
            )
        self.session_levels[session_id] = level

    def attach_controller(self, controller, seed: int = 0, draws=None):
        """Hand per-session level selection to an adaptive controller.

        ``controller`` is a :class:`repro_torch.policy.controller.
        AdaptiveController` sized to ``max_sessions``; call
        :meth:`adapt_sessions` once per serving epoch.  Exploration draws
        come from ``draws = (explore_u, arm)``, each (E, S), one row per
        epoch, or, when omitted, from a CPU ``torch.Generator`` seeded with
        ``seed`` (the reference's ``jax.random`` key chain cannot be
        reproduced; tests inject its draws).
        """
        if controller.n_sessions != self.max_sessions:
            raise ValueError(
                f"controller sized for {controller.n_sessions} sessions, "
                f"engine has {self.max_sessions}"
            )
        if self.level not in controller.levels:
            raise ValueError(
                f"engine default level {self.level} not among controller "
                f"levels {controller.levels}"
            )
        self._controller = controller
        self._ctl_state = controller.init()
        self._ctl_gen = torch.Generator(device="cpu").manual_seed(int(seed))
        self._ctl_draws = None if draws is None else (
            torch.as_tensor(_host(draws[0])).to(torch.float32),
            torch.as_tensor(_host(draws[1])).to(torch.int32))
        self._ctl_epoch = 0

    def _next_draws(self) -> tuple[torch.Tensor, torch.Tensor]:
        ctl = self._controller
        if self._ctl_draws is None:
            u = torch.rand((ctl.n_sessions,), generator=self._ctl_gen,
                           dtype=torch.float32)
            arm = torch.randint(0, ctl.n_levels, (ctl.n_sessions,),
                                generator=self._ctl_gen, dtype=torch.int32)
        else:
            t = self._ctl_epoch
            if t >= self._ctl_draws[0].shape[0]:
                raise ValueError(f"draws cover {t} epochs; epoch {t} has none")
            u, arm = self._ctl_draws[0][t], self._ctl_draws[1][t]
        self._ctl_epoch += 1
        return u.to(ctl.device), arm.to(ctl.device)

    def adapt_sessions(self) -> dict[int, ConsistencyLevel]:
        """One control-plane epoch: fold the serve telemetry into the
        controller and re-select every session's level.  Serving is
        read-only, so ``read_frac`` is 1 and the violation telemetry is
        unguarded sessions reading below their floor.  Returns the new
        assignment."""
        if self._controller is None:
            raise RuntimeError("no controller attached")
        ctl = self._controller
        idx_list = []
        for s in range(self.max_sessions):
            lv = self.level_for(s)
            if lv not in ctl.levels:
                raise RuntimeError(
                    f"session {s} is at level {lv.value}, which is not "
                    f"among the controller's levels "
                    f"{[l.value for l in ctl.levels]}; use "
                    "set_session_level with a controller level (or a "
                    "controller whose level set covers it)"
                )
            idx_list.append(ctl.levels.index(lv))

        def f32(x):
            return torch.as_tensor(x, device=ctl.device).to(torch.float32)

        self._ctl_state = ctl.observe(
            self._ctl_state,
            level_idx=torch.as_tensor(idx_list, dtype=torch.int32, device=ctl.device),
            stale=f32(self._sess_stale), viol=f32(self._sess_viol),
            reads=f32(self._sess_serves),
        )
        u, arm = self._next_draws()
        choice = ctl.select(self._ctl_state, u, arm, read_frac=1.0).cpu().tolist()
        self._sess_stale[:] = 0
        self._sess_viol[:] = 0
        self._sess_serves[:] = 0
        for sid in range(self.max_sessions):
            self.session_levels[sid] = ctl.levels[choice[sid]]
        return dict(self.session_levels)

    # -- routing ------------------------------------------------------------------

    def session_floor(self, session: ServeSession) -> int:
        """MR/RYW floor: store-tracked, joined with any external floor."""
        floor = int(self._store.session_floor(self._st, self._sid(session), 0))
        return max(floor, session.read_floor)

    def route(self, session: ServeSession, preferred: int | None = None) -> int:
        """Pick a replica for this session per *its* consistency level.

        A down replica is inadmissible for every level: the request
        fails over (to the nearest live replica with a topology, else the
        freshest live one), counted in ``failovers`` and ``reroutes``;
        the session floor is then checked against the failover target.
        """
        n = len(self.replicas)
        if n == 0:
            raise RoutingError("no replicas published")
        up = self._up()
        if preferred is not None:
            idx = preferred % n
        elif self._topology is not None:
            idx = self._geo_preferred(session.session_id, n)
        else:
            idx = session.session_id % n
        failed_over = not up[idx]
        if failed_over:
            idx = (self._geo_failover(session.session_id, up)
                   if self._topology is not None
                   else _freshest_replica(self.replicas, up))
            self.failovers += 1
            self.reroutes += 1
        if self.level_for(session.session_id).is_session_guarded:
            floor = self.session_floor(session)
            if self.replicas[idx].version < floor:
                best = (self._geo_reroute(session.session_id, floor, up)
                        if self._topology is not None
                        else _freshest_replica(self.replicas, up))
                if self.replicas[best].version < floor:
                    raise RoutingError("no admissible replica for session")
                # A down and inadmissible serve counts one reroute.
                if not failed_over:
                    self.reroutes += 1
                idx = best
        return idx

    def serve_with_retry(
        self,
        session: ServeSession,
        preferred: int | None = None,
        policy: RetryPolicy | None = None,
    ) -> int:
        """Route and observe one serve under a retry/backoff policy.

        An inadmissible request backs off per ``policy`` and retries; when
        the budget or ``timeout_ms`` runs out, ``policy.degrade`` admits it
        once on the freshest live replica with floor enforcement off
        (``downgrades``), else it fails with :class:`ServeTimeout`
        (``timeouts``).  Returns the replica that served.
        """
        if policy is None:
            policy = RetryPolicy()
        rng = np.random.default_rng(policy.seed + self._sid(session))
        waited = 0.0
        last_err: RoutingError | None = None
        for attempt in range(policy.max_retries + 1):
            try:
                r = self.route(session, preferred)
                self._observe(session, r)
                return r
            except RoutingError as e:
                last_err = e
            if attempt >= policy.max_retries:
                break
            wait = policy.backoff_ms(attempt, rng)
            if waited + wait > policy.timeout_ms:
                break
            waited += wait
            self.retries += 1
            self.retry_wait_ms += wait
        if policy.degrade:
            n = len(self.replicas)
            live = self.replica_up[:n] & ~self.replica_rebuilding[:n]
            if n and live.any():
                r = _freshest_replica(self.replicas, live)
                self.downgrades += 1
                self._observe(session, r, enforce=False)
                return r
        self.timeouts += 1
        raise ServeTimeout(
            f"session {session.session_id}: no admissible replica after "
            f"{policy.max_retries} retries ({waited:.1f} ms backoff)"
        ) from last_err

    def route_batch(self, sessions: list[ServeSession],
                    preferred=None) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized admission check for a batch of sessions.

        Routes every session to its preferred replica, runs the batched
        session-floor admission check (``ReplicatedStore.session_check``,
        one kernel on the card), reroutes inadmissible *guarded* sessions
        (unguarded ones take the stale serve, counted as their violation
        telemetry), fails sessions whose preferred replica is down over,
        and registers the serves in the store.  Returns ``(replica,
        served_version)``, (B,) int32 numpy arrays.
        """
        n = len(self.replicas)
        if n == 0:
            raise RoutingError("no replicas published")
        up = self._up()
        sid = np.asarray([self._sid(s) for s in sessions], np.int64)
        geo_rtts = self._geo_rtts(sid, n) if self._topology is not None else None
        if preferred is None:
            if geo_rtts is not None:
                # Nearest replica by RTT, liveness-ignorant: a down
                # nearest replica counts as a failover below.
                preferred = np.argmin(geo_rtts, axis=1)
            else:
                preferred = np.asarray([s.session_id % n for s in sessions])
        preferred = _host(preferred).astype(np.int64) % n
        guarded = np.asarray(
            [self.level_for(s.session_id).is_session_guarded for s in sessions],
            bool)
        alive = up[preferred]
        best = _freshest_replica(self.replicas, up)
        if guarded.any():
            # Admission against the store-tracked floors, without the
            # floor update: floors are committed by the observe read
            # below, once rerouting has decided where each session reads.
            # One copy of the (2, B) index in, one of [admissible, floor]
            # out.
            adm, floor = self._store.session_check(
                self._st, np.stack([sid, preferred]).astype(np.int32)).cpu().numpy()
            adm = adm.astype(bool)
            # Join with any externally set session floor (route() parity).
            ext = np.asarray([s.read_floor for s in sessions], np.int64)
            versions = np.asarray([r.version for r in self.replicas], np.int64)
            adm = (adm & (versions[preferred] >= ext)) | ~guarded
            ok = adm & alive
            floor = np.maximum(floor.astype(np.int64), ext)
            if geo_rtts is not None:
                # Per-session target: nearest live admissible replica
                # (freshest live when none admits); unguarded sessions
                # ignore floors and take the nearest live replica, as
                # route() does.
                adm_at = up[None, :] & (versions[None, :] >= floor[:, None])
                adm_at = np.where(guarded[:, None], adm_at, up[None, :])
                best = np.where(
                    adm_at.any(axis=1),
                    np.argmin(np.where(adm_at, geo_rtts, np.inf), axis=1),
                    best,
                )
            if np.any(guarded & ~ok & (versions[best] < floor)):
                raise RoutingError("no admissible replica for session")
        else:
            ok = alive
            if geo_rtts is not None:
                best = np.argmin(np.where(up[None, :n], geo_rtts, np.inf), axis=1)
        replica = np.where(ok, preferred, best).astype(np.int32)
        self.reroutes += int(np.sum(~ok))
        self.failovers += int(np.sum(~alive))
        served = self._observe_batch(sessions, replica, guarded)
        return replica, served

    def _observe_batch(self, sessions: list[ServeSession], replica,
                       guarded: np.ndarray | None = None) -> np.ndarray:
        sid = np.asarray([self._sid(s) for s in sessions], np.int64)
        if guarded is None:
            guarded = np.asarray(
                [self.level_for(s.session_id).is_session_guarded for s in sessions],
                bool)
        replica = np.asarray(replica, np.int64)
        sid_t = self._i32(sid)
        self._st, res = self._store.read_batch(
            self._st, client=sid_t, replica=self._i32(replica),
            resource=torch.zeros_like(sid_t), record=False,
            enforce=torch.as_tensor(guarded, device=self.device),
        )
        # One host transfer for the whole batch.
        version, stale, viol = torch.stack(
            [res.version, res.stale.to(torch.int32), res.violation.to(torch.int32)]
        ).cpu().numpy()
        self.total_serves += len(sessions)
        self.stale_serves += int(stale.sum())
        np.add.at(self._sess_stale, sid, stale)
        np.add.at(self._sess_viol, sid, viol)
        np.add.at(self._sess_serves, sid, 1)
        if self._topology is not None:
            sregs = self._session_region[sid]
            rregs = self._replica_region_np[replica]
            lat = self._rtt_np[sregs, rregs]
            np.add.at(self._region_serves, sregs, 1)
            np.add.at(self._region_stale, sregs, stale.astype(np.int64))
            np.add.at(self._region_lat_ms, sregs, lat)
            for g in np.unique(sregs):
                self._region_hist[g].observe(lat[sregs == g])
        for s, v in zip(sessions, version.tolist()):
            s.read_floor = max(s.read_floor, v)
        return version

    def _observe(self, session: ServeSession, replica: int,
                 enforce: bool | None = None) -> None:
        # Telemetry comes from the store's read result, the same source
        # as _observe_batch.  ``enforce`` overrides the session level's
        # guard (the degraded-admission path serves guarded sessions
        # unguarded).
        if enforce is None:
            enforce = self.level_for(session.session_id).is_session_guarded
        sid = self._sid(session)
        self._st, res = self._store.read_batch(
            self._st, client=self._i32([sid]), replica=self._i32([replica]),
            resource=self._i32([0]), record=False, enforce=enforce,
        )
        version, stale, viol = torch.stack(
            [res.version, res.stale.to(torch.int32), res.violation.to(torch.int32)]
        )[:, 0].tolist()
        self.total_serves += 1
        self.stale_serves += stale
        self._sess_stale[sid] += stale
        self._sess_viol[sid] += viol
        self._sess_serves[sid] += 1
        self._note_serve(sid, replica, stale)
        session.read_floor = max(session.read_floor, version)

    # -- compute ---------------------------------------------------------------

    def prefill(self, session: ServeSession, batch: dict,
                preferred: int | None = None):
        r = self.route(session, preferred)
        self._observe(session, r)
        logits, cache = self._prefill(self.replicas[r].params, batch)
        return logits, cache, r

    def decode(self, session: ServeSession, cache, tokens, replica: int):
        """Decode continues on the session's bound replica (KV-cache
        affinity); floors were checked at prefill.  A decode step is not a
        routed serve and never counts toward ``total_serves``."""
        return self._decode(self.replicas[replica].params, cache, tokens)

    def generate(self, session: ServeSession, batch: dict, n_tokens: int,
                 preferred: int | None = None):
        """Greedy generation: prefill, then ``n_tokens - 1`` decode steps
        on the bound replica.  Returns ``(tokens (B, n_tokens) int32,
        replica)``."""
        logits, cache, r = self.prefill(session, batch, preferred)
        tok = self._greedy(logits)
        out = [tok]
        for _ in range(n_tokens - 1):
            logits, cache = self.decode(session, cache, tok, r)
            tok = self._greedy(logits)
            out.append(tok)
        return torch.cat(out, dim=1), r

    def _greedy(self, logits):
        """(B, 1) int32 argmax of the last position.  Vocab-sharded DTensor
        logits (SPMD on a ``DeviceMesh``) are gathered first, once per
        token (``logit_gathers``)."""
        last = logits[:, -1]
        if sharding.is_dtensor(last):
            last = last.full_tensor()
            self.logit_gathers += 1
        return torch.argmax(last, dim=-1)[:, None].to(torch.int32)

    # -- metrics -----------------------------------------------------------------

    def staleness_rate(self) -> float:
        return self.stale_serves / max(1, self.total_serves)


def _freshest_replica(replicas: list[ReplicaSnapshot],
                      up: np.ndarray | None = None) -> int:
    """Freshest replica (lowest index on ties), restricted to live ones
    when ``up`` is given."""
    live = range(len(replicas)) if up is None else [
        r for r in range(len(replicas)) if up[r]
    ]
    return max(live, key=lambda r: replicas[r].version)


class ShardedServingRouter:
    """Admission front door for multi-tenant serving.

    Partitions the session space into ``n_shards`` disjoint tenant groups
    of ``sessions_per_shard`` sessions; each shard owns a full replicated
    store (snapshot replicas x shard sessions x the one model resource).
    The reference stacks the shards along a vmapped axis; here they are
    a list of stores, one per shard, routed in a loop.  They are never
    folded into one store of ``S * sessions`` clients: a store's session
    clocks and pending ring are O(C^2), which is what sharding avoids.
    Serving is read-only, so the shards share no floor state, and routing
    an (S, B) batch equals routing the concatenated sessions through one
    :class:`ServingEngine`.  Runs on ``device`` (``"cuda"`` unless the
    caller asks for the CPU); ``impl`` as for :class:`ServingEngine`.
    """

    def __init__(
        self,
        n_shards: int,
        sessions_per_shard: int,
        max_replicas: int = 8,
        level: ConsistencyLevel = ConsistencyLevel.X_STCC,
        age_hi: float = 1024.0,
        *,
        impl: str = "auto",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.n_shards = n_shards
        self.sessions_per_shard = sessions_per_shard
        self.max_replicas = max_replicas
        self.level = level
        self._store = ReplicatedStore(
            max_replicas, sessions_per_shard, 1, level=level,
            pending_cap=max(8, sessions_per_shard), ingest=impl, device=self.device,
        )
        self._st = [self._store.init() for _ in range(n_shards)]
        self._versions = np.zeros(max_replicas, np.int64)
        self.replica_up = np.ones(max_replicas, bool)
        self.n_replicas = 0
        self.total_serves = 0
        self.stale_serves = 0
        self.reroutes = 0
        self.failovers = 0
        # Staleness age of every routed serve (latest published version
        # minus served version, in versions).
        self._age_hist = HostHistogram(0.0, float(age_hi))

    def set_replica_health(self, health) -> None:
        """Drive the liveness mask (an object with ``alive()`` or a bool
        vector)."""
        if hasattr(health, "alive"):
            health = health.alive()
        up = np.asarray(health, bool)
        if up.shape[0] > self.max_replicas:
            raise ValueError(
                f"health covers {up.shape[0]} replicas, router has "
                f"max_replicas={self.max_replicas}"
            )
        self.replica_up[: up.shape[0]] = up

    def install(self, replica: int, version: int):
        """Publish a snapshot version on one replica of every shard.
        Replica ids must be dense (install ``0..n`` in order, or overwrite
        one): the routing modulus spans ``n_replicas``."""
        if replica >= self.max_replicas:
            raise RuntimeError(
                f"replica {replica} >= max_replicas {self.max_replicas}"
            )
        if replica > self.n_replicas:
            raise RuntimeError(
                f"replica ids must be dense: install replica "
                f"{self.n_replicas} before {replica}"
            )
        self._st = [self._store.install(st, replica=replica, resource=0,
                                        version=version) for st in self._st]
        self._versions[replica] = max(self._versions[replica], version)
        self.n_replicas = max(self.n_replicas, replica + 1)

    def route(self, session, preferred=None) -> tuple[np.ndarray, np.ndarray]:
        """Route one ``(S, B)`` batch of shard-local session ids.

        Admission against each shard's floors (``session_check``, the
        kernel on the card), reroute of inadmissible sessions to the
        freshest live replica, then the observe read that raises the
        floors.  Returns ``(replica, served)``, (S, B) int32 numpy arrays.
        """
        if self.n_replicas == 0:
            raise RoutingError("no replicas published")
        n = self.n_replicas
        up = self.replica_up[:n]
        if not up.any():
            raise RoutingError("no live replica to serve from")
        sid = _host(session).astype(np.int64)
        if sid.shape[0] != self.n_shards:
            raise ValueError(f"session batch has {sid.shape[0]} shards, router "
                             f"has {self.n_shards}")
        if sid.size and (sid.min() < 0 or sid.max() >= self.sessions_per_shard):
            # The reference lets such ids through, and JAX then clamps
            # their gathers and drops their scatters: one session would
            # read another's floor.  The engine refuses them too.
            raise ValueError(
                f"shard-local session ids must lie in [0, "
                f"{self.sessions_per_shard}), got [{sid.min()}, {sid.max()}]"
            )
        if preferred is None:
            preferred = sid % n
        preferred = _host(preferred).astype(np.int64) % n
        alive = up[preferred]
        # The freshest live replica is the failover and reroute target.
        best = int(np.argmax(np.where(up, self._versions[:n], -1)))

        def i32(x):
            return torch.as_tensor(x, device=self.device).to(torch.int32)

        guarded = self.level.is_session_guarded
        if guarded:
            # Each shard's admission check (no floor update: the observe
            # read below commits the floors), one launch per shard, from
            # one copy of the (shards, 2, B) index in and one copy out.
            index = torch.as_tensor(np.stack([sid, preferred], axis=1).astype(np.int32),
                                    device=self.device)
            out = torch.empty(index.shape, dtype=torch.int32, device=self.device)
            for s in range(self.n_shards):
                self._store.session_check(self._st[s], index[s], out=out[s])
            host = out.cpu().numpy()
            adm, floor = host[:, 0].astype(bool), host[:, 1]
            ok = adm & alive
            if np.any(~ok & (self._versions[best] < floor)):
                raise RoutingError("no admissible replica for session")
            replica = np.where(ok, preferred, best)
            self.reroutes += int(np.sum(~ok))
        else:
            # A failover is a reroute too, as in the unsharded engine.
            replica = np.where(alive, preferred, best)
            self.reroutes += int(np.sum(~alive))
        self.failovers += int(np.sum(~alive))
        rows = []
        for s in range(self.n_shards):
            c = i32(sid[s])
            self._st[s], res = self._store.read_batch(
                self._st[s], client=c, replica=i32(replica[s]),
                resource=torch.zeros_like(c), record=False, enforce=guarded)
            rows += [res.version, res.stale.to(torch.int32)]
        host = torch.stack(rows).cpu().numpy().reshape(self.n_shards, 2, -1)
        version, stale = host[:, 0], host[:, 1]
        self.total_serves += int(sid.size)
        self.stale_serves += int(stale.sum())
        ages = self._versions[:n].max() - version.astype(np.int64)
        self._age_hist.observe(np.maximum(ages, 0).ravel())
        return replica.astype(np.int32), version

    def age_stats(self) -> dict[str, float]:
        """Staleness-age distribution of every serve routed so far: p50
        and p99 of how many published versions the served snapshot lagged
        the freshest replica."""
        return {
            "serves": int(self._age_hist.count),
            "p50_age": self._age_hist.percentile(50),
            "p99_age": self._age_hist.percentile(99),
        }

    def staleness_rate(self) -> float:
        return self.stale_serves / max(1, self.total_serves)
