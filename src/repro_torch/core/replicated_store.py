"""ReplicatedStore — the replicated-state facade (port of
``repro.core.replicated_store``).

  * **state**     — :class:`StoreState` bundles the protocol cluster, the
    DUOT op log and the pending ring's emulated apply points;
  * **batch ops** — :meth:`ReplicatedStore.apply_batch` ingests ``(B,)``
    op tensors through :func:`repro_torch.core.xstcc.apply_op_batch` and
    registers them in the DUOT;
  * **merge cadence** — :func:`merge_cadence` maps a consistency level
    to its (sync period, Δ) pair, :meth:`ReplicatedStore.schedule_stream`
    replays the sequential merge schedule in op-index space, and
    :meth:`ReplicatedStore.merge` runs the timed-causal propagation step;
  * **faults**    — masked :meth:`~ReplicatedStore.merge`,
    :meth:`~ReplicatedStore.merge_faulty` and the clock-neutral
    :meth:`~ReplicatedStore.anti_entropy`;
  * **gossip / hinted handoff** — :meth:`~ReplicatedStore.gossip_round`
    (digest diff + range-restricted repair merges),
    :meth:`~ReplicatedStore.enqueue_hints` /
    :meth:`~ReplicatedStore.drain_hints` over :class:`HintState`;
  * **durability / crash recovery** — :class:`DurabilityConfig`,
    :class:`DuraState`, :meth:`~ReplicatedStore.snapshot`,
    :meth:`~ReplicatedStore.wal_append`, :meth:`~ReplicatedStore.crash`
    and the peer :meth:`~ReplicatedStore.bootstrap`;
  * **serving**   — :meth:`~ReplicatedStore.install`,
    :meth:`~ReplicatedStore.read_batch` / :meth:`~ReplicatedStore.write_batch`,
    :meth:`~ReplicatedStore.session_floor`, the batched admission
    check :meth:`~ReplicatedStore.admit_batch` (``kernels.ops.session_admit``)
    and the routers' check alone, :meth:`~ReplicatedStore.session_check`
    (``kernels.ops.session_check``);
  * **audit / GC** — :meth:`ReplicatedStore.audit`,
    :meth:`~ReplicatedStore.gc` and
    :meth:`~ReplicatedStore.stability_frontier`;
  * **sharding**  — :class:`ShardedStore`: S disjoint stores, their
    states stacked along a leading ``(S, …)`` axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import audit as audit_lib
from repro_torch.core import duot as duot_lib
from repro_torch.core import xstcc
from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.device import resolve_device
from repro_torch.gossip import digest as digest_lib
from repro_torch.kernels import ops as kernel_ops


def merge_cadence(
    level: ConsistencyLevel, merge_every: int, delta: int
) -> tuple[int, int]:
    """(sync_every, effective Δ) for a level.

    Synchronous levels (ALL/TWO/QUORUM) propagate on every op with no
    timed slack; ONE gossips on a slow cadence with an unbounded (large)
    Δ; CAUSAL merges on the normal cadence but is not timed; the timed
    levels (TCC/X-STCC) are forced prompt by the Δ bound.
    """
    if level in (
        ConsistencyLevel.ALL,
        ConsistencyLevel.TWO,
        ConsistencyLevel.QUORUM,
    ):
        return 1, 0
    if level is ConsistencyLevel.ONE:
        return 2 * merge_every, 4 * delta
    if level is ConsistencyLevel.CAUSAL:
        return merge_every, 4 * delta
    return merge_every, max(1, delta // 3)


_BIG = 2 ** 30  # "never" sentinel for the cadence emulator


def _timed_index(op_step: np.ndarray, s: int, d: int) -> np.ndarray:
    """Op index at which a write issued at ``op_step`` is Δ-overdue.

    Merges run after ops ``k*s - 1``, the logical clock at op ``g`` is
    ``g + g//s``, and the timed bound applies a write at the first merge
    whose clock exceeds the write's commit clock by Δ (int32 math)."""
    g = np.asarray(op_step, np.int32)
    cs = g + g // s
    k_timed = (d + cs + 1 + s) // (s + 1)     # ceil((d+cs+1)/(s+1))
    k_after = (g + s) // s                    # ceil((g+1)/s)
    return (np.maximum(k_timed, k_after) * s).astype(np.int32)


def schedule_apply_points(
    client: np.ndarray, replica: np.ndarray, kind: np.ndarray, *,
    sync_every: int, delta: int, n_clients: int, n_replicas: int,
) -> np.ndarray:
    """Emulated sequential apply op-index of every write of a stream.

    ``A(w) = min(timed(w), max(boundary_after(w), A(prev same-client
    op), max A over earlier same-coordinator writes))``; a read resets
    its session's carry to the ``_BIG`` sentinel, and reads get
    ``_BIG``.  The reference runs this as a ``lax.scan``; it is serial
    over the stream and computed once per run, so here it is a host
    loop over Python ints with the same int32 values.
    """
    n = len(client)
    g = np.arange(n, dtype=np.int32)
    base = ((g // sync_every + 1) * sync_every).tolist()
    timed = _timed_index(g, sync_every, delta).tolist()
    cl = np.asarray(client).tolist()
    pl = np.asarray(replica).tolist()
    wl = (np.asarray(kind) == xstcc.WRITE).tolist()
    last_a = [0] * n_clients
    rep_a = [0] * n_replicas
    out = [_BIG] * n
    for i in range(n):
        ci = cl[i]
        if wl[i]:
            pi = pl[i]
            a_w = min(timed[i], max(base[i], last_a[ci], rep_a[pi]))
            last_a[ci] = a_w
            if a_w > rep_a[pi]:
                rep_a[pi] = a_w
            out[i] = a_w
        else:
            last_a[ci] = _BIG
    return np.asarray(out, np.int32)


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """Static durability knobs.

    ``snapshot_every`` merge epochs between snapshot markers (0 = no
    snapshots); ``wal`` additionally journals every applied delta
    between markers, so a crashed replica restores its exact pre-crash
    applied state instead of the state as of the last marker.
    ``bootstrap_ranges`` is the digest granularity of the peer bootstrap;
    ``impl`` picks the ``digest_compare`` route (``None`` = auto), as
    ``GossipConfig.impl`` does.  Disabled, a crash is amnesiac and the
    replica rebuilds from its peers alone.
    """

    snapshot_every: int = 4
    wal: bool = False
    bootstrap_ranges: int = 8
    impl: str | None = None

    @property
    def enabled(self) -> bool:
        return self.snapshot_every > 0 or self.wal


class DuraState(NamedTuple):
    """Durable-media shadow of the applied state.

    ``snap_version``/``snap_vc`` mirror ``replica_version`` /
    ``replica_vc`` as of each replica's last snapshot marker;
    ``wal_len`` counts deltas journaled since that marker;
    ``wal_total``/``snap_rows`` accumulate lifetime I/O events for the
    eq. 8 durability bill."""

    snap_version: torch.Tensor  # (P, R) int32
    snap_vc: torch.Tensor       # (P, C) int32
    wal_len: torch.Tensor       # (P,) int32
    wal_total: torch.Tensor     # () int32
    snap_rows: torch.Tensor     # () int32


def make_dura(n_replicas: int, n_clients: int, n_resources: int,
              device: str | torch.device = "cuda") -> DuraState:
    i32 = dict(dtype=torch.int32, device=device)
    return DuraState(
        snap_version=torch.zeros((n_replicas, n_resources), **i32),
        snap_vc=torch.zeros((n_replicas, n_clients), **i32),
        wal_len=torch.zeros((n_replicas,), **i32),
        wal_total=torch.zeros((), **i32),
        snap_rows=torch.zeros((), **i32),
    )


class HintState(NamedTuple):
    """Bounded per-replica hinted-handoff queues.

    Queue ``d`` holds hints for writes that could not reach replica
    ``d`` when they committed: the pending-ring slot plus the committed
    version (which guards against slot recycling).  ``count[d]`` entries
    are live, in enqueue order; past-capacity hints bump ``dropped``."""

    slot: torch.Tensor      # (P, H) int32
    version: torch.Tensor   # (P, H) int32
    count: torch.Tensor     # (P,) int32
    dropped: torch.Tensor   # () int32


def make_hints(n_replicas: int, hint_cap: int,
               device: str | torch.device = "cuda") -> HintState:
    i32 = dict(dtype=torch.int32, device=device)
    return HintState(
        slot=torch.zeros((n_replicas, hint_cap), **i32),
        version=torch.zeros((n_replicas, hint_cap), **i32),
        count=torch.zeros((n_replicas,), **i32),
        dropped=torch.zeros((), **i32),
    )


def _host_bool(x) -> np.ndarray:
    """A bool mask on the host (a device tensor is read once)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=bool)


def _put_rows_drop(target: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """``target.at[row, col].set(vals, mode="drop")`` for columns in
    ``[0, H]``: column ``H`` is out of range and its writes are dropped
    (they land in a spare column that is cut off).  Kept targets must be
    unique, as they are for the hint queues."""
    p, h = target.shape
    ext = target.new_zeros((p, h + 1))
    ext[:, :h] = target
    ext.view(-1)[(row.long() * (h + 1) + col.long()).reshape(-1)] = (
        vals.to(target.dtype).reshape(-1))
    return ext[:, :h]


class StoreState(NamedTuple):
    """Protocol state + op log.

    ``pend_apply`` shadows the pending ring with each in-flight write's
    emulated sequential apply op-index, carrying the merge-cadence
    emulation across batch boundaries.  ``hints`` / ``dura`` hold the
    hinted-handoff queues and the durability layer when the store was
    built with them, and are ``None`` otherwise."""

    cluster: xstcc.ClusterState
    duot: duot_lib.Duot
    pend_apply: torch.Tensor     # (Q,) int32
    hints: HintState | None = None
    dura: DuraState | None = None


class ReplicatedStore:
    """Facade over the batched X-STCC engine for one replicated store.

    Static configuration (sizes, level, cadence, device) lives on the
    object; dynamic state lives in the :class:`StoreState` that every
    method threads functionally.  ``ingest`` picks the kernels'
    implementation (``"auto"`` / ``"cuda"`` / ``"torch"``, see
    ``kernels.ops``).
    """

    def __init__(
        self,
        n_replicas: int,
        n_clients: int,
        n_resources: int,
        *,
        level: ConsistencyLevel = ConsistencyLevel.X_STCC,
        merge_every: int = 8,
        delta: int = 24,
        pending_cap: int = 128,
        duot_cap: int = 1024,
        ingest: str = "auto",
        hint_cap: int = 0,
        durability: DurabilityConfig | None = None,
        device: str | torch.device = "cuda",
    ):
        self.n_replicas = n_replicas
        self.n_clients = n_clients
        self.n_resources = n_resources
        self.level = level
        self.pending_cap = pending_cap
        self.duot_cap = duot_cap
        self.hint_cap = hint_cap
        self.durability = (
            durability if durability is not None and durability.enabled
            else None
        )
        self.device = resolve_device(device)
        self.sync_every, self.delta = merge_cadence(level, merge_every, delta)
        self.enforce_sessions = level.is_session_guarded
        self.ingest = ingest

    # -- state ----------------------------------------------------------------

    def init(self) -> StoreState:
        return self.wrap(
            xstcc.make_cluster(
                self.n_replicas, self.n_clients, self.n_resources,
                pending_cap=self.pending_cap, device=self.device,
            ),
            duot_lib.make(self.duot_cap, self.n_clients, device=self.device),
        )

    def wrap(self, cluster: xstcc.ClusterState, duot: duot_lib.Duot) -> StoreState:
        """Adopt an existing (cluster, duot) pair as store state."""
        return StoreState(
            cluster=cluster,
            duot=duot,
            pend_apply=torch.zeros((cluster.pend_live.shape[0],), dtype=torch.int32,
                                   device=self.device),
            hints=(make_hints(self.n_replicas, self.hint_cap, self.device)
                   if self.hint_cap > 0 else None),
            dura=(make_dura(self.n_replicas, self.n_clients, self.n_resources,
                            self.device)
                  if self.durability is not None else None),
        )

    # -- merge-cadence emulation ---------------------------------------------

    def schedule_stream(self, client, replica, kind) -> np.ndarray:
        """Emulated sequential apply op-index for each write of a stream
        (host numpy; see :func:`schedule_apply_points`)."""
        return schedule_apply_points(
            np.asarray(client), np.asarray(replica), np.asarray(kind),
            sync_every=self.sync_every, delta=self.delta,
            n_clients=self.n_clients, n_replicas=self.n_replicas,
        )

    # -- batch ops ------------------------------------------------------------

    def _pend_timeline(
        self, state: StoreState, resource: torch.Tensor,
        pend_apply: torch.Tensor, step0: int, b: int,
    ) -> torch.Tensor:
        """Per-op visible pending version via a timeline running max.

        Each live pending slot's version activates at batch-local index
        ``act = clip(pend_apply - step0, 0, b)`` (row ``b`` = never); a
        cumulative max down the timeline gives, at row ``i``, the
        freshest pending version per resource visible to op ``i``.

        The reference builds the timeline over all ``R`` resources, a
        ``(b+1, R)`` grid (82 GB per round at b = 4096 and the paper's
        5M rows).  Ops only read their own resource's column, so here the
        columns are the ``U <= b`` distinct resources of the batch, plus
        one spare column for slots on any other resource: the same values
        at every ``(i, resource[i])``, in ``(b+1, U+1)`` memory.
        """
        cl = state.cluster
        dev = resource.device
        n_res = cl.global_version.shape[0]
        uniq, col = torch.unique(resource.long(), return_inverse=True)
        u = uniq.shape[0]
        lookup = torch.full((n_res,), u, dtype=torch.long, device=dev)
        lookup[uniq] = torch.arange(u, device=dev)
        # Dead slots (and slots on resources outside the batch) land in
        # the spare column u, which no op reads.
        pcol = torch.where(cl.pend_live, lookup[cl.pend_resource.clamp(min=0).long()], u)
        act = (pend_apply.to(torch.int32) - step0).clamp(0, b).long()
        val = torch.where(cl.pend_live, cl.pend_version, 0)
        timeline = torch.zeros((b + 1, u + 1), dtype=torch.int32, device=dev)
        timeline.view(-1).scatter_reduce_(0, act * (u + 1) + pcol, val,
                                          "amax", include_self=True)
        seen = torch.cummax(timeline, dim=0).values
        return seen[torch.arange(b, device=dev), col]

    def apply_batch(
        self,
        state: StoreState,
        *,
        client,
        replica,
        resource,
        kind,
        op_step0: int | None = None,
        apply_index=None,
        record: bool = True,
        enforce=None,
        with_clocks: bool = True,
    ) -> tuple[StoreState, xstcc.BatchResult]:
        """Ingest a mixed read/write batch and register it in the DUOT.

        With ``op_step0`` (the global op index of the batch's first op)
        the level's merge cadence is emulated inside the batch through
        the closed-form predicate ``op_index(i) >= apply_index(j)``:

          * synchronous levels (``sync_every == 1``): ``apply_index = 0``;
          * causal-family levels: each write carries its emulated
            sequential apply point (the batch's slice of
            :meth:`schedule_stream`).

        The pending ring's cadence visibility is folded in through the
        activation timeline (:meth:`_pend_timeline`), as the reference
        does for every non-dense ingest.  Without ``op_step0`` the batch
        has plain scalar-loop semantics.
        """
        dev = self.device
        c = torch.as_tensor(client, device=dev).to(torch.int32)
        p = torch.as_tensor(replica, device=dev).to(torch.int32)
        r = torch.as_tensor(resource, device=dev).to(torch.int32)
        k = torch.as_tensor(kind, device=dev).to(torch.int32)
        b = c.shape[0]
        op_index = None
        visible_version = None
        new_pend_apply = None
        if op_step0 is not None:
            step0 = int(op_step0)
            op_index = step0 + torch.arange(b, dtype=torch.int32, device=dev)
            if self.sync_every == 1 and apply_index is None:
                apply_index = torch.zeros((b,), dtype=torch.int32, device=dev)
                pend_apply = torch.zeros_like(state.pend_apply)
                new_pend_apply = torch.zeros((b,), dtype=torch.int32, device=dev)
            else:
                if apply_index is None:
                    apply_index = torch.as_tensor(
                        self.schedule_stream(c.cpu(), p.cpu(), k.cpu()) + step0,
                        device=dev,
                    )
                apply_index = torch.as_tensor(apply_index, device=dev).to(torch.int32)
                pend_apply = state.pend_apply
                new_pend_apply = apply_index
            visible_version = self._pend_timeline(state, r, pend_apply, step0, b)
        elif self.sync_every == 1:
            # Legacy batch entry points (no op index): intra-batch
            # merge-every-op visibility, pending ring untouched.
            op_index = torch.arange(b, dtype=torch.int32, device=dev)
            apply_index = torch.zeros((b,), dtype=torch.int32, device=dev)
        res = xstcc.apply_op_batch(
            state.cluster, client=c, replica=p, resource=r, kind=k,
            enforce_sessions=(
                self.enforce_sessions if enforce is None else enforce
            ),
            op_index=op_index, apply_index=apply_index,
            visible_version=visible_version, ingest=self.ingest,
            with_clocks=with_clocks,
        )
        pend_apply = state.pend_apply
        if new_pend_apply is not None:
            pend_apply = xstcc._set_rows(pend_apply, res.slot, new_pend_apply)
        duot = state.duot
        if record:
            duot = duot_lib.record(
                duot,
                {
                    "client": c, "kind": k, "resource": r,
                    "version": res.version, "replica": p, "vc": res.vc,
                },
            )
        return StoreState(cluster=res.state, duot=duot, pend_apply=pend_apply,
                          hints=state.hints, dura=state.dura), res

    def write_batch(self, state: StoreState, *, client, replica, resource,
                    record: bool = True) -> tuple[StoreState, xstcc.BatchResult]:
        """A batch of client writes, with scalar-loop semantics."""
        c = torch.as_tensor(client, device=self.device).to(torch.int32)
        return self.apply_batch(
            state, client=c, replica=replica, resource=resource,
            kind=torch.full(c.shape, xstcc.WRITE, dtype=torch.int32,
                            device=self.device),
            record=record,
        )

    def read_batch(self, state: StoreState, *, client, replica, resource,
                   record: bool = True, enforce=None) -> tuple[StoreState, xstcc.BatchResult]:
        """A batch of session reads, with scalar-loop semantics;
        ``enforce`` overrides the level's session enforcement, per batch
        or per op (a ``(B,)`` bool)."""
        c = torch.as_tensor(client, device=self.device).to(torch.int32)
        return self.apply_batch(
            state, client=c, replica=replica, resource=resource,
            kind=torch.full(c.shape, xstcc.READ, dtype=torch.int32,
                            device=self.device),
            record=record, enforce=enforce,
        )

    # -- server side ----------------------------------------------------------

    def merge(
        self,
        state: StoreState,
        *,
        delta: int | None = None,
        up=None,
        link=None,
        timed_only: bool = False,
        boundary: int | None = None,
    ) -> tuple[StoreState, torch.Tensor]:
        """Timed-causal propagation (Δ defaults to the level's cadence).

        ``up``/``link`` mask the propagation to live, connected replica
        pairs (see :func:`repro_torch.core.xstcc.server_merge`).
        ``timed_only`` drops the causal-dependency gate (lean replay);
        with ``boundary`` (the global op index reached so far) it applies
        exactly the slots whose emulated apply point has passed.
        """
        d = self.delta if delta is None else delta
        ready = None
        if boundary is not None:
            if not timed_only:
                raise ValueError("boundary requires timed_only")
            ready = state.pend_apply <= int(boundary)
        cluster, n = xstcc.server_merge(
            state.cluster, delta=d, level=self.level, up=up, link=link,
            timed_only=timed_only, ready=ready,
        )
        return state._replace(cluster=cluster), n

    def merge_geo(
        self, state: StoreState, topology, *, delta: int | None = None,
        up=None, link=None,
    ) -> tuple[StoreState, torch.Tensor, torch.Tensor]:
        """Two-tier region-grouped merge (see
        :func:`repro_torch.core.xstcc.server_merge_geo`): the state equals
        :meth:`merge`'s, and the third value is the ``(G, G)`` delivery
        matrix (LAN fan-out on the diagonal, one WAN hop per (write,
        newly reached region) off it).  ``up``/``link`` compose as in
        :meth:`merge`."""
        if topology.n_replicas != self.n_replicas:
            raise ValueError(
                f"topology places {topology.n_replicas} replicas, store "
                f"has {self.n_replicas}"
            )
        d = self.delta if delta is None else delta
        dev = state.cluster.pend_live.device
        cluster, n, traffic = xstcc.server_merge_geo(
            state.cluster, delta=d,
            region=torch.from_numpy(topology.regions()).to(dev),
            n_regions=topology.n_regions,
            rtt_ms=torch.from_numpy(topology.rtt()).to(dev),
            level=self.level, up=up, link=link,
        )
        return state._replace(cluster=cluster), n, traffic

    def merge_faulty(
        self, state: StoreState, *, up, link, delta: int | None = None,
    ) -> tuple[StoreState, torch.Tensor, torch.Tensor]:
        """Masked merge that also meters propagation: returns ``(state,
        n_applied, events)``, ``events`` the growth of ``pend_applied``
        (one replica-propagation payload each)."""
        before = state.cluster.pend_applied.sum(dtype=torch.int32)
        new, n = self.merge(state, delta=delta, up=up, link=link)
        events = new.cluster.pend_applied.sum(dtype=torch.int32) - before
        return new, n, events

    def anti_entropy(
        self, state: StoreState, *, up, link,
    ) -> tuple[StoreState, torch.Tensor]:
        """Full reconciliation along the live links: a Δ=0 masked merge
        that pushes the whole backlog to every reachable replica.  The
        logical clock is restored afterwards, so a second call at the
        same masks changes nothing.  Returns ``(state, deliveries)``."""
        new, _, events = self.merge_faulty(state, up=up, link=link, delta=0)
        new = new._replace(
            cluster=new.cluster._replace(clock=state.cluster.clock)
        )
        return new, events

    # -- gossip anti-entropy / hinted handoff -----------------------------------

    def _masked_pass(self, cluster: xstcc.ClusterState, select: torch.Tensor,
                     up, link) -> tuple[xstcc.ClusterState, torch.Tensor]:
        """A clock-neutral Δ=0 merge over the live slots in ``select``
        along ``link``; returns the cluster and the ``(P,)`` deliveries
        by receiving replica."""
        saved_live = cluster.pend_live
        before = cluster.pend_applied.sum(dim=0, dtype=torch.int32)
        merged, _ = xstcc.server_merge(
            cluster._replace(pend_live=saved_live & select), delta=0,
            level=self.level, up=up, link=link,
        )
        growth = merged.pend_applied.sum(dim=0, dtype=torch.int32) - before
        cluster = merged._replace(
            pend_live=saved_live & ~merged.pend_applied.all(dim=1),
            clock=cluster.clock,
        )
        return cluster, growth

    def gossip_round(
        self,
        state: StoreState,
        *,
        pairs,               # (M, 2) int — ordered (replica, peer) pairs
        up,                  # (P,) bool
        link,                # (P, P) bool — closed connectivity
        n_ranges: int,
        impl: str | None = None,
    ) -> tuple[StoreState, dict[str, torch.Tensor]]:
        """One digest-exchange pass: diff, then repair stale ranges.

        Each pair ``(a, b)`` diffs per-range digests
        (:func:`repro_torch.gossip.digest.range_digests`) through
        ``kernels.ops.digest_compare_pairs`` and repairs the differing ranges
        with a Δ=0 merge restricted to live writes in those ranges and
        to the ``a``–``b`` edge.  Pairs that are down, disconnected or
        self-loops are invalid and repair nothing.  Clock-neutral.  The
        reference scans the pairs; here they are a Python loop.

        Returns ``(state, telemetry)``: ``valid`` (M,) bool, ``ranges``
        (M,) int32 stale ranges per pair, ``growth`` (M, P) int32
        deliveries per pair by receiving replica, ``gap_repaired`` ()
        int32, the drop in ``Σ max(0, global − replica)``.
        """
        cl = state.cluster
        dev = cl.pend_live.device
        p = self.n_replicas
        r = self.n_resources
        # The pairs on the host (the loop below walks them; the digest
        # compare checks them against P there) and on the device.
        if isinstance(pairs, torch.Tensor):
            host_pairs = pairs.tolist()
            pairs = pairs.to(device=dev, dtype=torch.long)
        else:
            pairs_np = np.asarray(pairs, dtype=np.int64)
            host_pairs = pairs_np.tolist()
            pairs = torch.from_numpy(pairs_np).to(dev)
        u = torch.as_tensor(up, device=dev).to(torch.bool)
        ln = torch.as_tensor(link, device=dev).to(torch.bool)
        a_idx, b_idx = pairs[:, 0], pairs[:, 1]
        valid = u[a_idx] & u[b_idx] & ln[a_idx, b_idx] & (a_idx != b_idx)
        dig = digest_lib.range_digests(cl.replica_version, n_ranges)
        flags = kernel_ops.digest_compare_pairs(
            dig, a_idx, b_idx, host_pairs=host_pairs, impl=impl
        )                                                   # (3, M, K)
        stale = flags[0] & valid[:, None]
        rid = digest_lib.range_of_resource(r, n_ranges, dev).long()

        def gap(c):
            return torch.clamp(
                c.global_version[None, :] - c.replica_version, min=0
            ).sum(dtype=torch.int32)

        gap_before = gap(cl)
        eye = torch.eye(p, dtype=torch.bool, device=dev)
        rows = torch.arange(p, device=dev)
        growth = []
        for m, (a, b) in enumerate(host_pairs):
            res_rid = rid[torch.clamp(cl.pend_resource, 0, r - 1).long()]
            in_stale = stale[m][res_rid] & valid[m]                  # (Q,)
            ia, ib = rows == a, rows == b
            pair_ln = eye | (ia[:, None] & ib[None, :]) | (ib[:, None] & ia[None, :])
            cl, g = self._masked_pass(cl, in_stale, u, pair_ln)
            growth.append(g)
        telemetry = {
            "valid": valid,
            "ranges": stale.sum(dim=1, dtype=torch.int32),
            "growth": torch.stack(growth),
            "gap_repaired": gap_before - gap(cl),
        }
        return state._replace(cluster=cl), telemetry

    def enqueue_hints(
        self,
        state: StoreState,
        *,
        slot,        # (B,) int32 — pending-ring slot per op
        version,     # (B,) int32 — committed version per op
        kind,        # (B,) int32
        home,        # (B,) int32 — coordinator replica per op
        conn,        # (P, P) bool — closed connectivity this epoch
    ) -> tuple[StoreState, torch.Tensor, torch.Tensor]:
        """Queue hints for the replicas a batch's writes could not reach
        (``~conn[home, d]``): ``(slot, version)`` on ``d``'s bounded
        queue, overflow counted in ``hints.dropped``.  Returns ``(state,
        n_enqueued, n_dropped)``."""
        hints = state.hints
        dev = hints.count.device
        h = self.hint_cap
        is_w = torch.as_tensor(kind, device=dev) == xstcc.WRITE
        cn = torch.as_tensor(conn, device=dev).to(torch.bool)
        miss = is_w[None, :] & ~cn[torch.as_tensor(home, device=dev).long()].T  # (P, B)
        rank = torch.cumsum(miss.to(torch.int32), dim=1) - 1
        pos = hints.count[:, None] + rank                            # (P, B)
        ok = miss & (pos < h)
        posc = torch.where(ok, pos, h)      # h = out of range -> dropped
        d_grid = torch.arange(self.n_replicas, device=dev)[:, None].expand_as(posc)
        slot_b = torch.as_tensor(slot, device=dev)[None, :].expand_as(posc)
        ver_b = torch.as_tensor(version, device=dev)[None, :].expand_as(posc)
        n_enq = ok.sum(dtype=torch.int32)
        n_drop = (miss & ~ok).sum(dtype=torch.int32)
        new_hints = HintState(
            slot=_put_rows_drop(hints.slot, d_grid, posc, slot_b),
            version=_put_rows_drop(hints.version, d_grid, posc, ver_b),
            count=hints.count + ok.sum(dim=1, dtype=torch.int32),
            dropped=hints.dropped + n_drop,
        )
        return state._replace(hints=new_hints), n_enq, n_drop

    def drain_hints(
        self, state: StoreState, *, up, link,
    ) -> tuple[StoreState, torch.Tensor]:
        """Deliver queued hints along the now-live links (heal path).

        Per destination ``d`` the queue is re-validated against the
        pending ring (a recycled slot or a retired write is discarded),
        the surviving hinted writes are pushed by a clock-neutral Δ=0
        merge over the links touching ``d``, and the queue is compacted
        to the valid hints still undelivered at ``d``.  The reference
        scans the destinations; here they are a Python loop.  Returns
        ``(state, deliveries)``, a ``(P,)`` vector by receiving replica.
        """
        hints = state.hints
        cluster = state.cluster
        dev = cluster.pend_live.device
        h = self.hint_cap
        p = self.n_replicas
        q = cluster.pend_live.shape[0]
        u = torch.as_tensor(up, device=dev).to(torch.bool)
        ln = torch.as_tensor(link, device=dev).to(torch.bool)
        eye = torch.eye(p, dtype=torch.bool, device=dev)
        rows = torch.arange(p, device=dev)
        hpos = torch.arange(h, device=dev)
        delivered = torch.zeros((p,), dtype=torch.int32, device=dev)
        h_slot, h_ver, h_count = hints.slot, hints.version, hints.count
        for d in range(p):
            qslots = torch.clamp(h_slot[d], 0, q - 1).long()
            hint_ok = (
                (hpos < h_count[d])
                & cluster.pend_live[qslots]
                & (cluster.pend_version[qslots] == h_ver[d])
            )
            # Duplicate slots in one queue reduce by max, as .at[].max does.
            marked = torch.zeros((q,), dtype=torch.int32, device=dev).scatter_reduce(
                0, qslots, hint_ok.to(torch.int32), "amax", include_self=True
            ).to(torch.bool)
            touch_d = (rows == d)[:, None] | (rows == d)[None, :]
            cluster, ev = self._masked_pass(cluster, marked, u, (eye | touch_d) & ln)
            delivered = delivered + ev
            # Compact: keep valid hints still undelivered at d.
            keep = hint_ok & ~cluster.pend_applied[qslots, d]
            kpos = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0) - 1, h)
            zero_row = torch.zeros((1, h), dtype=torch.int32, device=dev)
            zeros_d = torch.zeros_like(kpos)
            h_slot = h_slot.clone()
            h_slot[d] = _put_rows_drop(zero_row, zeros_d, kpos, h_slot[d])[0]
            h_ver = h_ver.clone()
            h_ver[d] = _put_rows_drop(zero_row, zeros_d, kpos, h_ver[d])[0]
            h_count = h_count.clone()
            h_count[d] = keep.sum(dtype=torch.int32)
        hints = HintState(slot=h_slot, version=h_ver, count=h_count,
                          dropped=hints.dropped)
        return state._replace(cluster=cluster, hints=hints), delivered

    # -- durability ---------------------------------------------------------------

    def snapshot(self, state: StoreState) -> tuple[StoreState, torch.Tensor]:
        """Persist a snapshot marker at every replica and truncate the
        WALs; the I/O charged is the number of ``(replica, resource)``
        cells whose version moved since the last marker.  Returns
        ``(state, cells_written)``."""
        cl, du = state.cluster, state.dura
        cells = (du.snap_version != cl.replica_version).sum(dtype=torch.int32)
        dura = DuraState(
            snap_version=cl.replica_version,
            snap_vc=cl.replica_vc,
            wal_len=torch.zeros_like(du.wal_len),
            wal_total=du.wal_total,
            snap_rows=du.snap_rows + cells,
        )
        return state._replace(dura=dura), cells

    def wal_append(self, state: StoreState, records) -> StoreState:
        """Journal ``records`` (P,) applied deltas since the last marker."""
        du = state.dura
        rec = torch.as_tensor(records, device=du.wal_len.device).to(torch.int32)
        dura = du._replace(
            wal_len=du.wal_len + rec,
            wal_total=du.wal_total + rec.sum(dtype=torch.int32),
        )
        return state._replace(dura=dura)

    def crash(self, state: StoreState, crashed) -> tuple[StoreState, dict[str, torch.Tensor]]:
        """Destroy the volatile state of the ``crashed`` (P,) bool replicas.

        What survives depends on the store's :class:`DurabilityConfig`:
        with the WAL, snapshot load + replay restore the exact pre-crash
        applied state and only the I/O is billed; with snapshots only,
        the crashed rows roll back to the marker and their pending-ring
        applied bits survive only for writes the marker covered; with
        durability off, the rows and their applied bits are lost.  The
        commit log (pending ring, ``global_version``, floors) is never
        lost.  Returns ``(state, info)`` with () int32 ``wal_replayed``,
        ``snap_read`` and ``rows_lost``.
        """
        cl, du, cfg = state.cluster, state.dura, self.durability
        dev = cl.replica_version.device
        crashed = torch.as_tensor(crashed, device=dev).to(torch.bool)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        if cfg is not None and cfg.wal:
            snap_read = (crashed[:, None] & (du.snap_version > 0)).sum(dtype=torch.int32)
            replayed = torch.where(crashed, du.wal_len, 0).sum(dtype=torch.int32)
            return state, {"wal_replayed": replayed, "snap_read": snap_read,
                           "rows_lost": zero}
        if cfg is not None:
            base_v, base_c = du.snap_version, du.snap_vc
            snap_read = (crashed[:, None] & (base_v > 0)).sum(dtype=torch.int32)
        else:
            base_v = torch.zeros_like(cl.replica_version)
            base_c = torch.zeros_like(cl.replica_vc)
            snap_read = zero
        new_rv = torch.where(crashed[:, None], base_v, cl.replica_version)
        new_vc = torch.where(crashed[:, None], base_c, cl.replica_vc)
        rows_lost = (cl.replica_version > new_rv).sum(dtype=torch.int32)
        res = torch.clamp(cl.pend_resource, 0, self.n_resources - 1).long()
        covered = cl.pend_version[:, None] <= base_v[:, res].T          # (Q, P)
        touch = crashed[None, :] & cl.pend_live[:, None]
        applied = torch.where(touch, cl.pend_applied & covered, cl.pend_applied)
        new = state._replace(cluster=cl._replace(
            replica_version=new_rv, replica_vc=new_vc, pend_applied=applied))
        if du is not None:
            new = new._replace(dura=du._replace(
                wal_len=torch.where(crashed, 0, du.wal_len)))
        return new, {"wal_replayed": zero, "snap_read": snap_read,
                     "rows_lost": rows_lost}

    def bootstrap(
        self,
        state: StoreState,
        *,
        targets,     # (P,) bool — replicas rebuilding this epoch
        up,          # (P,) bool
        link,        # (P, P) bool — closed connectivity
        n_ranges: int,
        impl: str | None = None,
    ) -> tuple[StoreState, dict[str, torch.Tensor]]:
        """Rebuild each target replica from its nearest live holder.

        For target ``d`` (itself up) the source is the first live, linked,
        non-rebuilding peer in ring order after ``d``; the two diff
        per-range digests (:func:`repro_torch.gossip.digest.range_digests`)
        and every differing range is pulled: the target's version cells
        in it max-join the source's, its applied clock max-joins the
        source's, and live pending writes in it applied at the source are
        marked applied at the target, after which fully applied slots
        retire.  Clock-neutral and idempotent.

        The reference scans the P replicas, one (1, K) compare each.  A
        source is never a target, so its row never changes, and a
        target's row changes only at its own step: every verdict can be
        taken on the digests as they stand.  So the sources are chosen on
        the host (from host masks, or one read of device ones), all
        verdicts come from one ``kernels.ops.digest_compare_pairs`` call,
        and the pulls follow in ring order.  Returns ``(state,
        telemetry)`` with (P,) ``valid`` (a source was reachable),
        ``source`` (-1 without one), ``cells`` (version cells raised),
        ``pend`` (pending copies delivered) and ``ranges`` (stale ranges
        pulled).
        """
        cl = state.cluster
        dev = cl.replica_version.device
        p, r = self.n_replicas, self.n_resources
        t_all, u, ln = (_host_bool(x) for x in (targets, up, link))
        sources = []
        for d in range(p):
            offs = [(d + 1 + i) % p for i in range(p - 1)]
            cand = [o for o in offs if u[o] and ln[d, o] and not t_all[o]]
            sources.append(cand[0] if (t_all[d] and u[d] and cand) else -1)
        pairs = [(d, s) for d, s in enumerate(sources) if s >= 0]
        i32 = dict(dtype=torch.int32, device=dev)
        cells = torch.zeros((p,), **i32)
        pend = torch.zeros((p,), **i32)
        ranges = torch.zeros((p,), **i32)
        rv, vc, applied = cl.replica_version, cl.replica_vc, cl.pend_applied
        if pairs:
            idx = torch.tensor(pairs, dtype=torch.int64, device=dev)
            dig = digest_lib.range_digests(rv, n_ranges)
            stale = kernel_ops.digest_compare_pairs(
                dig, idx[:, 0], idx[:, 1], host_pairs=pairs, impl=impl)[0]  # (M, K)
            rid = digest_lib.range_of_resource(r, n_ranges, dev).long()
            slot_rid = rid[torch.clamp(cl.pend_resource, 0, r - 1).long()]
            # The state's tensors may be shared (a snapshot holds the
            # version rows): the pulls write into copies.
            rv, vc, applied = rv.clone(), vc.clone(), applied.clone()
            for m, (d, s) in enumerate(pairs):
                pull = torch.maximum(rv[d], torch.where(stale[m][rid], rv[s], 0))
                cells[d] = (pull > rv[d]).sum(dtype=torch.int32)
                rv[d] = pull
                vc[d] = torch.maximum(vc[d], vc[s])
                relay = cl.pend_live & stale[m][slot_rid] & applied[:, s]
                pend[d] = (relay & ~applied[:, d]).sum(dtype=torch.int32)
                applied[:, d] |= relay
                ranges[d] = stale[m].sum(dtype=torch.int32)
        live = cl.pend_live & ~applied.all(dim=1)
        cluster = cl._replace(replica_version=rv, replica_vc=vc, pend_applied=applied,
                              pend_live=live)
        telemetry = {
            "valid": torch.tensor([s >= 0 for s in sources], dtype=torch.bool, device=dev),
            "source": torch.tensor(sources, **i32),
            "cells": cells, "pend": pend, "ranges": ranges,
        }
        return state._replace(cluster=cluster), telemetry

    # -- serving: snapshot installs and session floors ------------------------

    def install(self, state: StoreState, *, replica, resource, version) -> StoreState:
        """Server-side snapshot install (the serving layer's ``publish``):
        an externally assigned version raises the replica's applied
        version and the global frontier; no session, no clock."""
        cl = state.cluster
        dev = cl.replica_version.device
        p, r, v = torch.broadcast_tensors(*(
            torch.as_tensor(x, device=dev).to(torch.int32)
            for x in (replica, resource, version)))
        cluster = cl._replace(
            replica_version=xstcc._scatter_max(
                cl.replica_version, p.long() * self.n_resources + r.long(), v),
            global_version=xstcc._scatter_max(cl.global_version, r.long(), v),
        )
        return state._replace(cluster=cluster)

    def session_floor(self, state: StoreState, client, resource) -> torch.Tensor:
        """The MR/RYW floor: the least version admissible for the session."""
        cl = state.cluster
        dev = cl.read_floor.device
        c = torch.as_tensor(client, device=dev).long()
        r = torch.as_tensor(resource, device=dev).long()
        return torch.maximum(cl.read_floor[c, r], cl.write_floor[c, r])

    def admit_batch(self, state: StoreState, *, client, replica, resource,
                    impl: str | None = None,
                    ) -> tuple[StoreState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Batched admission check + floor update (the serving hot loop).

        Checks ``replica_version[p, r] >= max(read_floor, write_floor)``
        for each op against the *pre-batch* floors (the router admits a
        batch concurrently), serves ``max(replica_version, floor)`` under
        session enforcement, and raises the read floors, through
        ``kernels.ops.session_admit`` (``impl`` defaults to the store's
        ``ingest``: the kernel on the card, the plain version on the
        CPU).  Returns ``(state, served, admissible, floor)``: the
        reference's triple, plus each op's pre-batch floor (what
        :meth:`session_floor` gives), which the routers need as well.
        """
        cl = state.cluster
        dev = cl.read_floor.device
        c, p, r = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                   for x in (client, replica, resource))
        served, adm, floor, new_rf = kernel_ops.session_admit(
            cl.replica_version, cl.read_floor, cl.write_floor, c, p, r,
            enforce=self.enforce_sessions,
            impl=self.ingest if impl is None else impl,
        )
        return state._replace(cluster=cl._replace(read_floor=new_rf)), served, adm, floor

    def session_check(self, state: StoreState, index, *, resource=None, out=None,
                      impl: str | None = None) -> torch.Tensor:
        """The routers' admission check: :meth:`admit_batch`'s admissible and
        floor outputs without its floor update, which the routers discard
        (their observe read commits the floors).  ``index`` is (2, B), the
        client ids then the replicas (a host array is copied to the device
        once); ``resource`` (B,) or None (every op at resource 0).  Returns
        ``(2, B)`` int32 ``[admissible, floor]`` (written into ``out`` when
        given), through ``kernels.ops.session_check``; no state changes."""
        cl = state.cluster
        idx = torch.as_tensor(index, dtype=torch.int32, device=cl.read_floor.device)
        return kernel_ops.session_check(
            cl.replica_version, cl.read_floor, cl.write_floor, idx, resource=resource,
            out=out, impl=self.ingest if impl is None else impl)

    # -- audit ----------------------------------------------------------------

    def audit(self, state: StoreState, *, delta: int | None = None) -> audit_lib.AuditResult:
        d = self.delta if delta is None else delta
        return audit_lib.audit(state.duot, delta=d, impl=self.ingest)

    def gc(self, state: StoreState) -> StoreState:
        """Drop the DUOT entries the global stability frontier covers."""
        frontier = xstcc.stability_frontier(state.cluster)
        return state._replace(duot=duot_lib.gc(state.duot, frontier))

    def stability_frontier(self, state: StoreState) -> torch.Tensor:
        return xstcc.stability_frontier(state.cluster)


def stack_tree(trees: list):
    """Stack same-shaped state trees (NamedTuples, dicts, tensors, host
    numbers, ``None``) along a new leading axis: tensors with
    ``torch.stack``, host numbers into a numpy array."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return torch.stack(trees)
    if isinstance(t0, dict):
        return {k: stack_tree([t[k] for t in trees]) for k in t0}
    if isinstance(t0, tuple):
        parts = [stack_tree([t[i] for t in trees]) for i in range(len(t0))]
        return type(t0)(*parts) if hasattr(t0, "_fields") else tuple(parts)
    return np.asarray(trees)


def index_tree(tree, i: int):
    """Shard ``i`` of a :func:`stack_tree` result."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [index_tree(v, i) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree[i]


class ShardedStore:
    """Disjoint-shard scale-out: S independent replica fleets, one axis.

    Multi-tenant ingestion partitions sessions and resources into S
    disjoint shards (tenant groups); each shard is a full
    :class:`ReplicatedStore` of its own (clients and resources numbered
    shard-locally) whose :class:`StoreState` is stacked along a leading
    ``(S, …)`` axis, as the reference's ``vmap`` stacks it.  The shards
    share no state, so each batch op runs shard after shard on the one
    device and stacks the results: the same answer as the reference's
    mapped axis.  Sharded metrics are exactly the sum of the per-shard
    unsharded runs.
    """

    def __init__(self, store: ReplicatedStore, n_shards: int):
        self.store = store
        self.n_shards = n_shards

    def _each(self, state: StoreState, fn):
        return stack_tree([fn(index_tree(state, s)) for s in range(self.n_shards)])

    def init(self) -> StoreState:
        """Stacked fresh state, one store per shard."""
        return stack_tree([self.store.init() for _ in range(self.n_shards)])

    def apply_batch(self, state: StoreState, *, client, replica, resource, kind,
                    op_step0=None, apply_index=None, record: bool = True,
                    enforce=None) -> tuple[StoreState, xstcc.BatchResult]:
        """One ``(B,)`` batch per shard (``(S, B)`` arrays of shard-local
        ids; ``op_step0`` ``(S,)``); returns the stacked state and
        results."""
        dev = self.store.device
        c, p, r, k = (torch.as_tensor(x, device=dev).to(torch.int32)
                      for x in (client, replica, resource, kind))
        outs = [self.store.apply_batch(
            index_tree(state, s), client=c[s], replica=p[s], resource=r[s], kind=k[s],
            op_step0=None if op_step0 is None else int(op_step0[s]),
            apply_index=None if apply_index is None else apply_index[s],
            record=record, enforce=enforce,
        ) for s in range(self.n_shards)]
        return stack_tree([o[0] for o in outs]), stack_tree([o[1] for o in outs])

    def read_batch(self, state: StoreState, *, client, replica, resource,
                   record: bool = True, enforce=None) -> tuple[StoreState, xstcc.BatchResult]:
        c = torch.as_tensor(client, device=self.store.device).to(torch.int32)
        return self.apply_batch(
            state, client=c, replica=replica, resource=resource,
            kind=torch.full(c.shape, xstcc.READ, dtype=torch.int32, device=c.device),
            record=record, enforce=enforce,
        )

    def write_batch(self, state: StoreState, *, client, replica, resource,
                    record: bool = True) -> tuple[StoreState, xstcc.BatchResult]:
        c = torch.as_tensor(client, device=self.store.device).to(torch.int32)
        return self.apply_batch(
            state, client=c, replica=replica, resource=resource,
            kind=torch.full(c.shape, xstcc.WRITE, dtype=torch.int32, device=c.device),
            record=record,
        )

    def merge(self, state: StoreState, *, delta: int | None = None, up=None,
              link=None) -> tuple[StoreState, torch.Tensor]:
        """Merge every shard (one availability mask shared by all)."""
        return self._each(state, lambda st: self.store.merge(
            st, delta=delta, up=up, link=link))

    def anti_entropy(self, state: StoreState, *, up, link) -> tuple[StoreState, torch.Tensor]:
        """Heal-time reconciliation on every shard; events summed."""
        st, ev = self._each(state, lambda st: self.store.anti_entropy(
            st, up=up, link=link))
        return st, ev.sum(dtype=torch.int32)

    def install(self, state: StoreState, *, replica, resource, version) -> StoreState:
        """Install a snapshot on every shard (server-side publish)."""
        return self._each(state, lambda st: self.store.install(
            st, replica=replica, resource=resource, version=version))
