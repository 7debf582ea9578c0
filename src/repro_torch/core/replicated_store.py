"""ReplicatedStore — the replicated-state facade (port of
``repro.core.replicated_store``, the flat subset).

  * **state**     — :class:`StoreState` bundles the protocol cluster, the
    DUOT op log and the pending ring's emulated apply points;
  * **batch ops** — :meth:`ReplicatedStore.apply_batch` ingests ``(B,)``
    op tensors through :func:`repro_torch.core.xstcc.apply_op_batch` and
    registers them in the DUOT;
  * **merge cadence** — :func:`merge_cadence` maps a consistency level
    to its (sync period, Δ) pair, :meth:`ReplicatedStore.schedule_stream`
    replays the sequential merge schedule in op-index space, and
    :meth:`ReplicatedStore.merge` runs the timed-causal propagation step;
  * **audit**     — :meth:`ReplicatedStore.audit`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import audit as audit_lib
from repro_torch.core import duot as duot_lib
from repro_torch.core import xstcc
from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.device import resolve_device


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


class StoreState(NamedTuple):
    """Protocol state + op log.

    ``pend_apply`` shadows the pending ring with each in-flight write's
    emulated sequential apply op-index, carrying the merge-cadence
    emulation across batch boundaries."""

    cluster: xstcc.ClusterState
    duot: duot_lib.Duot
    pend_apply: torch.Tensor     # (Q,) int32


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
        device: str | torch.device = "cuda",
    ):
        self.n_replicas = n_replicas
        self.n_clients = n_clients
        self.n_resources = n_resources
        self.level = level
        self.pending_cap = pending_cap
        self.duot_cap = duot_cap
        self.device = resolve_device(device)
        self.sync_every, self.delta = merge_cadence(level, merge_every, delta)
        self.enforce_sessions = level.is_session_guarded
        self.ingest = ingest

    # -- state ----------------------------------------------------------------

    def init(self) -> StoreState:
        return StoreState(
            cluster=xstcc.make_cluster(
                self.n_replicas, self.n_clients, self.n_resources,
                pending_cap=self.pending_cap, device=self.device,
            ),
            duot=duot_lib.make(self.duot_cap, self.n_clients, device=self.device),
            pend_apply=torch.zeros((self.pending_cap,), dtype=torch.int32,
                                   device=self.device),
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
        return StoreState(cluster=res.state, duot=duot, pend_apply=pend_apply), res

    # -- server side ----------------------------------------------------------

    def merge(
        self,
        state: StoreState,
        *,
        delta: int | None = None,
        timed_only: bool = False,
        boundary: int | None = None,
    ) -> tuple[StoreState, torch.Tensor]:
        """Timed-causal propagation (Δ defaults to the level's cadence).

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
            state.cluster, delta=d, level=self.level,
            timed_only=timed_only, ready=ready,
        )
        return state._replace(cluster=cluster), n

    # -- audit ----------------------------------------------------------------

    def audit(self, state: StoreState, *, delta: int | None = None) -> audit_lib.AuditResult:
        d = self.delta if delta is None else delta
        return audit_lib.audit(state.duot, delta=d, impl=self.ingest)
