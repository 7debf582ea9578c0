"""X-STCC protocol engine — paper §3.4 (port of ``repro.core.xstcc``,
the geo merge and the one-slot-at-a-time sequential merge included).

A functional state machine over ``(clients × replicas × resources)``:

  * **server side** — every replica applies writes in the causal order
    derived from vector clocks, bounded by the timed bound Δ;
  * **client side** — per-session floors enforce MR / RYW (reads never
    return a version below the session's read or own-write floor); MW
    and WFR follow from the causal order of the write clocks.

Ops come one at a time (:func:`client_write` / :func:`client_read`) or as
a batch (:func:`apply_op_batch`) with bit-identical results.  State is a
``NamedTuple`` of int32 / bool tensors; every function returns new
tensors and leaves its input state untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import vector_clock as vclock
from repro_torch.kernels import ops as kernel_ops

WRITE = 1
READ = 0
INT32_MAX = 2 ** 31 - 1


class ClusterState(NamedTuple):
    """Replicated-store state: P replicas, C clients, R resources."""

    replica_version: torch.Tensor   # (P, R) int32 — applied version per resource
    replica_vc: torch.Tensor        # (P, C) int32 — applied vector clock
    session_vc: torch.Tensor        # (C, C) int32 — each session's clock
    read_floor: torch.Tensor        # (C, R) int32 — MR floor
    write_floor: torch.Tensor       # (C, R) int32 — RYW floor
    global_version: torch.Tensor    # (R,) int32 — latest committed version
    # Pending writes ring: committed but not yet applied everywhere.
    pend_client: torch.Tensor       # (Q,) int32
    pend_resource: torch.Tensor     # (Q,) int32
    pend_version: torch.Tensor      # (Q,) int32
    pend_vc: torch.Tensor           # (Q, C) int32
    pend_coord: torch.Tensor        # (Q,) int32  — coordinator replica
    pend_time: torch.Tensor         # (Q,) int32  — commit step
    pend_live: torch.Tensor         # (Q,) bool
    pend_applied: torch.Tensor      # (Q, P) bool — applied at replica p?
    pend_dropped: torch.Tensor      # () int32 — writes that found no free slot
    clock: torch.Tensor             # () int32 — logical step counter


def make_cluster(
    n_replicas: int, n_clients: int, n_resources: int,
    pending_cap: int = 128, device: str | torch.device = "cuda",
) -> ClusterState:
    P, C, R, Q = n_replicas, n_clients, n_resources, pending_cap
    i32 = dict(dtype=torch.int32, device=device)
    return ClusterState(
        replica_version=torch.zeros((P, R), **i32),
        replica_vc=torch.zeros((P, C), **i32),
        session_vc=torch.zeros((C, C), **i32),
        read_floor=torch.zeros((C, R), **i32),
        write_floor=torch.zeros((C, R), **i32),
        global_version=torch.zeros((R,), **i32),
        pend_client=torch.full((Q,), -1, **i32),
        pend_resource=torch.full((Q,), -1, **i32),
        pend_version=torch.zeros((Q,), **i32),
        pend_vc=torch.zeros((Q, C), **i32),
        pend_coord=torch.full((Q,), -1, **i32),
        pend_time=torch.zeros((Q,), **i32),
        pend_live=torch.zeros((Q,), dtype=torch.bool, device=device),
        pend_applied=torch.zeros((Q, P), dtype=torch.bool, device=device),
        pend_dropped=torch.zeros((), **i32),
        clock=torch.zeros((), **i32),
    )


def _saturating_add(counter: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """int32 add that clamps at INT32_MAX instead of wrapping."""
    headroom = INT32_MAX - counter
    return counter + torch.minimum(n.to(torch.int32), headroom)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


def _scatter_max(target: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``target.at[index].max(values)`` over the flattened target (all
    indices in range); returns a new tensor."""
    out = target.clone()
    out.view(-1).scatter_reduce_(0, index.reshape(-1), values.reshape(-1),
                                 "amax", include_self=True)
    return out


def _set_rows(arr: torch.Tensor, slot: torch.Tensor, vals) -> torch.Tensor:
    """``arr.at[slot].set(vals, mode="drop")`` for slots in ``[0, Q]``.

    Kept slots are unique; the out-of-range slot ``Q`` lands in a spare
    row that is cut off, so the write needs no host sync.
    """
    q = arr.shape[0]
    ext = arr.new_zeros((q + 1,) + tuple(arr.shape[1:]))
    ext[:q] = arr
    ext[slot.long()] = torch.as_tensor(vals, device=arr.device).to(arr.dtype)
    return ext[:q]


class WriteResult(NamedTuple):
    state: ClusterState
    version: torch.Tensor  # version created
    vc: torch.Tensor       # clock stamped on the op


def client_write(state: ClusterState, *, client: int, replica: int,
                 resource: int) -> WriteResult:
    """Commit one write at its coordinator replica; enqueue propagation
    in the first free pending slot (dropped and counted when full)."""
    c, p, r = int(client), int(replica), int(resource)
    svc = vclock.receive(state.session_vc[c], state.replica_vc[p], c)
    ver = state.global_version[r] + 1

    replica_version = state.replica_version.clone()
    replica_version[p, r] = torch.maximum(replica_version[p, r], ver)
    replica_vc = state.replica_vc.clone()
    replica_vc[p] = vclock.merge(state.replica_vc[p], svc)

    Q = state.pend_live.shape[0]
    free = ~state.pend_live
    has_free = bool(free.any())
    q = int(torch.argmax(free.to(torch.int32))) if has_free else Q
    slot = torch.tensor([q], device=svc.device)
    applied0 = torch.zeros((state.pend_applied.shape[1],), dtype=torch.bool,
                           device=svc.device)
    applied0[p] = True

    def at(arr, val):
        return _set_rows(arr, slot, torch.as_tensor(val, device=arr.device).reshape(
            (1,) + tuple(arr.shape[1:])))

    session_vc = state.session_vc.clone()
    session_vc[c] = svc
    write_floor = state.write_floor.clone()
    write_floor[c, r] = torch.maximum(write_floor[c, r], ver)
    read_floor = state.read_floor.clone()
    read_floor[c, r] = torch.maximum(read_floor[c, r], ver)
    global_version = state.global_version.clone()
    global_version[r] = ver
    new = state._replace(
        replica_version=replica_version,
        replica_vc=replica_vc,
        session_vc=session_vc,
        write_floor=write_floor,
        read_floor=read_floor,
        global_version=global_version,
        pend_client=at(state.pend_client, c),
        pend_resource=at(state.pend_resource, r),
        pend_version=at(state.pend_version, ver),
        pend_vc=at(state.pend_vc, svc),
        pend_coord=at(state.pend_coord, p),
        pend_time=at(state.pend_time, state.clock),
        pend_live=at(state.pend_live, True),
        pend_applied=at(state.pend_applied, applied0),
        pend_dropped=_saturating_add(
            state.pend_dropped,
            torch.tensor(0 if has_free else 1, device=svc.device),
        ),
        clock=state.clock + 1,
    )
    return WriteResult(state=new, version=ver, vc=svc)


class ReadResult(NamedTuple):
    state: ClusterState
    version: torch.Tensor      # version returned
    admissible: torch.Tensor   # bool — replica satisfied the session floors
    stale: torch.Tensor        # bool — returned < globally-latest version
    violation: torch.Tensor    # bool — a session guarantee was violated


def client_read(state: ClusterState, *, client: int, replica: int,
                resource: int, enforce_sessions: bool = True) -> ReadResult:
    """Serve one read at ``replica``; under session enforcement an
    inadmissible replica is repaired before serving
    (``max(replica_version, floors)``)."""
    c, p, r = int(client), int(replica), int(resource)
    raw = state.replica_version[p, r]
    floor = torch.maximum(state.read_floor[c, r], state.write_floor[c, r])
    admissible = raw >= floor
    enforce = bool(enforce_sessions)
    served = torch.maximum(raw, floor) if enforce else raw
    violation = (not enforce) & ~admissible
    stale = served < state.global_version[r]

    svc = vclock.receive(state.session_vc[c], state.replica_vc[p], c)
    session_vc = state.session_vc.clone()
    session_vc[c] = svc
    read_floor = state.read_floor.clone()
    read_floor[c, r] = torch.maximum(read_floor[c, r], served)
    new = state._replace(
        session_vc=session_vc, read_floor=read_floor, clock=state.clock + 1,
    )
    return ReadResult(state=new, version=served, admissible=admissible,
                      stale=stale, violation=violation)


class BatchResult(NamedTuple):
    """Per-op outputs of :func:`apply_op_batch` (B = batch size)."""

    state: ClusterState
    version: torch.Tensor      # (B,) int32 — created (W) or served (R)
    vc: torch.Tensor           # (B, C) int32 — op clock (receive rule)
    admissible: torch.Tensor   # (B,) bool
    stale: torch.Tensor        # (B,) bool
    violation: torch.Tensor    # (B,) bool
    dropped: torch.Tensor      # (B,) bool
    slot: torch.Tensor         # (B,) int32 — pending slot (Q when none)


def apply_op_batch(
    state: ClusterState,
    *,
    client,
    replica,
    resource,
    kind,
    enforce_sessions=True,
    op_index=None,
    apply_index=None,
    pend_apply=None,
    visible_version=None,
    ingest: str | None = "auto",
    with_clocks: bool = True,
) -> BatchResult:
    """Ingest a batch of ``B`` ops — bit-identical to the scalar loop.

    Versions come from a per-resource prefix count; served versions and
    floors from the ``(occ, raw, floor)`` prefix reductions of
    ``kernels.ops.op_ingest``; the vector-clock chain from
    ``kernels.ops.vclock_chain``; merge cadences finer than the batch
    enter through ``op_index`` / ``apply_index`` / ``pend_apply`` (the
    closed-form predicate ``op_index(i) >= apply_index(j)``), or through
    ``visible_version``, a per-op visible pending version joined into
    the replica-visible max.  ``with_clocks=False`` skips the clock chain
    and leaves the clocks untouched (``vc`` is zeros).

    The pending ring matches the sequential loop: the k-th write of the
    batch takes the k-th free slot, and writes beyond the free capacity
    are dropped and counted in the saturating ``pend_dropped``.
    """
    dev = state.replica_version.device
    c, p, r, k = (_i32(x, dev) for x in (client, replica, resource, kind))
    B = c.shape[0]
    Q, P = state.pend_applied.shape
    R = state.replica_version.shape[1]
    C = state.session_vc.shape[0]
    cl, pl, rl = c.long(), p.long(), r.long()

    is_w = k == WRITE
    idx = torch.arange(B, dtype=torch.int32, device=dev)
    pend_kwargs = {}
    if pend_apply is not None:
        pend_kwargs = dict(
            pend_version=state.pend_version,
            pend_resource=state.pend_resource,
            pend_live=state.pend_live,
            pend_apply=_i32(pend_apply, dev),
        )
    g0 = state.global_version[rl]
    raw0 = state.replica_version[pl, rl]
    if visible_version is not None:
        raw0 = torch.maximum(raw0, _i32(visible_version, dev))
    floor0 = torch.maximum(state.read_floor[cl, rl], state.write_floor[cl, rl])
    occ, raw, floor = kernel_ops.op_ingest(
        c, p, r, is_w, g0, raw0, floor0,
        op_index=op_index, apply_index=apply_index, impl=ingest,
        **pend_kwargs,
    )
    gcur = g0 + occ                       # global version seen by op i
    ver_w = gcur + 1                      # version created IF a write
    verw_masked = torch.where(is_w, ver_w, 0)

    enforce = torch.as_tensor(enforce_sessions, device=dev).to(torch.bool)
    adm = raw >= floor
    served = torch.where(enforce, torch.maximum(raw, floor), raw)
    violation = ~is_w & ~enforce & ~adm
    stale = ~is_w & (served < gcur)
    version_out = torch.where(is_w, ver_w, served)
    admissible = is_w | adm

    # -- vector clocks (exact sequential chaining) ---------------------------
    if with_clocks:
        session_vc, replica_vc, vcs = kernel_ops.vclock_chain(
            c, p, is_w.to(torch.int32), state.session_vc, state.replica_vc,
            impl=ingest,
        )
    else:
        session_vc = state.session_vc
        replica_vc = state.replica_vc
        vcs = torch.zeros((B, C), dtype=torch.int32, device=dev)

    # -- pending ring: k-th batch write -> k-th free slot --------------------
    free = ~state.pend_live
    n_free = free.sum(dtype=torch.int32)
    wrank = torch.cumsum(is_w, 0, dtype=torch.int32) - 1
    free_rank = torch.cumsum(free, 0, dtype=torch.int32) - 1
    kth_free = _set_rows(
        torch.zeros((Q,), dtype=torch.int32, device=dev),
        torch.where(free, free_rank, Q),
        torch.arange(Q, dtype=torch.int32, device=dev),
    )
    enq = is_w & (wrank < n_free)
    slot = torch.where(enq, kth_free[wrank.clamp(0, Q - 1).long()], Q)
    dropped = is_w & ~enq
    applied0 = torch.arange(P, dtype=torch.int32, device=dev)[None, :] == p[:, None]
    pend_time = state.clock + idx

    new = state._replace(
        replica_version=_scatter_max(state.replica_version, pl * R + rl, verw_masked),
        replica_vc=replica_vc,
        session_vc=session_vc,
        read_floor=_scatter_max(state.read_floor, cl * R + rl,
                                torch.where(is_w, ver_w, served)),
        write_floor=_scatter_max(state.write_floor, cl * R + rl, verw_masked),
        global_version=_scatter_max(state.global_version, rl, verw_masked),
        pend_client=_set_rows(state.pend_client, slot, c),
        pend_resource=_set_rows(state.pend_resource, slot, r),
        pend_version=_set_rows(state.pend_version, slot, ver_w),
        pend_vc=(_set_rows(state.pend_vc, slot, vcs) if with_clocks
                 else state.pend_vc),
        pend_coord=_set_rows(state.pend_coord, slot, p),
        pend_time=_set_rows(state.pend_time, slot, pend_time),
        pend_live=_set_rows(state.pend_live, slot,
                            torch.ones((B,), dtype=torch.bool, device=dev)),
        pend_applied=_set_rows(state.pend_applied, slot, applied0),
        pend_dropped=_saturating_add(state.pend_dropped, dropped.sum()),
        clock=state.clock + B,
    )
    return BatchResult(
        state=new, version=version_out, vc=vcs, admissible=admissible,
        stale=stale, violation=violation, dropped=dropped,
        slot=slot.to(torch.int32),
    )


def client_write_batch(state: ClusterState, *, client, replica,
                       resource) -> BatchResult:
    """Commit a batch of writes — sequential-equivalent (see
    :func:`apply_op_batch`)."""
    c = _i32(client, state.replica_version.device)
    return apply_op_batch(
        state, client=c, replica=replica, resource=resource,
        kind=torch.full(c.shape, WRITE, dtype=torch.int32, device=c.device),
    )


def client_read_batch(state: ClusterState, *, client, replica, resource,
                      enforce_sessions=True) -> BatchResult:
    """Serve a batch of reads — sequential-equivalent (see
    :func:`apply_op_batch`)."""
    c = _i32(client, state.replica_version.device)
    return apply_op_batch(
        state, client=c, replica=replica, resource=resource,
        kind=torch.full(c.shape, READ, dtype=torch.int32, device=c.device),
        enforce_sessions=enforce_sessions,
    )


def server_merge(
    state: ClusterState,
    *,
    delta: int,
    level=None,
    up=None,
    link=None,
    timed_only: bool = False,
    ready: torch.Tensor | None = None,
) -> tuple[ClusterState, torch.Tensor]:
    """Timed-causal propagation step (server side).

    Applies, at every replica, all pending writes that (a) are older
    than Δ, or (b) whose causal predecessors are already applied — a
    fixpoint: each pass applies every write whose gate is open, then
    re-evaluates the gates with the updated replica clocks.  The
    reference runs the fixpoint as a ``lax.while_loop``; here it is a
    Python ``while`` that reads one flag per pass.

    ``up`` (``(P,)`` bool) and ``link`` (``(P, P)`` bool, the closed
    connectivity of ``FaultSchedule.closure``) mask the propagation: a
    write reaches replica ``p`` only if ``p`` is live and connected to a
    replica already holding it, and the causal gate spans the write's
    reachable component.  With all-True masks the result equals the
    unmasked merge bit for bit.

    The fixpoint runs over the live slots only, gathered once per merge
    (the reference sweeps the whole ring, a ``(Q, P, C)`` temporary per
    pass: ~3 GB at the fault path's 4M-slot ring).  Dead slots never
    pass the gate and add nothing to a max, so this is exact.  The clock
    gate and the clock max are also taken one replica at a time, an
    ``(L, C)`` temporary instead of the ``(L, P, C)`` cube.

    ``timed_only=True`` drops the causal gate (lean replay): one pass
    applying the slots in ``ready`` (or the Δ-overdue ones); it takes no
    fault masks.

    Returns (state, n_applied): writes that reached a new replica.
    """
    del level  # the order is identical; levels differ in *when* merge runs
    if ready is not None and not timed_only:
        raise ValueError("ready requires timed_only")
    d = int(delta)
    Q, P = state.pend_applied.shape
    C = state.replica_vc.shape[1]
    R = state.global_version.shape[0]
    dev = state.pend_live.device
    masked = up is not None or link is not None
    if masked:
        if timed_only:
            raise ValueError("timed_only merge cannot take fault masks")
        u = (torch.ones((P,), dtype=torch.bool, device=dev) if up is None
             else torch.as_tensor(up, device=dev).to(torch.bool))
        ln = (torch.ones((P, P), dtype=torch.bool, device=dev) if link is None
              else torch.as_tensor(link, device=dev).to(torch.bool))
        # Holders can only hand a write to live, reachable replicas.
        conn = ln & u[None, :] & u[:, None]

    live = state.pend_live
    overdue = live & ((state.clock - state.pend_time) >= d)

    if timed_only:
        # Dead slots carry version 0 into resource 0: a no-op under the max.
        res_safe = torch.where(live, state.pend_resource, 0).long()
        flat = torch.arange(P, device=dev)[None, :] * R + res_safe[:, None]
        elig = overdue if ready is None else live & ready
        elig_at = elig[:, None] & ~state.pend_applied                # (Q, P)
        ver_at = torch.where(elig_at, state.pend_version[:, None], 0)
        applied = state.pend_applied | elig_at
        fully = applied.all(dim=1)
        new = state._replace(
            replica_version=_scatter_max(state.replica_version, flat, ver_at),
            pend_applied=applied,
            pend_live=live & ~fully,
            clock=state.clock + 1,
        )
        return new, elig_at.any(dim=1).sum(dtype=torch.int32)

    idx = torch.nonzero(live).squeeze(1)                              # (L,)
    vc = state.pend_vc[idx]                                           # (L, C)
    ver = state.pend_version[idx]
    od = overdue[idx]
    applied = state.pend_applied[idx]                                 # (L, P)
    flat = (torch.arange(P, device=dev)[None, :] * R
            + state.pend_resource[idx].long()[:, None])
    # A write is applicable once its causal deps are stable: its vc
    # (minus its own tick) <= the replicas' vcs.
    own = torch.arange(C, device=dev)[None, :] == state.pend_client[idx][:, None]
    dep_vc = vc - own.to(torch.int32)
    rv, rvc = state.replica_version, state.replica_vc
    n = torch.zeros((), dtype=torch.int32, device=dev)
    go = idx.numel() > 0
    while go:
        deps_ok = torch.stack(
            [(dep_vc <= rvc[p][None, :]).all(dim=-1) for p in range(P)], dim=1
        )                                                             # (L, P)
        if masked:
            # reach[w, p]: some holder of w can ship it to p this epoch;
            # the gate spans the write's reachable component.
            reach = (applied[:, :, None] & conn[None, :, :]).any(dim=1)
            gate = torch.where(reach, deps_ok, True).all(dim=1)
            elig_at = ~applied & reach & (od | gate)[:, None]
        else:
            elig = ~applied.all(dim=1) & (od | deps_ok.all(dim=-1))
            elig_at = elig[:, None] & ~applied
        ver_at = torch.where(elig_at, ver[:, None], 0)
        rv = _scatter_max(rv, flat, ver_at)
        vc_new = torch.stack(
            [torch.where(elig_at[:, p, None], vc, 0).amax(dim=0) for p in range(P)]
        )                                                             # (P, C)
        rvc = torch.maximum(rvc, vc_new)
        applied = applied | elig_at
        n = n + elig_at.any(dim=1).sum(dtype=torch.int32)
        go = bool(elig_at.any())
    pend_applied = state.pend_applied.clone()
    pend_applied[idx] = applied
    fully = pend_applied.all(dim=1)
    new = state._replace(
        replica_version=rv,
        replica_vc=rvc,
        pend_applied=pend_applied,
        pend_live=live & ~fully,
        clock=state.clock + 1,
    )
    return new, n


def server_merge_geo(
    state: ClusterState,
    *,
    delta: int,
    region: torch.Tensor,
    n_regions: int,
    rtt_ms: torch.Tensor,
    level=None,
    up=None,
    link=None,
) -> tuple[ClusterState, torch.Tensor, torch.Tensor]:
    """Two-tier (region-grouped) propagation step.

    A write crosses the WAN once per destination region, then fans out
    over the region's LAN.  The state equals :func:`server_merge`'s (the
    flat fixpoint is the closure both tiers reach), so this runs the
    flat merge and derives the tier of every delivery from the
    ``pend_applied`` delta:

      * a (write, replica) delivery lands in region ``h``; if a replica
        of ``h`` held the write before this merge, the copy travels the
        LAN — an ``(h, h)`` event;
      * otherwise the first copy into ``h`` crosses the WAN from the
        nearest region (by ``rtt_ms``, ties → lowest id) that held the
        write before the merge — a ``(src, h)`` event — and the other
        copies fan out on the LAN.

    ``up``/``link`` pass through to the flat fixpoint.  Returns
    ``(state, n_applied, traffic)``, ``traffic`` a ``(G, G)`` int32
    matrix of delivery events.
    """
    dev = state.pend_applied.device
    reg = torch.as_tensor(region, device=dev).long()
    rtt = torch.as_tensor(rtt_ms, device=dev).to(torch.float32)
    G = n_regions
    before = state.pend_applied                                    # (Q, P)
    new, n_applied = server_merge(state, delta=delta, level=level, up=up,
                                  link=link)
    newly = new.pend_applied & ~before
    onehot = reg[:, None] == torch.arange(G, device=dev)[None, :]  # (P, G)
    held = (before[:, :, None] & onehot[None]).any(dim=1)          # (Q, G)
    new_in = (newly[:, :, None] & onehot[None]).sum(dim=1, dtype=torch.int32)
    # The first copy into a region that held nothing crosses the WAN from
    # the nearest pre-merge holder region.
    inter = (new_in > 0) & ~held                                   # (Q, G)
    big = torch.finfo(torch.float32).max
    src_cost = torch.where(held[:, :, None], rtt[None], big)       # (Q, Gs, Gd)
    # torch.argmin returns the first minimum (lowest region id on ties),
    # as jnp.argmin does; a holder-less column falls to region 0 in both.
    src = torch.argmin(src_cost, dim=1)                            # (Q, Gd)
    dst = torch.arange(G, device=dev)[None, :].expand_as(src)
    traffic = torch.zeros((G * G,), dtype=torch.int64, device=dev)
    traffic.index_add_(0, (src * G + dst).reshape(-1),
                       inter.reshape(-1).to(torch.int64))
    intra = (new_in - inter.to(torch.int32)).sum(dim=0)            # (G,)
    traffic = traffic.reshape(G, G)
    traffic += torch.diag(intra.to(torch.int64))
    return new, n_applied, traffic.to(torch.int32)



def merge_sequential_(state: ClusterState, delta: int, *,
                      count: bool = True) -> torch.Tensor | None:
    """:func:`server_merge_sequential` on ``state``'s own tensors, in place.

    One host read per merge (the pending ring's live, time, client,
    resource, version and clock columns, and the logical clock) fixes
    the order: the reference's stable ``argsort`` of the
    :func:`~repro_torch.core.vector_clock.total_order_key`, ``INT32_MAX``
    for slots that are not due, taken here in numpy int32.  Slots that
    are not live are no-ops, so the loop visits the live ones only.  A
    Δ-overdue slot is applied unconditionally; any other live slot —
    due or not — when its dependencies (its clock less its own tick) are
    below every replica's clock, a device-side gate that sees the
    replica clocks the earlier slots of the same pass raised.  Returns
    the number of slots applied (``None`` with ``count=False``).
    """
    Q, P = state.pend_applied.shape
    C = state.replica_vc.shape[1]
    dev = state.pend_live.device
    if Q == 0:
        state.clock.add_(1)
        return torch.zeros((), dtype=torch.int32, device=dev) if count else None
    host = torch.cat([
        state.pend_live.to(torch.int32)[:, None], state.pend_time[:, None],
        state.pend_client[:, None], state.pend_resource[:, None],
        state.pend_version[:, None], state.clock.expand(Q)[:, None],
        state.pend_vc,
    ], dim=1).cpu().numpy()
    live = host[:, 0] != 0
    client, resource, version = host[:, 2], host[:, 3], host[:, 4]
    age = host[:, 5] - host[:, 1]                 # int32, wrapping
    due = live & (age >= 0)
    overdue = live & (age >= np.int32(delta))
    key = host[:, 6:].sum(axis=1, dtype=np.int32) * np.int32(C + 1) + client
    key = np.where(due, key, np.int32(INT32_MAX))
    order = np.argsort(key, kind="stable")

    rv, rvc, applied = state.replica_version, state.replica_vc, state.pend_applied
    n_host = 0
    n_dev = torch.zeros((), dtype=torch.int32, device=dev) if count else None
    dep = None
    for qi in order[live[order]].tolist():
        r = int(resource[qi])
        if overdue[qi]:
            rv[:, r].clamp_(min=int(version[qi]))
            rvc.clamp_(min=state.pend_vc[qi])
            applied[qi] = True
            n_host += 1
            continue
        if dep is None:
            own = torch.arange(C, device=dev)[None, :] == state.pend_client[:, None]
            dep = state.pend_vc - own.to(torch.int32)
        ok = (dep[qi] <= rvc).all()
        rv[:, r].clamp_(min=state.pend_version[qi] * ok)
        rvc.clamp_(min=state.pend_vc[qi] * ok)
        applied[qi].logical_or_(ok)
        if count:
            n_dev += ok
    state.pend_live.logical_and_(~applied.all(dim=1))
    state.clock.add_(1)
    return n_dev + n_host if count else None


def server_merge_sequential(state: ClusterState, *, delta: int,
                            level=None) -> tuple[ClusterState, torch.Tensor]:
    """Pre-batching merge: one pending slot at a time.

    The reference engine's propagation pass, kept as the baseline of
    :func:`server_merge`: slots are applied one at a time in the
    deterministic causal-extension order, so a write whose dependencies
    are satisfied by a later-sorted slot of the same pass waits one
    more merge than under the fixpoint; otherwise the two agree.
    Returns (state, n_applied); the input state is left untouched.
    """
    del level
    work = ClusterState(*(t.clone() for t in state))
    n = merge_sequential_(work, int(delta))
    return work, n


def stability_frontier(state: ClusterState) -> torch.Tensor:
    """Component-wise min of the replica clocks — the DUOT GC frontier."""
    return torch.amin(state.replica_vc, dim=0)
