"""Consistency-policy-driven parameter synchronization across pods (port
of ``repro.sync.engine``).

The paper's technique as a training feature.  Pods are the replicas:
parameters carry an explicit leading replica dimension ``(n_pods, ...)``,
so a merge is one tensor operation per leaf over that dimension:

  ALL     mean over the pod axis every step (synchronous DP);
  QUORUM  rotating majority-subgroup mean every step;
  ONE     ring gossip with period Δ (no ordering — the violating
          baseline);
  CAUSAL  every-step vector-clock-ordered merge;
  TCC     Δ-periodic timed-causal merge (no session floors);
  X_STCC  Δ-periodic timed-causal merge + session guarantees +
          optional inter-pod compression (int8 / top-k).

The X-STCC bookkeeping goes through
``repro_torch.core.replicated_store.ReplicatedStore`` with client i =
pod i's training process and replica i = pod i's parameter copy; every
merge registers one batched write per pod in the DUOT (B.1 ``op_ingest``
and the clock chain on the card), advances vector clocks through the
store's batch ops and ``merge``, and runs the audit (B.2) for the causal
levels.

A merge writes the merged parameters (and the compression anchor and
residual) into the given tensors and returns them: the caller's state is
donated, as the reference's jitted trainer donates it, so a full-width
model is never held twice.  The f32 operations and their order are the
reference's; sums over the pod axis of more than two pods may differ
from XLA's in the last bit (its reduction order).

DTensor leaves (a state from ``train_step.distribute_state``): every
merge works on each rank's local block.  The reductions over pods are a
local sum and, where the pods are split over 'pod', an all-reduce over
that group; the gossip's neighbour rows are gathered over 'pod'; the
int8 scale is one max per pod over the whole leaf (each block's max,
all-reduced over the mesh dimensions that shard the leaf); top-k selects
over each pod's whole leaf (gathered over those dimensions), with
``compression.topk_index``'s lower-index-first tie rule, and each rank
keeps its block of the result.  The store's bookkeeping runs on its
small state, which every rank holds whole.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import duot as duot_lib
from repro_torch.core import xstcc
from repro_torch.core.consistency import ConsistencyLevel, ConsistencyPolicy
from repro_torch.core.replicated_store import ReplicatedStore
from repro_torch.device import resolve_device
from repro_torch.kernels.fp import div_f32
from repro_torch.models import sharding
from repro_torch.sync import compression
from repro_torch.tree import leaves, tree_map

Tensor = torch.Tensor


class SyncState(NamedTuple):
    cluster: xstcc.ClusterState   # P pods as both clients and replicas
    duot: duot_lib.Duot           # op log for the audit layer
    anchor: Any                   # last merged snapshot (compression) or None
    residual: Any                 # top-k error feedback or None
    merges: Tensor                # () int32
    inter_pod_gb: Tensor          # () float32 — analytic billed traffic
    violations: Tensor            # () int32 — audit-detected violations
    severity: Tensor              # () float32 — last audit severity


def _host_mask(up) -> np.ndarray:
    if isinstance(up, Tensor):
        up = up.detach().cpu().numpy()
    return np.asarray(up, bool)


class SyncEngine:
    """Per-policy merge engine over pod-stacked parameter trees."""

    def __init__(self, policy: ConsistencyPolicy, n_pods: int,
                 params_template=None, device="cuda"):
        self.policy = policy
        self.n_pods = max(1, n_pods)
        self.device = resolve_device(device)
        p = self.n_pods
        # All session-floor / clock bookkeeping goes through the store
        # facade: pods are both the clients and the replicas, and the
        # single resource is the parameter vector.
        self._store = ReplicatedStore(
            p, p, 1, level=policy.level, merge_every=policy.delta_steps,
            delta=policy.delta_steps, pending_cap=max(4 * p, 16),
            duot_cap=policy.duot_capacity, device=self.device,
        )
        self._wire_gb = None
        if params_template is not None:
            self._wire_gb = self.merge_wire_bytes(
                self.payload_bytes(params_template)) / 1e9

    # -- static accounting ---------------------------------------------------

    def payload_bytes(self, params_template) -> float:
        """One pod's merge payload in bytes (analytic, for the bill).
        ``params_template``: the pod-stacked tree; only shapes and dtypes
        are read (meta tensors will do)."""
        inner = tree_map(lambda l: torch.empty(tuple(l.shape[1:]), dtype=l.dtype,
                                               device="meta"), params_template)
        method = (self.policy.compress_inter_pod
                  if self.policy.level is ConsistencyLevel.X_STCC else "none")
        return compression.wire_bytes(inner, method, self.policy.topk_fraction)

    def merge_wire_bytes(self, payload: float) -> float:
        """Total inter-pod wire bytes of ONE merge, by collective shape.

        ALL/CAUSAL/TCC/X-STCC(mean): ring all-reduce  = 2(P-1) x payload
        QUORUM: all-reduce within the quorum          = 2(q-1) x payload
        ONE: neighbor gossip (one hop per pod)        =      P x payload
        X-STCC compressed: quantized ring reduce      = 2(P-1) x payload'
        (payload' already reflects the compression.)"""
        p = self.n_pods
        lv = self.policy.level
        if p <= 1:
            return 0.0
        if lv is ConsistencyLevel.ONE:
            return p * payload
        if lv is ConsistencyLevel.QUORUM:
            q = self.policy.quorum_size(p)
            return 2 * max(q - 1, 1) * payload
        return 2 * (p - 1) * payload

    # -- state ---------------------------------------------------------------

    def init_state(self, params_stacked) -> SyncState:
        needs_anchor = (
            self.policy.level is ConsistencyLevel.X_STCC
            and self.policy.compress_inter_pod != "none"
        )
        anchor = (tree_map(lambda x: sharding.map_local(torch.clone, sharding.pod_row(x, 0)),
                           params_stacked) if needs_anchor else None)
        residual = (
            tree_map(lambda x: sharding.map_local(torch.zeros_like, x), params_stacked)
            if self.policy.compress_inter_pod == "topk"
            else None
        )
        store0 = self._store.init()
        dev = self.device
        return SyncState(
            cluster=store0.cluster,
            duot=store0.duot,
            anchor=anchor,
            residual=residual,
            merges=torch.zeros((), dtype=torch.int32, device=dev),
            inter_pod_gb=torch.zeros((), dtype=torch.float32, device=dev),
            violations=torch.zeros((), dtype=torch.int32, device=dev),
            severity=torch.zeros((), dtype=torch.float32, device=dev),
        )

    # -- merges --------------------------------------------------------------

    def merge(self, params, sync: SyncState, up=None) -> tuple[Any, SyncState]:
        """Apply the policy's inter-pod merge to pod-stacked ``params``
        (written in place and returned).

        ``up`` (``(P,)`` bool, ``None`` = all) masks the merge: pods
        outside the mask drop out — they neither contribute to nor
        receive this merge's combined parameters, and the protocol
        bookkeeping propagates only among the live pods.  A dropped pod
        keeps its local parameters and catches up at the next merge it
        participates in — the Δ bound caps how stale it can get.
        """
        if self.n_pods == 1:
            return params, sync._replace(merges=sync.merges + 1)
        up = None if up is None else _host_mask(up)
        level = self.policy.level
        if level in (ConsistencyLevel.ALL, ConsistencyLevel.TWO, ConsistencyLevel.CAUSAL):
            self._mean_merge(params, up)
        elif level is ConsistencyLevel.QUORUM:
            self._quorum_merge(params, sync.merges, up)
        elif level is ConsistencyLevel.ONE:
            self._gossip_merge(params, up)
        else:  # TCC / X_STCC
            self._xstcc_merge(params, sync, up)
        sync = self._bookkeep(sync, level, up)
        return params, sync

    def _pod_weights(self, up: np.ndarray | None):
        """``((P,) f32 weights, live count)`` for masked reductions;
        ``(None, None)`` without a mask."""
        if up is None:
            return None, None
        w = torch.as_tensor(up.astype(np.float32), device=self.device)
        return w, torch.clamp(torch.sum(w), min=1.0)

    @staticmethod
    def _pods(w: Tensor, x, ndim: int) -> Tensor:
        """``w`` (per pod) at the pods of ``x``'s local rows, shaped to
        broadcast over a ``ndim``-dim block."""
        rows = sharding.pod_rows(x)
        w = w[rows.start:rows.stop]
        return w.reshape((len(rows),) + (1,) * (ndim - 1))

    def _write(self, x, merged: Tensor, up: np.ndarray | None) -> None:
        """``x`` (P, ...) takes ``merged`` (f32, x's inner block) at the
        live pods, cast to x's dtype; dropped pods keep their rows."""
        xl = sharding.local(x)
        if up is None:
            xl.copy_(merged.expand_as(xl))
            return
        for j, i in enumerate(sharding.pod_rows(x)):
            if up[i]:
                xl[j].copy_(merged)

    def _mean(self, v: Tensor, x, w: Tensor | None, n) -> Tensor:
        """The (masked) mean over every pod of f32 ``v`` (``x``'s local
        rows)."""
        if w is None:
            return div_f32(sharding.pod_sum(v, x), self.n_pods)
        return sharding.pod_sum(v * self._pods(w, x, v.dim()), x) / n

    def _mean_merge(self, params, up: np.ndarray | None) -> None:
        w, n = self._pod_weights(up)
        for x in leaves(params):
            self._write(x, self._mean(sharding.local(x).to(torch.float32), x, w, n), up)

    def _quorum_merge(self, params, merges: Tensor, up: np.ndarray | None) -> None:
        p = self.n_pods
        q = self.policy.quorum_size(p)
        idx = torch.arange(p, dtype=torch.int32, device=self.device)
        member = torch.remainder(idx - torch.remainder(merges, p), p) < q
        if up is not None:
            member = member & torch.as_tensor(up, device=self.device)
            denom = torch.clamp(torch.sum(member.to(torch.float32)), min=1.0)
        else:
            denom = torch.full((), float(q), dtype=torch.float32, device=self.device)
        for x in leaves(params):
            xl = sharding.local(x)
            mask = self._pods(member, x, xl.dim())
            x32 = xl.to(torch.float32)
            msum = sharding.pod_sum(torch.where(mask, x32, 0.0), x, keepdim=True)
            xl.copy_(torch.where(mask, msum / denom, x32))

    def _gossip_merge(self, params, up: np.ndarray | None) -> None:
        # A gossip hop runs only when both endpoints are live.
        ok = None
        if up is not None:
            ok = torch.as_tensor(up & np.roll(up, 1), device=self.device)
        for x in leaves(params):
            xl = sharding.local(x)
            x32 = xl.to(torch.float32)
            rows = sharding.pod_rows(x)
            prev = torch.roll(sharding.pod_gather(x32, x), 1, dims=0)[rows.start:rows.stop]
            mixed = (x32 + prev) * 0.5
            if ok is not None:
                mixed = torch.where(self._pods(ok, x, xl.dim()), mixed, x32)
            xl.copy_(mixed)

    def _xstcc_merge(self, params, sync: SyncState, up: np.ndarray | None) -> None:
        method = self.policy.compress_inter_pod
        if method == "none":
            self._mean_merge(params, up)
            return
        w, n = self._pod_weights(up)
        if method == "int8":
            for x, a in zip(leaves(params), leaves(sync.anchor)):
                self._int8_leaf(x, a, w, n, up)
            return
        for x, a, r in zip(leaves(params), leaves(sync.anchor), leaves(sync.residual)):
            self._topk_leaf(x, a, r, w, n, up)

    def _int8_leaf(self, x, a, w, n, up) -> None:
        """Quantize each pod's delta from the anchor to int8 (per-pod
        scale: the max over the pod's whole leaf), average the dequantized
        deltas, and move the anchor there.  ``d`` holds delta, then the
        codes, then their dequantized values in place: the codes are
        integers in [-127, 127], exact in f32, so the int8 round trip
        changes nothing."""
        xl, al = sharding.local(x), sharding.local(a)
        a32 = al.to(torch.float32)
        d = xl.to(torch.float32, copy=True).sub_(a32)
        lo, hi = torch.aminmax(d.reshape(d.shape[0], -1), dim=1)
        amax = sharding.shards_reduce(torch.maximum(-lo, hi), x, "max")
        scale = div_f32(torch.clamp(amax, min=1e-12), 127.0)
        sb = scale.reshape((d.shape[0],) + (1,) * (d.dim() - 1))
        d.div_(sb).round_().clamp_(-127, 127).mul_(sb)
        merged = self._mean(d, x, w, n).add_(a32)
        del d
        self._write(x, merged, up)
        al.copy_(merged)

    def _topk_leaf(self, x, a, r, w, n, up) -> None:
        """Top-k with error feedback: each pod sends its k largest-magnitude
        delta entries (plus its residual) of its whole leaf, keeps the rest
        as residual."""
        xl, al, rl = sharding.local(x), sharding.local(a), sharding.local(r)
        a32 = al.to(torch.float32)
        delta = xl.to(torch.float32, copy=True).sub_(a32).add_(rl.to(torch.float32))
        whole = sharding.shards_whole(delta, x)
        del delta
        flat = whole.reshape(whole.shape[0], -1)
        k = max(1, int(flat.shape[1] * self.policy.topk_fraction))
        idx = compression.topk_index(torch.abs(flat), k)
        sparse = torch.zeros_like(flat).scatter_(1, idx, torch.gather(flat, 1, idx))
        resid = sharding.shards_block(flat.scatter_(1, idx, 0.0).reshape(whole.shape), x)
        sparse = sharding.shards_block(sparse.reshape(whole.shape), x)
        merged = self._mean(sparse, x, w, n).add_(a32)
        if up is None:
            rl.copy_(resid)
        else:
            # A dropped pod transmits nothing: its residual is untouched.
            for j, i in enumerate(sharding.pod_rows(x)):
                if up[i]:
                    rl[j].copy_(resid[j])
        self._write(x, merged, up)
        al.copy_(merged)

    # -- protocol bookkeeping --------------------------------------------------

    def _bookkeep(self, sync: SyncState, level: ConsistencyLevel,
                  up: np.ndarray | None = None) -> SyncState:
        """Register this merge in the protocol state.

        Data-plane mirror of the merge: each pod *writes* its update at
        its home replica; each pod then *reads* at its neighbor replica
        (the paper's Fig. 2 mobility scenario — Bob reconnecting to a
        different server); finally the server-side propagation runs.

        Synchronous levels (ALL/TWO/QUORUM) propagate before the reads
        (write-acks span the replica set); causal-family levels
        propagate after, bounded by Δ — so ONE and plain CAUSAL expose
        session violations at the neighbor read, while X-STCC's
        enforcement repairs them (and counts zero).

        ``up`` masks the propagation to the pods in this merge: a
        dropped pod still commits its local write (it keeps training),
        but the server-side merge only moves versions among live pods,
        so its replica goes observably stale until it rejoins."""
        p = self.n_pods
        store = self._store
        st = store.wrap(sync.cluster, sync.duot)
        idx = torch.arange(p, dtype=torch.int32, device=self.device)
        res0 = torch.zeros((p,), dtype=torch.int32, device=self.device)

        # One batched write per pod at its home replica.
        st, _ = store.write_batch(st, client=idx, replica=idx, resource=res0)

        sync_ack = level in (
            ConsistencyLevel.ALL, ConsistencyLevel.TWO, ConsistencyLevel.QUORUM
        )
        if sync_ack:
            # Write acks span the replica set before the write commits.
            st, _ = store.merge(st, delta=0, up=up)

        # Batched read at the *neighbor* replica (client mobility).
        # X-STCC enforces the session floors; weaker levels serve raw
        # replicas.
        st, reads = store.read_batch(
            st, client=idx, replica=torch.remainder(idx + 1, p), resource=res0
        )
        viol = sync.violations + torch.sum(reads.violation.to(torch.int32))

        if not sync_ack:
            # Timed-causal propagation (bounded by Δ for TCC/X-STCC).
            st, _ = store.merge(st, delta=self.policy.delta_steps, up=up)

        severity = sync.severity
        if self.policy.audit_every and level.is_causal:
            severity = store.audit(st, delta=self.policy.delta_steps * p).severity
            # GC entries covered at every replica.
            st = store.gc(st)

        gb = float(np.float32(0.0 if self._wire_gb is None else self._wire_gb))
        return sync._replace(
            cluster=st.cluster,
            duot=st.duot,
            merges=sync.merges + 1,
            inter_pod_gb=sync.inter_pod_gb + gb,
            violations=viol,
            severity=severity,
        )
