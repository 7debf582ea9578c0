"""Plain NumPy reference of the flat X-STCC replay (paper §3.4), written
from the semantics and independent of the program under test.

It replays the same op stream in the same rounds as the engine it judges,
one round of ``b`` ops at a time, and keeps the whole store on the host:

* **Client side.**  A write creates the resource's next version and raises
  its session's read and write floors.  A read is served by its replica:
  the replica's applied version at the start of the round, joined with
  every write the replica can see by op ``g`` (earlier writes of the round
  coordinated by the same replica, any write whose emulated apply point is
  ``<= g``, and any pending write of an earlier round whose apply point is
  ``<= g``); under X-STCC's session guarantees the served version is raised
  to the session's floors (monotonic read, read your writes).  A read is
  stale when it returns less than the resource's latest version.
* **Clocks.**  Fidge clocks chained op by op: an op joins its session's
  clock with its replica's and ticks its own component; a write raises the
  replica's clock to the result.
* **Apply points.**  The level's merge cadence (every ``sync_every`` ops,
  timed bound Δ) inside a round, emulated in closed form: a write is
  visible everywhere from ``min(timed(w), max(boundary after w, its
  session's previous write's point, its coordinator's latest point))``.
* **Server side.**  At the end of each round every pending write that is
  Δ-overdue, or whose causal dependencies every replica already holds, is
  applied at every replica, to a fixpoint.
* **Pending ring** of ``pending_cap`` slots: the k-th write of a round takes
  the k-th free slot; a write that finds none is dropped and counted.
* **DUOT** of the first ``duot_cap`` ops, and its audit (paper eq. 1a–1d,
  the timed bound, the ODG-weighted severity).

``enforce_sessions=False`` serves reads without the floors: the control,
which breaks the client-side guarantee the configuration states.
"""

from __future__ import annotations

import numpy as np

READ, WRITE = 0, 1
BIG = 2 ** 30           # the apply point of a read: never
INT32_MAX = 2 ** 31 - 1


def cadence(merge_every: int, delta: int) -> tuple[int, int]:
    """(sync_every, effective Δ) of the timed levels: merges every
    ``merge_every`` ops, Δ cut to a third (never below 1)."""
    return merge_every, max(1, delta // 3)


def apply_points(client, home, kind, *, sync_every: int, delta: int, n_clients: int,
                 n_replicas: int, start: int = 0, carry=None):
    """Emulated apply op-index of each op ``start + i`` (reads: ``BIG``).

    Merges run after ops ``k*s - 1``, the logical clock at op ``g`` is
    ``g + g//s``; a write is Δ-overdue at the first merge whose clock
    exceeds its commit clock by Δ.  ``carry`` = (per-client, per-replica)
    last points, continued across calls; returns (points, carry)."""
    s, d = int(sync_every), int(delta)
    g = start + np.arange(len(client), dtype=np.int64)
    cs = g + g // s
    timed = (np.maximum((d + cs + 1 + s) // (s + 1), (g + s) // s) * s).tolist()
    base = ((g // s + 1) * s).tolist()
    last_a, rep_a = carry if carry is not None else ([0] * n_clients, [0] * n_replicas)
    out = [BIG] * len(client)
    for i, (c, p, w) in enumerate(zip(np.asarray(client).tolist(), np.asarray(home).tolist(),
                                      (np.asarray(kind) == WRITE).tolist())):
        if not w:
            last_a[c] = BIG
            continue
        a = min(timed[i], max(base[i], last_a[c], rep_a[p]))
        last_a[c] = a
        if a > rep_a[p]:
            rep_a[p] = a
        out[i] = a
    return np.asarray(out, np.int64), (last_a, rep_a)


def _prefix_max_excl(group: np.ndarray, value: np.ndarray) -> np.ndarray:
    """Per op, the max of ``value`` over the earlier ops of its group
    (``-1`` for none): a stable sort by group, a running max that restarts
    at each group, shifted by one."""
    n = len(group)
    order = np.argsort(group, kind="stable")
    g = group[order]
    v = value[order].astype(np.int64)
    start = np.ones(n, bool)
    start[1:] = g[1:] != g[:-1]
    gid = np.cumsum(start) - 1
    run = np.maximum.accumulate(gid * 2 ** 32 + v) - gid * 2 ** 32
    excl = np.empty(n, np.int64)
    excl[0] = -1
    excl[1:] = np.where(start[1:], -1, run[:-1])
    out = np.empty(n, np.int64)
    out[order] = excl
    return out


def _timeline_max(ev_res, ev_time, ev_val, q_res, q_time) -> np.ndarray:
    """Per query, the max ``ev_val`` over the events on its resource with
    ``ev_time <= q_time`` (0 for none)."""
    nq = len(q_res)
    res = np.concatenate([ev_res, q_res]).astype(np.int64)
    time = np.concatenate([ev_time, q_time]).astype(np.int64)
    kind = np.concatenate([np.zeros(len(ev_res), np.int64), np.ones(nq, np.int64)])
    val = np.concatenate([np.asarray(ev_val, np.int64), np.zeros(nq, np.int64)])
    order = np.lexsort((kind, time, res))
    r = res[order]
    start = np.ones(len(r), bool)
    start[1:] = r[1:] != r[:-1]
    gid = np.cumsum(start) - 1
    run = np.maximum.accumulate(gid * 2 ** 32 + val[order]) - gid * 2 ** 32
    out = np.empty(len(r), np.int64)
    out[order] = run
    return out[len(ev_res):]


class Store:
    """The flat store of ``n_replicas`` replicas, ``n_clients`` sessions and
    ``n_resources`` rows, with its pending ring and DUOT."""

    def __init__(self, *, n_replicas: int, n_clients: int, n_resources: int,
                 pending_cap: int, duot_cap: int, sync_every: int, delta: int,
                 enforce_sessions: bool = True):
        P, C, R, Q = n_replicas, n_clients, n_resources, pending_cap
        self.P, self.C, self.R, self.Q = P, C, R, Q
        self.sync_every, self.delta = sync_every, delta
        self.enforce = enforce_sessions
        i32 = np.int32
        self.rv = np.zeros((P, R), i32)
        self.rvc = np.zeros((P, C), i32)
        self.svc = np.zeros((C, C), i32)
        self.rf = np.zeros((C, R), i32)
        self.wf = np.zeros((C, R), i32)
        self.gv = np.zeros((R,), i32)
        self.pend = {
            "client": np.full(Q, -1, i32), "resource": np.full(Q, -1, i32),
            "version": np.zeros(Q, i32), "vc": np.zeros((Q, C), i32),
            "coord": np.full(Q, -1, i32), "time": np.zeros(Q, i32),
            "live": np.zeros(Q, bool), "applied": np.zeros((Q, P), bool),
            "apply": np.zeros(Q, i32),
        }
        self.dropped = 0
        self.clock = 0
        self.duot = {
            "client": np.full(duot_cap, -1, i32), "kind": np.zeros(duot_cap, i32),
            "resource": np.full(duot_cap, -1, i32), "version": np.zeros(duot_cap, i32),
            "replica": np.full(duot_cap, -1, i32), "seq": np.zeros(duot_cap, i32),
            "vc": np.zeros((duot_cap, C), i32), "valid": np.zeros(duot_cap, bool),
        }
        self.duot_size = 0
        self.next_seq = 0
        self.stale = self.viol = self.reads = 0
        self._carry = None

    # -- one round -------------------------------------------------------------

    def round(self, client, home, resource, kind, step0: int) -> dict:
        """Ingest ``b`` ops (global indices ``step0 ..``), then the boundary
        merge.  Returns the per-op answers: ``version`` (created or served),
        ``stale``, ``violation``, ``dropped``."""
        c = np.asarray(client, np.int64)
        p = np.asarray(home, np.int64)
        r = np.asarray(resource, np.int64)
        k = np.asarray(kind)
        b = len(c)
        is_w = k == WRITE
        g = step0 + np.arange(b, dtype=np.int64)
        a, self._carry = apply_points(c, p, k, sync_every=self.sync_every, delta=self.delta,
                                      n_clients=self.C, n_replicas=self.P, start=step0,
                                      carry=self._carry)
        # Versions: the resource's write count so far.
        g0 = self.gv[r].astype(np.int64)
        occ = _prefix_count_excl(r, is_w)
        gcur = g0 + occ
        ver_w = gcur + 1
        # What each replica shows op i.
        raw = self.rv[p, r].astype(np.int64)
        same = _prefix_max_excl(r * self.P + p, np.where(is_w, ver_w, -1))
        raw = np.maximum(raw, same)
        pend = self.pend
        lv = np.flatnonzero(pend["live"])
        wj = np.flatnonzero(is_w)
        seen = _timeline_max(
            np.concatenate([pend["resource"][lv], r[wj]]),
            np.concatenate([pend["apply"][lv], a[wj]]),
            np.concatenate([pend["version"][lv], ver_w[wj]]),
            r, g)
        raw = np.maximum(raw, seen)
        # Session floors: the floor at the round's start joined with the
        # session's earlier ops on the row in this round.
        floor0 = np.maximum(self.rf[c, r], self.wf[c, r]).astype(np.int64)
        contrib = np.where(is_w, ver_w, raw)
        floor = np.maximum(floor0, _prefix_max_excl(c * self.R + r, contrib))
        served = np.maximum(raw, floor) if self.enforce else raw
        stale = ~is_w & (served < gcur)
        violation = ~is_w & (not self.enforce) & (raw < floor)
        version = np.where(is_w, ver_w, served)
        vcs = self._chain(c, p, is_w)
        # Pending ring: the k-th write takes the k-th free slot.
        free = np.flatnonzero(~pend["live"])
        wrank = np.cumsum(is_w) - 1
        enq = is_w & (wrank < len(free))
        dropped = is_w & ~enq
        qi = np.flatnonzero(enq)
        slot = free[wrank[qi]]
        pend["client"][slot] = c[qi]
        pend["resource"][slot] = r[qi]
        pend["version"][slot] = ver_w[qi]
        pend["vc"][slot] = vcs[qi]
        pend["coord"][slot] = p[qi]
        pend["time"][slot] = self.clock + qi
        pend["live"][slot] = True
        pend["applied"][slot] = np.arange(self.P)[None, :] == p[qi][:, None]
        pend["apply"][slot] = a[qi]
        self.dropped = min(INT32_MAX, self.dropped + int(dropped.sum()))
        # The batch's effects on the replicas' rows, floors and frontier.
        np.maximum.at(self.rv, (p[wj], r[wj]), ver_w[wj].astype(np.int32))
        np.maximum.at(self.rf, (c, r), version.astype(np.int32))
        np.maximum.at(self.wf, (c[wj], r[wj]), ver_w[wj].astype(np.int32))
        np.maximum.at(self.gv, r[wj], ver_w[wj].astype(np.int32))
        self.clock += b
        self._record(c, k, r, version, p, vcs)
        self._merge()
        self.stale += int(stale.sum())
        self.viol += int(violation.sum())
        self.reads += int((~is_w).sum())
        return {"version": version, "stale": stale, "violation": violation,
                "dropped": dropped, "vc": vcs}

    def _chain(self, c, p, is_w) -> np.ndarray:
        """The ops' clocks, op by op; updates the session and replica clocks.

        Rows ``0 .. C-1`` of one table hold the sessions' clocks at the
        round's start, rows ``C .. C+P-1`` the replicas', and row ``C + P +
        i`` op ``i``'s clock; ``last[s]`` and ``rep[q]`` are the rows of
        session ``s``'s and replica ``q``'s latest clock.  A write's clock
        already dominates its replica's, so it becomes the replica's."""
        C, P = self.C, self.P
        table = np.empty((C + P + len(c), C), np.int32)
        table[:C] = self.svc
        table[C:C + P] = self.rvc
        rows = list(table)
        last = list(range(C))
        rep = list(range(C, C + P))
        for i, (ci, pi, wi) in enumerate(zip(c.tolist(), p.tolist(), is_w.tolist()), C + P):
            row = rows[i]
            np.maximum(rows[last[ci]], rows[rep[pi]], out=row)
            row[ci] += 1
            last[ci] = i
            if wi:
                rep[pi] = i
        self.svc[:] = table[last]
        self.rvc[:] = table[rep]
        return table[C + P:]

    def _record(self, c, k, r, version, p, vcs) -> None:
        d = self.duot
        cap = len(d["client"])
        b = len(c)
        n = max(0, min(b, cap - self.duot_size))
        lo, hi = self.duot_size, self.duot_size + n
        for name, v in (("client", c), ("kind", k), ("resource", r), ("version", version),
                        ("replica", p), ("vc", vcs)):
            d[name][lo:hi] = v[:n]
        d["seq"][lo:hi] = self.next_seq + np.arange(n)
        d["valid"][lo:hi] = True
        self.duot_size = hi
        self.next_seq += b

    def _merge(self) -> None:
        """The boundary merge: apply every Δ-overdue or causally ready
        pending write at every replica, until nothing more applies."""
        pend = self.pend
        idx = np.flatnonzero(pend["live"])
        if len(idx):
            vc = pend["vc"][idx].astype(np.int64)
            dep = vc.copy()
            dep[np.arange(len(idx)), pend["client"][idx]] -= 1
            overdue = (self.clock - pend["time"][idx].astype(np.int64)) >= self.delta
            applied = pend["applied"][idx].copy()
            done = applied.all(axis=1)
            res = pend["resource"][idx].astype(np.int64)
            ver = pend["version"][idx]
            while True:
                # Every replica holds the dependencies: they lie under the
                # replicas' componentwise least clock.
                ready = (dep <= self.rvc.min(axis=0)).all(axis=1)
                new = ~done & (overdue | ready)
                if not new.any():
                    break
                for q in range(self.P):
                    at = new & ~applied[:, q]
                    np.maximum.at(self.rv[q], res[at], ver[at])
                    if at.any():
                        np.maximum(self.rvc[q], vc[at].max(axis=0).astype(np.int32),
                                   out=self.rvc[q])
                applied |= new[:, None]
                done |= new
            pend["applied"][idx] = applied
            pend["live"][idx] = ~done
        self.clock += 1

    # -- the audit -------------------------------------------------------------

    def audit(self) -> dict:
        """The DUOT audit: per-kind pair counts and the ODG-weighted
        severity (float32, as the engine's result carries it)."""
        return audit_log(self.duot, self.delta)


def _prefix_count_excl(group: np.ndarray, flag: np.ndarray) -> np.ndarray:
    """Per op, how many earlier ops of its group have ``flag``."""
    order = np.argsort(group, kind="stable")
    g = group[order]
    f = flag[order].astype(np.int64)
    cum = np.cumsum(f)
    start = np.ones(len(g), bool)
    start[1:] = g[1:] != g[:-1]
    first = np.flatnonzero(start)
    base = (cum - f)[first]
    gid = np.cumsum(start) - 1
    out = np.empty(len(g), np.int64)
    out[order] = cum - f - base[gid]
    return out


PAIR_BLOCK = 1 << 22    # pairs classified at a time


def audit_log(duot: dict, delta: int) -> dict:
    """Classify every ordered pair of live entries on one resource.

    Same client and happens-before: a1 R,R; a2 W,W; a3 W,R; a4 R,W; other
    clients and happens-before: b1; no happens-before: b2 (never a
    violation).  Violations: a1 and a3 when the later op's version is
    lower, a2 and a4 when not higher, b1 (W then R) when lower; and the
    timed bound: a (write, later read) more than Δ apart whose read
    missed the write.  Severity weighs violated data edges 3, causal
    edges 2, the rest 1, over the same weights of all audited edges.

    Happens-before is read off the Fidge clocks: op ``i`` of session ``c``
    precedes op ``j`` exactly when ``vc_j[c] >= vc_i[c]`` (only session
    ``c``'s ops tick its component, and every clock is a join of earlier
    ones).  The pairs are taken ``PAIR_BLOCK`` at a time: a hot resource
    holds most of the log, and its pairs run to tens of millions."""
    ent = np.flatnonzero(duot["valid"])
    order = ent[np.lexsort((duot["seq"][ent], duot["resource"][ent]))]
    n = len(order)
    r_sorted = duot["resource"][order]
    starts = np.flatnonzero(np.r_[True, r_sorted[1:] != r_sorted[:-1]]) if n else \
        np.zeros(0, np.int64)
    sizes = np.diff(np.r_[starts, n])
    # Row ``i`` of the sorted log pairs with every later row of its group.
    n_pairs = np.repeat(starts + sizes, sizes) - np.arange(n) - 1
    cum = np.cumsum(n_pairs)
    seq = duot["seq"].astype(np.int64)
    kind, ver, cl, vc = duot["kind"], duot["version"], duot["client"], duot["vc"]
    w_num = w_den = n_audited = n_viol = 0
    row = 0
    while row < n:
        done = cum[row - 1] if row else 0
        stop = max(row + 1, int(np.searchsorted(cum, done + PAIR_BLOCK, side="right")))
        cnt = n_pairs[row:stop]
        ii = np.repeat(np.arange(row, stop), cnt)
        first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        jj = ii + 1 + (np.arange(len(ii)) - first)
        row = stop
        if not len(ii):
            continue
        i, j = order[ii], order[jj]
        ci = cl[i].astype(np.int64)
        hb = vc[j, ci] >= vc[i, ci]
        same = ci == cl[j]
        ki, kj, vi, vj = kind[i], kind[j], ver[i], ver[j]
        a1 = same & hb & (ki == READ) & (kj == READ)
        a2 = same & hb & (ki == WRITE) & (kj == WRITE)
        a3 = same & hb & (ki == WRITE) & (kj == READ)
        a4 = same & hb & (ki == READ) & (kj == WRITE)
        b1 = ~same & hb
        viol = ((a1 & (vj < vi)) | (a2 & (vj <= vi)) | (a3 & (vj < vi)) | (a4 & (vj <= vi))
                | (b1 & (ki == WRITE) & (kj == READ) & (vj < vi)))
        data = (ki == WRITE) & (kj == READ)
        timed = data & ((seq[j] - seq[i]) > delta) & (vj < vi) if delta > 0 else \
            np.zeros_like(viol)
        causal = hb
        other = ~causal & ~data
        n_audited += len(i)
        n_viol += int(viol.sum()) + int(timed.sum())
        w_num += (3 * int((viol & data).sum()) + 2 * int((viol & causal & ~data).sum())
                  + int(((viol | timed) & other).sum()))
        w_den += 3 * int(data.sum()) + 2 * int((causal & ~data).sum()) + int(other.sum())
    severity = np.float32(w_num) / np.float32(max(w_den, 1))
    return {"n_audited": n_audited, "n_violations": n_viol, "severity": float(severity)}


# -- the bill (paper eq. 5–8) ---------------------------------------------------

# The paper's cluster (§4, Fig. 7) and prices (Table 2).
N_NODES = 24
NODE_OPS_S = 4200.0
ROW_BYTES = 1024
REPLICAS_PER_DC = 4
INTRA_DC_RTT_MS = 0.115
HOSTED_GB = 18.65
PRICE_INSTANCE_HOUR = 0.0464
PRICE_GB_MONTH = 0.10
PRICE_PER_MILLION_IO = 0.10
PRICE_INTER_DC_GB = 0.01
PRICE_INTRA_DC_GB = 0.00
# X-STCC's terms: local DUOT repair of a stale read, the piggybacked DUOT
# append of a write, no remote repair traffic.
REPAIR_COST = 0.25
WRITE_COORD = 0.02
REPAIR_REMOTE = 0.0


def bill(*, read_fraction: float, n_operations: int, n_threads: int,
         stale_rate: float) -> dict[str, float]:
    """The X-STCC bill of one experiment from its measured staleness: the
    closed-loop throughput model (8 requests in flight per thread, smooth
    saturation at the cluster's capacity), the traffic model and eq. 5–8.
    A write commits at the nearest replica (the intra-DC RTT); a read is
    served there, and a stale one is repaired inside the DC."""
    r = read_fraction
    rtt = INTRA_DC_RTT_MS
    lat = r * (rtt + stale_rate * INTRA_DC_RTT_MS) + (1 - r) * rtt
    offered = 8 * n_threads / (lat / 1e3)
    work = 1.0 + r * stale_rate * REPAIR_COST + (1 - r) * WRITE_COORD
    capacity = N_NODES * NODE_OPS_S / work
    thr = offered / (1.0 + (offered / capacity) ** 2) ** 0.5
    if n_threads > 64:
        thr *= 1.0 - 0.08 * (n_threads - 64) / 36.0
    runtime_s = n_operations / thr
    writes = (1 - r) * n_operations
    reads = r * n_operations
    inter = writes * 8 * ROW_BYTES
    intra = writes * 3 * ROW_BYTES
    inter += reads * 0 * ROW_BYTES
    intra += reads * 1 * ROW_BYTES
    inter += reads * stale_rate * REPAIR_REMOTE * ROW_BYTES
    inter += writes * 8 * 64
    intra += writes * 3 * 64
    inter_gb, intra_gb = inter / 1e9, intra / 1e9
    hours = runtime_s / 3600.0
    months = runtime_s / (30 * 24 * 3600.0)
    instances = N_NODES * PRICE_INSTANCE_HOUR * hours
    storage = HOSTED_GB * PRICE_GB_MONTH * months + (
        float(n_operations) * 1 / 1e6) * PRICE_PER_MILLION_IO
    network = inter_gb * PRICE_INTER_DC_GB + intra_gb * PRICE_INTRA_DC_GB
    return {"throughput_ops_s": thr, "inter_dc_gb": inter_gb, "intra_dc_gb": intra_gb,
            "instances": instances, "storage": storage, "network": network,
            "total": instances + storage + network}
