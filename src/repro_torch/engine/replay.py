"""The epoch engine's replay (port of ``repro.engine.replay``).

One round step — crash and rejoin (state loss, durable restore, peer
bootstrap), heal-time hint drain and anti-entropy, failover, op ingest,
hint enqueue, the boundary merge (masked under faults, two-tier over a
region topology, both together), the gossip exchange, WAL/snapshot
journaling, counters, the per-region telemetry and the obs histograms —
runs once per merge round.  The reference scans it under one ``jit``
with every feature a statically gated section; here the round loop is
Python and every section is a plain ``if``.  The per-round masks
(``up``, ``conn``, ``faulty``, ``heal``, ``crash``, ``rejoin``,
``gossip``, ``snap``, ``pairs``) stay on the host, so a ``lax.cond``
becomes an ``if`` with no device sync; the stream and what a merge or
kernel consumes go to the device once.  Per round the host reads the DUOT size and one flag per
merge-fixpoint pass.  Disjoint tenant shards (``n_shards > 1``) run one
after another inside each round, each with its own carry, under the
one fault schedule; with ``use_devices`` and a process group of at
least ``n_shards`` ranks (:func:`shard_group`), each rank runs only its
own shard and the carries are gathered at the end.

One deliberate difference on the geo path: the reference sums each op's
f32 RTT into a per-region f32 vector every round, in an order XLA picks.
The port counts ops per (client region, serving region) pair in int64
and forms the latency sums once, at the end, from those counts (see
``results.assemble_geo``), so the card and the CPU agree exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import availability as avail_lib
from repro_torch.core import duot as duot_lib
from repro_torch.core.replicated_store import ReplicatedStore, stack_tree
from repro_torch.device import resolve_device
from repro_torch.engine import stream as stream_lib
from repro_torch.engine.config import EngineConfig
from repro_torch.gossip.scheduler import gossip_pairs
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs import metrics as obs_lib


class EpochEngine:
    """One workload replay on ``device`` (default ``"cuda"``).

    ``EpochEngine(config).replay(w)`` prepares the op stream, the
    cadence plan, the apply-point schedule and the per-round masks on
    the host, then runs the round loop with the state on the device.
    Result assembly lives in :mod:`repro_torch.engine.results`.
    """

    def __init__(self, config: EngineConfig, device: str | torch.device = "cuda",
                 *, telemetry: bool = False):
        self.config = config
        self.device = resolve_device(device)
        # Telemetry mode (the adaptive control plane's feed): per-client
        # count vectors per round, and no DUOT record.
        self.telemetry = telemetry
        c = config
        g = c.gossip
        self.faults_on = c.faults is not None
        self.g_on = g is not None and g.enabled
        # Hinted handoff is a fault-path feature.
        self.h_on = g is not None and g.handoff and self.faults_on
        # The all-up path models durability host-side; only the fault
        # path journals on the device.
        self.d_on = (c.durability is not None and c.durability.enabled
                     and self.faults_on)
        self.w_on = self.d_on and c.durability.wal
        self.s_on = self.d_on and c.durability.snapshot_every > 0
        # Crash events: state loss at the crash epoch, restore and peer
        # bootstrap at the rejoin epoch; the recovery counters run
        # whenever they or the durability layer do.
        self.crashes = self.faults_on and c.faults.has_crashes
        self.rx_on = self.d_on or self.crashes
        self.gx_on = g is not None and self.faults_on
        self.geo_on = c.topology is not None
        # Geo gossip attributes its exchanges to region pairs (all-up).
        self.ggx_on = self.g_on and self.geo_on and not self.faults_on
        self.o_on = c.obs is not None and c.obs.enabled
        if self.o_on:
            self.specs = obs_lib.build_metrics(c.obs, geo_on=self.geo_on,
                                               h_on=self.h_on)
        if self.geo_on:
            topo = c.topology
            dev = self.device
            self.client_reg = torch.from_numpy(
                topo.client_region_of(np.arange(c.n_clients))).long().to(dev)
            self.replica_reg = torch.from_numpy(topo.regions()).long().to(dev)
            self.rtt = torch.from_numpy(topo.rtt()).to(dev)
            self.all_up = torch.ones((topo.n_replicas,), dtype=torch.bool, device=dev)
            self.all_conn = torch.ones((topo.n_replicas,) * 2, dtype=torch.bool,
                                       device=dev)

    def plan(self) -> tuple[int, int, int, bool]:
        c = self.config
        return stream_lib.cadence_plan(
            c.level, c.shard_ops, c.batch_size, c.merge_every, c.delta
        )

    def store(self, w) -> ReplicatedStore:
        """One shard's store (the whole fleet when ``n_shards == 1``)."""
        c = self.config
        return ReplicatedStore(
            c.n_replicas, c.shard_clients, c.shard_resources, level=c.level,
            merge_every=c.merge_every, delta=c.delta,
            pending_cap=c.resolved_pending_cap(w.read_fraction),
            duot_cap=c.duot_cap, ingest=c.ingest,
            hint_cap=c.gossip.hint_cap if self.gx_on else 0,
            durability=c.durability if self.d_on else None,
            device=self.device,
        )

    def _anchored_schedule(self, n_rounds: int, rem: int, sub: int):
        """The fault schedule re-anchored onto this level's rounds: with
        ``schedule_unit``, round ``t`` takes the masks of schedule epoch
        ``t·sub // schedule_unit``.  Crash events fire once: only the first
        round mapped to a schedule epoch inherits its crash flags."""
        c = self.config
        schedule = c.faults
        if c.schedule_unit:
            starts = np.arange(n_rounds + (1 if rem else 0)) * sub
            idx = np.minimum(starts // c.schedule_unit, schedule.n_epochs - 1)
            first = np.ones(idx.shape, bool)
            first[1:] = idx[1:] != idx[:-1]
            schedule = avail_lib.FaultSchedule(
                schedule.up[idx], schedule.link[idx],
                crash=schedule.crashes()[idx] & first[:, None],
            )
        return schedule

    def _fault_masks(self, n_rounds: int, rem: int, sub: int):
        """(schedule, per-round host masks, tail host masks)."""
        c = self.config
        schedule = self._anchored_schedule(n_rounds, rem, sub)
        schedule, masks, tail_masks = stream_lib.fault_epoch_inputs(
            schedule, n_rounds, rem, self.crashes
        )
        n_epochs_total = n_rounds + (1 if rem else 0)
        if c.gossip is not None:
            g_active, g_pairs = gossip_pairs(3, n_epochs_total, c.gossip)
            masks["gossip"] = g_active[:n_rounds]
            masks["pairs"] = g_pairs[:n_rounds]
            tail_masks["gossip"] = g_active[n_epochs_total - 1]
            tail_masks["pairs"] = g_pairs[n_epochs_total - 1]
        if c.durability is not None and c.durability.snapshot_every > 0:
            se = c.durability.snapshot_every
            snap = (np.arange(n_epochs_total) + 1) % se == 0
            masks["snap"] = snap[:n_rounds]
            tail_masks["snap"] = snap[n_epochs_total - 1]
        return schedule, masks, tail_masks

    def prepare(self, w) -> dict[str, Any]:
        """Host-side inputs of one replay: streams, plan, schedule, masks.

        Each shard ``s`` gets its own stream (seed ``seed + s``) of
        ``shard_ops`` ops over ``shard_clients`` clients and
        ``shard_resources`` resources; the masks are shared by every
        shard.  ``streams``, ``batched`` and ``tails`` hold one entry per
        shard, as the reference's do.
        """
        c = self.config
        sub, rem, n_rounds, emulate = self.plan()
        store = self.store(w)
        schedule = masks = tail_masks = None
        if self.faults_on:
            schedule, masks, tail_masks = self._fault_masks(n_rounds, rem, sub)
        elif c.gossip is not None and c.gossip.enabled:
            # All-up gossip: the scheduled pairs only, no fault masks.
            n_epochs_total = n_rounds + (1 if rem else 0)
            g_active, g_pairs = gossip_pairs(
                store.n_replicas, n_epochs_total, c.gossip,
                c.topology if c.gossip.peer == "nearest" else None,
            )
            masks = {"gossip": g_active[:n_rounds], "pairs": g_pairs[:n_rounds]}
            tail_masks = {"gossip": g_active[n_epochs_total - 1],
                          "pairs": g_pairs[n_epochs_total - 1]}

        def dev(d):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                    for k, v in d.items()}

        streams, batched_shards, tails = [], [], []
        for s in range(c.n_shards):
            stream = stream_lib.op_stream(
                w, c.shard_ops, c.shard_clients, c.shard_resources, c.seed + s,
                store.n_replicas,
            )
            batched, tail = self._shard_inputs(
                store, stream, masks, tail_masks, sub, rem, n_rounds, emulate)
            streams.append(stream)
            batched_shards.append(dev(batched))
            tails.append(dev(tail))
        prep = {
            "store": store, "streams": streams, "batched": batched_shards,
            "tails": tails, "sub": sub, "rem": rem, "n_rounds": n_rounds,
            "emulate": emulate, "schedule": schedule, "masks": masks,
            "tail_masks": tail_masks,
        }
        if self.faults_on:
            # What the merges and kernels consume, on the device once.
            prep["dev_masks"] = dev({"up": masks["up"], "conn": masks["conn"]})
            prep["dev_tail_masks"] = dev({"up": tail_masks["up"],
                                          "conn": tail_masks["conn"]})
        return prep

    def _shard_inputs(self, store, stream, masks, tail_masks, sub: int, rem: int,
                      n_rounds: int, emulate: bool) -> tuple[dict, dict]:
        """One shard's ``(n_rounds, sub)`` round inputs and its tail."""
        c = self.config
        if self.faults_on and emulate:
            # The fault path builds its apply schedule by hand:
            # synchronous levels defer to the masked merge under faults,
            # and every level clamps faulty epochs.
            batched = {
                k: stream[k][: n_rounds * sub].reshape(n_rounds, sub)
                for k in stream_lib.OP_COLS
            }
            tail = {k: stream[k][-max(rem, 1):] for k in stream_lib.OP_COLS}
            if store.sync_every > 1:
                apply_idx = store.schedule_stream(
                    stream["client"], stream["home"], stream["kind"]
                )
            else:
                apply_idx = np.zeros(c.shard_ops, np.int32)
            faulty_full = np.concatenate([
                masks["faulty"],
                np.asarray([tail_masks["faulty"]]) if rem else np.zeros(0, bool),
            ])
            apply_idx = stream_lib.clamp_apply_idx(
                apply_idx, faulty_full, sub, c.shard_ops
            )
            batched["apply_idx"] = apply_idx[: n_rounds * sub].reshape(n_rounds, sub)
            tail["apply_idx"] = apply_idx[-max(rem, 1):]
            return batched, tail
        return stream_lib.batch_inputs(stream, store, sub, n_rounds, rem, emulate)

    def _init_carry(self, store: ReplicatedStore) -> dict:
        dev = self.device
        z = torch.zeros((), dtype=torch.int64, device=dev)
        carry = {"st": store.init(), "stale": z, "viol": z, "reads": z}
        if self.faults_on:
            carry.update(ae=z, prop=z, fail=z)
        if self.geo_on:
            g = self.config.topology.n_regions
            zg = torch.zeros((g,), dtype=torch.int64, device=dev)
            carry["traffic"] = torch.zeros((g, g), dtype=torch.int64, device=dev)
            # Per client region: stale reads, reads, and ops by serving
            # region (the latency sums are formed from these at the end).
            carry["reg"] = {"stale": zg, "reads": zg,
                            "pairs": torch.zeros((g, g), dtype=torch.int64,
                                                 device=dev)}
        if self.ggx_on:
            g = self.config.topology.n_regions
            zgg = torch.zeros((g, g), dtype=torch.int64, device=dev)
            carry["ggx"] = {"traffic": zgg, "digest": zgg, "ranges": z, "gap": z}
        if self.gx_on:
            carry["gx"] = {"deliv": z, "ranges": z, "pairs": z, "gap": z}
            if self.h_on:
                carry["gx"].update(
                    h_enq=z, h_drop=z,
                    h_deliv=torch.zeros((store.n_replicas,), dtype=torch.int64,
                                        device=dev),
                )
        if self.rx_on:
            carry["rx"] = {k: z for k in (
                "crashes", "wal_replayed", "rows_lost", "snap_read",
                "boot_cells", "boot_pend", "boot_events",
            )}
        if self.o_on:
            carry["obs"] = {
                "hist": torch.zeros((len(self.specs), self.config.obs.n_bins),
                                    dtype=torch.int32, device=dev),
                "counters": {k: 0 for k in obs_lib.COUNTERS},
            }
        return carry

    def round_step(self, store: ReplicatedStore, carry: dict, ops: dict,
                   m: dict | None, step0: int, width: int, emulate: bool,
                   ys: dict | None) -> dict:
        """One merge round.  ``m`` holds the round's host masks (plus the
        device ``up_t``/``conn_t``); ``ys`` collects the per-round series
        (``None`` for the tail round, whose series are dropped)."""
        c = self.config
        dev = self.device
        lean_merge = c.lean and emulate
        st = carry["st"]
        carry = dict(carry)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        if self.faults_on:
            up, conn = m["up_t"], m["conn_t"]
        if self.crashes:
            carry["rx"] = rx = dict(carry["rx"])
            if m["crash"].any():
                # Crash epoch: the replica's volatile state dies before
                # anything else happens; the durability layer survives.
                st, info = store.crash(st, m["crash"])
                rx["crashes"] = rx["crashes"] + int(m["crash"].sum())
                for k in ("wal_replayed", "rows_lost", "snap_read"):
                    rx[k] = rx[k] + info[k]
            if m["rejoin"].any():
                # Rejoin epoch: pull the stale ranges from the nearest live
                # holder before the replica serves anything.
                dura = c.durability
                st, tel = store.bootstrap(
                    st, targets=m["rejoin"], up=m["up"], link=m["conn"],
                    n_ranges=dura.bootstrap_ranges if dura is not None else 8,
                    impl=dura.impl if dura is not None else None,
                )
                rx["boot_cells"] = rx["boot_cells"] + tel["cells"].sum()
                rx["boot_pend"] = rx["boot_pend"] + tel["pend"].sum()
                rx["boot_events"] = rx["boot_events"] + tel["valid"].sum()
        if self.w_on:
            # Applied copies at the start of the epoch (after recovery):
            # the epoch's growth is what each replica journals.
            applied0 = st.cluster.pend_applied.sum(dim=0, dtype=torch.int32)
        hd = None
        if self.h_on and m["heal"]:
            # Heal epoch: targeted hint deliveries front-run the full
            # anti-entropy pass.
            st, hd = store.drain_hints(st, up=up, link=conn)
        if self.faults_on:
            if m["heal"]:
                # Reconcile the backlog along the newly available links
                # before serving this epoch's ops.
                st, ev = store.anti_entropy(st, up=up, link=conn)
                carry["ae"] = carry["ae"] + ev
            if m["up"].all():
                home = ops["home"]
            else:
                # Ops whose home replica is down fail over to the next
                # live replica in ring order.
                home = avail_lib.reroute_ops(ops["home"], up)
                carry["fail"] = carry["fail"] + (home != ops["home"]).sum()
            if m["faulty"]:
                # While a fault is active the closed-form cadence's
                # "applied everywhere at the apply index" is wrong: defer
                # pending-ring visibility to the real masked merges.
                st = st._replace(pend_apply=torch.clamp(
                    st.pend_apply, min=step0 + width))
        else:
            home = ops["home"]
        if self.w_on:
            # Ring slots claimed by this batch's writes overwrite their
            # old applied bits; keep them so the journal counts gross
            # applies.
            pre_bits = st.cluster.pend_applied
        # -- op ingest ----------------------------------------------------
        st, res = store.apply_batch(
            st, client=ops["client"], replica=home,
            resource=ops["resource"], kind=ops["kind"],
            op_step0=step0 if emulate else None,
            apply_index=ops.get("apply_idx"),
            record=not (c.lean or self.telemetry),
            with_clocks=not lean_merge,
        )
        ne = nd = zero
        if self.h_on and m["faulty"]:
            # Writes served during a fault leave hints for the replicas
            # the coordinator could not reach this epoch.
            st, ne, nd = store.enqueue_hints(
                st, slot=res.slot, version=res.version, kind=ops["kind"],
                home=home, conn=conn,
            )
        # -- boundary merge -----------------------------------------------
        if lean_merge:
            st, _ = store.merge(st, timed_only=True, boundary=step0 + width)
        elif self.geo_on and self.faults_on:
            # Two-tier merge along the live links: propagation is the
            # growth of the applied bits, traffic the (G, G) deliveries.
            before = st.cluster.pend_applied.sum(dtype=torch.int32)
            st, _, tr = store.merge_geo(st, c.topology, up=up, link=conn)
            carry["prop"] = carry["prop"] + (
                st.cluster.pend_applied.sum(dtype=torch.int32) - before)
            carry["traffic"] = carry["traffic"] + tr
        elif self.geo_on:
            st, _, tr = store.merge_geo(st, c.topology)
            carry["traffic"] = carry["traffic"] + tr
        elif self.faults_on:
            st, _, ev = store.merge_faulty(st, up=up, link=conn)
            carry["prop"] = carry["prop"] + ev
        else:
            st, _ = store.merge(st)
        # -- gossip anti-entropy ------------------------------------------
        if self.gx_on:
            gd = gr = gp = gg = zero
            if self.g_on and m["gossip"]:
                st, tel = store.gossip_round(
                    st, pairs=m["pairs"], up=up, link=conn,
                    n_ranges=c.gossip.n_ranges, impl=c.gossip.impl,
                )
                gd = tel["growth"].sum()
                gr = tel["ranges"].sum()
                gp = tel["valid"].sum()
                gg = tel["gap_repaired"]
            gx = dict(carry["gx"])
            gx["deliv"] = gx["deliv"] + gd
            gx["ranges"] = gx["ranges"] + gr
            gx["pairs"] = gx["pairs"] + gp
            gx["gap"] = gx["gap"] + gg
            if self.h_on:
                gx["h_enq"] = gx["h_enq"] + ne
                gx["h_drop"] = gx["h_drop"] + nd
                if hd is not None:
                    gx["h_deliv"] = gx["h_deliv"] + hd
            carry["gx"] = gx
            if ys is not None:
                ys["gossip"].append(torch.stack([x.to(torch.int64) for x in (gd, gr, gg)]))
        elif self.ggx_on and m["gossip"]:
            # Geo flavour: repair deliveries and digest payloads are
            # attributed to the exchanging replicas' region pair.
            st, tel = store.gossip_round(
                st, pairs=m["pairs"], up=self.all_up, link=self.all_conn,
                n_ranges=c.gossip.n_ranges, impl=c.gossip.impl,
            )
            g = c.topology.n_regions
            pairs = torch.from_numpy(np.asarray(m["pairs"])).long().to(dev)
            a, b = pairs[:, 0], pairs[:, 1]
            ab = self.replica_reg[a] * g + self.replica_reg[b]
            ba = self.replica_reg[b] * g + self.replica_reg[a]
            mi = torch.arange(a.shape[0], device=dev)
            growth = tel["growth"].long()
            v = tel["valid"].long()
            gt = torch.zeros((g * g,), dtype=torch.int64, device=dev)
            gt.index_add_(0, ab, growth[mi, b]).index_add_(0, ba, growth[mi, a])
            dg = torch.zeros((g * g,), dtype=torch.int64, device=dev)
            dg.index_add_(0, ab, v).index_add_(0, ba, v)
            ggx = carry["ggx"]
            carry["ggx"] = {
                "traffic": ggx["traffic"] + gt.reshape(g, g),
                "digest": ggx["digest"] + dg.reshape(g, g),
                "ranges": ggx["ranges"] + tel["ranges"].sum(),
                "gap": ggx["gap"] + tel["gap_repaired"],
            }
        # -- durability epilogue ------------------------------------------
        if self.w_on:
            # Journal each replica's applied deltas (new coordinator
            # copies + merge/gossip deliveries), adding back the bits of
            # recycled slots.  The reference's gather clamps the
            # out-of-range slot Q of reads and dropped writes to Q-1.
            q = pre_bits.shape[0]
            is_w = ops["kind"] == duot_lib.WRITE
            lost = (pre_bits[torch.clamp(res.slot, max=q - 1).long()].to(torch.int32)
                    * is_w[:, None].to(torch.int32)).sum(dim=0, dtype=torch.int32)
            growth = torch.clamp(
                st.cluster.pend_applied.sum(dim=0, dtype=torch.int32)
                - applied0 + lost, min=0,
            )
            st = store.wal_append(st, growth)
        if self.s_on and m["snap"]:
            # Periodic snapshot marker: persist applied state, truncate
            # the journals.
            st, _ = store.snapshot(st)
        # -- counters -----------------------------------------------------
        is_read = ops["kind"] == duot_lib.READ
        e_stale = res.stale.sum()
        e_viol = res.violation.sum()
        n_reads = is_read.sum()
        carry["st"] = st
        carry["stale"] = carry["stale"] + e_stale
        carry["viol"] = carry["viol"] + e_viol
        carry["reads"] = carry["reads"] + n_reads
        if self.geo_on:
            g = c.topology.n_regions
            creg = self.client_reg[ops["client"].long()]
            hreg = self.replica_reg[home.long()]
            reg = carry["reg"]
            carry["reg"] = {
                "stale": reg["stale"].index_add(0, creg, res.stale.long()),
                "reads": reg["reads"].index_add(0, creg, is_read.long()),
                "pairs": reg["pairs"].reshape(-1).index_add(
                    0, creg * g + hreg, torch.ones_like(creg)).reshape(g, g),
            }
        if self.telemetry and ys is not None:
            # Per-client stale, violation, read and write counts: one
            # int64 scatter-add over the four (C,) rows.
            n = c.n_clients
            cl = ops["client"].long()
            tel = torch.zeros((4 * n,), dtype=torch.int64, device=dev)
            tel.index_add_(0, torch.cat([cl, cl + n, cl + 2 * n, cl + 3 * n]),
                           torch.cat([res.stale, res.violation, is_read,
                                      ~is_read]).long())
            ys["tel"].append(tel.reshape(4, n))
        # -- observability plane ------------------------------------------
        if self.o_on:
            # Staleness age = the resource's post-merge write frontier
            # minus the version served; masked to violating reads it is
            # the violation severity.
            obs = c.obs
            age = torch.clamp(
                st.cluster.global_version[ops["resource"].long()] - res.version,
                min=0,
            ).to(torch.float32)
            rows, row_mask = [age, age], [is_read, res.violation]
            if self.geo_on:
                rows.append(self.rtt[creg, hreg])
                row_mask.append(is_read)
            # The counts are added into the run's own (M, n_bins) buffer
            # in place (made by _init_carry, held by no one else).
            hist = carry["obs"]["hist"]
            kernel_ops.histogram(
                torch.stack(rows),
                lo=self.ob_lo, hi=self.ob_hi, n_bins=obs.n_bins,
                mask=torch.stack(row_mask), out=hist[: self.n_op_metrics],
                impl=obs.impl,
            )
            if self.h_on:
                kernel_ops.histogram(
                    st.hints.count.to(torch.float32),
                    lo=0.0, hi=self.depth_hi, n_bins=obs.n_bins,
                    out=hist[self.n_op_metrics], impl=obs.impl,
                )
            c0 = carry["obs"]["counters"]
            carry["obs"] = {"hist": hist, "counters": {
                "ops": c0["ops"] + width,
                "reads": c0["reads"] + n_reads,
                "writes": c0["writes"] + width - n_reads,
                "stale": c0["stale"] + e_stale,
                "viol": c0["viol"] + e_viol,
                "epochs": c0["epochs"] + 1,
            }}
            if ys is not None:
                ys["obs"].append(torch.stack([e_stale, e_viol]))
        return carry

    def replay(self, w) -> dict[str, Any]:
        """Run the whole workload; returns the :meth:`prepare` dict with
        ``out`` (the final carry) and ``per_round`` (the gossip and obs
        series of the full rounds, or ``None``).

        With ``n_shards > 1`` each shard keeps its own carry and every
        round passes each shard's batch through the round step, shard
        after shard: the shards share nothing, so this is the
        reference's mapped shard axis.  The carries are stacked once at
        the end, along a leading shard axis (``out``), and the per-round
        series become ``(S, T)`` arrays.  Where :func:`shard_group`
        gives a group (the reference's device mesh over the shard axis),
        rank ``r`` of it runs shard ``r`` alone, on this engine's device,
        and every rank then gathers every shard's carry and series, so
        each returns what the one-process run returns.
        """
        return self.execute(self.prepare(w))

    def execute(self, prep: dict[str, Any]) -> dict[str, Any]:
        """The round loop over :meth:`prepare`'s inputs: ``prep`` with
        ``out`` and ``per_round`` added (see :meth:`replay`)."""
        store = prep["store"]
        sub, rem, n_rounds = prep["sub"], prep["rem"], prep["n_rounds"]
        n_shards = self.config.n_shards
        if self.o_on:
            # Host bounds: the histogram params are computed once.
            self.ob_lo, self.ob_hi, self.n_op_metrics = obs_lib.batch_bounds(self.specs)
            self.depth_hi = float(self.config.obs.depth_hi)
        group = shard_group(self.config)
        owned = range(n_shards)
        if group is not None:
            import torch.distributed as dist

            rank = dist.get_rank(group)
            owned = range(rank, rank + 1) if rank < n_shards else range(0)
        carries = [self._init_carry(store) for _ in range(n_shards)]
        ys = [{"gossip": [], "obs": [], "tel": []} for _ in range(n_shards)]
        masks = prep["masks"]

        def round_masks(t: int | None) -> dict | None:
            if masks is None:
                return None
            if t is None:
                m = dict(prep["tail_masks"])
                if self.faults_on:
                    m["up_t"] = prep["dev_tail_masks"]["up"]
                    m["conn_t"] = prep["dev_tail_masks"]["conn"]
                return m
            m = {k: v[t] for k, v in masks.items()}
            if self.faults_on:
                m["up_t"] = prep["dev_masks"]["up"][t]
                m["conn_t"] = prep["dev_masks"]["conn"][t]
            return m

        for t in range(n_rounds):
            m = round_masks(t)
            for s in owned:
                ops = {k: v[t] for k, v in prep["batched"][s].items()}
                carries[s] = self.round_step(store, carries[s], ops, m, t * sub,
                                             sub, prep["emulate"], ys[s])
        if rem:
            m = round_masks(None)
            for s in owned:
                carries[s] = self.round_step(store, carries[s], prep["tails"][s], m,
                                             n_rounds * sub, rem, prep["emulate"], None)

        def series(key: str, width: int) -> list[np.ndarray]:
            return [torch.stack(y[key]).cpu().numpy() if y[key]
                    else np.zeros((0, width), np.int64) for y in ys]

        if group is not None:
            ys = [{k: list(v) for k, v in y.items()} for y in ys]
            got = _gather_shards(group, {s: (carries[s], ys[s]) for s in owned}, n_shards,
                                 self.device)
            carries, ys = [got[s][0] for s in range(n_shards)], [got[s][1] for s in range(n_shards)]

        def by_column(arrs: list[np.ndarray]) -> tuple:
            cols = [tuple(a[:, i] for i in range(a.shape[1])) for a in arrs]
            if n_shards == 1:
                return cols[0]
            return tuple(np.stack(x) for x in zip(*cols))

        per_round = {}
        if self.gx_on:
            per_round["gossip"] = by_column(series("gossip", 3))
        if self.o_on:
            per_round["obs"] = by_column(series("obs", 2))
        prep["out"] = carries[0] if n_shards == 1 else stack_tree(carries)
        prep["per_round"] = per_round or None
        return prep

    def run(self, w) -> dict[str, Any]:
        """Replay + result assembly (see :mod:`repro_torch.engine.results`)."""
        from repro_torch.engine import results

        return results.assemble(self.config, self.replay(w), w)


def shard_group(config: EngineConfig):
    """The process group that replays ``config``'s shards one per rank, or
    ``None`` where they run one after another in this process.

    The reference's rule (``use_devices``, no faults, no topology, at
    least ``n_shards`` devices) with ranks for devices: the active
    ``DeviceMesh``'s 'shard' axis, or, with no mesh set, every rank of
    the initialized process group; too few ranks, no process group, or a
    mesh without a 'shard' axis give ``None``."""
    c = config
    if not (c.use_devices and c.n_shards > 1 and c.faults is None and c.topology is None):
        return None
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from repro_torch.models import sharding

    mesh = sharding.get_mesh()
    if mesh is None:
        group = dist.group.WORLD
    elif "shard" in sharding.mesh_shape(mesh) and sharding._is_device_mesh(mesh):
        group = mesh.get_group("shard")
    else:
        return None
    return group if dist.get_world_size(group) >= c.n_shards else None


def _moved(tree, device):
    """``tree`` (tensors in dicts, lists and tuples, host values) with
    every tensor on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moved(v, device) for v in tree]
    if isinstance(tree, tuple):
        parts = [_moved(v, device) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def _gather_shards(group, mine: dict, n_shards: int, device) -> dict:
    """Every shard's payload, gathered over ``group`` from the ranks that
    ran them (``mine``: this rank's ``{shard: payload}``), on ``device``:
    host copies travel as pickled objects, so every bit is kept."""
    import torch.distributed as dist

    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, _moved(mine, "cpu"), group=group)
    every = {s: p for part in parts for s, p in part.items()}
    return {s: _moved(every[s], device) for s in range(n_shards)}


def session_telemetry_runner(
    level, n_clients: int, n_resources: int, merge_every: int, delta: int,
    sub: int, emulate: bool, device: str | torch.device = "cuda",
):
    """``(store, run)`` emitting per-client counts per ``sub``-op round.

    The adaptive control plane's telemetry feed: the flat round step in
    telemetry mode — per-client counts per round, the DUOT skipped — with
    the reference's ring sizes (DUOT 64 entries, pending ring ``max(128,
    2·sub)``).  ``run(batched)`` takes ``(n_rounds, sub)`` arrays of the
    op columns (plus ``apply_idx`` for the emulated timed levels): the
    stream tiles exactly, with no tail round.  It returns ``(stale, viol,
    reads, writes)``, each ``(n_rounds, C)`` int64 numpy.
    """
    pending_cap = max(128, 2 * sub)
    config = EngineConfig(
        level, n_ops=sub, n_clients=n_clients, n_resources=n_resources,
        merge_every=merge_every, delta=delta, duot_cap=64, batch_size=sub,
        pending_cap=pending_cap,
    )
    engine = EpochEngine(config, device=device, telemetry=True)
    store = ReplicatedStore(
        3, n_clients, n_resources, level=level, merge_every=merge_every,
        delta=delta, pending_cap=pending_cap, duot_cap=64, ingest="auto",
        device=engine.device,
    )

    def run(batched: dict[str, np.ndarray]):
        cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(engine.device)
                for k, v in batched.items()}
        carry = engine._init_carry(store)
        ys = {"tel": []}
        for t in range(cols["client"].shape[0]):
            ops = {k: v[t] for k, v in cols.items()}
            carry = engine.round_step(store, carry, ops, None, t * sub, sub,
                                      emulate, ys)
        tel = torch.stack(ys["tel"]).cpu().numpy()
        return tuple(tel[:, i] for i in range(4))

    return store, run
