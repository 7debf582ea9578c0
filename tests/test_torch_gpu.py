"""The CUDA kernels against their plain versions on the card.

Marked ``gpu``; each test skips (inside the ``cuda`` fixture) where no
CUDA device is present.  Imports neither JAX nor ``repro``, so it runs
on a machine with only PyTorch:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import availability as av
from repro_torch.core.consistency import EVAL_LEVELS, ConsistencyLevel
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.geo import placement as pl
from repro_torch.geo.topology import PAPER_TOPOLOGY
from repro_torch.gossip.scheduler import GossipConfig
from repro_torch.kernels import digest_compare as dc
from repro_torch.kernels import histogram as hg
from repro_torch.kernels import ops
from repro_torch.kernels import placement_score as pls
from repro_torch.kernels import policy_score as ps
from repro_torch.kernels import session_floor as sf
from repro_torch.obs.metrics import ObsConfig
from repro_torch.policy.controller import AdaptiveController, CadenceController
from repro_torch.policy.sla import SLA_RELAXED, SLA_STRICT
from repro_torch.storage import simulator
from repro_torch.storage.ycsb import PHASED_RW, PHASED_RWR, WORKLOAD_A

from torch_port_helpers import (AUDIT_MIXES, CHAIN_MIXES, FAMILY_ARCHS, FAMILY_CHECK,
                                TRAIN_CASES, as_lists, audit_mix, causal_attention_layers,
                                chain_mix, expected_train_launches, f32_same,
                                family_inputs, family_mismatches, family_outputs,
                                family_serving, geo_mismatches, history_mismatches,
                                placement_inputs, policy_inputs, port_trainer,
                                record_mismatches, select_inputs, sync_record,
                                torch_batch, train_case_id, tree_to)

pytestmark = pytest.mark.gpu

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_wrappers.json"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(x, dev):
    return torch.as_tensor(np.asarray(x), device=dev)


@pytest.mark.parametrize("b", [1, 8, 128, 129, 1000])
@pytest.mark.parametrize("pending", [False, True])
def test_op_ingest_kernel_matches_plain(cuda, b, pending):
    rng = np.random.default_rng(b)
    kw = dict(
        client=_t(rng.integers(0, 16, b, dtype=np.int32), cuda),
        replica=_t(rng.integers(0, 3, b, dtype=np.int32), cuda),
        resource=_t(rng.integers(0, 24, b, dtype=np.int32), cuda),
        is_write=_t(rng.integers(0, 2, b) > 0, cuda),
        g0=_t(rng.integers(0, 40, b, dtype=np.int32), cuda),
        raw0=_t(rng.integers(0, 40, b, dtype=np.int32), cuda),
        floor0=_t(rng.integers(0, 40, b, dtype=np.int32), cuda),
        op_index=_t(np.arange(b, dtype=np.int32) + 100, cuda),
        apply_index=_t(rng.integers(100, 100 + 2 * b, b, dtype=np.int32), cuda),
    )
    if pending:
        q = 2 * b + 5
        kw.update(
            pend_version=_t(rng.integers(0, 60, q, dtype=np.int32), cuda),
            pend_resource=_t(rng.integers(0, 24, q, dtype=np.int32), cuda),
            pend_live=_t(rng.integers(0, 2, q) > 0, cuda),
            pend_apply=_t(rng.integers(100, 100 + 2 * b, q, dtype=np.int32), cuda),
        )
    got = ops.op_ingest(**kw, impl="cuda")
    want = ops.op_ingest(**kw, impl="torch")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b", [1, 127, 128, 129, 1000, 4096, 4097])
@pytest.mark.parametrize("pending", [False, True])
@pytest.mark.parametrize("small_max", [None, 1024, 0], ids=["auto", "one_cta", "tiles"])
def test_op_ingest_designs_match_plain(cuda, monkeypatch, b, pending, small_max):
    """Both kernel designs, on either side of ``SMALL_MAX`` (``auto``; the
    one-CTA kernel wherever it fits, up to 1024 padded rows; the tile
    kernels at any size), bit for bit against the plain version; one
    counted launch per call."""
    from repro_torch.kernels import op_ingest as oi

    if small_max is not None:
        monkeypatch.setattr(oi, "SMALL_MAX", small_max)
    rng = np.random.default_rng(b + 7)
    t = lambda x: _t(np.asarray(x, np.int32), cuda)  # noqa: E731
    kw = dict(
        client=t(rng.integers(0, 16, b)), replica=t(rng.integers(0, 3, b)),
        resource=t(rng.integers(0, 24 if b <= 128 else 512, b)),
        is_write=_t(rng.integers(0, 2, b) > 0, cuda),
        g0=t(rng.integers(0, 40, b)), raw0=t(rng.integers(0, 40, b)),
        floor0=t(rng.integers(0, 40, b)), op_index=t(np.arange(b) + 100),
        apply_index=t(rng.integers(100, 100 + 2 * b, b)),
    )
    if pending:
        q = 2 * b + 5
        kw.update(
            pend_version=t(rng.integers(0, 60, q)),
            pend_resource=t(rng.integers(0, 24 if b <= 128 else 512, q)),
            pend_live=_t(rng.integers(0, 2, q) > 0, cuda),
            pend_apply=t(rng.integers(100, 100 + 2 * b, q)),
        )
    n0 = oi.launches
    got = oi.op_ingest_cuda(oi.pack_ops(**kw))
    want = oi.op_ingest_ref(**kw)
    torch.cuda.synchronize()
    assert oi.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,n", [(100, 16), (2048, 16), (333, 64)])
@pytest.mark.parametrize("delta", [0, 8])
def test_vclock_audit_kernel_matches_plain(cuda, m, n, delta):
    rng = np.random.default_rng(m + n)
    kw = dict(
        vc=_t(rng.integers(0, 25, (m, n), dtype=np.int32), cuda),
        client=_t(rng.integers(0, n, m, dtype=np.int32), cuda),
        kind=_t(rng.integers(0, 2, m, dtype=np.int32), cuda),
        resource=_t(rng.integers(0, 6, m, dtype=np.int32), cuda),
        version=_t(rng.integers(0, 40, m, dtype=np.int32), cuda),
        seq=_t(rng.permutation(m).astype(np.int32), cuda),
        valid=_t(rng.random(m) < 0.9, cuda),
    )
    got = ops.vclock_audit(**kw, delta=delta, impl="cuda")
    want = ops.vclock_audit(**kw, delta=delta, impl="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mix", AUDIT_MIXES + ("six_resources",))
@pytest.mark.parametrize("m,n", [(100, 16), (2048, 16), (333, 64), (4096, 64), (300, 3),
                                 (500, 100)])
def test_vclock_audit_designs_match_plain(cuda, mix, m, n):
    """Every design, forced, and the per-tile choice, bit for bit against
    the plain version; one counted launch per call.  (300, 3) has an odd
    clock width, (500, 100) one wider than a staged chunk."""
    from repro_torch.kernels import vclock_audit as va

    rng = np.random.default_rng(m + n)
    arrays = (audit_mix("random", rng, m, n, n_resources=6) if mix == "six_resources"
              else audit_mix(mix, rng, m, n))
    args = [_t(x, cuda) for x in arrays]
    for delta in (0, 8, 96):
        want = va.vclock_audit_ref(*args, delta=delta)
        for design in va.DESIGNS:
            n0 = va.launches
            got = va.vclock_audit_cuda(*args, delta=delta, design=design)
            torch.cuda.synchronize()
            assert va.launches == n0 + 1
            assert torch.equal(got, want), (design, delta)


@pytest.mark.parametrize("b,c", [(1, 4), (128, 16), (3000, 64), (300, 500), (64, 2100)])
def test_vclock_chain_kernel_matches_plain(cuda, b, c):
    rng = np.random.default_rng(b)
    args = (
        _t(rng.integers(0, c, b, dtype=np.int32), cuda),
        _t(rng.integers(0, 3, b, dtype=np.int32), cuda),
        _t(rng.integers(0, 2, b, dtype=np.int32), cuda),
        _t(rng.integers(0, 30, (c, c), dtype=np.int32), cuda),
        _t(rng.integers(0, 30, (3, c), dtype=np.int32), cuda),
    )
    got = ops.vclock_chain(*args, impl="cuda")
    want = ops.vclock_chain(*args, impl="torch")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (B, C, P) at the narrow and the wide width, and the designs each runs.
CHAIN_WIDTHS = {"narrow": ((600, 64, 3), ("small", "segments", "levels")),
                "narrow_p12": ((333, 40, 12), ("small", "segments", "levels")),
                "narrow_p1": ((1, 16, 1), ("small", "segments", "levels")),
                "wide": ((700, 2100, 3), ("levels",)),
                "wide_p12": ((2100, 2100, 12), ("levels",))}


@pytest.mark.parametrize("mix", CHAIN_MIXES)
@pytest.mark.parametrize("width", list(CHAIN_WIDTHS))
def test_vclock_chain_designs_match_plain(cuda, mix, width):
    """Every design the shape allows, forced, and the automatic choice,
    bit for bit against the plain walk; one counted launch per call."""
    from repro_torch.kernels import vclock_chain as vch

    (b, c, p), designs = CHAIN_WIDTHS[width]
    rng = np.random.default_rng(b + c + p)
    b = min(b, c) if mix == "reads_once" else b
    cl, rp, w = chain_mix(mix, rng, b, c, p)
    args = (_t(cl, cuda), _t(rp, cuda), _t(w, cuda),
            _t(rng.integers(0, 30, (c, c), dtype=np.int32), cuda),
            _t(rng.integers(0, 30, (p, c), dtype=np.int32), cuda))
    want = vch.vclock_chain_ref(*args)
    for design in (None,) + designs:
        n0 = vch.launches
        got = vch.vclock_chain_cuda(*args, design=design)
        torch.cuda.synchronize()
        assert vch.launches == n0 + 1
        for g, wnt in zip(got, want):
            assert torch.equal(g, wnt), design


@pytest.mark.parametrize("level", EVAL_LEVELS, ids=lambda lv: lv.name)
def test_golden_protocol_case_on_the_card(cuda, level):
    golden = json.loads(GOLDEN.read_text())[f"protocol/{level.name}"]
    ops.reset_launch_counts()
    got = simulator.run_protocol(level, WORKLOAD_A, n_ops=600, device=cuda)
    assert got == golden
    counts = ops.launch_counts()
    assert counts["op_ingest"] > 0 and counts["vclock_audit"] == 1
    assert counts["vclock_chain"] == counts["op_ingest"]


def test_entry_points_default_to_the_card(cuda):
    got = simulator.run_protocol(ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=300)
    want = simulator.run_protocol(ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=300,
                                  device="cpu")
    assert got == want


@pytest.mark.parametrize("m", [1, 24, 255, 257, 65536])
def test_digest_compare_kernel_matches_plain(cuda, m):
    """``ops.digest_compare`` on the card (the two sides as one table for
    the gathered kernel) against its plain version: overflowing
    components, a quarter of the rows equal."""
    rng = np.random.default_rng(m)
    extremes = np.asarray([2**31 - 1, -(2**31), 0, 1, -1], np.int64)
    a = rng.choice(extremes, (m, 4)).astype(np.int32)
    b = rng.choice(extremes, (m, 4)).astype(np.int32)
    b[::4] = a[::4]                                   # equal rows
    n0 = dc.launches
    got = ops.digest_compare(_t(a, cuda), _t(b, cuda))
    want = ops.digest_compare(torch.from_numpy(a), torch.from_numpy(b), impl="torch")
    torch.cuda.synchronize()
    assert dc.launches == n0 + 1
    for g, w in zip(got, want):
        assert g.shape == (m,) and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("m,k", [(1, 1), (3, 8), (15, 17), (257, 1), (64, 1024)])
def test_digest_compare_pairs_kernel_matches_plain(cuda, m, k):
    """The gathered kernel at M * K = 1, 24, 255, 257 and 65,536, indices
    read in place from the columns of an (M, 2) pair tensor; overflowing
    components, equal replicas and self pairs."""
    rng = np.random.default_rng(m * k)
    p = 5
    extremes = np.asarray([2**31 - 1, -(2**31), 0, 1, -1, 7], np.int64)
    tab = rng.choice(extremes, (p, k, 4)) + rng.integers(-3, 4, (p, k, 4))
    tab = ((tab + 2**31) % 2**32 - 2**31).astype(np.int32)
    tab[1] = tab[0]
    pairs = rng.integers(0, p, (m, 2))
    pairs[::3, 1] = pairs[::3, 0]
    dig, tp = _t(tab, cuda), _t(pairs, cuda).long()
    want = dc.digest_compare_pairs_ref(dig, tp[:, 0], tp[:, 1])
    n0 = dc.launches
    got = dc.digest_compare_pairs_cuda(dig, tp[:, 0], tp[:, 1], pairs.tolist())
    via_ops = ops.digest_compare_pairs(dig, tp[:, 0], tp[:, 1])
    torch.cuda.synchronize()
    assert dc.launches == n0 + 2
    assert got.shape == (3, m, k) and got.dtype == torch.bool
    assert torch.equal(got, want) and torch.equal(via_ops, want)
    with pytest.raises(ValueError):
        dc.digest_compare_pairs_cuda(dig, tp[:, 0], tp[:, 1] + p)


@pytest.mark.parametrize("healed", [False, True])
def test_gossip_round_on_the_card_equals_cpu(cuda, healed):
    """A store after three rounds with replica 1 down, then one digest
    exchange: the card's state and every telemetry field equal the CPU's."""
    from repro_torch.core.replicated_store import ReplicatedStore

    states, tels = [], []
    for dev in (cuda, "cpu"):
        store = ReplicatedStore(3, 6, 12, level=ConsistencyLevel.X_STCC, pending_cap=48,
                                duot_cap=64, hint_cap=5, device=dev)
        st = store.init()
        rng = np.random.default_rng(7)
        outage = np.asarray([True, False, True])
        link = np.ones((3, 3), bool)
        for rd in range(3):
            ops_ = {k: rng.integers(0, n, 12).astype(np.int32)
                    for k, n in (("client", 6), ("replica", 3), ("resource", 12),
                                 ("kind", 2))}
            ops_["replica"][ops_["replica"] == 1] = 2
            st, _ = store.apply_batch(st, **ops_, op_step0=rd * 12)
            st, _ = store.merge(st, up=torch.as_tensor(outage, device=dev),
                                link=torch.as_tensor(link, device=dev))
        up = np.ones(3, bool) if healed else outage
        st, tel = store.gossip_round(st, pairs=np.asarray([[0, 1], [1, 2], [2, 0]]),
                                     up=up, link=link, n_ranges=4)
        states.append(st)
        tels.append(tel)
    for k in ("valid", "ranges", "growth", "gap_repaired"):
        assert torch.equal(tels[0][k].cpu(), tels[1][k]), k
    for f, x in zip(states[0]._fields, states[0]):
        y = states[1][states[0]._fields.index(f)]
        for a, b in zip(_leaves(x), _leaves(y)):
            assert torch.equal(a.cpu(), b), f
    if healed:
        assert int(tels[0]["growth"].sum()) > 0


def _leaves(x):
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _leaves(y)]


@pytest.mark.parametrize("m,b", [(2, 128), (1, 3), (3, 5000)])
@pytest.mark.parametrize("n_bins", [4, 64])
def test_histogram_kernel_matches_plain(cuda, m, b, n_bins):
    rng = np.random.default_rng(m * b + n_bins)
    v = rng.integers(-50, 1200, (m, b)).astype(np.float32)
    v[:, ::9] = 1e9
    v[:, 1::9] = -1e9
    v[:, 2::9] = np.nan
    vals, mask = _t(v, cuda), _t(rng.integers(0, 2, (m, b), dtype=np.int32), cuda)
    params = hg.metric_params(0.0, 1024.0, n_bins, device=cuda).expand(m, 2)
    got = hg.histogram_cuda(vals, mask, params, n_bins=n_bins)
    want = hg.histogram_ref(vals, mask, params, n_bins=n_bins)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,b", [(2, 128), (2, 4096), (3, 4097), (1, 65536), (2, 1)])
@pytest.mark.parametrize("mask_kind", ["int32", "bool", "none"])
def test_histogram_designs_match_plain(cuda, m, b, mask_kind):
    """One CTA per row at any B, per-row and cached params, int32, bool
    and no mask, writing and accumulating: bit for bit against the plain
    version, one counted launch per call."""
    rng = np.random.default_rng(m * b)
    v = rng.integers(-50, 1200, (m, b)).astype(np.float32)
    v[:, ::9] = 1e9
    v[:, 1::9] = -1e9
    v[:, 2::9] = np.nan
    v[:, 3::9] = 1024.0
    mk = rng.integers(0, 2, (m, b), dtype=np.int32)
    mk[-1] = 0
    vals = _t(v, cuda)
    mask = {"int32": _t(mk, cuda), "bool": _t(mk > 0, cuda), "none": None}[mask_kind]
    for params in (hg.metric_params([0.0] * m, [1024.0] * m, 64, device=cuda),
                   hg.row_params(0.0, 1024.0, 64, m, cuda)):
        want = hg.histogram_ref(vals, mask, params, n_bins=64)
        n0 = hg.launches
        got = hg.histogram_cuda(vals, mask, params, n_bins=64)
        run = torch.full((m, 64), 5, dtype=torch.int32, device=cuda)
        hg.histogram_cuda(vals, mask, params, n_bins=64, out=run)
        torch.cuda.synchronize()
        assert hg.launches == n0 + 2
        assert torch.equal(got, want)
        assert torch.equal(run, want + 5)


FAULT_CASES = {
    **{f"faulty_allup/{lv.name}": (lv, {}) for lv in EVAL_LEVELS},
    "faulty/X_STCC/outage": (ConsistencyLevel.X_STCC, dict(
        schedule=av.replica_outage(5, 3, 1, 1, 3), schedule_unit=128,
        gossip=GossipConfig(cadence=2, hint_cap=32),
        recovery=DurabilityConfig(snapshot_every=2, wal=True))),
    "faulty/CAUSAL/outage": (ConsistencyLevel.CAUSAL, dict(
        schedule=av.replica_outage(5, 3, 1, 1, 3), schedule_unit=128, audit=False)),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_golden_fault_case_on_the_card(cuda, case):
    level, kw = FAULT_CASES[case]
    golden = json.loads(GOLDEN.read_text())[case]
    got = simulator.run_protocol_faulty(level, WORKLOAD_A, n_ops=600, device=cuda, **kw)
    assert as_lists(got) == golden


def test_fault_path_launches_every_kernel(cuda):
    level, kw = FAULT_CASES["faulty/X_STCC/outage"]
    ops.reset_launch_counts()
    simulator.run_protocol_faulty(level, WORKLOAD_A, n_ops=600, device=cuda,
                                  obs=ObsConfig(), **kw)
    counts = ops.launch_counts()
    # Every kernel but the placement planner's, the policy scorer's, the
    # serving admission's and the model's attention runs on the fault path.
    assert all(v > 0 for k, v in counts.items()
               if k not in ("placement_score", "placement_select", "policy_score",
                            "session_floor", "flash_attention")), counts


SHARDED_CASES = {
    **{f"sharded/{lv.name}": (simulator.run_protocol_sharded, lv, dict(n_shards=2))
       for lv in EVAL_LEVELS},
    "faulty/X_STCC/sharded": (simulator.run_protocol_faulty, ConsistencyLevel.X_STCC, dict(
        n_shards=2, schedule=av.replica_outage(5, 3, 1, 1, 3), schedule_unit=128,
        audit=False)),
}


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_golden_sharded_case_on_the_card(cuda, case):
    fn, level, kw = SHARDED_CASES[case]
    golden = json.loads(GOLDEN.read_text())[case]
    ops.reset_launch_counts()
    got = fn(level, WORKLOAD_A, n_ops=600, device=cuda, **kw)
    assert as_lists(got) == golden
    counts = ops.launch_counts()
    # Each shard ingests its own batch every round through the kernels.
    assert counts["op_ingest"] > 0 and counts["op_ingest"] % 2 == 0
    assert counts["vclock_chain"] == counts["op_ingest"]


def test_scalar_engine_on_the_card_equals_cpu(cuda):
    for level in (ConsistencyLevel.X_STCC, ConsistencyLevel.ONE, ConsistencyLevel.ALL):
        ops.reset_launch_counts()
        got = simulator.run_protocol_scalar(level, WORKLOAD_A, n_ops=600, device=cuda)
        assert ops.launch_counts()["vclock_audit"] == 1
        assert got == simulator.run_protocol_scalar(level, WORKLOAD_A, n_ops=600,
                                                    device="cpu")


CRASH = dict(schedule=av.replica_crash(8, 3, 1, 3, 2),
             recovery=DurabilityConfig(snapshot_every=2, wal=True),
             gossip=GossipConfig(cadence=2, hint_cap=8), obs=ObsConfig())


def test_crash_run_on_the_card_equals_cpu(cuda):
    kw = dict(CRASH, n_ops=1024, batch_size=128)
    ops.reset_launch_counts()
    got = simulator.run_protocol_faulty(ConsistencyLevel.X_STCC, WORKLOAD_A, device=cuda,
                                        **kw)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("op_ingest", "vclock_chain", "vclock_audit",
                                       "digest_compare", "histogram"))
    assert got == simulator.run_protocol_faulty(ConsistencyLevel.X_STCC, WORKLOAD_A,
                                                device="cpu", **kw)
    assert got["recovery"]["crashes"] == got["recovery"]["rejoins"] == 1


def test_bootstrap_launches_digest_compare_and_matches_plain(cuda):
    from repro_torch.core.replicated_store import ReplicatedStore

    store = ReplicatedStore(3, 8, 40, pending_cap=64, device=cuda)
    st = store.init()
    rng = np.random.default_rng(0)
    for _ in range(3):
        st, _ = store.write_batch(
            st, client=_t(rng.integers(0, 8, 32, dtype=np.int32), cuda),
            replica=_t(rng.integers(0, 3, 32, dtype=np.int32), cuda),
            resource=_t(rng.integers(0, 40, 32, dtype=np.int32), cuda))
        st, _ = store.merge(st)
    down = np.asarray([False, True, False])
    st, _ = store.crash(st, down)
    kw = dict(targets=down, up=np.ones(3, bool), link=np.ones((3, 3), bool), n_ranges=8)
    ops.reset_launch_counts()
    got, tel = store.bootstrap(st, **kw)
    assert ops.launch_counts()["digest_compare"] == 1
    want, wtel = store.bootstrap(st, impl="torch", **kw)
    for a, b in zip(got.cluster, want.cluster):
        assert torch.equal(a, b)
    for k in tel:
        assert torch.equal(tel[k], wtel[k]), k
    assert int(tel["cells"].sum()) > 0


def test_geo_faults_run_on_the_card_equals_cpu(cuda):
    from repro_torch.engine.config import EngineConfig
    from repro_torch.engine.replay import EpochEngine

    config = EngineConfig(ConsistencyLevel.TCC, n_ops=1024, topology=PAPER_TOPOLOGY,
                          faults=CRASH["schedule"] & av.partition(8, 3, [[0], [1, 2]], 5, 7),
                          gossip=CRASH["gossip"], durability=CRASH["recovery"],
                          obs=CRASH["obs"])
    got = EpochEngine(config, device=cuda).run(WORKLOAD_A)
    assert got == EpochEngine(config, device="cpu").run(WORKLOAD_A)
    assert got["geo"]["traffic_events"][0][1] > 0


def test_chaos_seed_on_the_card_equals_cpu(cuda):
    from repro_torch.chaos import run_chaos

    got = run_chaos(0, device=cuda)
    assert got["ok"] and got["crashes"] > 0
    assert got == run_chaos(0, device="cpu")


@pytest.mark.parametrize("r", [1, 24, 257, 65537])
@pytest.mark.parametrize("max_lat", [10.0, float("inf")])
def test_placement_score_kernel_matches_plain(cuda, r, max_lat):
    args = placement_inputs(np.random.default_rng(r), r, cuda)
    got = pls.placement_score_cuda(*args, max_latency_ms=max_lat)
    want = pls.placement_score_ref(*args, max_latency_ms=max_lat)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("r", [24, 1, 257, 65537])
@pytest.mark.parametrize("max_lat", [10.0, float("inf")])
def test_placement_select_kernel_matches_plain(cuda, r, max_lat):
    args = placement_inputs(np.random.default_rng(r), r, cuda)
    before = pls.select_launches
    got = pls.placement_select_cuda(*args, max_latency_ms=max_lat)
    want = pls.placement_select_ref(*args, max_latency_ms=max_lat)
    torch.cuda.synchronize()
    assert pls.select_launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(want, pls.select_from_grid(
        *pls.placement_score_ref(*args, max_latency_ms=max_lat)))
    # The planner's small-demand layout: views into one copy; strided
    # halves are made contiguous first.
    demand = torch.stack(args[:2])
    assert torch.equal(got, pls.placement_select_cuda(
        demand[0], demand[1], *args[2:], max_latency_ms=max_lat))
    wide = torch.cat(args[:2], dim=1)
    assert torch.equal(got, pls.placement_select_cuda(
        wide[:, :3], wide[:, 3:], *args[2:], max_latency_ms=max_lat))


def test_plan_placement_is_one_select_launch(cuda):
    reads = np.random.default_rng(0).integers(0, 5, (24, 3)).astype(np.float32)
    ops.reset_launch_counts()
    plan = pl.plan_placement(PAPER_TOPOLOGY, reads, reads, SLA_RELAXED, device=cuda)
    counts = ops.launch_counts()
    assert counts["placement_select"] == 1 and counts["placement_score"] == 0
    want = pl.plan_placement(PAPER_TOPOLOGY, reads, reads, SLA_RELAXED, device="cpu")
    for f in ("choice", "counts", "utility", "feasible", "cost"):
        assert np.array_equal(getattr(plan, f), getattr(want, f)), f


GEO_CASES = {
    **{f"geo/{lv.name}": (lv, {}) for lv in EVAL_LEVELS},
    "geo/X_STCC/gossip_recovery": (ConsistencyLevel.X_STCC, dict(
        gossip=GossipConfig(cadence=2, hint_cap=32),
        recovery=DurabilityConfig(snapshot_every=2, wal=True))),
}


@pytest.mark.parametrize("case", sorted(GEO_CASES))
def test_golden_geo_case_on_the_card(cuda, case):
    level, kw = GEO_CASES[case]
    golden = json.loads(GOLDEN.read_text())[case]
    got = simulator.run_protocol_geo(level, WORKLOAD_A, n_ops=600, device=cuda, **kw)
    assert geo_mismatches(golden, got) == []
    want = simulator.run_protocol_geo(level, WORKLOAD_A, n_ops=600, device="cpu", **kw)
    assert got == want


def test_geo_path_launches_every_kernel(cuda):
    ops.reset_launch_counts()
    simulator.run_protocol_geo(
        ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=600, device=cuda, obs=ObsConfig(),
        gossip=GossipConfig(cadence=2, peer="nearest"))
    reads = np.ones((24, 3), np.float32)
    plan = pl.plan_placement(PAPER_TOPOLOGY, reads, reads, SLA_RELAXED, device=cuda)
    assert plan.choice.shape == (24,)
    counts = ops.launch_counts()
    # Every kernel but the (R, K) grid kernel (the planner selects on the
    # card), the adaptive path's policy scorer, the serving path's
    # admission check and the model's attention.
    assert all(v > 0 for k, v in counts.items()
               if k not in ("placement_score", "policy_score", "session_floor",
                            "flash_attention")), counts


@pytest.mark.parametrize("s", [1, 64, 129, 1000, 65537])
@pytest.mark.parametrize("two_levels", [False, True])
def test_policy_score_kernel_matches_plain(cuda, s, two_levels):
    levels = (ConsistencyLevel.ONE, ConsistencyLevel.X_STCC) if two_levels else None
    args = policy_inputs(np.random.default_rng(s), s, cuda, levels=levels)
    got = ps.policy_score_cuda(*args)
    want = ps.policy_score_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("s", [1, 16, 64, 129, 1000, 65537])
@pytest.mark.parametrize("w", [1, 8])
@pytest.mark.parametrize("n_levels", [2, 6])
def test_policy_select_kernel_matches_plain(cuda, s, w, n_levels):
    levels = (ConsistencyLevel.ONE, ConsistencyLevel.X_STCC) if n_levels == 2 else None
    inp = select_inputs(np.random.default_rng(s + w), s, w, cuda, levels=levels, wraps=2)
    args = [inp[k] for k in ("stale_win", "viol_win", "reads_win", "table")]
    bounds = (0.16, 0.016, 10.0, 50.0)
    for rf in (0.5, inp["read_frac"]):
        for valid in (None, inp["valid"]):
            kw = dict(read_frac=rf, valid=valid)
            for eps in (0.0, 1.0, float(np.float32(0.05))):
                draws = dict(explore_u=inp["explore_u"], arm=inp["arm"], epsilon=eps)
                got = ps.policy_select_cuda(*args, bounds, **kw, **draws)
                want = ps.policy_select_ref(*args, bounds, **kw, **draws)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
            got = ps.policy_select_cuda(*args, bounds, **kw)
            want = ps.policy_select_ref(*args, bounds, **kw)
            torch.cuda.synchronize()
            assert f32_same(got[0], want[0]) and torch.equal(got[1], want[1])


def test_controller_select_is_one_launch(cuda):
    inp = select_inputs(np.random.default_rng(3), 64, 8, cuda)
    ctl = AdaptiveController(64, SLA_RELAXED, device=cuda)
    state = ctl.init()._replace(stale_win=inp["stale_win"], viol_win=inp["viol_win"],
                                reads_win=inp["reads_win"])
    ops.reset_launch_counts()
    got = ctl.select(state, inp["explore_u"], inp["arm"], read_frac=inp["read_frac"])
    scores = ctl.scores(state, read_frac=1.0)
    assert ops.launch_counts()["policy_score"] == 2
    plain = AdaptiveController(64, SLA_RELAXED, impl="torch", device=cuda)
    assert torch.equal(got, plain.select(state, inp["explore_u"], inp["arm"],
                                         read_frac=inp["read_frac"]))
    want = plain.scores(state, read_frac=1.0)
    assert f32_same(scores[0], want[0]) and torch.equal(scores[1], want[1])


@pytest.mark.parametrize("w", [PHASED_RW, PHASED_RWR], ids=lambda w: w.name)
@pytest.mark.parametrize("sla", [SLA_RELAXED, SLA_STRICT], ids=lambda s: s.name)
def test_adaptive_run_on_the_card_equals_cpu(cuda, w, sla):
    kw = dict(n_ops=1536, epoch_size=64)
    ops.reset_launch_counts()
    got = simulator.run_protocol_adaptive(w, sla, device=cuda, **kw)
    counts = ops.launch_counts()
    want = simulator.run_protocol_adaptive(w, sla, device="cpu", **kw)
    assert np.array_equal(got.pop("choice"), want.pop("choice"))
    assert got == want
    # One scoring launch per epoch; the telemetry mode records no DUOT.
    assert counts["policy_score"] == 1536 // 64
    assert counts["vclock_audit"] == 0 and counts["op_ingest"] > 0


def test_controllers_on_the_card_equal_cpu(cuda):
    rng = np.random.default_rng(0)
    e, s = 16, 300
    reads = rng.integers(0, 40, (e, s))
    tel = {"stale": np.minimum(rng.integers(0, 30, (e, s, 6)), reads[..., None]),
           "viol": np.minimum(rng.integers(0, 5, (e, s, 6)), reads[..., None]),
           "reads": reads, "writes": rng.integers(0, 40, (e, s))}
    runs = [AdaptiveController(s, SLA_STRICT, eps0=0.3, device=d).run_scan(1, tel)[1]
            for d in (cuda, "cpu")]
    for k in runs[1]:
        assert torch.equal(runs[0][k].cpu(), runs[1][k]), k
    ctel = {"gb": rng.random((e, 5)).astype(np.float32) * 1e-3,
            "stale": rng.integers(0, 50, (e, 5)), "reads": rng.integers(50, 100, e)}
    runs = [CadenceController(eps0=0.3, device=d).run_scan(2, ctel)[1]
            for d in (cuda, "cpu")]
    for k in runs[1]:
        assert torch.equal(runs[0][k].cpu(), runs[1][k]), k


@pytest.mark.parametrize("shape", [(2, 3, 4, 10), (4, 16, 8, 100), (8, 64, 1, 256),
                                   (12, 16384, 1, 16384), (3, 7, 5, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("enforce", [True, False])
@pytest.mark.parametrize("dup", [False, True])
def test_session_floor_kernel_matches_plain(cuda, shape, enforce, dup):
    p, c, r, b = shape
    rng = np.random.default_rng(b + dup)
    rv, rf, wf = (_t(rng.integers(0, 40, s, dtype=np.int32), cuda)
                  for s in ((p, r), (c, r), (c, r)))
    cl, pl, res = (_t(rng.integers(0, n, b, dtype=np.int32), cuda) for n in (c, p, r))
    if dup:
        cl[1::2], res[1::2] = cl[0], res[0]
    valid = _t(rng.random(b) < 0.8, cuda)
    rf0 = rf.clone()
    for v in (None, valid):
        got = ops.session_admit(rv, rf, wf, cl, pl, res, enforce=enforce, valid=v,
                                impl="cuda")
        want = ops.session_admit(rv, rf, wf, cl, pl, res, enforce=enforce, valid=v,
                                 impl="torch")
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert torch.equal(rf, rf0)   # the input floors are untouched


@pytest.mark.parametrize("shape", [(2, 3, 4, 10), (4, 16, 8, 100), (8, 64, 1, 256),
                                   (12, 64, 1, 64), (12, 16384, 1, 16384), (3, 7, 5, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dup", [False, True])
def test_session_check_kernel_matches_plain(cuda, shape, dup):
    p, c, r, b = shape
    rng = np.random.default_rng(b + dup)
    rv, rf, wf = (_t(rng.integers(-5, 40, s, dtype=np.int32), cuda)
                  for s in ((p, r), (c, r), (c, r)))
    cl, pl, res = (_t(rng.integers(0, n, b, dtype=np.int32), cuda) for n in (c, p, r))
    if dup:
        cl[1::2], res[1::2] = cl[0], res[0]
    index = torch.stack([cl, pl])
    valid = _t(rng.random(b) < 0.8, cuda)
    for v in (None, valid):
        for resource in (None, res):
            got = sf.session_check_cuda(rv, rf, wf, index, resource=resource, valid=v)
            want = sf.session_check_ref(rv, rf, wf, index, resource=resource, valid=v)
            out = torch.full_like(got, -1)
            assert ops.session_check(rv, rf, wf, index, resource=resource, valid=v,
                                     out=out) is out
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(out, want)
        admit = sf.session_admit_cuda(rv, rf, wf, cl, pl, res, valid=v)
        assert torch.equal(sf.session_check_cuda(rv, rf, wf, index, resource=res, valid=v),
                           torch.stack([admit[1].to(torch.int32), admit[2]]))


@pytest.mark.parametrize("level", ["X_STCC", "ONE"])
def test_serving_on_the_card_equals_cpu(cuda, level):
    from repro_torch.serve import ServingEngine
    from torch_port_helpers import PortServingApi, plain, serving_counters, serving_script

    class Null:
        prefill = decode_step = None

    out = []
    for dev in (cuda, "cpu"):
        eng = ServingEngine(Null(), ConsistencyLevel[level], max_replicas=12,
                            max_sessions=64, device=dev)
        eng.set_topology(pl.fleet_topology(PAPER_TOPOLOGY,
                                           pl.static_counts(PAPER_TOPOLOGY, 4)))
        eng.attach_controller(AdaptiveController(64, SLA_RELAXED, device=dev))
        ops.reset_launch_counts()
        log = serving_script(PortServingApi(), eng, seed=0, n_epochs=4, rounds=2,
                             n_sessions=64)
        out.append((plain(log), serving_counters(eng), ops.launch_counts()))
    assert out[0][:2] == out[1][:2]
    assert out[0][2]["session_floor"] > 0 and out[0][2]["policy_score"] == 4
    assert out[0][2]["vclock_audit"] == 0 and out[1][2]["session_floor"] == 0


# -- B.8 flash_attention ------------------------------------------------------

# (b, h, hkv, s, t, hd, causal, window, dtype): the reference's FA_CASES
# (tests/test_kernels.py), then ragged 64-row tiles, S != T, head dims 32
# and 256 in bf16, a window in bf16, and qwen2-7b's group of 7.
FA_GPU_CASES = [
    (2, 4, 2, 256, 256, 64, True, 0, "float32"),
    (1, 2, 1, 128, 128, 128, True, 0, "float32"),
    (1, 4, 4, 256, 256, 64, False, 0, "float32"),
    (2, 2, 2, 256, 256, 64, True, 64, "float32"),
    (1, 8, 2, 384, 384, 64, True, 0, "bfloat16"),
    (1, 1, 1, 128, 128, 256, True, 0, "float32"),
    (1, 2, 1, 96, 96, 32, True, 0, "float32"),
    (2, 8, 1, 160, 160, 256, True, 0, "bfloat16"),
    (1, 4, 2, 200, 200, 128, True, 50, "bfloat16"),
    (1, 3, 3, 100, 70, 64, False, 0, "bfloat16"),
    (1, 2, 2, 64, 130, 64, True, 0, "float32"),
    (1, 14, 2, 192, 192, 128, True, 0, "bfloat16"),
]


def _fa_inputs(case, dev):
    from repro_torch.kernels import flash_attention as fa  # noqa: F401

    b, h, hkv, s, t, hd, _, _, dtype = case
    g = torch.Generator(device=dev).manual_seed(s * hd + h)
    dt = getattr(torch, dtype)
    return [torch.randn(shape, generator=g, device=dev).to(dt)
            for shape in ((b, h, s, hd), (b, hkv, t, hd), (b, hkv, t, hd))]


def _fa_tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


@pytest.mark.parametrize("case", FA_GPU_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import flash_attention as fa

    *_, causal, window, dtype = case
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _fa_inputs(case, cuda)
    n0 = fa.launches
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1 and got.dtype == q.dtype
    tol = _fa_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# The bf16 wgmma kernel: head dims 32 / 64 / 128 / 256, groups 1, 2, 8,
# lengths off the 64-key and 128-row tiles, S != T both ways, windows,
# non-causal, gemma-2b's full shape, and rows whose keys are all masked
# (S > T with a window: rows i >= T - 1 + window see no key).
FA_BF16_CASES = [
    (1, 2, 2, 96, 96, 32, True, 0, "bfloat16"),
    (1, 2, 1, 64, 192, 32, True, 0, "bfloat16"),
    (1, 4, 2, 130, 130, 64, True, 0, "bfloat16"),
    (1, 4, 2, 300, 100, 64, True, 0, "bfloat16"),
    (1, 2, 1, 200, 70, 64, True, 16, "bfloat16"),
    (1, 8, 1, 333, 333, 128, True, 0, "bfloat16"),
    (1, 4, 4, 100, 300, 128, False, 0, "bfloat16"),
    (2, 8, 1, 200, 200, 256, True, 32, "bfloat16"),
    (1, 8, 1, 2048, 2048, 256, True, 0, "bfloat16"),
    (1, 8, 8, 257, 257, 256, False, 0, "bfloat16"),
]


@pytest.mark.parametrize("case", FA_BF16_CASES, ids=str)
def test_flash_attention_bf16_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import flash_attention as fa

    *_, causal, window, dtype = case
    q, k, v = _fa_inputs(case, cuda)
    n0 = fa.launches
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1 and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("hd,h,hkv", [(256, 8, 1), (128, 28, 4), (32, 4, 2)])
def test_flash_attention_bf16_reads_model_layout_in_place(cuda, hd, h, hkv):
    """(B, S, H, hd) tensors passed as transposed views (no copy), into a
    (B, S, H, hd) output view: the same answer as contiguous inputs."""
    from repro_torch.kernels import flash_attention as fa

    case = (2, h, hkv, 160, 160, hd, True, 0, "bfloat16")
    q, k, v = _fa_inputs(case, cuda)
    want = fa.flash_attention_cuda(q, k, v)
    sw = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    out = torch.empty((2, 160, h, hd), dtype=torch.bfloat16, device=cuda)
    n0 = fa.launches
    fa.flash_attention_cuda(*sw, out=out.transpose(1, 2))
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    assert torch.equal(out.transpose(1, 2), want)
    torch.testing.assert_close(want.float(), fa.flash_attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


def test_flash_attention_bf16_refuses_unaligned_views(cuda):
    """A row stride that is not a 16-byte multiple cannot be a TMA tensor
    map: the wrapper raises rather than copying."""
    from repro_torch.kernels import flash_attention as fa

    base = torch.zeros((1, 2, 64, 68), device=cuda, dtype=torch.bfloat16)
    q = base[..., :64]
    n0 = fa.launches
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention_cuda(q, q, q)
    assert fa.launches == n0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ops_layouts_on_the_card(cuda, dtype):
    """``ops.flash_attention`` under ``impl="auto"`` launches the kernel on
    CUDA tensors, in both layouts (``bshd`` read and written through
    strides), and equals the plain version."""
    case = (2, 8, 2, 256, 256, 128, True, 0, dtype)
    q, k, v = _fa_inputs(case, cuda)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, layout="bhsd")
    sw = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    got_bshd = ops.flash_attention(*sw)
    want = ops.flash_attention(q, k, v, layout="bhsd", impl="torch")
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 2
    tol = _fa_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got_bshd.transpose(1, 2), got)


def test_flash_attention_kernel_refuses_what_it_cannot_run(cuda):
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros((1, 2, 64, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, q, q)
    q = torch.zeros((1, 2, 64, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention_cuda(q, q, q)
    q = torch.zeros((1, 2, 64, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        fa.flash_attention_cuda(q, q.detach(), q.detach())


@pytest.mark.parametrize("arch,over", [("gemma-2b", {}), ("qwen2-7b", {"n_kv_heads": 2})])
def test_model_forward_on_the_card_matches_cpu(cuda, arch, over):
    """A reduced model's forward on the card, through the kernel, against
    the plain attention on the CPU (f32, TF32 off)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(arch), **over)
    model = build_model(dataclasses.replace(cfg, use_flash_kernel=True))
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64), dtype=np.int32))
    ops.reset_launch_counts()
    with torch.inference_mode():
        got, _ = model.forward(_to(params, cuda),
                               {"tokens": tokens.to(cuda)})
        want, _ = build_model(cfg).forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_model_generate_on_the_card_equals_cpu(cuda):
    """``ServingEngine.generate`` on a reduced gemma-2b: the tokens,
    replicas and routing counters of the card equal the CPU's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import ServeSession, ServingEngine
    from torch_port_helpers import (MODEL_SERVING, model_serving_counters,
                                    model_serving_script)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("gemma-2b"))
    model = build_model(cfg)
    params = [model.init(seed, device="cpu") for seed in (0, 1)]
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8), dtype=np.int32))
               for _ in range(MODEL_SERVING["n_requests"])]
    out = []
    for dev in (cuda, torch.device("cpu")):
        eng = ServingEngine(model, device=dev)
        with torch.inference_mode():
            log = model_serving_script(
                eng, [_to(p, dev) for p in params],
                lambda i: {"tokens": prompts[i].to(dev), "max_seq": 12}, ServeSession,
                n_tokens=4, **MODEL_SERVING)
        out.append((log, model_serving_counters(eng)))
    assert out[0] == out[1]
    assert out[0][1]["failovers"] == 1


# ---- the model families ------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_on_the_card_equals_cpu(cuda, arch):
    """A reduced f32 model of each MoE, VLM, hybrid, SSM and audio
    configuration: ``forward`` through B.8 (one launch per causal
    self-attention layer), prefill + decode and the served tokens on the
    card against the plain attention on the CPU (logits within
    ``FAMILY_TOL``, TF32 off; tokens and routing exactly)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(arch))
    card = build_model(dataclasses.replace(cfg, use_flash_kernel=True))
    cpu = build_model(cfg)
    params = [cpu.init(seed, device="cpu") for seed in (0, 1)]
    with torch.inference_mode():
        ops.reset_launch_counts()
        card.forward(tree_to(params[0], cuda),
                     torch_batch(family_inputs(cfg, 2, FAMILY_CHECK["seq"], 0), cuda))
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == causal_attention_layers(cfg)
        got = family_outputs(card, tree_to(params[0], cuda), cfg, cuda)
        want = family_outputs(cpu, params[0], cfg, "cpu")
        assert family_mismatches(got, want) == []
        assert family_serving(card, params, cfg, cuda) == family_serving(
            cpu, params, cfg, "cpu")


# ---- the training path -------------------------------------------------------------

GPU_TRAIN_CASES = [c for c in TRAIN_CASES
                   if train_case_id(c) in ("CAUSAL/2pods", "X_STCC/2pods/int8",
                                           "X_STCC/2pods/topk", "QUORUM/4pods")]


@pytest.mark.parametrize("case", GPU_TRAIN_CASES, ids=train_case_id)
def test_training_on_the_card_equals_cpu(cuda, case):
    """A reduced sync run from the same weights and batches: the
    bookkeeping (counters, clocks, DUOT) equal to the CPU, the losses
    within ``TRAIN_LOSS_RTOL``, and B.1 / chain / B.2 launched as
    predicted (two, two and one per causal merge)."""
    card, cpu = port_trainer(case, cuda), port_trainer(case, "cpu")
    params = cpu.model.init(0, device="cpu")
    ops.reset_launch_counts()
    st_card = card.run(card.init_state(params))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st_cpu = cpu.run(cpu.init_state(params))
    assert history_mismatches(cpu.history, card.history) == []
    assert record_mismatches(sync_record(st_cpu.sync), sync_record(st_card.sync)) == []
    want = expected_train_launches(case)
    assert {k: counts[k] for k in want} == want
    assert sum(counts.values()) == sum(want.values())


def test_trainer_refuses_the_attention_kernel_on_the_card(cuda):
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import policy_for
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(configs.reduced(configs.get_config("gemma-2b")),
                              use_flash_kernel=True)
    with pytest.raises(ValueError, match="no backward"):
        Trainer(cfg, DataConfig(cfg.vocab_size, 16, 4), AdamWConfig(), policy_for("X_STCC"),
                TrainerConfig(n_pods=2), device=cuda)


# ---- the one-device mesh ---------------------------------------------------------


def test_one_device_mesh_sync_step_equals_no_mesh(cuda):
    """A (1, 1) mesh over an NCCL group of one rank: reduced qwen2-7b's
    ``sync_step`` under ``use_mesh`` equals the same steps with no mesh,
    bit for bit, with B.1 / chain / B.2 launched as predicted."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from torch_port_helpers import (MESH_STEP_CASE, mesh_step_launches, mesh_step_mismatches,
                                    mesh_sync_steps)

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        params = port_trainer(MESH_STEP_CASE, "cpu").model.init(0, device="cpu")
        plain = mesh_sync_steps(cuda, params)
        ops.reset_launch_counts()
        on_mesh = mesh_sync_steps(cuda, params, mesh)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    assert mesh_step_mismatches(plain, on_mesh) == []
    want = mesh_step_launches()
    assert {k: counts[k] for k in want} == want


def test_one_device_mesh_sync_step_on_dtensors_equals_no_mesh(cuda):
    """The same steps on the state ``init_state`` places on the (1, 1)
    NCCL mesh (DTensor leaves: the pod loop, AdamW on local blocks, the
    merge on DTensors) equal the plain steps bit for bit, with the same
    launches."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding
    from repro_torch.tree import leaves
    from torch_port_helpers import (MESH_STEP_CASE, mesh_step_launches, mesh_step_mismatches,
                                    mesh_sync_steps)

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        params = port_trainer(MESH_STEP_CASE, "cpu").model.init(0, device="cpu")
        plain = mesh_sync_steps(cuda, params)
        ops.reset_launch_counts()
        placed = mesh_sync_steps(cuda, params, mesh, placed=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert all(map(sharding.is_dtensor, leaves(placed[1].params)))
        assert mesh_step_mismatches(plain, placed) == []
    finally:
        dist.destroy_process_group()
    want = mesh_step_launches()
    assert {k: counts[k] for k in want} == want


# ---- the mesh's collective regions ----------------------------------------------------


def _reduced_kv1(device, **over):
    """Reduced qwen2-7b with one kv head ("dp" attention on a model axis
    of 2 or 4): its config, model and parameters on ``device``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    cfg = reduced(get_config("qwen2-7b"), n_kv_heads=1, **over)
    return cfg, build_model(cfg), build_model(cfg).init(0, device=device)


def test_nccl_one_rank_lse_decode_equals_plain_decode(cuda):
    """A (1, 1) mesh over an NCCL group of one rank: reduced qwen2-7b (one
    kv head) decoding with ``decode_comm="lse_shardmap"``, its ``pmax`` /
    ``psum`` NCCL all-reduces, within 1e-4 of the plain decode; the
    combine ran in every layer of every step."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, sharding
    from torch_mesh_cases import count_regions, decode_logits

    cfg, lse, params = _reduced_kv1(cuda, decode_comm="lse_shardmap")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32).to(cuda)
    want = decode_logits(build_model(dataclasses.replace(cfg, decode_comm="xla")), params,
                         {"tokens": toks}, 16, 8, 24)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with count_regions() as calls, sharding.use_mesh(make_mesh((1, 1), ("data", "model"))):
            got = decode_logits(lse, params, {"tokens": toks}, 16, 8, 24)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert calls == {"ring": 0, "lse": cfg.n_layers * 8}
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_stacked_ring_forward_on_the_card(cuda):
    """Under ``MeshShape({"data": 1, "model": 4})`` the ring attention
    (all four shards on the card) gives reduced qwen2-7b's logits within
    1e-4 of the plain attention on the card and of the ring on the CPU."""
    from repro_torch.models import sharding
    from repro_torch.models.sharding import MeshShape
    from repro_torch.tree import tree_map
    from torch_mesh_cases import count_regions

    cfg, model, params = _reduced_kv1("cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    mesh = MeshShape({"data": 1, "model": 4})
    with torch.no_grad():
        with sharding.use_mesh(mesh):
            cpu = model.forward(params, {"tokens": toks})[0]
        params = tree_map(lambda t: t.to(cuda), params)
        plain = model.forward(params, {"tokens": toks.to(cuda)})[0]
        with count_regions() as calls, sharding.use_mesh(mesh):
            ring = model.forward(params, {"tokens": toks.to(cuda)})[0]
    assert calls == {"ring": cfg.n_layers, "lse": 0}
    torch.testing.assert_close(ring, plain, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ring.cpu(), cpu, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nccl_one_rank_spmd_flash_wrapper(cuda, dtype):
    """A (1, 1) mesh over an NCCL group of one rank, reduced gemma-2b's
    parameters as DTensors: B.8's local-shard wrapper
    (``attention.flash_attention_spmd``) on the DTensor q/k/v launches the
    kernel once and equals the kernel on the plain tensors bit for bit,
    and the plain attention within B.8's contract; the model's flash
    forward on the DTensors launches it once per layer and equals the
    plain flash forward bit for bit."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, build_model, common, sharding, transformer

    cfg = dataclasses.replace(reduced(get_config("gemma-2b")), dtype=dtype,
                              use_flash_kernel=True)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32).to(cuda)
    pos = common.arange_positions(2, 64, cuda)
    blk = common.layer(params["dense_blocks"], 0, 0)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        with torch.no_grad():
            x = transformer.embed_tokens(params, cfg, toks, {})
            q, k, v = attention._project_qkv(x, blk["attn"], cfg, pos, flash=True)
            want = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
            plain_attn = attention._attend_block(q, k, v, cfg, pos, pos, True)
            plain_fwd = model.forward(params, {"tokens": toks})[0]
            with sharding.use_mesh(mesh):
                placed = sharding.distribute_params(params, cfg)
                with sharding.spmd(placed):
                    xd = transformer.embed_tokens(placed, cfg, toks, {})
                    qd, kd, vd = attention._project_qkv(xd, common.layer(
                        placed["dense_blocks"], 0, 0)["attn"], cfg, pos, flash=True)
                    ops.reset_launch_counts()
                    got = attention.flash_attention_spmd(qd, kd, vd, cfg)
                    one = ops.launch_counts()["flash_attention"]
                ops.reset_launch_counts()
                fwd = model.forward(placed, {"tokens": toks})[0]
                per_forward = ops.launch_counts()["flash_attention"]
            torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert sharding.is_dtensor(got) and (one, per_forward) == (1, cfg.n_layers)
    assert torch.equal(got.full_tensor(), want)
    torch.testing.assert_close(got.full_tensor().float(), plain_attn.float(), atol=tol, rtol=tol)
    assert torch.equal(fwd.full_tensor(), plain_fwd)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_nccl_one_rank_spmd_families(cuda, arch):
    """A (1, 1) mesh over an NCCL group of one rank, each family's reduced
    f32 parameters as DTensors, B.8 on: ``forward``, the prompt's prefill
    (logits and every cache leaf) and a greedy ``generate`` equal to the
    same parameters plain, bit for bit (one rank: no partial sums), with
    as many B.8 launches per meshed forward as per plain forward."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, sharding
    from repro_torch.serve import ServeSession, ServingEngine

    cfg = dataclasses.replace(reduced(get_config(arch)), use_flash_kernel=True)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    batch = torch_batch(family_inputs(cfg, 2, 32, 5), cuda)
    batch.pop("labels")
    k = 16 + cfg.n_vis_tokens
    prompt = dict(batch, tokens=batch["tokens"][:, :k], max_seq=k + 4)

    def run(p):
        ops.reset_launch_counts()
        fwd = model.forward(p, batch)[0]
        launches = ops.launch_counts()["flash_attention"]
        logits, cache = model.prefill(p, prompt)
        eng = ServingEngine(model, device=cuda)
        eng.publish(p, version=1)
        toks, _ = eng.generate(ServeSession(0), prompt, 4)
        out = {"forward": fwd, "prefill": logits, **{f"cache/{n}": c for n, c in cache.items()},
               "generate": toks}
        return {n: x.full_tensor() if sharding.is_dtensor(x) else x
                for n, x in out.items()}, launches, eng.logit_gathers

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        with torch.no_grad():
            want, plain_launches, _ = run(params)
            with sharding.use_mesh(mesh):
                got, launches, gathers = run(sharding.distribute_params(params, cfg))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert launches == plain_launches == causal_attention_layers(cfg)
    assert gathers == 4
