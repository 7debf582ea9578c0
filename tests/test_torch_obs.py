"""Port's observability plane == JAX's: the histogram's plain version
against the reference oracle and twin (empty, saturated and far
out-of-range observations), percentiles and summaries, and the whole
``"obs"`` block of flat and fault-path runs against the live reference;
obs on leaves every other key unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_bridge import sanitize
from repro.core import availability as jav
from repro.core.consistency import ConsistencyLevel as JL
from repro.core.replicated_store import DurabilityConfig as JDura
from repro.gossip.scheduler import GossipConfig as JGossip
from repro.kernels import histogram as jhg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.obs import metrics as jobs
from repro.storage import simulator as jsim
from repro.storage import ycsb as jycsb
from repro_torch import convert
from repro_torch.core import availability as tav
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.gossip.scheduler import GossipConfig
from repro_torch.kernels import histogram as thg
from repro_torch.kernels import ops
from repro_torch.obs import metrics as tobs
from repro_torch.storage import simulator as tsim
from repro_torch.storage import ycsb as tycsb

from torch_port_helpers import CPU

torch.set_num_threads(1)


def _observations(rng, m, b, hi):
    v = rng.integers(0, int(hi), (m, b)).astype(np.float32)
    v[:, ::7] = hi                                   # exactly at hi -> top bin
    v[:, 1::11] = 1e9                                # far beyond hi
    v[:, 2::13] = -1e9                               # far below lo
    v[:, 3::17] = rng.random(v[:, 3::17].shape) * hi  # fractional values
    mask = (rng.random((m, b)) < 0.8).astype(np.int32)
    if m > 1:
        mask[1] = 0                                  # an empty row
    return v, mask


@pytest.mark.parametrize("n_bins", [4, 16, 64])
@pytest.mark.parametrize("batch", [3, 64, 4096])
def test_histogram_plain_matches_oracle_and_twin(n_bins, batch):
    rng = np.random.default_rng(n_bins * batch)
    v, mask = _observations(rng, 3, batch, 64.0)
    lo = np.asarray([0.0, 0.0, -3.5], np.float32)
    hi = np.asarray([64.0, 1024.0, 7.25], np.float32)
    jparams = jhg.metric_params(jnp.asarray(lo), jnp.asarray(hi), n_bins)
    tparams = thg.metric_params(lo, hi, n_bins)
    np.testing.assert_array_equal(tparams.numpy(), np.asarray(jparams))
    want = np.asarray(jref.histogram_ref(jnp.asarray(v), jnp.asarray(mask), jparams,
                                         n_bins=n_bins))
    got = thg.histogram_ref(torch.from_numpy(v), torch.from_numpy(mask), tparams,
                            n_bins=n_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    twin = np.asarray(jops.histogram(jnp.asarray(v), lo=jnp.asarray(lo), hi=jnp.asarray(hi),
                                     n_bins=n_bins, mask=jnp.asarray(mask), impl="tiled"))
    wrapped = ops.histogram(torch.from_numpy(v), lo=lo, hi=hi, n_bins=n_bins,
                            mask=torch.from_numpy(mask), impl="torch")
    np.testing.assert_array_equal(wrapped.numpy(), twin)
    assert int(got[1].sum()) == 0
    # Saturation: everything >= hi of row 0 sits in the top bin.
    assert int(got[0, -1]) >= int(((v[0] >= 64.0) & (mask[0] > 0)).sum())


def test_histogram_one_d_and_nan_match_reference():
    v = np.asarray([0, 1, 5, 1023, 1024, 1e12, -1e12, np.nan, np.inf, -np.inf], np.float32)
    want = np.asarray(jops.histogram(jnp.asarray(v), lo=0.0, hi=1024.0, n_bins=16,
                                     impl="dense"))
    got = ops.histogram(torch.from_numpy(v), lo=0.0, hi=1024.0, n_bins=16, impl="torch")
    assert got.shape == (16,)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        ops.histogram(torch.from_numpy(v), lo=0.0, hi=1.0, n_bins=4, impl="cuda")


@pytest.mark.parametrize("n", [0, 1, 2, 17, 300])
def test_percentiles_and_summaries_match_reference(n):
    rng = np.random.default_rng(n)
    counts = np.zeros(16, np.int32)
    np.add.at(counts, rng.integers(0, 16, n), 1)
    for q in tobs.PERCENTILES + (0.0, 100.0, 37.5):
        want = jobs.host_percentile(counts, 2.0, 4.0, q)
        assert tobs.host_percentile(counts, 2.0, 4.0, q) == want
        dev = float(np.asarray(jhg.hist_percentile(jnp.asarray(counts), 2.0, 4.0, q)))
        assert float(thg.hist_percentile(torch.from_numpy(counts), 2.0, 4.0, q)) == dev
    for h_on in (False, True):
        jspecs = jobs.build_metrics(jobs.ObsConfig(n_bins=16), geo_on=False, h_on=h_on)
        tspecs = tobs.build_metrics(tobs.ObsConfig(n_bins=16), geo_on=False, h_on=h_on)
        assert [tuple(s) for s in jspecs] == [tuple(s) for s in tspecs]
        for a, b in zip(jobs.batch_bounds(jspecs), tobs.batch_bounds(tspecs)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        hist = np.stack([np.roll(counts, i) for i in range(len(tspecs))])
        counters = {k: i * n for i, k in enumerate(tobs.COUNTERS)}
        assert (tobs.summarize(tobs.ObsConfig(n_bins=16), tspecs, hist, counters)
                == jobs.summarize(jobs.ObsConfig(n_bins=16), jspecs, hist, counters))


def test_obs_carry_round_trips_through_numpy():
    d = {"hist": np.arange(6, dtype=np.int32).reshape(2, 3),
         "counters": {k: np.int32(i) for i, k in enumerate(tobs.COUNTERS)}}
    back = convert.obs_to_numpy(convert.obs_from_numpy(d, device=CPU))
    np.testing.assert_array_equal(back["hist"], d["hist"])
    assert {k: int(v) for k, v in back["counters"].items()} == {
        k: int(v) for k, v in d["counters"].items()}


# -- whole runs against the live reference ----------------------------------------

RUNS = {
    "X_STCC/outage+gossip+hints+durability": (
        "faulty", TL.X_STCC, dict(schedule_unit=128),
        dict(gossip=JGossip(cadence=2, hint_cap=32),
             recovery=JDura(snapshot_every=2, wal=True)),
        dict(gossip=GossipConfig(cadence=2, hint_cap=32),
             recovery=DurabilityConfig(snapshot_every=2, wal=True))),
    "CAUSAL/outage": ("faulty", TL.CAUSAL, dict(schedule_unit=128), {}, {}),
    "ONE/all-up": ("flat", TL.ONE, {}, {}, {}),
}


def _port_run(kind, level, common, tkw, obs):
    cfg = tobs.ObsConfig() if obs else None
    if kind == "flat":
        return sanitize(tsim.run_protocol(level, tycsb.WORKLOAD_A, n_ops=600, obs=cfg,
                                          device=CPU))
    return sanitize(tsim.run_protocol_faulty(
        level, tycsb.WORKLOAD_A, n_ops=600, schedule=tav.replica_outage(5, 3, 1, 1, 3),
        obs=cfg, device=CPU, **common, **tkw))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_obs_block_matches_live_reference(run):
    kind, level, common, jkw, tkw = RUNS[run]
    if kind == "flat":
        want = jsim.run_protocol(JL[level.name], jycsb.WORKLOAD_A, n_ops=600,
                                 obs=jobs.ObsConfig())
    else:
        want = jsim.run_protocol_faulty(
            JL[level.name], jycsb.WORKLOAD_A, n_ops=600,
            schedule=jav.replica_outage(5, 3, 1, 1, 3), obs=jobs.ObsConfig(),
            **common, **jkw)
    want = sanitize(want)
    got = _port_run(kind, level, common, tkw, obs=True)
    assert got["obs"] == want["obs"]
    assert got == want
    m = got["obs"]["metrics"]
    assert m["staleness_age"]["count"] == got["obs"]["counters"]["reads"]
    assert ("hint_depth" in m) == run.startswith("X_STCC")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_obs_on_leaves_every_other_key_unchanged(run):
    kind, level, common, _, tkw = RUNS[run]
    on = _port_run(kind, level, common, tkw, obs=True)
    off = _port_run(kind, level, common, tkw, obs=False)
    on.pop("obs")
    assert on == off
