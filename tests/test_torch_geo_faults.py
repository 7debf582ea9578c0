"""Port's geo + faults == JAX's: ``EngineConfig(topology=PAPER_TOPOLOGY,
faults=...)`` with an outage, a partition and a crash, gossip with hinted
handoff, WAL/snapshot durability and the obs plane, replayed through both
packages (the latency fields within ``GEO_LATENCY_RTOL``, the rest
exact, the faulty result's ``"geo"`` block included); the reference's
``ValueError``s for a topology that is not 3 replicas and for
nearest-peer gossip on the fault path."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import availability as jav
from repro.core.replicated_store import DurabilityConfig as JDura
from repro.engine import EngineConfig as JConfig
from repro.engine import EpochEngine as JEngine
from repro.geo import topology as jtopo
from repro.gossip.scheduler import GossipConfig as JGossip
from repro.obs.metrics import ObsConfig as JObs
from repro.storage.ycsb import WORKLOAD_A as JW
from repro_torch.core import availability as tav
from repro_torch.core.consistency import EVAL_LEVELS
from repro_torch.core.consistency import ConsistencyLevel as TL
from repro_torch.core.replicated_store import DurabilityConfig
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.replay import EpochEngine
from repro_torch.geo import topology as ttopo
from repro_torch.gossip.scheduler import GossipConfig
from repro_torch.obs.metrics import ObsConfig
from repro_torch.storage.ycsb import WORKLOAD_A

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import CPU, geo_mismatches, jlevel

torch.set_num_threads(1)

N_OPS, BATCH = 1024, 128


def _schedule(m):
    """Replica 1 crashes at epoch 2 for two epochs, replica 0 is cut off
    for epochs [5, 7), and replica 2 is down in epoch 7."""
    return (m.replica_crash(10, 3, 1, 2, 2)
            & m.partition(10, 3, [[0], [1, 2]], 5, 7)
            & m.replica_outage(10, 3, 2, 7, 8))


def _outage_only(m):
    return m.replica_outage(10, 3, 1, 2, 5)


VARIANTS = {
    # name: (schedule, gossip, durability, obs)
    "all": (_schedule, dict(cadence=2, hint_cap=8), (2, True), True),
    "snapshots_no_gossip": (_schedule, None, (2, False), False),
    "outage_amnesiac": (_outage_only, dict(cadence=1, hint_cap=0), None, True),
}


def _pair(level, variant, *, topology="paper"):
    sched, gossip, dura, obs = VARIANTS[variant]
    jt = {"paper": jtopo.PAPER_TOPOLOGY,
          "hot": dataclasses.replace(jtopo.PAPER_TOPOLOGY,
                                     client_region=(0,) * 11 + (1, 1, 1) + (2, 2))}[topology]
    tt = {"paper": ttopo.PAPER_TOPOLOGY,
          "hot": dataclasses.replace(ttopo.PAPER_TOPOLOGY,
                                     client_region=(0,) * 11 + (1, 1, 1) + (2, 2))}[topology]
    kw = dict(n_ops=N_OPS, batch_size=BATCH)
    jc = JConfig(jlevel(level), topology=jt, faults=sched(jav),
                 gossip=JGossip(**gossip) if gossip else None,
                 durability=JDura(*dura) if dura else None,
                 obs=JObs() if obs else None, **kw)
    tc = EngineConfig(level, topology=tt, faults=sched(tav),
                      gossip=GossipConfig(**gossip) if gossip else None,
                      durability=DurabilityConfig(*dura) if dura else None,
                      obs=ObsConfig() if obs else None, **kw)
    return JEngine(jc).run(JW), EpochEngine(tc, device=CPU).run(WORKLOAD_A)


@pytest.mark.parametrize("level", EVAL_LEVELS, ids=lambda lv: lv.name)
def test_geo_faults_six_levels_match_reference(level):
    want, got = _pair(level, "all")
    assert geo_mismatches(want, got) == []
    assert got["recovery"]["crashes"] == 1 and got["crash_epochs"] == [2]
    geo = got["geo"]
    assert np.asarray(geo["traffic_events"]).sum() > 0
    assert sum(geo["per_region"]["ops"]) == N_OPS
    assert got["propagation_events"] > 0 and got["failovers"] > 0


@pytest.mark.parametrize("variant", ["snapshots_no_gossip", "outage_amnesiac"])
def test_geo_faults_variants_match_reference(variant):
    want, got = _pair(TL.X_STCC, variant, topology="hot")
    assert geo_mismatches(want, got) == []
    assert ("recovery" in got) == (variant != "outage_amnesiac")


def test_geo_faults_rejections_match_reference():
    # A composed topology must place the paper's 3 replicas.
    for cfg, topo, av in ((JConfig, jtopo, jav), (EngineConfig, ttopo, tav)):
        level = jlevel(TL.X_STCC) if cfg is JConfig else TL.X_STCC
        with pytest.raises(ValueError, match="exactly 3 replicas"):
            cfg(level, topology=topo.single_region(4), faults=av.all_up(5, 3))
        with pytest.raises(ValueError, match="n_shards"):
            cfg(level, topology=topo.PAPER_TOPOLOGY, n_shards=2)
        # single_region(3) composes.
        cfg(level, topology=topo.single_region(3), faults=av.all_up(5, 3))


def test_geo_faults_nearest_peer_gossip_raises_as_in_reference():
    """The fault path schedules gossip without the topology, so
    ``peer="nearest"`` needs a topology there, in both packages."""
    kw = dict(n_ops=256, batch_size=BATCH)
    jc = JConfig(jlevel(TL.X_STCC), topology=jtopo.PAPER_TOPOLOGY, faults=_schedule(jav),
                 gossip=JGossip(cadence=2, peer="nearest"), **kw)
    tc = EngineConfig(TL.X_STCC, topology=ttopo.PAPER_TOPOLOGY, faults=_schedule(tav),
                      gossip=GossipConfig(cadence=2, peer="nearest"), **kw)
    with pytest.raises(ValueError, match="RegionTopology"):
        JEngine(jc).run(JW)
    with pytest.raises(ValueError, match="RegionTopology"):
        EpochEngine(tc, device=CPU).run(WORKLOAD_A)
