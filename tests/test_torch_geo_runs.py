"""Port's ``run_protocol_geo`` == the live JAX reference, six levels, on
the hot-region client skew and on the paper's 12-replica fleet (4 per
DC): every field exact but the latency fields, held within 1e-5
relative.  (The paper's own 3-region topology is held against the golden
file in ``test_torch_geo.py``.)"""

import dataclasses

import pytest
import torch

from golden_bridge import sanitize
from repro.geo import placement as jpl
from repro.geo import topology as jtopo
from repro.storage import simulator as jsim
from repro.storage.ycsb import WORKLOAD_A as JA
from repro_torch import convert
from repro_torch.core.consistency import EVAL_LEVELS
from repro_torch.storage import simulator as tsim
from repro_torch.storage.ycsb import WORKLOAD_A

from torch_port_helpers import CPU, geo_mismatches, jlevel

torch.set_num_threads(1)

TOPOLOGIES = {
    "hot": dataclasses.replace(jtopo.PAPER_TOPOLOGY,
                               client_region=(0,) * 11 + (1, 1, 1) + (2, 2)),
    "fleet12": jpl.fleet_topology(jtopo.PAPER_TOPOLOGY,
                                  jpl.static_counts(jtopo.PAPER_TOPOLOGY, 4)),
}


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("level", EVAL_LEVELS, ids=lambda lv: lv.name)
def test_run_protocol_geo_matches_reference(topo, level):
    jt = TOPOLOGIES[topo]
    want = sanitize(jsim.run_protocol_geo(jlevel(level), JA, topology=jt, n_ops=600))
    got = sanitize(tsim.run_protocol_geo(level, WORKLOAD_A,
                                         topology=convert.region_topology(jt),
                                         n_ops=600, device=CPU))
    assert geo_mismatches(want, got) == []


def test_fleet_traffic_is_the_papers_two_tier_matrix():
    """12 replicas, 4 per DC: the X_STCC traffic matrix at 600 ops."""
    got = tsim.run_protocol_geo(
        EVAL_LEVELS[0], WORKLOAD_A, topology=convert.region_topology(TOPOLOGIES["fleet12"]),
        n_ops=600, device=CPU)
    assert got["traffic_events"] == [[969, 160, 160], [88, 969, 88], [75, 75, 969]]
