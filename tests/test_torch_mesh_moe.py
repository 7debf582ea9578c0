"""The MoE layer's per-data-shard dispatch in the port: with more than
2048 tokens under a mesh whose data axis divides them, each shard's
contiguous block of tokens routes on its own, under its own capacity,
as the reference's ``shard_map`` over 'data' does.  Held against the
reference under the same mesh of forced host devices
(``tests/torch_mesh_ref.py``, one subprocess per gloo group), with the
port under a ``MeshShape`` in this process and under a ``DeviceMesh`` of
spawned gloo groups of 4 and 2.

Exact: each shard's routing (sorted experts, tokens, queue positions),
its (E, C, D) buffer, which slots are kept and which dropped, the shard
count and capacity.  Within tolerance: the router's probabilities and
the gates (1e-6: the two packages' f32 router products round apart), the
aux loss (1e-6, for the same reason; it stays over all T, bit-equal to
the port's own no-mesh aux), the layer's output and the model's logits
(atol = rtol = 1e-5), one step's gradients (rtol 1e-4, atol 1e-6, the
families' rule).
"""

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
import torch_mesh_cases as mc
from repro.models import moe as j_moe
from repro.models import sharding as j_sharding
from repro_torch import configs as tc
from repro_torch.models import abstract_params, build_model, common, moe
from repro_torch.models import sharding
from repro_torch.models.sharding import MeshShape

PART = "moe"
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
CASES = mc.CASES[PART]
WORLDS = [(4, (mc.M22, mc.M41)), (2, (mc.M21,))]
MODES = ("stacked", "gloo")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, case id -> the stacked outputs, case id ->
    every gloo rank's outputs)."""
    return mc.run_all(PART, tmp_path_factory.mktemp("mesh_moe"), WORLDS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES, ids=mc.case_ids(CASES))
def test_routing_and_drops_exact(runs, case, mode):
    got, want = mc.outputs(runs, case, mode)
    assert int(got["shards"]) == int(want["shards"]) == case["mesh"]["data"]
    assert int(got["capacity"]) == int(want["capacity"])
    for k in ("se", "st", "pos", "buf"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    kept = want["pos"] < want["capacity"]
    np.testing.assert_array_equal(got["pos"] < got["capacity"], kept)
    assert (~kept).any() and kept.any()           # the input makes every shard drop slots
    for k in ("probs", "sg"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES, ids=mc.case_ids(CASES))
def test_layer_output_aux_and_logits(runs, case, mode):
    got, want = mc.outputs(runs, case, mode)
    np.testing.assert_allclose(got["y"], want["y"], **TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got["forward"], want["forward"], **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_one_step_gradients(runs, mode):
    case = next(c for c in CASES if c.get("grad"))
    got, want = mc.outputs(runs, case, mode)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    keys = sorted(k for k in want if k.startswith("grad/"))
    assert keys and keys == sorted(k for k in got if k.startswith("grad/"))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def _layer(arch: str):
    cfg = tc.reduced(tc.get_config(arch))
    params = build_model(cfg).init(mc.SEED, device="cpu")
    return cfg, common.layer(params["moe_blocks"]["moe"], 0)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b"])
def test_split_drops_other_slots_and_keeps_aux_whole(arch):
    """The per-shard capacity drops other slots than one capacity over all
    tokens, so the output moves; the aux loss is over all tokens either
    way, bit for bit."""
    cfg, p = _layer(arch)
    case = dict(b=16, s=256)
    x = torch.from_numpy(mc.moe_input(cfg, case))
    with mc.record_dispatch() as routes:
        y0, aux0 = moe.moe(x, p, cfg)
        with sharding.use_mesh(MeshShape(mc.M41)):
            y1, aux1 = moe.moe(x, p, cfg)
    whole, split = ((r[-1] >= r[1]).sum(-1) for r in routes)
    assert whole.shape == (1,) and split.shape == (4,)
    assert int(split.sum()) != int(whole.sum())
    assert not torch.equal(y0, y1)
    assert torch.equal(aux0, aux1)


@pytest.mark.parametrize("axes", [mc.M22, mc.M41, {"data": 16, "model": 16}])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b"])
def test_small_t_equals_the_no_mesh_layer_bitwise(arch, axes):
    """Up to 2048 tokens the whole batch routes as one block under any
    mesh, as in the reference."""
    cfg, p = _layer(arch)
    x = torch.from_numpy(mc.moe_input(cfg, dict(b=8, s=256)))
    y0, aux0 = moe.moe(x, p, cfg)
    with sharding.use_mesh(MeshShape(axes)):
        y1, aux1 = moe.moe(x, p, cfg)
    assert torch.equal(y0, y1) and torch.equal(aux0, aux1)


@pytest.mark.parametrize("axes", [None, mc.M22, mc.M41, {"data": 3, "model": 2},
                                  {"pod": 2, "data": 16, "model": 16}, {"model": 4}],
                         ids=["none", "2x2", "4x1", "3x2", "2x16x16", "model_only"])
def test_n_data_shards_matches_reference(axes):
    jmesh = None if axes is None else AbstractMesh(tuple(axes.values()), tuple(axes))
    for t in (2048, 4096, 6144, 4097):
        j_sharding.set_mesh(jmesh)
        try:
            want = j_moe._n_data_shards(t)
        finally:
            j_sharding.set_mesh(None)
        with sharding.use_mesh(None if axes is None else MeshShape(axes)):
            assert moe._n_data_shards(t) == want, (axes, t)


def test_per_shard_dispatch_runs_on_meta():
    """The dry run's path: 16 data shards, each its own (E, C, D) buffer,
    on meta tensors (no host read)."""
    cfg = tc.reduced(tc.get_config("olmoe-1b-7b"))
    p = common.layer(abstract_params(build_model(cfg))["moe_blocks"]["moe"], 0)
    x = torch.empty((16, 256, cfg.d_model), device="meta")
    with mc.record_dispatch() as routes, sharding.use_mesh(MeshShape({"data": 16,
                                                                      "model": 16})):
        y, aux = moe.moe(x, p, cfg)
    bufs = [r[2] for r in routes]
    assert y.device.type == "meta" and tuple(y.shape) == tuple(x.shape)
    assert tuple(bufs[0].shape) == (16, cfg.n_experts, moe.capacity(cfg, 256), cfg.d_model)
