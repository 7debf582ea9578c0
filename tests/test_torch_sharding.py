"""The port's logical-axis sharding rules and production meshes against
the JAX reference (``repro.models.sharding``, ``repro.configs.shapes``'
``mesh=`` branches, ``attn_parallel_mode``).

Meshes are ``jax.sharding.AbstractMesh`` on the reference side and the
same axis sizes (``MeshShape``) on the port's; placements compare entry
by entry with the reference's ``PartitionSpec``.  The production meshes
are built on a fake process group of 256 and 512 ranks.
"""

import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.configs import reduced as j_reduced
from repro.configs import shapes as j_shapes
from repro.models import build_model as j_build_model
from repro.models import sharding as j_sharding
from repro.models.attention import attn_parallel_mode as j_attn_parallel_mode
from repro_torch import configs as tc
from repro_torch.launch import mesh as tmesh
from repro_torch.models import abstract_params, build_model
from repro_torch.models import sharding
from repro_torch.models.attention import attn_parallel_mode

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(1)

ARCHS = list_archs()
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x4": {"data": 4, "model": 4},
}


def _abstract(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


class FakeMesh:
    """The reference tests' mesh stand-in: only a ``.shape`` mapping."""

    def __init__(self, shape):
        self.shape = shape


@functools.lru_cache(maxsize=None)
def _reference_leaves(arch: str) -> tuple:
    tree = jax.eval_shape(j_build_model(j_get_config(arch)).init, jax.random.key(0))
    return tuple((tuple(str(getattr(k, "key", k)) for k in path), tuple(leaf.shape))
                 for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])


def _port_leaves(arch: str) -> dict:
    out = {}

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], path + (k,))
        else:
            out[path] = tuple(tree.shape)

    walk(abstract_params(build_model(tc.get_config(arch))))
    return out


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp_only"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pspec_for_param_matches_reference(arch, mesh, fsdp):
    jcfg = dataclasses.replace(j_get_config(arch), fsdp_params=fsdp)
    tcfg = dataclasses.replace(tc.get_config(arch), fsdp_params=fsdp)
    ref_leaves, port_leaves = _reference_leaves(arch), _port_leaves(arch)
    assert dict(ref_leaves) == port_leaves
    j_sharding.set_mesh(_abstract(MESHES[mesh]))
    try:
        want = {p: tuple(j_sharding.pspec_for_param(p, s, jcfg)) for p, s in ref_leaves}
    finally:
        j_sharding.set_mesh(None)
    with sharding.use_mesh(sharding.MeshShape(MESHES[mesh])):
        got = {p: sharding.pspec_for_param(p, s, tcfg) for p, s in port_leaves.items()}
        tree = sharding.param_placements(abstract_params(build_model(tcfg)), tcfg)
    assert got == want
    # param_placements gives the same tuple at every leaf.
    flat = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            flat[path] = t

    walk(tree)
    assert flat == want


def _spec_rows(specs) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."),
                None if getattr(v, "sharding", None) is None else tuple(v.sharding.spec))
            for k, v in specs.items()}


def _port_rows(specs) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."), v.placement)
            for k, v in specs.items()}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_reference_on_production_meshes(arch, mesh):
    jcfg, tcfg = j_get_config(arch), tc.get_config(arch)
    jmesh, tmesh_ = _abstract(MESHES[mesh]), sharding.MeshShape(MESHES[mesh])
    shapes = [s.name for s in tc.shapes_for(tcfg)]
    assert shapes == [s.name for s in j_shapes.shapes_for(jcfg)]
    for name in shapes:
        jshape, tshape = j_shapes.SHAPES_BY_NAME[name], tc.SHAPES_BY_NAME[name]
        want = _spec_rows(j_shapes.input_specs(jcfg, jshape, mesh=jmesh))
        assert _port_rows(tc.input_specs(tcfg, tshape, mesh=tmesh_)) == want, name
        if tshape.kind == "decode":
            want = _spec_rows(j_shapes.cache_specs(jcfg, jshape, mesh=jmesh))
            assert _port_rows(tc.cache_specs(tcfg, tshape, mesh=tmesh_)) == want, name


def test_specs_without_a_mesh_have_no_placement():
    cfg = tc.get_config("qwen2-7b")
    for spec in (list(tc.input_specs(cfg, tc.TRAIN_4K).values())
                 + list(tc.cache_specs(cfg, tc.DECODE_32K).values())):
        assert spec.placement is None


def test_rules_spec_and_shard_off_a_mesh():
    assert sharding.get_mesh() is None
    assert sharding.spec("batch", None) == tuple(j_sharding.spec("batch", None))
    for logical in ("batch", "heads", "kv_heads", "ff", "vocab", "experts", "kv_seq",
                    "embed", "fsdp", "seq", "residual", None, "unknown"):
        assert sharding.get_rule(logical) == j_sharding.get_rule(logical), logical
    x = torch.ones(4, 4)
    assert sharding.shard(x, "batch", None) is x
    assert sharding.named_sharding("batch") is None
    sharding.set_rule("residual", "model")
    try:
        assert sharding.spec("residual", "batch") == ("model", "data")
    finally:
        sharding.set_rule("residual", None)
    assert sharding.get_rule("residual") is None
    with sharding.use_mesh(sharding.MeshShape({"data": 16, "model": 16})) as m:
        assert sharding.get_mesh() is m
        # Divisibility guard: a plain tensor comes back unchanged.
        assert sharding.shard(torch.ones(4, 28), "batch", "heads").shape == (4, 28)
        assert sharding.named_sharding("batch", None) == ("data", None)
    assert sharding.get_mesh() is None


def test_attn_parallel_mode_matches_reference():
    cfg16 = (j_reduced(j_get_config("olmoe-1b-7b"), n_heads=16, n_kv_heads=16),
             tc.reduced(tc.get_config("olmoe-1b-7b"), n_heads=16, n_kv_heads=16))
    cfg28 = (j_reduced(j_get_config("qwen2-7b"), n_heads=28, n_kv_heads=4),
             tc.reduced(tc.get_config("qwen2-7b"), n_heads=28, n_kv_heads=4))
    cfg_kv = (j_reduced(j_get_config("qwen2-7b"), n_heads=32, n_kv_heads=4),
              tc.reduced(tc.get_config("qwen2-7b"), n_heads=32, n_kv_heads=4))
    for shape in ({"data": 16, "model": 16}, {"data": 4, "model": 4}, {"data": 16},
                  {"pod": 2, "data": 16, "model": 16}):
        j_sharding.set_mesh(FakeMesh(shape))
        try:
            want = [j_attn_parallel_mode(j) for j, _ in (cfg16, cfg28, cfg_kv)]
        finally:
            j_sharding.set_mesh(None)
        with sharding.use_mesh(sharding.MeshShape(shape)):
            assert [attn_parallel_mode(t) for _, t in (cfg16, cfg28, cfg_kv)] == want
    assert [attn_parallel_mode(t) for _, t in (cfg16, cfg28, cfg_kv)] == ["tp"] * 3
    with sharding.use_mesh(sharding.MeshShape({"data": 16, "model": 16})):
        assert [attn_parallel_mode(t) for _, t in (cfg16, cfg28, cfg_kv)] == ["tp", "dp", "dp"]


@pytest.fixture
def fake_world():
    """A fake process group of ``n`` ranks (this process is rank 0),
    destroyed at teardown."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(n: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_production_mesh(device_type="cpu")


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
def test_production_meshes_on_a_fake_process_group(fake_world, multi_pod):
    from torch.distributed.tensor import Replicate, distribute_tensor

    n = tmesh.devices_required(multi_pod=multi_pod)
    fake_world(n)
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    assert sharding.mesh_shape(mesh) == want
    assert tuple(mesh.mesh_dim_names) == tuple(want) and mesh.size() == n
    assert tmesh.n_pods(mesh) == (2 if multi_pod else 1)
    assert tmesh.production_mesh_shape(multi_pod=multi_pod).shape == want
    # The world must be the mesh's size: never shrunk.
    with pytest.raises(ValueError, match=f"needs {512 if not multi_pod else 256} "
                                         f"processes; the process group has {n}"):
        tmesh.make_mesh((2, 16, 16) if not multi_pod else (16, 16),
                        ("pod", "data", "model") if not multi_pod else ("data", "model"),
                        device_type="cpu")
    # A parameter and a batch distributed under their placements give rank 0
    # the shard the reference's spec implies.
    cfg = tc.reduced(tc.get_config("qwen2-7b"), d_model=64, d_ff=96)
    jcfg = j_reduced(j_get_config("qwen2-7b"), d_model=64, d_ff=96)
    params = {"dense_blocks": {"mlp": {"w_up": torch.zeros(64, 96),
                                       "w_down": torch.zeros(96, 64)}},
              "final_norm": torch.zeros(64)}
    j_sharding.set_mesh(_abstract(want))
    try:
        want_specs = {k: tuple(j_sharding.pspec_for_param(("dense_blocks", "mlp", k),
                                                          tuple(v.shape), jcfg))
                      for k, v in params["dense_blocks"]["mlp"].items()}
        batch_spec = tuple(j_shapes.input_specs(
            jcfg, j_shapes.SHAPES_BY_NAME["train_4k"], mesh=_abstract(want))["tokens"].sharding.spec)
    finally:
        j_sharding.set_mesh(None)
    with sharding.use_mesh(mesh):
        placed = sharding.param_placements(params, cfg)
        assert placed["final_norm"] == sharding.dtensor_placements(mesh, ())
        for k, x in params["dense_blocks"]["mlp"].items():
            assert placed["dense_blocks"]["mlp"][k] == sharding.dtensor_placements(
                mesh, want_specs[k])
            local = distribute_tensor(x, mesh, placed["dense_blocks"]["mlp"][k]).to_local()
            assert tuple(local.shape) == sharding.shard_shape(tuple(x.shape), want_specs[k]), k
            assert tuple(local.shape) == tuple(
                d // _split(want, e) for d, e in zip(x.shape, want_specs[k]))
    tokens = tc.input_specs(cfg, tc.TRAIN_4K, mesh=mesh)["tokens"]
    assert tokens.placement == batch_spec
    small = torch.zeros(64, 32, dtype=torch.int32)
    local = distribute_tensor(small, mesh, sharding.dtensor_placements(
        mesh, tokens.placement)).to_local()
    assert tuple(local.shape) == (64 // _split(want, batch_spec[0]), 32)
    # shard() redistributes a DTensor by logical axes, dropping an axis that
    # does not divide its dimension (28 heads on 16).
    x = distribute_tensor(torch.zeros(64, 28), mesh, [Replicate()] * len(want))
    with sharding.use_mesh(mesh):
        y = sharding.shard(x, "batch", "heads")
    assert list(y.placements) == sharding.dtensor_placements(mesh, ("data", None))
    assert tuple(y.to_local().shape) == (4, 28)


def test_one_device_mesh_sync_step_equals_no_mesh_on_the_cpu():
    """The card's mesh check on the CPU: a (1, 1) mesh over a gloo group
    of one process; reduced qwen2-7b's sync steps under it equal the same
    steps with no mesh, bit for bit, and every leaf is replicated."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.tree import items
    from torch_port_helpers import (MESH_STEP_CASE, mesh_step_mismatches, mesh_sync_steps,
                                    port_trainer)

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = tmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        cfg = tc.get_config("gemma-2b")
        with sharding.use_mesh(mesh):
            placed = sharding.param_placements(abstract_params(build_model(cfg)), cfg)
        assert all(all(isinstance(x, Replicate) for x in pl) for _, pl in items(placed))
        params = port_trainer(MESH_STEP_CASE, "cpu").model.init(0, device="cpu")
        plain = mesh_sync_steps("cpu", params)
        on_mesh = mesh_sync_steps("cpu", params, mesh)
        assert mesh_step_mismatches(plain, on_mesh) == []
        assert int(on_mesh[1].sync.merges) == MESH_STEP_CASE[2]
    finally:
        dist.destroy_process_group()


def _split(shape: dict, entry) -> int:
    n = 1
    for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
        n *= shape[a]
    return n
