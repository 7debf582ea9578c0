"""The mesh's attention regions in the port (``sharding.shard_map``): the
ring attention over ``kv_seq`` and the ``lse_shardmap`` flash-decode
combine, against the reference under the same mesh of forced host
devices (``tests/torch_mesh_ref.py``, one subprocess for the file), in
both of the port's modes: every shard stacked in this process under a
``MeshShape``, and one shard per rank of a spawned gloo group (worlds 4
and 2) under a ``DeviceMesh``.

The dense transformer served as SPMD (the ``spmd`` cases, in the same
subprocess and gloo groups): DTensor parameters placed by the
reference's rules on a (1, 2) "tp", a (2, 1) FSDP and a (2, 2) "dp"
mesh, held against the reference under the same mesh and against the
port with no mesh.

Tolerances: logits atol = rtol = 1e-5 (f32; the ring and the combine add
in other orders than the plain attention, as they do in the reference);
one step's gradients rtol 1e-4, atol 1e-6, the families' rule.  Every
rank of a gloo group must hold the same global outputs, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
import torch_mesh_cases as mc
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import attention as j_attention
from repro.models import sharding as j_sharding
from repro_torch import configs as tc
from repro_torch.models import attention, sharding
from repro_torch.models.sharding import MeshShape

PART = "attention"
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
CASES = mc.CASES[PART]
RING = [c for c in CASES if c["kind"] == "ring"]
DECODE = [c for c in CASES if c["kind"] == "decode"]
SPMD = [c for c in CASES if c["kind"] == "spmd"]
B8_TOL = dict(atol=2e-5, rtol=2e-5)       # B.8's f32 contract
# The gloo groups: world size -> the meshes run on it.
WORLDS = {4: (mc.M22, mc.M14), 2: (mc.M12, mc.M21)}
MODES = ("stacked", "gloo")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, case id -> the stacked outputs, case id ->
    every gloo rank's outputs)."""
    return mc.run_all(PART, tmp_path_factory.mktemp("mesh_attention"), WORLDS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", RING, ids=mc.case_ids(RING))
def test_ring_forward_and_prefill_logits(runs, case, mode):
    got, want = mc.outputs(runs, case, mode)
    for key in ("forward", "prefill"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    # The ring ran in each attention layer of forward and prefill (and of
    # the loss's forward), and the combine never.
    cfg = mc.port_config(case["cfg"])
    assert int(got["calls/ring"]) == cfg.n_layers * (3 if case.get("grad") else 2)
    assert int(got["calls/lse"]) == 0


@pytest.mark.parametrize("mode", MODES)
def test_ring_gradients(runs, mode):
    case = next(c for c in RING if c.get("grad"))
    got, want = mc.outputs(runs, case, mode)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    keys = sorted(k for k in want if k.startswith("grad/"))
    assert keys and keys == sorted(k for k in got if k.startswith("grad/"))
    for k in keys:
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", DECODE, ids=mc.case_ids(DECODE))
def test_lse_decode_logits(runs, case, mode):
    got, want = mc.outputs(runs, case, mode)
    assert got["decode"].shape == want["decode"].shape
    np.testing.assert_allclose(got["decode"], want["decode"], **TOL)
    # Every decode step's attention went through the combine; with a cache
    # length the axis does not divide, none did (the reference's _decode_xla).
    assert int(got["calls/lse"]) == case["lse"] * case["steps"]


# ---- the dense transformer as SPMD on a DeviceMesh ------------------------------------


def _spmd_runs(runs, case):
    """(the gloo ranks' outputs, the reference's, the port's with no mesh)."""
    got, want = mc.outputs(runs, case, "gloo")
    plain, _ = mc.outputs(runs, case, "stacked")
    return got, want, plain


def _dp_ring(case) -> bool:
    cfg = mc.port_config(case["cfg"])
    m = case["mesh"]["model"]
    return m > 1 and (cfg.n_heads % m or cfg.n_kv_heads % m)


@pytest.mark.parametrize("case", SPMD, ids=mc.case_ids(SPMD))
def test_spmd_logits_match_reference_and_plain_port(runs, case):
    """forward, the prompt's prefill and every decode step's logits, with
    DTensor parameters, against the reference under the same mesh and the
    port with no mesh (atol = rtol = 1e-5: the TP out-projections add
    partial sums in another order)."""
    got, want, plain = _spmd_runs(runs, case)
    for key in ("forward", "prefill", "decode"):
        assert got[key].shape == want[key].shape == plain[key].shape, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
        np.testing.assert_allclose(got[key], plain[key], err_msg=key, **TOL)
    # "dp" mode runs the ring over the model axis in forward and both prefills.
    n = mc.port_config(case["cfg"]).n_layers
    assert int(got["calls/ring"]) == (3 * n if _dp_ring(case) else 0)
    assert int(plain["calls/ring"]) == int(got["calls/lse"]) == 0


@pytest.mark.parametrize("case", SPMD, ids=mc.case_ids(SPMD))
def test_spmd_generate_tokens_equal_plain(runs, case):
    """Greedy ``generate`` through ``ServingEngine`` gives the port's
    no-mesh tokens exactly, with one gather of the vocab-sharded logits
    per token."""
    got, _, plain = _spmd_runs(runs, case)
    assert got["generate"].shape == (case["b"], case["gen"])
    np.testing.assert_array_equal(got["generate"], plain["generate"])
    assert int(got["logit_gathers"]) == case["gen"]
    assert int(plain["logit_gathers"]) == 0


@pytest.mark.parametrize("case", SPMD, ids=mc.case_ids(SPMD))
def test_spmd_rank_holds_only_its_shards(runs, case):
    """Each rank's parameter bytes are the sum of its leaves' shard shapes
    (``sharding.shard_shape`` of ``pspec_for_param``), less than the whole
    tree's on every mesh here (an axis exceeds 1)."""
    got, _, _ = _spmd_runs(runs, case)
    local, shards, whole = (int(x) for x in got["bytes"])
    assert local == shards < whole


@pytest.mark.parametrize("case", SPMD, ids=mc.case_ids(SPMD))
def test_spmd_flash_wrapper_on_local_shards(runs, case):
    """B.8's wrapper (its plain version on the CPU) on each rank's local
    block: the local heads in "tp" mode, the local batch rows otherwise,
    one call per layer per forward; its output against the plain attention
    on the same DTensors, and the flash forward's logits against the
    port's flash forward with no mesh."""
    got, _, plain = _spmd_runs(runs, case)
    cfg = mc.port_config(case["cfg"])
    np.testing.assert_allclose(got["b8_wrapper"], got["b8_plain"], **B8_TOL)
    np.testing.assert_allclose(got["flash_forward"], plain["flash_forward"], **TOL)
    assert int(got["flash_calls"]) == int(plain["flash_calls"]) == cfg.n_layers
    d, m = case["mesh"]["data"], case["mesh"]["model"]
    heads = cfg.n_heads if _dp_ring(case) else cfg.n_heads // m
    assert tuple(got["flash_q_shape"]) == (case["b"] // d, case["s"], heads, cfg.head_dim)
    assert tuple(plain["flash_q_shape"]) == (case["b"], case["s"], cfg.n_heads, cfg.head_dim)


def test_moe_config_refuses_device_mesh(runs):
    """``distribute_params`` of a MoE configuration on a ``DeviceMesh``
    raises ``NotImplementedError`` instead of running replicated."""
    for case in SPMD:
        got, _, _ = _spmd_runs(runs, case)
        assert int(got["moe_refused"]) == 1, case["id"]


# ---- the port's own rules, against the reference's where it has them ---------------


@pytest.mark.parametrize("axes", [None, {"data": 2, "model": 2}, {"data": 1, "model": 4},
                                  {"data": 4, "model": 1}, {"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16}, {"data": 8}],
                         ids=["none", "2x2", "1x4", "4x1", "16x16", "2x16x16", "data_only"])
def test_ring_applicable_matches_reference(axes):
    """``_ring_applicable`` over configs in "tp" and "dp" mode, with
    ``attn_impl`` "auto" and "dp", at lengths the axis does and does not
    divide and with s != t."""
    jmesh = None if axes is None else AbstractMesh(tuple(axes.values()), tuple(axes))
    tmesh = None if axes is None else MeshShape(axes)
    for arch, over in (("qwen2-7b", {"n_kv_heads": 1}), ("qwen2-7b", {}),
                       ("qwen2-7b", {"n_kv_heads": 1, "attn_impl": "dp"}),
                       ("gemma-2b", {}), ("whisper-large-v3", {})):
        jcfg = j_reduced(j_get_config(arch), **over)
        tcfg = tc.reduced(tc.get_config(arch), **over)
        for s, t in ((64, 64), (48, 48), (30, 30), (64, 32), (512, 512)):
            j_sharding.set_mesh(jmesh)
            try:
                want = j_attention._ring_applicable(jcfg, s, t)
            finally:
                j_sharding.set_mesh(None)
            with sharding.use_mesh(tmesh):
                assert attention._ring_applicable(tcfg, s, t) == want, (arch, over, axes, s, t)


def test_flash_kernel_keeps_priority_over_the_ring():
    """With ``use_flash_kernel`` a causal self-attention runs the flash
    wrapper (its plain version on the CPU) even where the ring applies."""
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(tc.reduced(tc.get_config("qwen2-7b"), n_kv_heads=1),
                              use_flash_kernel=True)
    gen = torch.Generator().manual_seed(0)
    p = attention.init_attention_params(gen, cfg, torch.float32)
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    pos = torch.arange(64, dtype=torch.int32).expand(2, 64)
    flash = ops.flash_attention
    launches = []

    def counted(*a, **kw):
        launches.append(1)
        return flash(*a, **kw)

    ops.flash_attention = counted
    try:
        with mc.count_regions() as calls, sharding.use_mesh(MeshShape(mc.M22)):
            assert attention._ring_applicable(cfg, 64, 64)
            flashed = attention.full_attention(x, p, cfg, pos)
            assert (len(launches), calls["ring"]) == (1, 0)
            plain = attention.full_attention(
                x, p, dataclasses.replace(cfg, use_flash_kernel=False), pos)
            assert (len(launches), calls["ring"]) == (1, 1)
    finally:
        ops.flash_attention = flash
    np.testing.assert_allclose(flashed.numpy(), plain.numpy(), atol=2e-5, rtol=2e-5)


def test_shard_map_stacked_blocks_and_collectives():
    """Under a ``MeshShape``: contiguous blocks on a leading dim, a cyclic
    permute sending shard j's block to j + 1, ``pmax`` and an ascending
    ``psum`` over the shards, replicated inputs and outputs."""
    x = torch.arange(16.0).reshape(2, 8)
    r = torch.tensor([100.0, 200.0])
    seen = {}

    def body(ax, xb, rb):
        seen.update(size=ax.size, x=xb.clone(), r=rb.clone())
        rolled = ax.permute(xb, [(j, (j + 1) % ax.size) for j in range(ax.size)])
        return rolled + ax.psum(xb.sum(-1, keepdim=True)) - ax.pmax(xb.amax(-1, keepdim=True))

    with sharding.use_mesh(MeshShape(mc.M14)):
        out = sharding.shard_map(body, ((None, "model"), (None,)), (None, "model"), "model")(
            x, r)
        total = sharding.shard_map(lambda ax, xb: ax.psum(xb), ((None, "model"),),
                                   (None, None), "model")(x)
    assert seen["size"] == 4
    np.testing.assert_array_equal(seen["x"].numpy(), x.reshape(2, 4, 2).movedim(1, 0).numpy())
    np.testing.assert_array_equal(seen["r"].numpy(), np.tile(r.numpy(), (4, 1)))
    blocks = x.reshape(2, 4, 2)
    want = (torch.roll(blocks, 1, dims=1) + blocks.sum((1, 2), keepdim=True)
            - blocks.amax((1, 2), keepdim=True))
    np.testing.assert_array_equal(out.numpy(), want.reshape(2, 8).numpy())
    np.testing.assert_array_equal(total.numpy(), (((blocks[:, 0] + blocks[:, 1])
                                                    + blocks[:, 2]) + blocks[:, 3]).numpy())
    with pytest.raises(ValueError, match="cyclic shift"):
        sharding.StackedAxis(4).permute(x, [(0, 1), (1, 0), (2, 3), (3, 2)])
