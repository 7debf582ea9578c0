"""Every family but the dense transformer served as SPMD on a
``DeviceMesh``: reduced olmoe, llama4-maverick (the MoE's expert
parallelism), internvl2 (the VLM prefix), zamba2 (hybrid), rwkv6 (SSM)
and whisper (audio), their parameters DTensors placed by the reference's
rules on a (1, 2) "tp", a (2, 1) FSDP and a (2, 2) mesh of spawned gloo
groups, held against the reference under the same mesh of forced host
devices (``tests/torch_mesh_ref.py``, one subprocess per gloo group) and
against the port with no mesh.

The same families trained on DTensor leaves (the ``train`` cases, in the
world of 4): the state placed as the reference's dry run places it on a
(pod 2, data 1, model 2) mesh (olmoe, internvl2, zamba2 at 2-token SSD
chunks and whisper, X_STCC with int8) and a (pod 2, data 2, model 1)
mesh (llama4 under ALL, rwkv6 under X_STCC with top-k, and olmoe at
2 x 1040 tokens per pod, whose data blocks route on their own), a local
step then a sync step, against the reference's jitted steps under the
same mesh and against the port with no mesh.

Tolerances: logits atol = rtol = 1e-5 (f32; the TP products add partial
sums in other orders); the MoE layer's routing, drops, dispatch buffer,
shard count and capacity exact, its router probabilities, gates and aux
loss within 1e-6, its output within atol = rtol = 1e-5; greedy tokens
exact.  Training: losses and grad norms rtol 1e-5, the sync bookkeeping
exact, parameters and anchor by ``mc.assert_train_state_close`` (the
dense cases' tiers; zamba2 and olmoe's long case may leave a larger share
of entries outside the tight one, ``mc.FLIP_SHARES``), AdamW's moments
atol 1e-6, rtol 1e-4 (the dense cases' bounds).  Every rank of a
gloo group must hold the same global outputs, bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
import torch_mesh_cases as mc
from torch_port_helpers import causal_attention_layers
from repro_torch.models import attention, common, moe, sharding, transformer

PART = "families"
TOL = dict(atol=1e-5, rtol=1e-5)
CASES = mc.CASES[PART]
SPMD = [c for c in CASES if c["kind"] == "spmd"]
TRAIN = [c for c in CASES if c["kind"] == "train"]
MOE = [c for c in SPMD if mc.port_config(c["cfg"]).n_experts]
# One gloo group per world, all spawned at once; the training meshes join
# the world of 4.
WORLDS = [(2, (mc.M12,)), (2, (mc.M21,)), (4, (mc.M22, mc.P2D1M2, mc.P2D2M1))]

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, case id -> the port's no-mesh outputs, case
    id -> every gloo rank's outputs)."""
    return mc.run_all(PART, tmp_path_factory.mktemp("mesh_families"), WORLDS)


def _runs(runs, case):
    """(the gloo ranks' outputs, the reference's, the port's with no mesh)."""
    got, want = mc.outputs(runs, case, "gloo")
    plain, _ = mc.outputs(runs, case, "stacked")
    return got, want, plain


@pytest.mark.parametrize("case", SPMD, ids=mc.case_ids(SPMD))
def test_logits_match_reference_and_plain_port(runs, case):
    """forward, the prompt's prefill and every decode step's logits (the
    steps of the greedy ``generate``), with DTensor parameters, against
    the reference under the same mesh and the port with no mesh."""
    got, want, plain = _runs(runs, case)
    for key in ("forward", "prefill", "decode"):
        assert got[key].shape == want[key].shape == plain[key].shape, key
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
        np.testing.assert_allclose(got[key], plain[key], err_msg=key, **TOL)


@pytest.mark.parametrize("case", SPMD, ids=mc.case_ids(SPMD))
def test_generate_tokens_equal_plain(runs, case):
    """Greedy ``generate`` through ``ServingEngine`` gives the port's
    no-mesh tokens and the reference's exactly, with one gather of the
    vocab-sharded logits per token."""
    got, want, plain = _runs(runs, case)
    assert got["generate"].shape == (case["b"], case["gen"])
    np.testing.assert_array_equal(got["generate"], plain["generate"])
    np.testing.assert_array_equal(got["generate"], want["generate"])
    assert int(got["logit_gathers"]) == case["gen"]
    assert int(plain["logit_gathers"]) == 0


@pytest.mark.parametrize("case", SPMD, ids=mc.case_ids(SPMD))
def test_rank_holds_only_its_shards(runs, case):
    """Each rank's parameter bytes are the sum of its leaves' shard shapes
    (``sharding.shard_shape`` of ``pspec_for_param``), less than the whole
    tree's."""
    got, _, _ = _runs(runs, case)
    local, shards, whole = (int(x) for x in got["bytes"])
    assert local == shards < whole


@pytest.mark.parametrize("case", SPMD, ids=mc.case_ids(SPMD))
def test_flash_wrapper_on_local_shards(runs, case):
    """B.8's wrapper (its plain version on the CPU) runs as often per
    meshed forward as per plain forward, one call per causal
    self-attention (rwkv6 has none), on each rank's local heads; the flash
    forward's logits match the port's flash forward with no mesh."""
    got, _, plain = _runs(runs, case)
    cfg = mc.port_config(case["cfg"])
    n = causal_attention_layers(cfg)
    assert int(got["flash_calls"]) == int(plain["flash_calls"]) == n
    np.testing.assert_allclose(got["flash_forward"], plain["flash_forward"], **TOL)
    if n:
        d, m = case["mesh"]["data"], case["mesh"]["model"]
        assert tuple(got["flash_q_shape"]) == (case["b"] // d, case["s"], cfg.n_heads // m,
                                               cfg.head_dim)


def _moe_keys(case):
    return [f"moe{b * s}" for b, s in mc.MOE_TOKENS]


@pytest.mark.parametrize("case", MOE, ids=mc.case_ids(MOE))
def test_moe_routing_and_drops_exact(runs, case):
    """The MoE layer on DTensor activations: above ``_SMALL_T`` tokens each
    data rank routes its own block under its own capacity, at ``_SMALL_T``
    the whole batch is one block; every shard's sorted experts, tokens,
    queue positions and buffer exactly the reference's, the router's
    probabilities and the gates within 1e-6."""
    got, want, _ = _runs(runs, case)
    for t in _moe_keys(case):
        shards = case["mesh"]["data"] if int(t[3:]) > moe._SMALL_T else 1
        assert int(got[f"{t}/shards"]) == int(want[f"{t}/shards"]) == shards, t
        assert int(got[f"{t}/capacity"]) == int(want[f"{t}/capacity"]), t
        for k in ("se", "st", "pos", "buf"):
            assert got[f"{t}/{k}"].shape == want[f"{t}/{k}"].shape, (t, k)
            np.testing.assert_array_equal(got[f"{t}/{k}"], want[f"{t}/{k}"], err_msg=f"{t}/{k}")
        kept = want[f"{t}/pos"] < want[f"{t}/capacity"]
        assert (~kept).any() and kept.any(), t     # the input drops slots in every case
        for k in ("probs", "sg"):
            np.testing.assert_allclose(got[f"{t}/{k}"], want[f"{t}/{k}"], atol=1e-6, rtol=1e-6,
                                       err_msg=f"{t}/{k}")


@pytest.mark.parametrize("case", MOE, ids=mc.case_ids(MOE))
def test_moe_layer_output_and_aux(runs, case):
    """The MoE layer's output within atol = rtol = 1e-5 of the reference
    under the same mesh, its aux loss (over all tokens) within 1e-6."""
    got, want, _ = _runs(runs, case)
    for t in _moe_keys(case):
        np.testing.assert_allclose(got[f"{t}/y"], want[f"{t}/y"], err_msg=t, **TOL)
        np.testing.assert_allclose(got[f"{t}/aux"], want[f"{t}/aux"], atol=1e-6, rtol=1e-6,
                                   err_msg=t)


@pytest.mark.parametrize("case", MOE, ids=mc.case_ids(MOE))
def test_moe_constraints_take_effect_on_a_mesh(runs, case):
    """The MoE block's residual constraint ("batch", "residual", None) and
    the serve layer's ("batch", None, None) place a replicated input's
    output on the batch over 'data' and replicated over 'model'."""
    got, _, _ = _runs(runs, case)
    want = [0 if case["mesh"]["data"] > 1 else -1, -1]
    assert got["moe_block_pl"].tolist() == want
    assert got["serve_layer_pl"].tolist() == want


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b"])
def test_moe_constraints_are_the_identity_off_a_mesh(arch):
    """Off a mesh the MoE block's and serve layer's constraints return
    their input itself, and the block's output is ``x + y``."""
    from repro_torch import configs as tc
    from repro_torch.models import build_model

    cfg = tc.reduced(tc.get_config(arch))
    blk = common.layer(build_model(cfg).init(mc.SEED, device="cpu")["moe_blocks"], 0)
    x = torch.from_numpy(mc.moe_input(cfg, dict(b=2, s=8)))
    pos = common.arange_positions(2, 8, x.device)
    calls = []
    shard = sharding.shard

    def spy(t, *axes):
        out = shard(t, *axes)
        calls.append((axes, out is t))
        return out

    sharding.shard = spy
    try:
        with torch.no_grad():
            y, aux = transformer._moe_block(x, blk, cfg, pos)
            block_calls = list(calls)
            h = common.rms_norm(x, blk["attn_norm"], cfg.norm_eps)
            x1 = x + attention.full_attention(h, blk["attn"], cfg, pos)
            want, want_aux = moe.moe(common.rms_norm(x1, blk["mlp_norm"], cfg.norm_eps),
                                     blk["moe"], cfg)
            calls.clear()
            transformer._serve_layer(
                x, blk, cfg,
                lambda h_, p: attention.prefill_attention_with_cache(h_, p, cfg, pos))
            serve_calls = list(calls)
    finally:
        sharding.shard = shard
    assert torch.equal(y, x1 + want) and torch.equal(aux, want_aux)
    assert block_calls[-1] == (("batch", "residual", None), True)
    assert serve_calls[-1] == (("batch", None, None), True)
    assert all(same for _, same in serve_calls)


# ---- training on DTensor leaves ------------------------------------------------------


@pytest.mark.parametrize("case", TRAIN, ids=mc.case_ids(TRAIN))
def test_family_train_steps_match_reference(runs, case):
    """A local step then a sync step on the DTensor state placed as the dry
    run places it (with the batch's frames or image prefix split over the
    pods), against the reference's jitted steps under the same mesh: losses
    and grad norms within rtol 1e-5, the bookkeeping (merges, violations,
    severity, the bill, the clocks, the DUOT) exact, the parameters and
    anchor by ``mc.assert_train_state_close``, the moments within atol
    1e-6, rtol 1e-4."""
    got, want, _ = _runs(runs, case)
    assert bool(got["placed"])
    for key in ("loss", "grad_norm"):
        assert got[key].shape == want[key].shape == (case["steps"],)
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    book = sorted(k for k in want if k.startswith("sync/")
                  and k.split("/")[1] not in mc.STATE_TREES)
    assert book and int(want["sync/merges"]) == 1
    assert not any(k.startswith("masked/") for k in got)
    for k in book:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mc.assert_train_state_close(got, want, "sync", case.get("flip_share"))
    moments = [k for k in want if k.startswith(("mu/", "nu/"))]
    assert moments and sorted(moments) == sorted(k for k in got if k.startswith(("mu/", "nu/")))
    for k in moments:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", TRAIN, ids=mc.case_ids(TRAIN))
def test_family_train_steps_match_plain_port(runs, case):
    """The same steps on the port's plain tensors with no mesh: the same
    bounds and every bookkeeping value exact, up to ``_SMALL_T`` tokens per
    pod.  Above it the plain port routes each pod's tokens as one block
    while the mesh's data blocks route on their own, each under its own
    capacity, as the reference's do: the losses differ."""
    got, _, plain = _runs(runs, case)
    if case["b"] // mc.TRAIN_PODS * case["s"] > moe._SMALL_T:
        assert case["mesh"]["data"] > 1
        assert not np.allclose(got["loss"], plain["loss"], rtol=1e-5, atol=0)
        return
    np.testing.assert_allclose(got["loss"], plain["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], plain["grad_norm"], rtol=1e-5)
    for k in (k for k in plain if k.startswith("sync/")
              and k.split("/")[1] not in mc.STATE_TREES):
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    mc.assert_train_state_close(got, plain, "sync", case.get("flip_share"))


@pytest.mark.parametrize("case", TRAIN, ids=mc.case_ids(TRAIN))
def test_family_global_norm_over_dtensor_leaves(runs, case):
    """``adamw.global_norm`` of a pod's DTensor parameters, sharded over
    'model' or 'data' (the experts' 3-D leaves, the hybrid's shared block,
    rwkv6's mixes and LoRA, whisper's encoder), is the whole tree's norm on
    every rank (rtol 1e-6)."""
    got, _, _ = _runs(runs, case)
    np.testing.assert_allclose(got["norms"][0], got["norms"][1], rtol=1e-6)
