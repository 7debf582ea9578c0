"""Training on DTensor leaves in this process, with no process spawned: a
gloo group of one rank (a (1, 1) mesh, where every placement is whole and
the meshed path must equal the plain one bit for bit) and a fake process
group of eight ranks (a (pod 2, data 2, model 2) mesh: placements and
per-rank bytes only, its collectives do not run), for the dense
transformer and every other family.  The steps over several ranks are
held against the reference in the gloo worlds of
``tests/test_torch_mesh_attention.py`` (the dense transformer) and
``tests/test_torch_mesh_families.py`` (the other families)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_port_helpers import (FAMILY_ARCHS, MESH_STEP_CASE, family_trainer,
                                mesh_local_sync, mesh_step_mismatches, port_trainer)
from repro_torch import configs as tc
from repro_torch.checkpoint import CheckpointStore, SessionToken
from repro_torch.core import policy_for
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, common, moe, sharding
from repro_torch.models.sharding import MeshShape
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_fns
from repro_torch.tree import items, leaves, tree_map

CFG = tc.reduced(tc.get_config("qwen2-7b"))
P222 = {"pod": 2, "data": 2, "model": 2}


@pytest.fixture
def one_rank():
    """A gloo group of one rank and its (1, 1) ("data", "model") mesh;
    the group is destroyed at teardown."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture
def fake_p222():
    """A fake process group of eight ranks (this process is rank 0) and its
    (pod 2, data 2, model 2) mesh; destroyed at teardown."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_mesh(tuple(P222.values()), tuple(P222), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _whole(tree):
    return tree_map(lambda x: x.full_tensor() if sharding.is_dtensor(x) else x, tree)


def test_adamw_on_dtensor_leaves_equals_plain(one_rank):
    """``global_norm``, ``clip_by_global_norm`` and three ``adamw.apply``
    steps on DTensor parameters, moments and gradients (f32 and bf16
    leaves) equal the plain tensors' bit for bit on one rank."""
    gen = torch.Generator().manual_seed(0)
    params = build_model(CFG).init(0, device="cpu")
    params["embed"] = params["embed"].to(torch.bfloat16)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8, grad_clip=0.5)
    plain = tree_map(torch.clone, params)
    with sharding.use_mesh(one_rank):
        placed = sharding.distribute_params(tree_map(torch.clone, params), CFG)
    assert all(map(sharding.is_dtensor, leaves(placed)))
    ps, ts = adamw.init(plain, cfg), adamw.init(placed, cfg)
    for step in range(3):
        grads = tree_map(lambda x: torch.randn(x.shape, generator=gen).to(x.dtype), params)
        with sharding.use_mesh(one_rank):
            g_placed = sharding.distribute_params(tree_map(torch.clone, grads), CFG)
        assert torch.equal(adamw.global_norm(g_placed), adamw.global_norm(grads))
        clipped, _ = adamw.clip_by_global_norm(g_placed, 0.5)
        for a, b in zip(leaves(_whole(clipped)), leaves(adamw.clip_by_global_norm(grads, 0.5)[0])):
            assert torch.equal(a, b)
        plain, ps, pm = adamw.apply(plain, grads, ps, cfg)
        placed, ts, tm = adamw.apply(placed, g_placed, ts, cfg)
        assert torch.equal(pm["grad_norm"], tm["grad_norm"]) and ts.count == ps.count
    for a, b in zip(leaves(plain) + leaves(ps.mu) + leaves(ps.nu),
                    leaves(_whole(placed)) + leaves(_whole(ts.mu)) + leaves(_whole(ts.nu))):
        assert torch.equal(a, b)


# The dense transformer's cases keep their ids; every other family joins.
DISTRIBUTE_CASES = [pytest.param("qwen2-7b", c, id=c) for c in ("int8", "topk")] + [
    pytest.param(arch, c, id=f"{arch}-{c}") for arch in FAMILY_ARCHS for c in ("int8", "topk")]


@pytest.mark.parametrize("arch,compress", DISTRIBUTE_CASES)
def test_distribute_state_follows_the_dry_run(fake_p222, arch, compress):
    """``make_train_fns``' init under a (pod 2, data 2, model 2) mesh places
    every leaf as the dry run's specs say (``P("pod", *pspec_for_param)``
    for the parameters and both moments, the anchor as one pod's
    parameters, the residual as the parameters: the experts' 3-D leaves,
    the hybrid's shared block, rwkv6's mixes and LoRA, whisper's encoder
    alike), and rank 0 holds exactly the bytes the dry run counts for it."""
    cfg = tc.reduced(tc.get_config(arch))
    policy = policy_for("X_STCC", delta_steps=1, compress_inter_pod=compress)
    fns = make_train_fns(build_model(cfg), adamw.AdamWConfig(), policy, 2, device="cpu")
    params = build_model(cfg).init(0, device="cpu")
    with sharding.use_mesh(fake_p222):
        state = fns.init(params=params)
    specs = dryrun._leaf_specs(fns.init(params=params).params, cfg, MeshShape(P222),
                               pod_dim=True)
    pod = sharding.dtensor_placements
    for path, _, _, spec in specs:
        key = "/".join(path)
        want = pod(fake_p222, ("pod",) + tuple(spec))
        for tree in (state.params, state.opt.mu, state.opt.nu):
            assert list(dict(items(tree))[key].placements) == want, key
        if compress == "topk":
            assert list(dict(items(state.sync.residual))[key].placements) == want, key
        assert list(dict(items(state.sync.anchor))[key].placements) == pod(fake_p222, spec), key
    mesh = MeshShape(P222)
    assert sharding.local_nbytes(state.params) == dryrun._state_bytes(specs, mesh, pods=2)
    assert sharding.local_nbytes(state.opt.mu) + sharding.local_nbytes(state.opt.nu) == (
        2 * dryrun._state_bytes(specs, mesh, 4, pods=2))
    sync = sharding.local_nbytes(state.sync.anchor) + (
        sharding.local_nbytes(state.sync.residual) if compress == "topk" else 0)
    assert sync == dryrun._sync_bytes(state.sync, specs, mesh, 2) > 0
    assert sharding.local_nbytes(state.params) < sharding.local_nbytes(_whole_shapes(specs))


def _whole_shapes(specs) -> dict:
    return {"/".join(path): torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
            for path, leaf, _, _ in specs}


def test_checkpoint_round_trip_on_a_mesh(one_rank, tmp_path):
    """``Trainer`` under a (1, 1) mesh: the placed state trains two sync
    steps, ``save_checkpoint`` writes pod 0's parameters whole,
    ``restore_checkpoint`` places them again and one more step follows;
    every step, parameter and bookkeeping value equals the same run on
    plain tensors bit for bit, and both checkpoints hold the same tensors."""
    runs = []
    for mesh in (None, one_rank):
        trainer = port_trainer(MESH_STEP_CASE, "cpu")
        trainer.ckpt_store = CheckpointStore(str(tmp_path / str(mesh is None)), n_replicas=2,
                                             device="cpu")
        trainer.ckpt_session = SessionToken(client_id=0)
        steps = []
        with sharding.use_mesh(mesh):
            state = trainer.init_state()
            for step in range(2):
                state, m = trainer.fns.sync_step(state, trainer.batch_for(step))
                steps.append({k: np.asarray(v) for k, v in m.items()})
            trainer.save_checkpoint(state, 2)
            state, at = trainer.restore_checkpoint()
            assert at == 2 and all(map(sharding.is_dtensor, leaves(state.params))) == (
                mesh is not None)
            state, m = trainer.fns.sync_step(state, trainer.batch_for(2))
            steps.append({k: np.asarray(v) for k, v in m.items()})
        saved, _, _ = trainer.ckpt_store.restore(
            tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype),
                     _whole(state.params)), trainer.ckpt_session)
        runs.append((steps, state._replace(params=_whole(state.params)), saved))
    (m0, s0, c0), (m1, s1, c1) = runs
    assert mesh_step_mismatches((m0, s0), (m1, s1)) == []
    assert all(torch.equal(a, b) for a, b in zip(leaves(c0), leaves(c1)))


def test_active_mesh_is_the_processs():
    """The mesh set by ``use_mesh`` is seen from other threads: autograd
    runs a CUDA backward, and the rematerialized layers' forwards inside
    it, on threads of its own."""
    import threading

    seen = []
    with sharding.use_mesh(MeshShape(P222)):
        t = threading.Thread(target=lambda: seen.append(sharding.mesh_shape(sharding.get_mesh())))
        t.start()
        t.join()
    assert seen == [P222] and sharding.get_mesh() is None


# Every family's local then sync step (``family_trainer``: reduced, 2 pods,
# X_STCC with int8, the batches' frames or image prefix from
# ``Trainer.batch_for``), and llama4 with every group of its interleaved
# layers rematerialized (the recompute routes its tokens again).
FAMILY_STEP_CASES = [pytest.param(arch, {}, id=arch) for arch in FAMILY_ARCHS] + [
    pytest.param("llama4-maverick-400b-a17b", {"remat": "full"}, id="llama4-remat_full")]


@pytest.mark.parametrize("arch,over", FAMILY_STEP_CASES)
def test_family_steps_on_dtensors_equal_plain(one_rank, arch, over):
    """A family's local step then sync step on the state placed on the
    (1, 1) mesh (DTensor leaves) equal the same steps on plain tensors bit
    for bit: every metric, the parameters, moments, anchor and the sync
    bookkeeping."""
    params = build_model(tc.reduced(tc.get_config(arch), **over)).init(0, device="cpu")
    plain = mesh_local_sync(family_trainer(arch, "cpu", **over), params)
    placed = mesh_local_sync(family_trainer(arch, "cpu", **over), params, one_rank)
    assert all(map(sharding.is_dtensor, leaves(placed[1].params)))
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in plain[0])
    assert int(placed[1].sync.merges) == 1
    assert mesh_step_mismatches(plain, placed) == []


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-large-v3"])
def test_family_checkpoint_on_a_mesh(one_rank, tmp_path, arch):
    """``Trainer`` of a family on the (1, 1) mesh: after a sync step
    ``save_checkpoint`` writes pod 0's parameters whole (the experts' 3-D
    leaves, the encoder), equal to the plain run's pod 0 bit for bit, and
    ``restore_checkpoint`` places them again as DTensors on every pod."""
    params = build_model(tc.reduced(tc.get_config(arch))).init(0, device="cpu")
    pods = []
    for mesh in (None, one_rank):
        trainer = family_trainer(arch, "cpu")
        trainer.ckpt_store = CheckpointStore(str(tmp_path / str(mesh is None)), n_replicas=2,
                                             device="cpu")
        trainer.ckpt_session = SessionToken(client_id=0)
        with sharding.use_mesh(mesh):
            state = trainer.init_state(params)
            state, _ = trainer.fns.sync_step(state, trainer.batch_for(0))
            trainer.save_checkpoint(state, 1)
            restored, at = trainer.restore_checkpoint()
        assert at == 1
        assert all(map(sharding.is_dtensor, leaves(restored.params))) == (mesh is not None)
        saved, _, _ = trainer.ckpt_store.restore(
            tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype), params),
            trainer.ckpt_session)
        first = _whole(tree_map(lambda x: sharding.pod_row(x, 0), state.params))
        again = _whole(tree_map(lambda x: sharding.pod_row(x, 1), restored.params))
        for a, b, c in zip(leaves(saved), leaves(first), leaves(again)):
            assert torch.equal(a, b) and torch.equal(a, c)
        pods.append(saved)
    assert all(torch.equal(a, b) for a, b in zip(leaves(pods[0]), leaves(pods[1])))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b"])
def test_moe_spmd_backward_on_dtensors(one_rank, arch):
    """``moe._moe_spmd``'s backward on DTensor activations and parameters:
    its aux loss stays a DTensor (made whole with ``full_tensor`` it was a
    plain tensor, which the DTensor loss took as a replicated value, so its
    gradient came back a DTensor that ``full_tensor``'s backward refuses);
    the output and the aux loss equal the plain layer's, and so do the
    gradients of the input and of every parameter, bit for bit."""
    from torch.distributed.tensor import distribute_tensor

    cfg = tc.reduced(tc.get_config(arch))
    params = build_model(cfg).init(0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, cfg.d_model), generator=gen)
    w = torch.randn((2, 8, cfg.d_model), generator=gen)

    def run(layer, xin):
        layer = tree_map(lambda t: t.detach().requires_grad_(), layer)
        xin = xin.detach().requires_grad_()
        with sharding.spmd(layer):
            y, aux = moe.moe(xin, layer, cfg)
            loss = (y * w).sum() + 0.01 * aux
            if sharding.is_dtensor(loss):
                loss = sharding.replicate(loss)
            grads = torch.autograd.grad(loss, [xin] + leaves(layer))
        return y, aux, grads

    y0, aux0, g0 = run(common.layer(params["moe_blocks"]["moe"], 0), x)
    with sharding.use_mesh(one_rank):
        placed = sharding.distribute_params(tree_map(torch.clone, params), cfg)
        xd = distribute_tensor(x, one_rank, sharding.dtensor_placements(
            one_rank, sharding.resolve(x.shape, ("batch", None, None))))
        y1, aux1, g1 = run(common.layer(placed["moe_blocks"]["moe"], 0), xd)
        assert sharding.is_dtensor(aux1)
        whole = [t.full_tensor() for t in (y1, aux1, *g1)]
    assert torch.equal(whole[0], y0) and torch.equal(whole[1], aux0)
    assert len(g0) == len(whole) - 2
    for a, b in zip(g0, whole[2:]):
        assert torch.equal(a, b)
