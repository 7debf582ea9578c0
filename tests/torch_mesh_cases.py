"""The cases of ``tests/test_torch_mesh_{attention,moe}.py`` and the
port's side of them, JAX-free: the reference side is
``tests/torch_mesh_ref.py``, run in a subprocess with four forced host
devices; the port runs each case under a ``MeshShape`` in the test
process (every shard stacked in one process) and in a gloo group of
spawned processes (a ``DeviceMesh``, one shard per rank), on the
reference's parameters.

Every case names a reduced configuration (``CONFIGS``), a mesh and the
entry points it drives:
  * ``ring``: ``forward`` and ``prefill`` logits (and with ``grad`` one
    step's loss and gradients) of a config in "dp" attention mode, where
    the ring attention over ``kv_seq`` runs;
  * ``decode``: a prefill and ``steps`` decode steps with
    ``decode_comm="lse_shardmap"``, every step's logits;
  * ``moe``: the first MoE layer's output, aux loss and each data
    shard's routing at T = 4096 tokens, the model's logits (and with
    ``grad`` one step's gradients);
  * ``spmd``: the dense transformer as SPMD on a ``DeviceMesh`` with
    DTensor parameters (``sharding.distribute_params``): ``forward``, the
    prompt's ``prefill`` and ``steps`` decode steps' logits, a greedy
    ``generate`` through ``ServingEngine``, the rank's parameter bytes,
    and B.8's local-shard wrapper (``attention.flash_attention_spmd``,
    its plain version here) against the plain attention on the same
    DTensors.  Its in-process run is the port with no mesh (the SPMD
    path's own baseline), not a ``MeshShape``.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.tree import items

SEED = 3
HERE = pathlib.Path(__file__).resolve().parent

# name -> (arch, overrides of the reduced config).  qwen2-7b with one kv
# head is in "dp" mode on a model axis of 2 or 4 (its 4 heads divide the
# axis, its kv head does not); zamba2 with a 16-slot window decodes from
# a ring buffer; whisper's cross decode attends to 32 frames.
CONFIGS = {
    "qwen_kv1": ("qwen2-7b", {"n_kv_heads": 1}),
    "qwen_kv1_cap_win": ("qwen2-7b", {"n_kv_heads": 1, "attn_logit_softcap": 4.0,
                                      "sliding_window": 24}),
    "qwen_lse": ("qwen2-7b", {"n_kv_heads": 1, "decode_comm": "lse_shardmap"}),
    "zamba2_lse": ("zamba2-1.2b", {"sliding_window": 16, "decode_comm": "lse_shardmap"}),
    "whisper_lse": ("whisper-large-v3", {"decode_comm": "lse_shardmap"}),
    "qwen_spmd": ("qwen2-7b", {}),
    "gemma_spmd": ("gemma-2b", {}),
    "olmoe": ("olmoe-1b-7b", {}),
    "llama4": ("llama4-maverick-400b-a17b", {}),
}

# Configurations that differ only in settings no parameter depends on
# share one set of parameters (one reference initialisation fewer each).
SHARED_PARAMS = {"qwen_kv1_cap_win": "qwen_kv1", "qwen_lse": "qwen_kv1"}


def params_name(cfg_name: str) -> str:
    return SHARED_PARAMS.get(cfg_name, cfg_name)


M22 = {"data": 2, "model": 2}
M14 = {"data": 1, "model": 4}
M12 = {"data": 1, "model": 2}
M41 = {"data": 4, "model": 1}
M21 = {"data": 2, "model": 1}

RING = dict(kind="ring", b=2, s=64)
DECODE = dict(kind="decode", b=2, prompt=8, steps=4, max_seq=16)
MOE = dict(kind="moe", b=16, s=256)          # T = 4096 > the reference's _SMALL_T
SPMD = dict(kind="spmd", b=2, s=16, prompt=8, steps=3, max_seq=16, gen=4)

CASES = {
    "attention": [
        dict(RING, id="ring_d2m2", cfg="qwen_kv1", mesh=M22, grad=True),
        dict(RING, id="ring_d1m4", cfg="qwen_kv1", mesh=M14),
        dict(RING, id="ring_d1m2", cfg="qwen_kv1", mesh=M12),
        dict(RING, id="ring_softcap_window", cfg="qwen_kv1_cap_win", mesh=M22),
        # lse: the flash-decode regions per decode step (one per attention
        # layer; whisper's self and cross attention both).
        dict(DECODE, id="lse_dense_d2m2", cfg="qwen_lse", mesh=M22, lse=2),
        dict(DECODE, id="lse_dense_d1m4", cfg="qwen_lse", mesh=M14, lse=2),
        dict(DECODE, id="lse_dense_d1m2", cfg="qwen_lse", mesh=M12, lse=2),
        dict(DECODE, id="lse_hybrid_ring_buffer", cfg="zamba2_lse", mesh=M22, prompt=16,
             steps=6, max_seq=24, lse=3),
        dict(DECODE, id="lse_cross", cfg="whisper_lse", mesh=M22, lse=4),
        # 18 cache slots on a 4-way axis: the reference decodes with _decode_xla.
        dict(DECODE, id="lse_indivisible", cfg="qwen_lse", mesh=M14, steps=3, max_seq=18,
             lse=0),
        # SPMD: reduced qwen2-7b's 4 heads and 4 kv heads divide the model
        # axis ("tp"); reduced gemma-2b's one kv head does not ("dp", the
        # ring in forward and prefill); the (2, 1) mesh is FSDP only.
        dict(SPMD, id="spmd_tp_d1m2", cfg="qwen_spmd", mesh=M12),
        dict(SPMD, id="spmd_fsdp_d2m1", cfg="qwen_spmd", mesh=M21),
        dict(SPMD, id="spmd_dp_d2m2", cfg="gemma_spmd", mesh=M22),
    ],
    "moe": [
        dict(MOE, id="olmoe_d2m2", cfg="olmoe", mesh=M22, grad=True),
        dict(MOE, id="olmoe_d4m1", cfg="olmoe", mesh=M41),
        dict(MOE, id="llama4_d2m2", cfg="llama4", mesh=M22),
        dict(MOE, id="llama4_d4m1", cfg="llama4", mesh=M41),
        dict(MOE, id="olmoe_d2m1", cfg="olmoe", mesh=M21),
    ],
}


def case_by_id(part: str, cid: str) -> dict:
    return next(c for c in CASES[part] if c["id"] == cid)


def inputs(cfg, case) -> dict:
    """The case's batch as numpy: tokens and labels (B, S) int32, and
    whisper's frames."""
    s = case.get("s", case.get("prompt", 0) + case.get("steps", 0))
    rng = np.random.default_rng(SEED + 1)
    toks = rng.integers(0, cfg.vocab_size, (case["b"], s)).astype(np.int32)
    out = {"tokens": toks, "labels": toks.copy()}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((case["b"], cfg.n_frames, cfg.d_model),
                                            dtype=np.float32)
    return out


def moe_input(cfg, case) -> np.ndarray:
    """The MoE layer's input (B, S, D): f32 standard normal, the first
    half of the rows shifted along one random direction and the second
    half along another, so the two halves load the experts unevenly and
    differently (per-shard capacities then drop other slots than one
    capacity over all tokens)."""
    rng = np.random.default_rng(SEED + 2)
    x = rng.standard_normal((case["b"], case["s"], cfg.d_model), dtype=np.float32)
    shift = 2.0 * rng.standard_normal((2, cfg.d_model), dtype=np.float32)
    half = case["b"] // 2
    x[:half] += shift[0]
    x[half:] += shift[1]
    return x


# ---- the parameters and the reference's arrays -------------------------------------


def write_params(part: str, path) -> dict:
    """Every configuration's parameters for the cases of ``part``, drawn by
    the port's initializer from ``SEED`` (the reference's layout), the
    constant leaves (norm weights, biases) perturbed so that a wrong use of
    them shows; saved as ``params/<name>/<a/b/...>`` and returned."""
    from repro_torch.models import build_model

    rng = np.random.default_rng(SEED)
    arrays = {}
    for name in sorted({params_name(c["cfg"]) for c in CASES[part]}):
        tree = build_model(port_config(name)).init(SEED, device="cpu")
        for key, leaf in items(tree):
            a = leaf.numpy()
            last = key.split("/")[-1]
            if last.endswith("norm") or last.startswith("ln") or last in ("w", "b", "bq", "bk",
                                                                           "bv"):
                a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            arrays[f"params/{name}/{key}"] = a
    np.savez(path, **arrays)
    return arrays


def start_reference(part: str, params_path, out_path) -> subprocess.Popen:
    """Start ``torch_mesh_ref.py`` for ``part`` in a subprocess (it runs
    while the port's side does); :func:`reference_arrays` waits for it."""
    env = dict(os.environ)
    src = str(HERE.parent / "src")
    env["PYTHONPATH"] = os.pathsep.join([src, str(HERE), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, str(HERE / "torch_mesh_ref.py"), part,
                             str(params_path), str(out_path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def reference_arrays(proc: subprocess.Popen, out_path) -> dict:
    """The reference's arrays, once its subprocess has ended."""
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    if proc.returncode:
        raise RuntimeError(f"the reference's mesh run failed:\n{err[-4000:]}")
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


def nested(arrays: dict, prefix: str) -> dict:
    """The entries ``<prefix>/a/b`` as a nested dict ``{"a": {"b": ...}}``."""
    out: dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def case_arrays(arrays: dict, cid: str) -> dict:
    p = cid + "/"
    return {k[len(p):]: v for k, v in arrays.items() if k.startswith(p)}


# ---- the port's side ---------------------------------------------------------------


def port_config(name: str):
    from repro_torch import configs as tc

    arch, over = CONFIGS[name]
    return tc.reduced(tc.get_config(arch), **over)


def _batch(np_batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in np_batch.items()}


def _loss_and_grads(model, params, batch) -> dict:
    """One step's loss and its gradients under autograd (``grad/a/b``)."""
    wrt = {k: v.requires_grad_() for k, v in items(params)}
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, list(wrt.values()))
    return {"loss": loss.detach(), **{f"grad/{k}": g for k, g in zip(wrt, grads)}}


def _ring(case, cfg, params) -> dict:
    from repro_torch.models import build_model

    model = build_model(cfg)
    batch = _batch(inputs(cfg, case))
    s = batch["tokens"].shape[1]
    out = {}
    with torch.no_grad():
        out["forward"] = model.forward(params, batch)[0]
        out["prefill"] = model.prefill(params, {"tokens": batch["tokens"], "max_seq": s})[0]
    if case.get("grad"):
        out.update(_loss_and_grads(model, params, batch))
    return out


def decode_logits(model, params, batch: dict, k: int, steps: int, max_seq: int):
    """Prefill ``batch`` (its ``tokens`` cut to the first ``k``), then
    ``steps`` decode steps fed the next tokens: (steps, B, 1, V) logits."""
    toks = batch["tokens"]
    out = []
    with torch.no_grad():
        _, cache = model.prefill(params, dict(batch, tokens=toks[:, :k], max_seq=max_seq))
        for i in range(steps):
            logits, cache = model.decode_step(params, cache, toks[:, k + i:k + i + 1])
            out.append(logits)
    return torch.stack(out)


def _decode(case, cfg, params) -> dict:
    from repro_torch.models import build_model

    batch = _batch(inputs(cfg, case))
    batch.pop("labels")
    return {"decode": decode_logits(build_model(cfg), params, batch, case["prompt"],
                                    case["steps"], case["max_seq"])}


def _moe(case, cfg, params) -> dict:
    from repro_torch.models import build_model, common, moe

    model = build_model(cfg)
    layer = common.layer(params["moe_blocks"]["moe"], 0)
    x = torch.from_numpy(moe_input(cfg, case))
    with record_dispatch() as routes, torch.no_grad():
        y, aux = moe.moe(x, layer, cfg)
    (probs, cap, buf, se, st, sg, pos), = routes
    out = {"y": y, "aux": aux, "probs": probs.reshape(-1, cfg.n_experts), "buf": buf, "se": se,
           "st": st, "sg": sg, "pos": pos, "capacity": torch.tensor(cap),
           "shards": torch.tensor(se.shape[0])}
    batch = _batch(inputs(cfg, case))
    with torch.no_grad():
        out["forward"] = model.forward(params, batch)[0]
    if case.get("grad"):
        out.update(_loss_and_grads(model, params, batch))
    return out


def _whole(x):
    """A DTensor's global value (a collective: every rank calls it in the
    same order); a plain tensor as it is."""
    from repro_torch.models import sharding

    return x.full_tensor() if sharding.is_dtensor(x) else x


def _spmd(case, cfg, params) -> dict:
    """The SPMD case's outputs on the active mesh (``None``: the port's
    plain path): logits of ``forward`` over all ``s`` tokens, of the
    prompt's ``prefill`` and of ``steps`` decode steps; ``gen`` greedy
    tokens from the prompt through ``ServingEngine`` and its logit
    gathers; the forward with ``use_flash_kernel`` and its wrapper calls;
    on a ``DeviceMesh``, the rank's parameter bytes beside the shards'
    and the whole tree's, B.8's wrapper against the plain attention on
    the first layer's DTensor q/k/v, and whether a MoE config refuses to
    be distributed."""
    import dataclasses

    from repro_torch.convert import params_from_numpy
    from repro_torch.models import (abstract_params, attention, build_model, common, sharding,
                                    transformer)
    from repro_torch.serve import ServeSession, ServingEngine
    from repro_torch.tree import tree_map

    model = build_model(cfg)
    mesh = sharding.get_mesh()
    placed = params_from_numpy(tree_map(lambda t: t.numpy(), params), "cpu", mesh=mesh,
                               cfg=cfg) if mesh is not None else params
    batch = _batch(inputs(cfg, case))
    toks, k = batch["tokens"], case["prompt"]
    out = {}
    with torch.no_grad():
        out["forward"] = _whole(model.forward(placed, {"tokens": toks})[0])
        pre, cache = model.prefill(placed, {"tokens": toks[:, :k], "max_seq": case["max_seq"]})
        out["prefill"] = _whole(pre)
        steps = []
        for i in range(case["steps"]):
            logits, cache = model.decode_step(placed, cache, toks[:, k + i:k + i + 1])
            steps.append(_whole(logits))
        out["decode"] = torch.stack(steps)
        eng = ServingEngine(model, device="cpu")
        eng.publish(placed, version=1)
        out["generate"], _ = eng.generate(
            ServeSession(0), {"tokens": toks[:, :k], "max_seq": k + case["gen"]}, case["gen"])
        out["logit_gathers"] = torch.tensor(eng.logit_gathers)
        flash = build_model(dataclasses.replace(cfg, use_flash_kernel=True))
        with record_flash() as seen:
            out["flash_forward"] = _whole(flash.forward(placed, {"tokens": toks})[0])
        out["flash_calls"] = torch.tensor(len(seen))
        out["flash_q_shape"] = torch.tensor(seen[0])
    if mesh is None:
        return out
    whole = sharding.local_nbytes(params)
    shards = 0
    for key, leaf in items(params):
        spec = sharding.pspec_for_param(tuple(key.split("/")), tuple(leaf.shape), cfg)
        shards += int(np.prod(sharding.shard_shape(tuple(leaf.shape), spec))) * leaf.element_size()
    out["bytes"] = torch.tensor([sharding.local_nbytes(placed), shards, whole])
    # B.8's wrapper and the plain attention on the same DTensors.
    blk = common.layer(placed["dense_blocks"], 0, 0)
    pos = common.arange_positions(*toks.shape, toks.device)
    with torch.no_grad(), sharding.spmd(placed):
        x = transformer.embed_tokens(placed, cfg, toks, {})
        h = common.rms_norm(x, blk["attn_norm"], cfg.norm_eps)
        q, kk, v = attention._project_qkv(h, blk["attn"], cfg, pos, flash=True)
        out["b8_wrapper"] = _whole(attention.flash_attention_spmd(q, kk, v, cfg))
        out["b8_plain"] = _whole(attention._attend_block(q, kk, v, cfg, pos, pos, True))
    moe_cfg = port_config("olmoe")
    try:
        sharding.distribute_params(abstract_params(build_model(moe_cfg)), moe_cfg)
        out["moe_refused"] = torch.tensor(0)
    except NotImplementedError:
        out["moe_refused"] = torch.tensor(1)
    return out


@contextlib.contextmanager
def record_flash():
    """Record the q shape every call of ``kernels.ops.flash_attention``
    (B.8's wrapper) gets inside the block: a rank's local block on a
    ``DeviceMesh``."""
    from repro_torch.kernels import ops

    seen = []
    flash = ops.flash_attention

    def spy(q, *a, **kw):
        seen.append(tuple(q.shape))
        return flash(q, *a, **kw)

    ops.flash_attention = spy
    try:
        yield seen
    finally:
        ops.flash_attention = flash


RUN = {"ring": _ring, "decode": _decode, "moe": _moe, "spmd": _spmd}


@contextlib.contextmanager
def record_dispatch():
    """Record every MoE dispatch run inside the block: ``(probs, capacity,
    buf, se, st, sg, pos)``, the slots stacked by data shard."""
    from repro_torch.models import moe

    routes = []
    dispatch = moe._dispatch_local

    def spy(xt, probs, cfg, cap):
        res = dispatch(xt, probs, cfg, cap)
        routes.append((probs, cap) + res)
        return res

    moe._dispatch_local = spy
    try:
        yield routes
    finally:
        moe._dispatch_local = dispatch


@contextlib.contextmanager
def count_regions():
    """Count the ring attention's (``ring``) and the flash-decode
    combine's (``lse``) regions run inside the block."""
    from repro_torch.models import attention

    calls = {"ring": 0, "lse": 0}
    bodies = {"ring": attention._ring_body, "lse": attention._lse_body}

    def counted(name):
        def run(*a, **kw):
            calls[name] += 1
            return bodies[name](*a, **kw)
        return run

    attention._ring_body, attention._lse_body = counted("ring"), counted("lse")
    try:
        yield calls
    finally:
        attention._ring_body, attention._lse_body = bodies["ring"], bodies["lse"]


def port_outputs(case: dict, arrays: dict, mesh) -> dict:
    """The port's outputs of ``case`` under ``mesh`` (any mesh the port
    takes: a ``MeshShape``, a ``DeviceMesh``, or ``None``) on the
    parameters in ``arrays``, as numpy; ``calls/ring`` and ``calls/lse``
    count the regions it ran."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import sharding

    cfg = port_config(case["cfg"])
    params = params_from_numpy(nested(arrays, f"params/{params_name(case['cfg'])}"),
                               device="cpu")
    with count_regions() as calls, sharding.use_mesh(mesh):
        out = RUN[case["kind"]](case, cfg, params)
    out = {k: v.detach().numpy() for k, v in out.items()}
    out.update({f"calls/{k}": np.asarray(v) for k, v in calls.items()})
    return out


# ---- the gloo group ----------------------------------------------------------------


def _gloo_rank(rank: int, world: int, part: str, ids: list, params_path: str, store: str,
               out_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        with np.load(params_path) as z:
            arrays = {k: z[k] for k in z.files}
        meshes = {}
        result = {}
        for cid in ids:
            case = case_by_id(part, cid)
            key = tuple(case["mesh"].items())
            if key not in meshes:
                meshes[key] = init_device_mesh("cpu", tuple(case["mesh"].values()),
                                               mesh_dim_names=tuple(case["mesh"]))
            out = port_outputs(case, arrays, meshes[key])
            result.update({f"{cid}/{k}": v for k, v in out.items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **result)
    finally:
        dist.destroy_process_group()


def run_gloo(part: str, world: int, ids: list, params_path, tmp_dir) -> list[dict]:
    """The port's outputs of the cases ``ids`` in a gloo group of
    ``world`` spawned processes (a ``DeviceMesh`` per case's mesh shape),
    one dict per rank."""
    import torch.multiprocessing as mp

    tmp_dir = pathlib.Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    store = tmp_dir / "store"
    mp.spawn(_gloo_rank, args=(world, part, list(ids), str(params_path), str(store),
                               str(tmp_dir)), nprocs=world, join=True)
    outs = []
    for r in range(world):
        with np.load(tmp_dir / f"rank{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def run_all(part: str, tmp_dir, worlds: dict) -> tuple[dict, dict, dict]:
    """The reference's arrays, the port's stacked outputs and the gloo
    groups' outputs for every case of ``part``: the parameters first, then
    the reference's subprocess while the port runs its cases in this
    process (each under its ``MeshShape``; an ``spmd`` case with no mesh)
    and in one gloo group per world size of ``worlds`` (world -> the
    meshes it runs)."""
    from repro_torch.models.sharding import MeshShape

    tmp_dir = pathlib.Path(tmp_dir)
    params_path, ref_path = tmp_dir / "params.npz", tmp_dir / "ref.npz"
    params = write_params(part, params_path)
    proc = start_reference(part, params_path, ref_path)
    try:
        stacked = {c["id"]: port_outputs(c, params, None if c["kind"] == "spmd"
                                         else MeshShape(c["mesh"])) for c in CASES[part]}
        gloo = {}
        for world, meshes in worlds.items():
            ids = [c["id"] for c in CASES[part] if c["mesh"] in meshes]
            ranks = run_gloo(part, world, ids, params_path, tmp_dir / f"gloo{world}")
            gloo.update({cid: [case_arrays(r, cid) for r in ranks] for cid in ids})
    except BaseException:
        proc.kill()
        raise
    return reference_arrays(proc, ref_path), stacked, gloo


def outputs(runs: tuple, case: dict, mode: str) -> tuple[dict, dict]:
    """The port's outputs of ``case`` in ``mode`` ("stacked" or "gloo")
    and the reference's, from :func:`run_all`'s ``runs``.  Every gloo rank
    must hold the same outputs, bit for bit."""
    ref, stacked, gloo = runs
    if mode == "stacked":
        got = stacked[case["id"]]
    else:
        ranks = gloo[case["id"]]
        for r, other in enumerate(ranks[1:], 1):
            assert sorted(other) == sorted(ranks[0])
            for k in ranks[0]:
                np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=f"rank {r}: {k}")
        got = ranks[0]
    return got, case_arrays(ref, case["id"])


def case_ids(cases: list) -> list[str]:
    return [c["id"] for c in cases]
