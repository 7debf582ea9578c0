"""The cases of ``tests/test_torch_mesh_{attention,moe,families}.py`` and
the port's side of them, JAX-free: the reference side is
``tests/torch_mesh_ref.py``, run in subprocesses with four forced host
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
  * ``spmd``: a model as SPMD on a ``DeviceMesh`` with DTensor
    parameters (``sharding.distribute_params``): ``forward``, the
    prompt's ``prefill`` and ``steps`` decode steps' logits, a greedy
    ``generate`` through ``ServingEngine``, the rank's parameter bytes,
    the flash forward's B.8 calls (``attention.flash_attention_spmd``,
    the plain version here) and, for the dense transformer, B.8's
    local-shard wrapper against the plain attention on the same DTensors
    and the training entry points' refusal of DTensor leaves; for a MoE
    configuration, the first MoE layer on DTensor activations
    (``moe._moe_spmd``) at ``MOE_TOKENS``' sizes, above ``_SMALL_T`` and
    at it, with each data shard's routing, and the placements the MoE
    block's and serve layer's constraints give.  Its in-process run is the
    port with no mesh (the SPMD path's own baseline), not a ``MeshShape``;
  * ``train``: a model's training on a (pod, data, model) mesh, its
    state placed as the reference's dry run places it (``make_train_fns``'
    init under the mesh): a ``local_step``, a ``sync_step`` and (the dense
    transformer's cases) one ``SyncEngine.merge`` with pod 1 down, each
    step's loss and grad norm, the parameters, moments, compression state
    and bookkeeping after the sync step and after the masked merge; for
    the dense cases on a mesh with a model axis, also the int8 and top-k
    merges of a leaf sharded over 'model' (:func:`_whole_leaf_merges`).
    Its in-process run is the port with no mesh; the state is held by
    :func:`assert_train_state_close`;
  * ``devices``: ``run_protocol_sharded`` with ``use_devices`` on a
    ``{"shard": n}`` mesh, one shard per rank: the result dict, the
    stacked carries and the rounds each rank replayed.  Its in-process
    run is the one-process replay (``use_devices=False``); the reference
    has no side of it.
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
    "internvl2": ("internvl2-2b", {}),
    "zamba2": ("zamba2-1.2b", {}),
    # The hybrid's training at 2-token SSD chunks, where the reference's
    # gradients stay finite (at its reduced 16-token chunk they are NaN:
    # ROADMAP C).
    "zamba2_c2": ("zamba2-1.2b", {"ssm_chunk": 2}),
    "rwkv6": ("rwkv6-3b", {}),
    "whisper": ("whisper-large-v3", {}),
}

# Configurations that differ only in settings no parameter depends on
# share one set of parameters (one reference initialisation fewer each).
SHARED_PARAMS = {"qwen_kv1_cap_win": "qwen_kv1", "qwen_lse": "qwen_kv1", "zamba2_c2": "zamba2"}


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
# The other families: three served tokens, whose two decode steps' logits
# are the decode check (no ``steps``); the VLM's prompt holds its 8 image
# positions and 8 tokens.
FAMILY_SPMD = dict(SPMD, steps=0, gen=3)
FAMILY_SPMD_CFGS = {"olmoe": {}, "llama4": {}, "internvl2": dict(s=24, prompt=16, max_seq=24),
                    "zamba2": {}, "rwkv6": {}, "whisper": {}}
# The MoE layer's (b, s) on DTensors: T = 4096 > _SMALL_T (each data shard
# routes its own block) and T = 2048 (the whole batch as one block).
MOE_TOKENS = ((16, 256), (8, 256))
SPMD_MESHES = {"tp_d1m2": M12, "fsdp_d2m1": M21, "d2m2": M22}
P2D1M2 = {"pod": 2, "data": 1, "model": 2}
P2D2M1 = {"pod": 2, "data": 2, "model": 1}
SHARD2 = {"shard": 2}
# Training on DTensors: 2 pods, a local step then a sync step (Δ = 1),
# each on its own (P, B/P, S) batch; AdamW past warmup by the sync step.
TRAIN = dict(kind="train", b=4, s=16, steps=2, delta=1)
TRAIN_PODS = 2
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)
# The other families' training: the same steps, with neither the masked
# merge nor the whole-leaf merges, which the dense cases hold (they do not
# depend on the model).
FAMILY_TRAIN = dict(TRAIN, merge_checks=False)
# olmoe at 2 x 1040 tokens per pod: above ``_SMALL_T``, so on a data axis
# of 2 each data block of 1040 tokens routes on its own under the backward.
LONG_MOE_S = 1040
# Two cases whose reorder leaves more entries outside the tight tier than
# ``FLIP_SHARE`` (below) allows, each with the share it is held to.  The
# hybrid's SSD at 2-token chunks adds its decays and states in many short
# sums, in another order than XLA's: the port with no mesh already leaves
# 2.2e-3 of the entries against the reference (1.9e-3 on the mesh).
# olmoe's gradients at 2080 tokens per pod sum 65 times the terms of the
# 32-token cases, so more of them cancel to rounding noise (9.9e-4 on the
# mesh; the plain port routes those tokens otherwise and cannot show it).
FLIP_SHARES = {"zamba2_c2": 5e-3, "olmoe_long": 3e-3}
P2D1M2_INT8 = dict(mesh=P2D1M2, level="X_STCC", compress="int8")
DEVICES = dict(kind="devices", level="TCC", n_ops=400, n_shards=2)
# Kinds whose in-process run is the port with no mesh.
NO_MESH = ("spmd", "train", "devices")

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
        # Training on DTensor leaves: pods split over 'pod', each pod TP
        # over 'model' (int8 and top-k compression) or FSDP over 'data'.
        dict(TRAIN, id="train_p2d1m2", cfg="qwen_spmd", mesh=P2D1M2, level="X_STCC",
             compress="int8"),
        dict(TRAIN, id="train_p2d2m1", cfg="qwen_spmd", mesh=P2D2M1, level="ALL",
             compress="none"),
        dict(TRAIN, id="train_topk_p2d1m2", cfg="qwen_spmd", mesh=P2D1M2, level="X_STCC",
             compress="topk"),
        dict(DEVICES, id="devices_shard2", mesh=SHARD2),
    ],
    "moe": [
        dict(MOE, id="olmoe_d2m2", cfg="olmoe", mesh=M22, grad=True),
        dict(MOE, id="olmoe_d4m1", cfg="olmoe", mesh=M41),
        dict(MOE, id="llama4_d2m2", cfg="llama4", mesh=M22),
        dict(MOE, id="llama4_d4m1", cfg="llama4", mesh=M41),
        dict(MOE, id="olmoe_d2m1", cfg="olmoe", mesh=M21),
    ],
    # Every family but the dense one, as SPMD on each mesh, then trained on
    # DTensor leaves: pods split over 'pod', each pod TP over 'model' or
    # FSDP over 'data'.
    # The training cases are listed so that ``run_all``'s dealing of them
    # over the reference subprocesses gives each about the same compile time.
    "families": [dict(FAMILY_SPMD, id=f"{name}_{mid}", cfg=name, mesh=mesh, **over)
                 for name, over in FAMILY_SPMD_CFGS.items()
                 for mid, mesh in SPMD_MESHES.items()] + [
        dict(FAMILY_TRAIN, id="olmoe_train_p2d1m2", cfg="olmoe", **P2D1M2_INT8),
        dict(FAMILY_TRAIN, id="zamba2_c2_train_p2d1m2", cfg="zamba2_c2",
             flip_share=FLIP_SHARES["zamba2_c2"], **P2D1M2_INT8),
        dict(FAMILY_TRAIN, id="rwkv6_train_p2d2m1", cfg="rwkv6", mesh=P2D2M1, level="X_STCC",
             compress="topk"),
        dict(FAMILY_TRAIN, id="internvl2_train_p2d1m2", cfg="internvl2", **P2D1M2_INT8),
        dict(FAMILY_TRAIN, id="llama4_train_p2d2m1", cfg="llama4", mesh=P2D2M1, level="ALL",
             compress="none"),
        dict(FAMILY_TRAIN, id="whisper_train_p2d1m2", cfg="whisper", **P2D1M2_INT8),
        dict(FAMILY_TRAIN, id="olmoe_long_train_p2d2m1", cfg="olmoe", mesh=P2D2M1,
             level="X_STCC", compress="int8", s=LONG_MOE_S,
             flip_share=FLIP_SHARES["olmoe_long"]),
    ],
}


def case_by_id(part: str, cid: str) -> dict:
    return next(c for c in CASES[part] if c["id"] == cid)


def inputs(cfg, case) -> dict:
    """The case's batch as numpy: tokens and labels (B, S) int32, and
    whisper's frames or the VLM's image prefix."""
    s = case.get("s", case.get("prompt", 0) + case.get("steps", 0))
    rng = np.random.default_rng(SEED + 1)
    toks = rng.integers(0, cfg.vocab_size, (case["b"], s)).astype(np.int32)
    out = {"tokens": toks, "labels": toks.copy()}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((case["b"], cfg.n_frames, cfg.d_model),
                                            dtype=np.float32)
    if cfg.n_vis_tokens:
        out["vis_embeds"] = rng.standard_normal((case["b"], cfg.n_vis_tokens, cfg.d_model),
                                                dtype=np.float32)
    return out


def extras(batch: dict) -> dict:
    """The batch's inputs besides the tokens (frames, the image prefix)."""
    return {k: v for k, v in batch.items() if k in ("frames", "vis_embeds")}


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
    for name in sorted({params_name(c["cfg"]) for c in CASES[part] if "cfg" in c}):
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


def start_reference(part: str, params_path, out_path, ids=()) -> subprocess.Popen:
    """Start ``torch_mesh_ref.py`` for ``part`` (its cases ``ids``, or all)
    in a subprocess (it runs while the port's side does);
    :func:`reference_arrays` waits for it."""
    env = dict(os.environ)
    src = str(HERE.parent / "src")
    env["PYTHONPATH"] = os.pathsep.join([src, str(HERE), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, str(HERE / "torch_mesh_ref.py"), part,
                             str(params_path), str(out_path), ",".join(ids)],
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


class Recorder:
    """A model whose prefill and decode keep every logits tensor they
    return (the served path's logits, read after ``generate``)."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def prefill(self, params, batch):
        logits, cache = self.model.prefill(params, batch)
        self.logits.append(logits)
        return logits, cache

    def decode_step(self, params, cache, tokens):
        logits, cache = self.model.decode_step(params, cache, tokens)
        self.logits.append(logits)
        return logits, cache


def _spmd(case, cfg, params) -> dict:
    """The SPMD case's outputs on the active mesh (``None``: the port's
    plain path): logits of ``forward`` over all ``s`` tokens, of the
    prompt's ``prefill`` and of ``steps`` decode steps fed the next tokens
    (with no ``steps``, the ``gen - 1`` decode steps of ``generate``, fed
    its greedy tokens); ``gen`` greedy tokens from the prompt through
    ``ServingEngine`` and its logit gathers; the forward with
    ``use_flash_kernel`` and its wrapper calls; on a ``DeviceMesh``, the
    rank's parameter bytes beside the shards' and the whole tree's, and
    per family the checks of :func:`_spmd_dense` and :func:`_spmd_moe`."""
    import dataclasses

    from repro_torch.convert import params_from_numpy
    from repro_torch.models import build_model, sharding
    from repro_torch.serve import ServeSession, ServingEngine
    from repro_torch.tree import tree_map

    model = build_model(cfg)
    mesh = sharding.get_mesh()
    placed = params_from_numpy(tree_map(lambda t: t.numpy(), params), "cpu", mesh=mesh,
                               cfg=cfg) if mesh is not None else params
    batch = _batch(inputs(cfg, case))
    toks, k, more = batch["tokens"], case["prompt"], extras(batch)
    prompt = dict(more, tokens=toks[:, :k])
    out = {}
    with torch.no_grad():
        out["forward"] = _whole(model.forward(placed, dict(more, tokens=toks))[0])
        if case["steps"]:
            pre, cache = model.prefill(placed, dict(prompt, max_seq=case["max_seq"]))
            out["prefill"] = _whole(pre)
            steps = []
            for i in range(case["steps"]):
                logits, cache = model.decode_step(placed, cache, toks[:, k + i:k + i + 1])
                steps.append(_whole(logits))
            out["decode"] = torch.stack(steps)
        rec = Recorder(model)
        eng = ServingEngine(rec, device="cpu")
        eng.publish(placed, version=1)
        out["generate"], _ = eng.generate(ServeSession(0), dict(prompt, max_seq=k + case["gen"]),
                                          case["gen"])
        out["logit_gathers"] = torch.tensor(eng.logit_gathers)
        if not case["steps"]:
            out["prefill"] = _whole(rec.logits[0])
            out["decode"] = torch.stack([_whole(x) for x in rec.logits[1:]])
        flash = build_model(dataclasses.replace(cfg, use_flash_kernel=True))
        with record_flash() as seen:
            out["flash_forward"] = _whole(flash.forward(placed, dict(more, tokens=toks))[0])
        out["flash_calls"] = torch.tensor(len(seen))
        if seen:
            out["flash_q_shape"] = torch.tensor(seen[0])
    if mesh is None:
        return out
    whole = sharding.local_nbytes(params)
    shards = 0
    for key, leaf in items(params):
        spec = sharding.pspec_for_param(tuple(key.split("/")), tuple(leaf.shape), cfg)
        shards += int(np.prod(sharding.shard_shape(tuple(leaf.shape), spec))) * leaf.element_size()
    out["bytes"] = torch.tensor([sharding.local_nbytes(placed), shards, whole])
    if cfg.family == "dense":
        out.update(_spmd_dense(cfg, placed, toks))
    if cfg.n_experts:
        out.update(_spmd_moe(cfg, placed, mesh))
    return out


def _spmd_dense(cfg, placed, toks) -> dict:
    """B.8's wrapper and the plain attention on the first layer's DTensor
    q/k/v; the training entry points on the DTensor parameters
    (``train_ran``: make_train_fns' init from them, a local step,
    ``adamw.apply`` and ``SyncEngine.merge``, each run to its end with
    DTensor leaves out; ``train_ring``: the ring regions of the local
    step, which the case's region counts include)."""
    from repro_torch.core.consistency import ConsistencyLevel, ConsistencyPolicy
    from repro_torch.models import attention, build_model, common, sharding, transformer
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_fns
    from repro_torch.tree import leaves, tree_map

    out = {}
    blk = common.layer(placed["dense_blocks"], 0, 0)
    pos = common.arange_positions(*toks.shape, toks.device)
    with torch.no_grad(), sharding.spmd(placed):
        x = transformer.embed_tokens(placed, cfg, toks, {})
        h = common.rms_norm(x, blk["attn_norm"], cfg.norm_eps)
        q, kk, v = attention._project_qkv(h, blk["attn"], cfg, pos, flash=True)
        out["b8_wrapper"] = _whole(attention.flash_attention_spmd(q, kk, v, cfg))
        out["b8_plain"] = _whole(attention._attend_block(q, kk, v, cfg, pos, pos, True))
    fns = make_train_fns(build_model(cfg), adamw.AdamWConfig(),
                         ConsistencyPolicy(ConsistencyLevel.X_STCC), 2, device="cpu")
    placed_leaves = lambda t: all(map(sharding.is_dtensor, leaves(t)))
    ran = []
    state = fns.init(params=placed)
    ran.append(placed_leaves(state.params))
    pods = {"tokens": toks.reshape(2, toks.shape[0] // 2, -1)}
    pods["labels"] = pods["tokens"]
    with count_regions() as calls:
        state, metrics = fns.local_step(state, pods)
    out["train_ring"] = torch.tensor(calls["ring"])
    ran.append(placed_leaves(state.params) and bool(torch.isfinite(metrics["loss"])))
    own = tree_map(lambda x: sharding.map_local(torch.clone, x), placed)
    own, _, _ = adamw.apply(own, own, adamw.init(own, adamw.AdamWConfig()), adamw.AdamWConfig())
    ran.append(placed_leaves(own))
    params, _ = fns.engine.merge(state.params, state.sync)
    ran.append(placed_leaves(params))
    out["train_ran"] = torch.tensor(sum(ran))
    return out


def placement_code(x) -> torch.Tensor:
    """A DTensor's placements as ints, one per mesh dimension: ``d`` for
    ``Shard(d)``, -1 for ``Replicate``, -2 for a partial sum."""
    return torch.tensor([p.dim if p.is_shard() else (-2 if p.is_partial() else -1)
                         for p in x.placements])


def _spmd_moe(cfg, placed, mesh) -> dict:
    """The first MoE layer on DTensor activations (placed on the batch) at
    each of ``MOE_TOKENS``' sizes: ``moe<T>/`` its output, aux loss and
    every data shard's routing (each rank's recorded dispatch, joined over
    'data'); ``moe_block_pl`` / ``serve_layer_pl``: the placements of the
    MoE block's and serve layer's outputs (their constraints) given an
    input replicated over the mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.models import attention, common, moe, sharding, transformer

    out = {}
    blk = common.layer(placed["moe_blocks"], 0)
    for b, s in MOE_TOKENS:
        x = torch.from_numpy(moe_input(cfg, dict(b=b, s=s)))
        xd = distribute_tensor(x, mesh, sharding.dtensor_placements(
            mesh, sharding.resolve(x.shape, ("batch", None, None))))
        with record_dispatch() as routes, torch.no_grad(), sharding.spmd(placed):
            y, aux = moe.moe(xd, blk["moe"], cfg)
        (probs, cap, buf, se, st, sg, pos), = routes
        t = f"moe{b * s}"
        split = b * s > moe._SMALL_T and moe._n_data_shards(b * s) > 1
        data = list(mesh.mesh_dim_names).index("data")
        join = [Replicate()] * mesh.ndim
        join[data] = Shard(0)

        def joined(a):
            return DTensor.from_local(a.contiguous(), mesh, join).full_tensor() if split else a

        out.update({f"{t}/y": _whole(y), f"{t}/aux": _whole(aux),
                    f"{t}/capacity": torch.tensor(cap),
                    f"{t}/shards": torch.tensor(joined(se).shape[0]),
                    f"{t}/probs": joined(probs).reshape(-1, cfg.n_experts)})
        out.update({f"{t}/{k}": joined(a) for k, a in (("buf", buf), ("se", se), ("st", st),
                                                        ("sg", sg), ("pos", pos))})
    # The constraints after the MoE layer, on a replicated input.
    x = torch.from_numpy(moe_input(cfg, dict(b=2, s=8)))
    xd = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)
    pos = common.arange_positions(2, 8, x.device)
    with torch.no_grad(), sharding.spmd(placed):
        y, _ = transformer._moe_block(xd, blk, cfg, pos)
        out["moe_block_pl"] = placement_code(y)
        y, _, _ = transformer._serve_layer(
            xd, blk, cfg, lambda h, p: attention.prefill_attention_with_cache(h, p, cfg, pos))
        out["serve_layer_pl"] = placement_code(y)
    return out


def train_batches(cfg, case) -> list[dict]:
    """A ``train`` case's batches, one per step, as numpy: tokens and labels
    split over the pods, ``(TRAIN_PODS, b / TRAIN_PODS, s)`` int32, and
    whisper's frames or the VLM's image prefix split the same way, f32."""
    rng = np.random.default_rng(SEED + 5)
    shape = (TRAIN_PODS, case["b"] // TRAIN_PODS, case["s"])
    out = []
    for _ in range(case["steps"]):
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        batch = {"tokens": toks, "labels": toks.copy()}
        for key, n in (("frames", cfg.n_frames if cfg.is_encdec else 0),
                       ("vis_embeds", cfg.n_vis_tokens)):
            if n:
                batch[key] = rng.standard_normal(shape[:2] + (n, cfg.d_model),
                                                 dtype=np.float32)
        out.append(batch)
    return out


MASKED_UP = (True, False)

# Parameters, compression anchor and residual after the training steps.
# The tight tier is tests/test_torch_train.py's AdamW bound (rtol 1e-6,
# atol 1e-7) widened ten times for the TP / FSDP partial sums, which add
# in another order than one device (and than XLA).  AdamW divides each
# gradient entry by its own magnitude, so where a gradient is rounding
# noise (the key bias's is zero: one shift of every key leaves each
# softmax unchanged) two correct runs step in unrelated directions, each
# step at most ``lr`` long; an int8 code at a rounding boundary moves by
# one quantum (far below ``lr``) and a top-k selection at its k-th
# magnitude swaps an entry whose delta is at most the steps' length.  So
# at most ``FLIP_SHARE`` of the entries may leave the tight tier, and none
# by more than 2 ``lr`` per step taken (``FLIP_SHARES`` above: the two
# cases held to a larger share).
STATE_TOL = dict(atol=1e-6, rtol=1e-5)
FLIP_SHARE = 1e-3
FLIP_ATOL = 2 * TRAIN_OPT["lr"] * TRAIN["steps"]
STATE_TREES = ("params", "anchor", "residual")


def assert_train_state_close(got: dict, want: dict, tag: str,
                             flip_share: float | None = None) -> None:
    """The ``tag/`` state trees of two ``train`` runs' outputs within the
    two tiers above, at most ``flip_share`` (default ``FLIP_SHARE``) of the
    entries outside the tight one."""
    keys = sorted(k for k in want if k.startswith(tag + "/") and k.split("/")[1] in STATE_TREES)
    assert keys and keys == sorted(k for k in got if k.startswith(tag + "/")
                                   and k.split("/")[1] in STATE_TREES)
    loose = total = 0
    for k in keys:
        g, w = got[k], want[k]
        assert g.shape == w.shape and np.isfinite(g).all(), k
        err = np.abs(g.astype(np.float64) - w)
        assert err.max() <= FLIP_ATOL, (k, err.max())
        loose += int((err > STATE_TOL["atol"] + STATE_TOL["rtol"] * np.abs(w)).sum())
        total += g.size
    assert loose <= (flip_share or FLIP_SHARE) * total, (tag, loose, total)


def _train(case, cfg, params) -> dict:
    """The ``train`` case on the active mesh (``None``: the port's plain
    path): ``make_train_fns``' init from the one-pod ``params``, a local
    step, a sync step, then (unless the case drops ``merge_checks``) one
    merge with ``MASKED_UP``."""
    from repro_torch.core import policy_for
    from repro_torch.models import build_model, sharding
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_fns

    policy = policy_for(case["level"], delta_steps=case["delta"],
                        compress_inter_pod=case["compress"])
    fns = make_train_fns(build_model(cfg), adamw.AdamWConfig(**TRAIN_OPT), policy, TRAIN_PODS,
                         device="cpu")
    state = fns.init(params=params)
    metrics = []
    for step, batch in zip((fns.local_step, fns.sync_step), train_batches(cfg, case)):
        state, m = step(state, _batch(batch))
        metrics.append(m)
    out = {"loss": torch.stack([m["loss"] for m in metrics]),
           "grad_norm": torch.stack([m["grad_norm"] for m in metrics]),
           **_train_record("sync", state)}
    if case.get("merge_checks", True):
        merged, sync = fns.engine.merge(state.params, state.sync, up=np.array(MASKED_UP))
        out.update(_train_record("masked", state._replace(params=merged, sync=sync)))
    for name, tree in (("mu", state.opt.mu), ("nu", state.opt.nu)):
        out.update({f"{name}/{k}": _whole(v) for k, v in items(tree)})
    mesh = sharding.get_mesh()
    if mesh is not None:
        out["placed"] = torch.tensor(all(sharding.is_dtensor(v) for _, v in items(state.params)))
        # The global norm of pod 0's DTensor parameters beside the norm of
        # the same parameters made whole.
        first = {k: sharding.pod_row(v, 0) for k, v in items(state.params)}
        whole = {k: _whole(v) for k, v in first.items()}
        out["norms"] = torch.stack([adamw.global_norm(first), adamw.global_norm(whole)])
        if case.get("merge_checks", True) and sharding.mesh_shape(mesh).get("model", 1) > 1:
            out.update(_whole_leaf_merges(mesh))
    return out


def _train_record(tag: str, state) -> dict:
    """A training state's parameters, compression anchor and residual
    (made whole) and its sync bookkeeping, under ``tag/``: copies, which
    the next merge does not write."""
    out = {}
    for name in ("params", "anchor", "residual"):
        tree = state.params if name == "params" else getattr(state.sync, name)
        if tree is not None:
            out.update({f"{name}/{k}": v for k, v in items(tree)})
    sync = state.sync
    for k in ("merges", "violations", "severity", "inter_pod_gb"):
        out[k] = getattr(sync, k)
    for part in ("cluster", "duot"):
        rec = getattr(sync, part)
        out.update({f"{part}/{f}": getattr(rec, f) for f in rec._fields})
    return {f"{tag}/{k}": _whole(v).clone() for k, v in out.items()}


def _whole_leaf_merges(mesh) -> dict:
    """The int8 and top-k merges of one pod-stacked (2, 4, 8) leaf placed
    ``("pod", None, "model")`` whose two 'model' halves drift 100 times
    apart: on the mesh (``<method>/mesh``), on the whole leaf in this
    process (``<method>/plain``) and on each half alone
    (``<method>/halves``, what a scale or a selection from one rank's
    shard would give): the merged parameters and anchor, whole."""
    from repro_torch.core import policy_for
    from repro_torch.models import sharding
    from repro_torch.sync.engine import SyncEngine

    rng = np.random.default_rng(SEED + 6)
    base = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    drift = torch.from_numpy(0.01 * rng.standard_normal((TRAIN_PODS, 4, 8)).astype(np.float32))
    drift[..., 4:] *= 100.0
    place = sharding.dtensor_placements(mesh, ("pod", None, "model"))

    def merged(method, start, moved, on_mesh):
        eng = SyncEngine(policy_for("X_STCC", delta_steps=1, compress_inter_pod=method),
                         TRAIN_PODS, device="cpu")
        stacked = start[None].repeat(TRAIN_PODS, 1, 1)
        if on_mesh:
            stacked = sharding._from_whole(stacked, mesh, place)
        sync = eng.init_state({"w": stacked})
        x = sharding._from_whole(moved, mesh, place) if on_mesh else moved.clone()
        params, sync = eng.merge({"w": x}, sync)
        return torch.cat([_whole(params["w"]).flatten(), _whole(sync.anchor["w"]).flatten()])

    out = {}
    for method in ("int8", "topk"):
        moved = base + drift
        out[f"whole_leaf/{method}/mesh"] = merged(method, base, moved, True)
        out[f"whole_leaf/{method}/plain"] = merged(method, base, moved, False)
        halves = [merged(method, base[:, h], moved[..., h].contiguous(), False)
                  for h in (slice(0, 4), slice(4, 8))]
        out[f"whole_leaf/{method}/halves"] = torch.cat(halves)
    return out


def _devices(case) -> dict:
    """``run_protocol_sharded`` of the ``devices`` case with ``use_devices``
    on the active mesh (with no mesh: ``use_devices=False``): its result
    dict (``result/...``), the stacked carries (``carry/...``), the rounds
    this process replayed and whether the shards were spread over ranks."""
    from repro_torch.core.consistency import ConsistencyLevel
    from repro_torch.engine import EpochEngine, replay
    from repro_torch.models import sharding
    from repro_torch.storage import simulator
    from repro_torch.storage.ycsb import WORKLOAD_A

    seen = {"rounds": 0}
    step, execute = EpochEngine.round_step, EpochEngine.execute

    def counted(self, *a, **kw):
        seen["rounds"] += 1
        return step(self, *a, **kw)

    def kept(self, prep):
        seen["spread"] = replay.shard_group(self.config) is not None
        prep = execute(self, prep)
        seen["carry"] = prep["out"]
        return prep

    EpochEngine.round_step, EpochEngine.execute = counted, kept
    try:
        res = simulator.run_protocol_sharded(
            ConsistencyLevel[case["level"]], WORKLOAD_A, n_shards=case["n_shards"],
            n_ops=case["n_ops"], audit=True, use_devices=sharding.get_mesh() is not None,
            device="cpu")
    finally:
        EpochEngine.round_step, EpochEngine.execute = step, execute
    out = {"rounds": seen["rounds"], "spread": seen["spread"]}
    flatten("result", res, out)
    flatten("carry", seen["carry"], out)
    return out


def flatten(prefix: str, x, out: dict) -> None:
    """Every tensor and host value in ``x`` (dicts, lists, tuples and
    NamedTuples of them) into ``out`` under ``prefix/<key or index>``
    (``None`` left out)."""
    if isinstance(x, dict):
        for k in sorted(x):
            flatten(f"{prefix}/{k}", x[k], out)
    elif isinstance(x, (list, tuple)):
        keys = x._fields if hasattr(x, "_fields") else range(len(x))
        for k, v in zip(keys, x):
            flatten(f"{prefix}/{k}", v, out)
    elif x is not None:
        out[prefix] = x


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


RUN = {"ring": _ring, "decode": _decode, "moe": _moe, "spmd": _spmd, "train": _train}


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

    if case["kind"] == "devices":
        with sharding.use_mesh(mesh):
            out = _devices(case)
        return {k: _numpy(v) for k, v in out.items()}
    cfg = port_config(case["cfg"])
    params = params_from_numpy(nested(arrays, f"params/{params_name(case['cfg'])}"),
                               device="cpu")
    with count_regions() as calls, sharding.use_mesh(mesh):
        out = RUN[case["kind"]](case, cfg, params)
    out = {k: _numpy(v) for k, v in out.items()}
    out.update({f"calls/{k}": np.asarray(v) for k, v in calls.items()})
    return out


def _numpy(v) -> np.ndarray:
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


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


def start_gloo(part: str, world: int, ids: list, params_path, tmp_dir):
    """Spawn a gloo group of ``world`` processes running the cases ``ids``
    (a ``DeviceMesh`` per case's mesh shape); :func:`gloo_outputs` waits
    for it."""
    import torch.multiprocessing as mp

    tmp_dir = pathlib.Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    store = tmp_dir / "store"
    return mp.spawn(_gloo_rank, args=(world, part, list(ids), str(params_path), str(store),
                                      str(tmp_dir)), nprocs=world, join=False)


def gloo_outputs(ctx, world: int, tmp_dir) -> list[dict]:
    """The outputs of a group from :func:`start_gloo`, one dict per rank,
    once every rank has ended."""
    while not ctx.join():
        pass
    outs = []
    for r in range(world):
        with np.load(pathlib.Path(tmp_dir) / f"rank{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def _plain_key(case: dict) -> tuple:
    """Cases that differ only in their mesh and id have one plain run."""
    return tuple(sorted((k, str(v)) for k, v in case.items() if k not in ("id", "mesh")))


def run_all(part: str, tmp_dir, worlds: list) -> tuple[dict, dict, dict]:
    """The reference's arrays, the port's stacked outputs and the gloo
    groups' outputs for every case of ``part``.  The parameters first;
    then, all at once, one gloo group per ``(world, meshes)`` entry of
    ``worlds`` for the cases on those meshes (a ``DeviceMesh`` each) with
    a reference subprocess of its own for the same cases, while the port
    runs every case in this process (each under its ``MeshShape``; an
    ``spmd`` case with no mesh, once for the cases that differ only in
    their mesh; a ``train`` or ``devices`` case likewise).  The
    reference's ``train`` cases, its slowest (jitted training steps), are
    dealt over the subprocesses from the last world's on, whatever world
    their gloo side runs in: the subprocesses' forced host devices serve
    any mesh of up to four."""
    from repro_torch.models.sharding import MeshShape

    tmp_dir = pathlib.Path(tmp_dir)
    params_path = tmp_dir / "params.npz"
    params = write_params(part, params_path)
    groups = []
    for i, (world, meshes) in enumerate(worlds):
        ids = [c["id"] for c in CASES[part] if c["mesh"] in meshes]
        groups.append((world, ids, tmp_dir / f"gloo{i}", tmp_dir / f"ref{i}.npz"))
    ref_ids = [[cid for cid in ids if case_by_id(part, cid)["kind"] != "train"]
               for _, ids, _, _ in groups]
    trains = [c["id"] for c in CASES[part] if c["kind"] == "train"]
    for i, cid in enumerate(trains):
        ref_ids[len(groups) - 1 - i % len(groups)].append(cid)
    refs, started = [], []
    try:
        for (world, ids, where, ref_path), rids in zip(groups, ref_ids):
            refs.append(start_reference(part, params_path, ref_path, rids))
            started.append(start_gloo(part, world, ids, params_path, where))
        stacked, plain = {}, {}
        for c in CASES[part]:
            if c["kind"] not in NO_MESH:
                stacked[c["id"]] = port_outputs(c, params, MeshShape(c["mesh"]))
                continue
            key = _plain_key(c)
            if key not in plain:
                plain[key] = port_outputs(c, params, None)
            stacked[c["id"]] = plain[key]
        gloo = {}
        for ctx, (world, ids, where, _) in zip(started, groups):
            ranks = gloo_outputs(ctx, world, where)
            gloo.update({cid: [case_arrays(r, cid) for r in ranks] for cid in ids})
    except BaseException:
        for proc in refs:
            proc.kill()
        for ctx in started:
            for p in ctx.processes:
                p.kill()
        raise
    ref = {}
    for proc, (*_, ref_path) in zip(refs, groups):
        ref.update(reference_arrays(proc, ref_path))
    return ref, stacked, gloo


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
