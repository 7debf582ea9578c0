"""The reference side of ``tests/test_torch_mesh_{attention,moe}.py``: the
JAX models under a mesh of forced host devices, run as a subprocess so
the forced device count stays out of the test process.

    python tests/torch_mesh_ref.py {attention|moe} PARAMS.npz OUT.npz

reads the seeded parameters of ``torch_mesh_cases.write_params``
(``params/<name>/<a/b/...>``, the reference's layout) and writes, for
every case of ``torch_mesh_cases`` in that part, the reference's
outputs under the case's mesh on the case's inputs.  Each entry
point is jitted as a fresh closure inside the mesh: a jitted function
called outside the mesh first would reuse that trace.
"""

from __future__ import annotations

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import build_model, moe as j_moe, sharding  # noqa: E402
import torch_mesh_cases as mc  # noqa: E402


def _cfg(name: str):
    arch, over = mc.CONFIGS[name]
    return reduced(get_config(arch), **over)


def _flat(prefix: str, tree: dict, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def _mesh(shape: dict):
    return make_mesh(tuple(shape.values()), tuple(shape))


def _ring(case, cfg, params, out):
    """forward and prefill logits, and with ``grad`` one step's loss and
    gradients, under the case's mesh."""
    model = build_model(cfg)
    batch = mc.inputs(cfg, case)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    s = batch["tokens"].shape[1]
    with sharding.use_mesh(_mesh(case["mesh"])):
        logits, _ = jax.jit(lambda p, b: model.forward(p, b))(params, jb)
        pre, _ = jax.jit(lambda p, t: model.prefill(p, {"tokens": t, "max_seq": s}))(
            params, jb["tokens"])
        out["forward"], out["prefill"] = np.asarray(logits), np.asarray(pre)
        if case.get("grad"):
            fn = jax.jit(lambda p, b: jax.value_and_grad(model.loss, has_aux=True)(p, b))
            (loss, _), grads = fn(params, jb)
            out["loss"] = np.asarray(loss)
            _flat("grad", jax.tree.map(np.asarray, grads), out)


def _decode(case, cfg, params, out):
    """prefill of the first ``prompt`` tokens, then ``steps`` decode steps
    fed the next tokens: every step's logits, under the case's mesh."""
    model = build_model(cfg)
    batch = mc.inputs(cfg, case)
    toks = batch["tokens"]
    k, max_seq = case["prompt"], case["max_seq"]
    pre_batch = {key: jnp.asarray(v) for key, v in batch.items() if key != "labels"}
    pre_batch["tokens"] = jnp.asarray(toks[:, :k])
    with sharding.use_mesh(_mesh(case["mesh"])):
        _, cache = jax.jit(lambda p, b: model.prefill(p, dict(b, max_seq=max_seq)))(
            params, pre_batch)
        step = jax.jit(lambda p, c, t: model.decode_step(p, c, t))
        steps = []
        for i in range(case["steps"]):
            logits, cache = step(params, cache, jnp.asarray(toks[:, k + i:k + i + 1]))
            steps.append(np.asarray(logits))
    out["decode"] = np.stack(steps)


def _moe(case, cfg, params, out):
    """The first MoE layer under the case's mesh (output, aux) and each
    data shard's routing from the reference's ``_dispatch_local`` on its
    block; the model's logits; with ``grad``, one step's gradients."""
    model = build_model(cfg)
    batch = mc.inputs(cfg, case)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), params["moe_blocks"]["moe"])
    x = jnp.asarray(mc.moe_input(cfg, case))
    b, sl, d = x.shape
    t = b * sl
    with sharding.use_mesh(_mesh(case["mesh"])):
        y, aux = jax.jit(lambda x_, p_: j_moe.moe(x_, p_, cfg))(x, p)
        shards = j_moe._n_data_shards(t) if t > j_moe._SMALL_T else 1
        logits, _ = jax.jit(lambda p_, b_: model.forward(p_, b_))(params, jb)
        if case.get("grad"):
            fn = jax.jit(lambda p_, b_: jax.value_and_grad(model.loss, has_aux=True)(p_, b_))
            (loss, _), grads = fn(params, jb)
            out["loss"] = np.asarray(loss)
            _flat("grad", jax.tree.map(np.asarray, grads), out)
    out["y"], out["aux"], out["forward"] = np.asarray(y), np.asarray(aux), np.asarray(logits)
    out["shards"] = np.asarray(shards)
    # Each shard's routing, as the reference's shard_map body computes it.
    xt = x.reshape(t, d)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, p["router"]).astype(jnp.float32), -1)
    t_loc = t // shards
    cap = max(1, int(cfg.capacity_factor * t_loc * cfg.top_k / cfg.n_experts))
    cap = max(8, (cap + 7) // 8 * 8)
    dispatch = jax.jit(j_moe._dispatch_local, static_argnums=(2, 3))
    routes = [dispatch(xt[i * t_loc:(i + 1) * t_loc], probs[i * t_loc:(i + 1) * t_loc], cfg,
                       cap) for i in range(shards)]
    for j, name in enumerate(("buf", "se", "st", "sg", "pos")):
        out[name] = np.stack([np.asarray(r[j]) for r in routes])
    out["probs"], out["capacity"] = np.asarray(probs), np.asarray(cap)


def _spmd(case, cfg, params, out):
    """forward logits over all ``s`` tokens, then the prompt's prefill and
    ``steps`` decode steps' logits, under the case's mesh."""
    model = build_model(cfg)
    toks = jnp.asarray(mc.inputs(cfg, case)["tokens"])
    k, max_seq = case["prompt"], case["max_seq"]
    with sharding.use_mesh(_mesh(case["mesh"])):
        logits, _ = jax.jit(lambda p, t: model.forward(p, {"tokens": t}))(params, toks)
        pre, cache = jax.jit(lambda p, t: model.prefill(p, {"tokens": t, "max_seq": max_seq}))(
            params, toks[:, :k])
        step = jax.jit(lambda p, c, t: model.decode_step(p, c, t))
        steps = []
        for i in range(case["steps"]):
            lg, cache = step(params, cache, toks[:, k + i:k + i + 1])
            steps.append(np.asarray(lg))
    out["forward"], out["prefill"] = np.asarray(logits), np.asarray(pre)
    out["decode"] = np.stack(steps)


RUN = {"ring": _ring, "decode": _decode, "moe": _moe, "spmd": _spmd}


def main(part: str, params_path: str, path: str) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    with np.load(params_path) as z:
        arrays = {k: z[k] for k in z.files}
    out_arrays: dict = {}
    for case in mc.CASES[part]:
        params = jax.tree.map(jnp.asarray,
                              mc.nested(arrays, f"params/{mc.params_name(case['cfg'])}"))
        out: dict = {}
        RUN[case["kind"]](case, _cfg(case["cfg"]), params, out)
        out_arrays.update({f"{case['id']}/{k}": v for k, v in out.items()})
    np.savez(path, **out_arrays)


if __name__ == "__main__":
    main(*sys.argv[1:4])
