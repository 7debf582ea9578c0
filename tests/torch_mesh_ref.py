"""The reference side of ``tests/test_torch_mesh_*.py``: the JAX models
under a mesh of forced host devices, run as a subprocess so the forced
device count stays out of the test process.

    python tests/torch_mesh_ref.py {attention|moe|families} PARAMS.npz OUT.npz [IDS]

reads the seeded parameters of ``torch_mesh_cases.write_params``
(``params/<name>/<a/b/...>``, the reference's layout) and writes, for
every case of ``torch_mesh_cases`` in that part (or only those named in
the comma-separated IDS), the reference's outputs under the case's mesh
on the case's inputs.  Each entry point is jitted as a fresh closure
inside the mesh: a jitted function called outside the mesh first would
reuse that trace.
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


def _moe_layer(cfg, p, x, out, prefix=""):
    """The MoE layer ``p`` on ``x`` under the active mesh (output, aux)
    and each data shard's routing from the reference's
    ``_dispatch_local`` on its block, as its ``shard_map`` body computes
    it."""
    b, sl, d = x.shape
    t = b * sl
    y, aux = jax.jit(lambda x_, p_: j_moe.moe(x_, p_, cfg))(x, p)
    shards = j_moe._n_data_shards(t) if t > j_moe._SMALL_T else 1
    out[prefix + "y"], out[prefix + "aux"] = np.asarray(y), np.asarray(aux)
    out[prefix + "shards"] = np.asarray(shards)
    xt = np.asarray(x).reshape(t, d)
    probs = np.asarray(jax.jit(lambda xt_, r: jax.nn.softmax(
        jnp.einsum("td,de->te", xt_, r).astype(jnp.float32), -1))(xt, p["router"]))
    t_loc = t // shards
    cap = max(1, int(cfg.capacity_factor * t_loc * cfg.top_k / cfg.n_experts))
    cap = max(8, (cap + 7) // 8 * 8)
    dispatch = jax.jit(j_moe._dispatch_local, static_argnums=(2, 3))
    routes = [dispatch(xt[i * t_loc:(i + 1) * t_loc], probs[i * t_loc:(i + 1) * t_loc], cfg,
                       cap) for i in range(shards)]
    for j, name in enumerate(("buf", "se", "st", "sg", "pos")):
        out[prefix + name] = np.stack([np.asarray(r[j]) for r in routes])
    out[prefix + "probs"], out[prefix + "capacity"] = np.asarray(probs), np.asarray(cap)


def _moe(case, cfg, params, out):
    """The first MoE layer under the case's mesh (:func:`_moe_layer`); the
    model's logits; with ``grad``, one step's gradients."""
    model = build_model(cfg)
    batch = mc.inputs(cfg, case)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), params["moe_blocks"]["moe"])
    x = jnp.asarray(mc.moe_input(cfg, case))
    with sharding.use_mesh(_mesh(case["mesh"])):
        _moe_layer(cfg, p, x, out)
        logits, _ = jax.jit(lambda p_, b_: model.forward(p_, b_))(params, jb)
        if case.get("grad"):
            fn = jax.jit(lambda p_, b_: jax.value_and_grad(model.loss, has_aux=True)(p_, b_))
            (loss, _), grads = fn(params, jb)
            out["loss"] = np.asarray(loss)
            _flat("grad", jax.tree.map(np.asarray, grads), out)
    out["forward"] = np.asarray(logits)


def _spmd(case, cfg, params, out):
    """forward logits over all ``s`` tokens, then the prompt's prefill and
    ``steps`` decode steps' logits fed the next tokens (with no ``steps``,
    ``gen - 1`` decode steps fed the greedy tokens, and the ``gen`` greedy
    tokens), under the case's mesh; for a MoE configuration the first MoE
    layer at each of ``MOE_TOKENS``' sizes (``moe<T>/``)."""
    model = build_model(cfg)
    batch = mc.inputs(cfg, case)
    toks, more = batch["tokens"], {k: jnp.asarray(v) for k, v in mc.extras(batch).items()}
    k = case["prompt"]
    greedy = not case["steps"]
    max_seq = k + case["gen"] if greedy else case["max_seq"]
    with sharding.use_mesh(_mesh(case["mesh"])):
        logits, _ = jax.jit(lambda p, b: model.forward(p, b))(
            params, dict(more, tokens=jnp.asarray(toks)))
        pre, cache = jax.jit(lambda p, b: model.prefill(p, dict(b, max_seq=max_seq)))(
            params, dict(more, tokens=jnp.asarray(toks[:, :k])))
        step = jax.jit(lambda p, c, t: model.decode_step(p, c, t))
        steps, tokens = [], [np.argmax(np.asarray(pre)[:, -1], -1)[:, None].astype(np.int32)]
        for i in range(case["gen"] - 1 if greedy else case["steps"]):
            lg, cache = step(params, cache, jnp.asarray(tokens[-1] if greedy
                                                        else toks[:, k + i:k + i + 1]))
            steps.append(np.asarray(lg))
            tokens.append(np.argmax(steps[-1][:, -1], -1)[:, None].astype(np.int32))
        if greedy:
            out["generate"] = np.concatenate(tokens, axis=1)
        if cfg.n_experts:
            p = jax.tree.map(lambda a: jnp.asarray(a[0]), params["moe_blocks"]["moe"])
            for b, s in mc.MOE_TOKENS:
                x = jnp.asarray(mc.moe_input(cfg, dict(b=b, s=s)))
                _moe_layer(cfg, p, x, out, f"moe{b * s}/")
    out["forward"], out["prefill"] = np.asarray(logits), np.asarray(pre)
    out["decode"] = np.stack(steps)


def _train(case, cfg, params, out):
    """The ``train`` case under its mesh: the state from the one-pod
    parameters (``stack_for_pods``, ``adamw.init``, ``engine.init_state``)
    placed as the dry run places it (``dryrun.py:84-117``: parameters and
    moments ``P("pod", *params_shardings)``, the rest replicated), then a
    ``local_step`` and a ``sync_step`` on the case's two batches (with
    their frames or image prefix) and, unless the case drops
    ``merge_checks``, ``engine.merge`` with ``MASKED_UP``."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.core import policy_for
    from repro.optim import adamw
    from repro.train.train_step import TrainState, make_train_fns, stack_for_pods

    model = build_model(cfg)
    policy = policy_for(case["level"], delta_steps=case["delta"],
                        compress_inter_pod=case["compress"])
    opt_cfg = adamw.AdamWConfig(**mc.TRAIN_OPT)
    fns = make_train_fns(model, opt_cfg, policy, mc.TRAIN_PODS)
    mesh = _mesh(case["mesh"])
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in mc.train_batches(cfg, case)]
    with sharding.use_mesh(mesh):
        specs = sharding.params_shardings(params, cfg)
        pod = lambda tree: jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, P("pod", *s.spec))), tree, specs)
        repl = lambda tree: jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree)
        stacked = stack_for_pods(params, mc.TRAIN_PODS)
        opt = adamw.init(stacked, opt_cfg)
        state = TrainState(params=pod(stacked), opt=opt._replace(
            mu=pod(opt.mu), nu=pod(opt.nu), count=repl(opt.count)),
            sync=repl(fns.engine.init_state(stacked)), step=repl(jnp.zeros((), jnp.int32)))
        # The sync step is the local step then the merge, as ``sync_step``
        # composes them, jitted as two programs so that the local step
        # compiles once for both steps (the outputs equal one jitted
        # ``sync_step``'s bit for bit on the family cases).
        local = jax.jit(lambda s, b: fns.local_step(s, b))
        merge = jax.jit(lambda p, s: fns.engine.merge(p, s))
        placed = jax.tree.map(lambda x: x.sharding, state)
        losses, norms = [], []
        for i, batch in enumerate(batches):
            # Each step starts from the dry run's placement (XLA may hand a
            # leaf back placed otherwise, which would compile the step again).
            state, m = local(jax.device_put(state, placed), batch)
            if i:
                params2, sync2 = merge(state.params, state.sync)
                state = state._replace(params=params2, sync=sync2)
            losses.append(np.asarray(m["loss"]))
            norms.append(np.asarray(m["grad_norm"]))
        _train_record("sync", state.params, state.sync, out)
        if case.get("merge_checks", True):
            up = jnp.asarray(mc.MASKED_UP)
            params2, sync2 = jax.jit(lambda p, s: fns.engine.merge(p, s, up=up))(
                state.params, state.sync)
            _train_record("masked", params2, sync2, out)
    out["loss"], out["grad_norm"] = np.stack(losses), np.stack(norms)
    _flat("mu", jax.tree.map(np.asarray, state.opt.mu), out)
    _flat("nu", jax.tree.map(np.asarray, state.opt.nu), out)


def _train_record(tag, params, sync, out):
    _flat(f"{tag}/params", jax.tree.map(np.asarray, params), out)
    for name in ("anchor", "residual"):
        tree = getattr(sync, name)
        if tree is not None:
            _flat(f"{tag}/{name}", jax.tree.map(np.asarray, tree), out)
    for k in ("merges", "violations", "severity", "inter_pod_gb"):
        out[f"{tag}/{k}"] = np.asarray(getattr(sync, k))
    for part in ("cluster", "duot"):
        rec = getattr(sync, part)
        for f in rec._fields:
            out[f"{tag}/{part}/{f}"] = np.asarray(getattr(rec, f))


RUN = {"ring": _ring, "decode": _decode, "moe": _moe, "spmd": _spmd, "train": _train}


def main(part: str, params_path: str, path: str, ids: str = "") -> None:
    """The reference's outputs of the cases of ``part`` (those in the
    comma-separated ``ids``, if given) into ``path``."""
    assert len(jax.devices()) == 4, jax.devices()
    with np.load(params_path) as z:
        arrays = {k: z[k] for k in z.files}
    out_arrays: dict = {}
    for case in mc.CASES[part]:
        if (ids and case["id"] not in ids.split(",")) or case["kind"] not in RUN:
            continue
        params = jax.tree.map(jnp.asarray,
                              mc.nested(arrays, f"params/{mc.params_name(case['cfg'])}"))
        out: dict = {}
        RUN[case["kind"]](case, _cfg(case["cfg"]), params, out)
        out_arrays.update({f"{case['id']}/{k}": v for k, v in out.items()})
    np.savez(path, **out_arrays)


if __name__ == "__main__":
    main(*sys.argv[1:5])
