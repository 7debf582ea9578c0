"""Helpers of ``tests/test_torch_{moe,ssm,encdec}.py``: the port's model
families against the JAX reference on the same numpy inputs and the
reference's converted parameters, in f32 on the CPU.

Tolerances: atol = rtol = 1e-5 for modules and models (both sides sum
in f32 in orders their BLAS picks); prefill + decode against forward
within the reference's own 2e-4 (``tests/test_decode_consistency.py``);
served tokens exactly; one step's gradients within ``GRAD_TOL``, the
bound ``tests/test_torch_train.py`` holds the dense family to (autograd
and ``jax.grad`` sum in different orders).
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import policy_for as jpolicy_for
from repro.core.consistency import ConsistencyLevel as JLevel
from repro.data import DataConfig as JData
from repro.models import build_model as j_build
from repro.optim import adamw as jadamw
from repro.serve import ServeSession as JSession
from repro.serve import ServingEngine as JEngine
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import configs as tc
from repro_torch.convert import params_from_numpy
from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.models import build_model as t_build
from repro_torch.models.common import count_params
from repro_torch.serve import ServeSession, ServingEngine
from repro_torch.tree import items
from torch_port_helpers import (FAMILY_TRAIN, FAMILY_TRAIN_CASE, MODEL_SERVING, family_inputs,
                                model_serving_counters, model_serving_script, torch_batch)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# Leaves that init to constants (norm weights and biases, fixed decays):
# perturbed so that a wrong use of them shows.
PERTURBED = {"bq", "bk", "bv", "w", "b", "conv_b", "dt_bias", "d_skip", "bonus_u",
             "decay_b"}


def cfgs(arch, **over):
    return (j_reduced(j_get_config(arch), **over),
            tc.reduced(tc.get_config(arch), **over))


def np_params(jcfg, seed=0):
    """The reference's parameters as numpy, the constant leaves perturbed."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax.jit(j_build(jcfg).init)(jax.random.key(seed)))

    def perturb(path, a):
        name = path[-1].key
        if name.endswith("norm") or name.startswith(("ln", "final_ln")) or name in PERTURBED:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def both(np_tree):
    return jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree, device="cpu")


def close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def close_tree(got: dict, want: dict, **tol):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in got:
        (close_tree if isinstance(got[k], dict) else close)(got[k], want[k], **tol)


def check_layout(arch, **over):
    """The port's initializer fills the reference's layout: keys, shapes,
    dtypes and the parameter count; ``abstract_params`` gives the same
    on the meta device."""
    from repro_torch.models import abstract_params

    jcfg, tcfg = cfgs(arch, **over)
    jp = jax.eval_shape(j_build(jcfg).init, jax.random.key(0))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    model = t_build(tcfg)

    def shapes(tree):
        return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
                            tree)

    tp = model.init(0, device="cpu")
    assert shapes(tp) == want
    assert shapes(abstract_params(model)) == want
    assert count_params(tp) == sum(int(a.size) for a in jax.tree.leaves(jp))
    assert tcfg.param_count() == jcfg.param_count()


def check_model(arch, *, s=16, k=12, seed=5, **over):
    """forward (logits and aux), loss and its metrics, prefill (cache
    padded to ``s``) and ``s - k`` decode steps, on the reference's
    converted parameters; the reference runs under ``jax.jit``."""
    jcfg, tcfg = cfgs(arch, **over)
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp, tp = both(np_params(jcfg, seed))
    nb = family_inputs(jcfg, 2, s, seed)
    jb = {kk: jnp.asarray(v) for kk, v in nb.items()}
    tb = torch_batch(nb, "cpu")
    extra = [kk for kk in nb if kk not in ("tokens", "labels")]

    (jl, jaux), (jloss, jmet) = jax.jit(lambda p, b: (jm.forward(p, b), jm.loss(p, b)))(
        jp, jb)
    tl, taux = tm.forward(tp, tb)
    close(tl, jl)
    close(taux, jaux)
    tloss, tmet = tm.loss(tp, tb)
    close(tloss, jloss)
    close_tree(tmet, jmet)

    j_prefill = jax.jit(lambda p, t, e: jm.prefill(p, {"tokens": t, **e, "max_seq": s}))
    jl, jcache = j_prefill(jp, jb["tokens"][:, :k], {kk: jb[kk] for kk in extra})
    tl, tcache = tm.prefill(tp, {"tokens": tb["tokens"][:, :k], "max_seq": s,
                                 **{kk: tb[kk] for kk in extra}})
    close(tl, jl)
    close_tree(tcache, jcache)
    j_decode = jax.jit(jm.decode_step)
    for t in range(k, s):
        jl, jcache = j_decode(jp, jcache, jb["tokens"][:, t:t + 1])
        tl, tcache = tm.decode_step(tp, tcache, tb["tokens"][:, t:t + 1])
        close(tl, jl)
    close_tree(tcache, jcache)


def check_decode_matches_forward(arch, *, s=16, k=12, **over):
    """The reference's invariant (``tests/test_decode_consistency.py``) on
    the port alone, with its own initializer: prefill(tokens[:k]) +
    decode(rest) equals forward(tokens) position by position, within
    2e-4.  With the VLM prefix, position p holds token p - n_vis."""
    tcfg = tc.reduced(tc.get_config(arch), attn_chunk=4, **over)
    model = t_build(tcfg)
    params = model.init(1, device="cpu")
    batch = torch_batch(family_inputs(tcfg, 2, s, 6), "cpu")
    full, _ = model.forward(params, batch)
    nv = tcfg.n_vis_tokens
    pre = {kk: (v[:, :k] if kk in ("tokens", "labels") else v) for kk, v in batch.items()}
    pre["max_seq"] = s
    lg, cache = model.prefill(params, pre)
    errs = [float((lg[:, 0] - full[:, k - 1]).abs().max())]
    for t in range(k, s):
        lg, cache = model.decode_step(params, cache, batch["tokens"][:, t - nv:t - nv + 1])
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, errs
    assert int(cache["pos"]) == s


PROMPT, TOKENS = 8, 4


def _jitted(model, max_seq: int, extra: tuple):
    """The reference model with prefill and decode under ``jit`` (its
    engine is built with ``jit=False``: it would trace ``max_seq``)."""
    prefill = jax.jit(lambda p, t, e: model.prefill(p, {"tokens": t, **e,
                                                        "max_seq": max_seq}))
    return types.SimpleNamespace(
        prefill=lambda p, b: prefill(p, b["tokens"], {kk: b[kk] for kk in extra}),
        decode_step=jax.jit(model.decode_step))


def check_generate(arch, level="X_STCC", **over):
    """``ServingEngine.generate`` of the port against the reference engine
    on the same converted parameters and prompts: tokens, replicas and
    routing counters equal."""
    jcfg, tcfg = cfgs(arch, **over)
    jm = j_build(jcfg)
    np_ab = [np_params(jcfg, s) for s in (0, 1)]
    prompts = [family_inputs(jcfg, 1, PROMPT, 100 + i)
               for i in range(MODEL_SERVING["n_requests"])]
    for p in prompts:
        del p["labels"]
    extra = tuple(kk for kk in prompts[0] if kk != "tokens")
    max_seq = PROMPT + TOKENS

    j_eng = JEngine(_jitted(jm, max_seq, extra), JLevel[level], jit=False)
    want = model_serving_script(
        j_eng, [jax.tree.map(jnp.asarray, p) for p in np_ab],
        lambda i: {**{kk: jnp.asarray(v) for kk, v in prompts[i].items()},
                   "max_seq": max_seq},
        JSession, n_tokens=TOKENS, **MODEL_SERVING)
    t_eng = ServingEngine(t_build(tcfg), ConsistencyLevel[level], device="cpu")
    got = model_serving_script(
        t_eng, [params_from_numpy(p, device="cpu") for p in np_ab],
        lambda i: {**torch_batch(prompts[i], "cpu"), "max_seq": max_seq},
        ServeSession, n_tokens=TOKENS, **MODEL_SERVING)
    assert got == want
    assert model_serving_counters(t_eng) == model_serving_counters(j_eng)


# ---- gradients ---------------------------------------------------------------


def reference_grads(jcfg, np_tree, np_batch) -> tuple[float, dict]:
    """``jax.value_and_grad`` of the reference's loss, jitted: ``(loss,
    {"a/b": gradient as numpy})``."""
    fn = jax.jit(jax.value_and_grad(j_build(jcfg).loss, has_aux=True))
    (loss, _), grads = fn(jax.tree.map(jnp.asarray, np_tree),
                          {k: jnp.asarray(v) for k, v in np_batch.items()})
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return float(loss), {"/".join(str(k.key) for k in path): np.asarray(g)
                         for path, g in flat}


def port_grads(tcfg, np_tree, np_batch) -> tuple[float, dict]:
    """The port's loss and its gradients under autograd, on the
    reference's converted parameters (``cfg.remat`` applies)."""
    tree = params_from_numpy(np_tree, device="cpu")
    wrt = {k: v.requires_grad_() for k, v in items(tree)}
    loss, _ = t_build(tcfg).loss(tree, torch_batch(np_batch, "cpu"))
    grads = torch.autograd.grad(loss, list(wrt.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(wrt, grads)}


def all_finite(grads: dict) -> bool:
    return all(np.isfinite(g).all() for g in grads.values())


def assert_grads_close(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **(tol or GRAD_TOL))


# ---- the trainer ---------------------------------------------------------------


def reference_family_run(arch: str) -> dict:
    """The reference's ``Trainer`` on the reduced ``arch`` under
    ``FAMILY_TRAIN_CASE``: its initial parameters (one pod's), batches,
    history and final sync state."""
    level, pods, steps, kw = FAMILY_TRAIN_CASE
    t = FAMILY_TRAIN
    cfg = j_reduced(j_get_config(arch))
    tr = JTrainer(cfg, JData(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                             global_batch=t["global_batch"]),
                  jadamw.AdamWConfig(lr=t["lr"], warmup_steps=t["warmup_steps"],
                                     total_steps=t["total_steps"]),
                  jpolicy_for(level, delta_steps=t["delta"], **kw),
                  JTrainerConfig(n_steps=steps, n_pods=pods, log_every=1))
    state = tr.init_state()
    params0 = jax.tree.map(lambda x: np.asarray(x[0]), state.params)
    batches = [jax.tree.map(np.asarray, tr.batch_for(s)) for s in range(steps)]
    state = tr.run(state)
    return dict(params0=params0, batches=batches, history=tr.history, sync=state.sync)
