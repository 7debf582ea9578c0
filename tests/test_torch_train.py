"""The port's training path — AdamW, the data pipeline, the dense LM's
gradients, the train step and the ``Trainer`` — against the JAX reference
on the same numpy inputs, on the CPU.

Bounds, each the tightest the part meets:
  * AdamW with injected gradients and no clipping: the moments exactly;
    the parameters within 2 f32 ulp (the learning rate's ``cos`` and the
    bias corrections' ``pow`` are XLA's own implementations, each within
    1 ulp of the port's, ``SCHEDULE_ULP``, away from the end of a decay
    to 0 where ``1 + cos`` cancels); with clipping, rtol 1e-6 (the global
    norm is an f32 sum in an order XLA picks);
  * one step's gradients (reduced qwen2-7b, f32): rtol 1e-4, atol 1e-6;
  * the ``Trainer``'s loss and grad-norm history over 16 steps: rtol 1e-5
    (autograd and ``jax.grad`` sum in different orders; measured 2e-7 and
    2e-6); its sync metrics, the final clocks, the DUOT and the counters
    exactly.  The final parameters are not compared: Adam's normalized
    step turns the last-bit noise of a near-zero gradient (the key bias,
    whose gradient is 0 in exact arithmetic) into lr-sized moves, and
    int8 / top-k selection is discontinuous; the merges themselves are
    held exactly in ``test_torch_sync.py``.
The reference's parameters cross with ``convert.params_from_numpy`` and
its batches are injected: its ``jax.random`` draws have no torch
counterpart (ROADMAP C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import policy_for as jpolicy_for
from repro.data import DataConfig as JData
from repro.models import abstract_params as j_abstract
from repro.models import build_model as j_build
from repro.optim import adamw as jadamw
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import train_step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, batch_at, extra_inputs
from repro_torch.models import abstract_params, build_model
from repro_torch.optim import adamw
from repro_torch.train import split_batch_for_pods, stack_for_pods
from repro_torch.tree import items, leaves

from torch_port_helpers import (TRAIN_CASES, as_np, assert_tree_equal, port_trainer,
                                train_case_id)

torch.set_num_threads(1)
CPU = "cpu"
SCHEDULE_ULP = 1
PARAM_ULP = 2
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
HISTORY_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tree(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(dtype) for k, s in shapes.items()}


SHAPES = {"embed": (16, 8), "norm": (8,), "w": (3, 8, 4)}


# ---- AdamW --------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(), dict(warmup_steps=4, total_steps=32, lr=1e-3),
    dict(warmup_steps=0, total_steps=10, min_lr_ratio=0.0)], ids=["default", "short", "nowarm"])
def test_schedule_matches_reference(cfg):
    j, t = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    steps = np.arange(0, 64, dtype=np.int32)
    want = np.asarray([jadamw.schedule(j, jnp.int32(s)) for s in steps], np.float32)
    got = np.asarray([adamw.schedule(t, int(s)) for s in steps], np.float32)
    # One ulp of cos (2^-24 near 1), scaled by lr: 1 + cos cancels near the
    # end of the decay, where a last-bit difference is many ulp of the sum.
    np.testing.assert_allclose(got, want, rtol=0, atol=t.lr * 2.0 ** -23)


def test_bias_correction_within_one_ulp_of_pow():
    """``1 - b ** count``: the power within 1 ulp (2^-24 below 1); the
    difference cancels into many ulp of a small ``1 - b ** count``."""
    for b in (0.9, 0.95, 0.999):
        count = np.arange(1, 200, dtype=np.float32)
        want = np.asarray(1.0 - b ** jnp.asarray(count))
        got = np.asarray([adamw._bias_correction(b, int(c)) for c in count], np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=SCHEDULE_ULP * 2.0 ** -24)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_init_matches_reference(state_dtype):
    tree = _tree(0, SHAPES)
    cfg = dict(state_dtype=state_dtype)
    j = jadamw.init(jax.tree.map(jnp.asarray, tree), jadamw.AdamWConfig(**cfg))
    t = adamw.init({k: _t(v) for k, v in tree.items()}, adamw.AdamWConfig(**cfg))
    assert t.count == int(j.count) == 0
    for k in tree:
        assert t.mu[k].dtype == getattr(torch, state_dtype)
        np.testing.assert_array_equal(as_np(t.nu[k].float()), np.asarray(j.nu[k], np.float32))


def test_global_norm_and_clip_match_reference():
    tree = _tree(1, SHAPES)
    jt = jax.tree.map(jnp.asarray, tree)
    tt = {k: _t(v) for k, v in tree.items()}
    np.testing.assert_allclose(as_np(adamw.global_norm(tt)),
                               np.asarray(jadamw.global_norm(jt)), rtol=1e-6)
    for max_norm in (0.5, 1e4):
        jc, jn = jadamw.clip_by_global_norm(jt, max_norm)
        tc, tn = adamw.clip_by_global_norm(tt, max_norm)
        for k in tree:
            np.testing.assert_allclose(as_np(tc[k]), np.asarray(jc[k]), rtol=1e-6)


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("dtype,state_dtype", [("float32", "float32"),
                                               ("bfloat16", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_apply_with_injected_grads_matches_reference(clip, dtype, state_dtype):
    """Three AdamW steps on the same params and gradients (eager JAX: no
    fused multiply-adds on the reference side)."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=8, grad_clip=clip,
               state_dtype=state_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jdt = jnp.dtype(dtype)
    params = _tree(2, SHAPES)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    js, ts = jadamw.init(jp, jcfg), adamw.init(tp, tcfg)
    for step in range(3):
        grads = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(10 + step, SHAPES))
        tg = params_from_numpy(jax.tree.map(np.asarray, grads), device=CPU)
        jp, js, jm = jadamw.apply(jp, grads, js, jcfg)
        tp, ts, tm = adamw.apply(tp, tg, ts, tcfg)
        assert ts.count == int(js.count)
        np.testing.assert_array_max_ulp(np.float32(tm["lr"]), np.asarray(jm["lr"]),
                                        maxulp=SCHEDULE_ULP)
        for k in params:
            want_p = np.asarray(jp[k], np.float32)
            got_p = as_np(tp[k].float())
            if clip:
                # The clip scale's last bit moves every gradient's; the
                # moments' b1·m + (1-b1)·g can cancel, so atol too.
                np.testing.assert_allclose(got_p, want_p, rtol=1e-6, atol=1e-7)
                np.testing.assert_allclose(as_np(ts.mu[k].float()),
                                           np.asarray(js.mu[k], np.float32),
                                           rtol=1e-6, atol=1e-8)
                continue
            np.testing.assert_array_equal(as_np(ts.mu[k].float()),
                                          np.asarray(js.mu[k], np.float32))
            np.testing.assert_array_equal(as_np(ts.nu[k].float()),
                                          np.asarray(js.nu[k], np.float32))
            if dtype == "float32":
                np.testing.assert_array_max_ulp(got_p, want_p, maxulp=PARAM_ULP)
            else:
                # bf16 parameters: the f32 result within 2 ulp rounds to
                # the same bf16 value or its neighbour.
                np.testing.assert_allclose(got_p, want_p, rtol=2 ** -7)


# ---- data ------------------------------------------------------------------------


def test_batch_at_is_deterministic_and_shaped():
    cfg = DataConfig(vocab_size=512, seq_len=32, global_batch=8, seed=3)
    a, b = batch_at(cfg, 5, device=CPU), batch_at(cfg, 5, device=CPU)
    c = batch_at(cfg, 6, device=CPU)
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (8, 32)
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert (a["labels"][:, -1] == -100).all()
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 512
    # The reference's draws have the same shapes, dtypes and label rule.
    j = jax.tree.map(np.asarray, __import__("repro.data", fromlist=["x"]).batch_at(
        JData(vocab_size=512, seq_len=32, global_batch=8, seed=3), 5))
    assert {k: (v.shape, v.dtype) for k, v in j.items()} == \
        {k: (tuple(v.shape), np.int32) for k, v in a.items()}
    # Zipf marginal: token 0 is the most frequent.
    toks = torch.cat([batch_at(cfg, s, device=CPU)["tokens"].flatten() for s in range(20)])
    counts = torch.bincount(toks.long(), minlength=512)
    assert int(torch.argmax(counts)) == 0


def test_extra_inputs_empty_for_dense():
    assert extra_inputs(tconfigs.get_config("gemma-2b"), 4, 0, device=CPU) == {}


def test_split_and_stack_match_reference():
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 9, (8, 5)).astype(np.int32), "n": np.int32(3)}
    want = jstep.split_batch_for_pods({k: jnp.asarray(v) for k, v in batch.items()}, 4)
    got = split_batch_for_pods({"tokens": _t(batch["tokens"]), "n": 3}, 4)
    np.testing.assert_array_equal(as_np(got["tokens"]), np.asarray(want["tokens"]))
    with pytest.raises(ValueError):
        split_batch_for_pods({"tokens": _t(batch["tokens"])}, 3)
    tree = _tree(5, SHAPES)
    ws = jstep.stack_for_pods(jax.tree.map(jnp.asarray, tree), 3)
    gs = stack_for_pods({k: _t(v) for k, v in tree.items()}, 3)
    for k in tree:
        np.testing.assert_array_equal(as_np(gs[k]), np.asarray(ws[k]))


# ---- models: abstract params and gradients ----------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-7b", "phi4-mini-3.8b", "qwen1.5-4b"])
def test_abstract_params_match_reference(arch):
    want = j_abstract(j_build(jconfigs.get_config(arch)))
    got = abstract_params(build_model(tconfigs.get_config(arch)))
    want_items = [("/".join(str(k.key) for k in path), (tuple(s.shape), str(s.dtype)))
                  for path, s in jax.tree_util.tree_flatten_with_path(want)[0]]
    got_items = [(k, (tuple(v.shape), str(v.dtype).removeprefix("torch.")))
                 for k, v in items(got)]
    assert got_items == want_items
    assert all(v.device.type == "meta" for v in leaves(got))


def _np_params(jcfg, seed=0):
    """The reference's parameters as numpy, norm weights and biases
    perturbed so that their gradients are not trivially shaped."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.key(seed)))

    def perturb(path, a):
        if path[-1].key.endswith("norm") or path[-1].key in ("bq", "bk", "bv"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.fixture(scope="module")
def reference_grads():
    out = {}
    for arch, over in (("qwen2-7b", {"n_kv_heads": 2}), ("gemma-2b", {})):
        jcfg = jconfigs.reduced(jconfigs.get_config(arch), **over)
        params = _np_params(jcfg)
        batch = jax.tree.map(np.asarray, __import__("repro.data", fromlist=["x"]).batch_at(
            JData(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4), 0))
        (loss, _), grads = jax.jit(jax.value_and_grad(j_build(jcfg).loss, has_aux=True))(
            jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
        out[arch] = (params, batch, float(loss), jax.tree.map(np.asarray, grads))
    return out


@pytest.mark.parametrize("remat", ["none", "full", "selective"])
@pytest.mark.parametrize("arch,over", [("qwen2-7b", {"n_kv_heads": 2}), ("gemma-2b", {})],
                         ids=["qwen2-7b", "gemma-2b"])
def test_one_step_gradients_match_reference(reference_grads, arch, over, remat):
    params, batch, jloss, jgrads = reference_grads[arch]
    cfg = tconfigs.reduced(tconfigs.get_config(arch), remat=remat, **over)
    model = build_model(cfg)
    tp = params_from_numpy(params, device=CPU)
    wrt = {k: v.requires_grad_() for k, v in items(tp)}
    loss, _ = model.loss(tp, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(wrt.values()))
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-6)
    want = dict((("/".join(str(k.key) for k in path)), g)
                for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0])
    for (key, _), g in zip(wrt.items(), grads):
        np.testing.assert_allclose(as_np(g), want[key], err_msg=key, **GRAD_TOL)


# ---- the trainer -------------------------------------------------------------------


def _reference_run(case):
    level, pods, steps, kw = case
    cfg = jconfigs.reduced(jconfigs.get_config("qwen2-7b"), n_layers=2)
    tr = JTrainer(cfg, JData(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8),
                  jadamw.AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=32),
                  jpolicy_for(level, delta_steps=4, **kw),
                  JTrainerConfig(n_steps=steps, n_pods=pods, log_every=4))
    state = tr.init_state()
    params0 = jax.tree.map(lambda x: np.asarray(x[0]), state.params)
    batches = [jax.tree.map(np.asarray, tr.batch_for(s)) for s in range(steps)]
    state = tr.run(state)
    return dict(params0=params0, batches=batches, history=tr.history, sync=state.sync)


# The cases of tests/test_trainer_levels.py, and top-k; TCC and QUORUM at
# two pods differ from these only in the bookkeeping that
# test_torch_sync.py holds.
REFERENCE_CASES = [c for c in TRAIN_CASES
                   if train_case_id(c) not in ("TCC/2pods", "QUORUM/2pods")]


@pytest.fixture(scope="module")
def reference_runs():
    return {train_case_id(c): _reference_run(c) for c in REFERENCE_CASES}


@pytest.mark.parametrize("case", REFERENCE_CASES, ids=train_case_id)
def test_trainer_matches_reference(reference_runs, case):
    want = reference_runs[train_case_id(case)]
    tr = port_trainer(case, CPU)
    tr.batch_for = lambda s: {k: _t(v) for k, v in want["batches"][s].items()}
    state = tr.run(tr.init_state(params_from_numpy(want["params0"], device=CPU)))
    assert [h["step"] for h in tr.history] == [h["step"] for h in want["history"]]
    for g, w in zip(tr.history, want["history"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=HISTORY_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=HISTORY_RTOL)
        for k in ("synced", "inter_pod_gb", "violations", "severity"):
            assert g.get(k) == w.get(k), (g["step"], k)
    sync = state.sync
    assert_tree_equal(want["sync"].cluster, sync.cluster, "cluster")
    assert_tree_equal(want["sync"].duot, sync.duot, "duot")
    for f in ("merges", "violations", "severity", "inter_pod_gb"):
        np.testing.assert_array_equal(as_np(getattr(sync, f)),
                                      np.asarray(getattr(want["sync"], f)))
    if case[0] == "ALL":     # ALL keeps the replicas identical
        assert all(torch.equal(x[0], x[1]) for x in leaves(state.params))


def test_trainer_refuses_the_attention_kernel():
    """B.8 has no backward: a config that asks for it cannot train, and
    the trainer says so instead of running the plain attention."""
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("gemma-2b")),
                              use_flash_kernel=True)
    with pytest.raises(ValueError, match="no backward"):
        from repro_torch.core import policy_for
        from repro_torch.train import Trainer, TrainerConfig

        Trainer(cfg, DataConfig(512, 16, 4), adamw.AdamWConfig(), policy_for("X_STCC"),
                TrainerConfig(n_pods=2), device=CPU)


def test_trainer_checkpoint_round_trip(tmp_path):
    from repro_torch.checkpoint import CheckpointStore, SessionToken

    case = ("X_STCC", 2, 4, {})
    tr = port_trainer(case, CPU)
    tr.ckpt_store = CheckpointStore(str(tmp_path), n_replicas=3, device=CPU)
    tr.ckpt_session = SessionToken(client_id=1)
    tr.tcfg.ckpt_every = 2
    state = tr.run()
    restored, step = tr.restore_checkpoint()
    assert step == 4 and restored.step == 4 and restored.opt.count == 4
    for x, y in zip(leaves(state.params), leaves(restored.params)):
        assert torch.equal(x[0], y[0]) and torch.equal(y[0], y[1])
    assert int(restored.sync.merges) == 0
    # Resume: replay the data stream from the restored step.
    tr.tcfg.n_steps = 6
    resumed = tr.run(state=restored, start_step=step)
    assert resumed.step == 6 and resumed.opt.count == 6 and int(resumed.sync.merges) == 0
    assert [h["step"] for h in tr.history[-2:]] == [4, 5]


def test_launch_train_runs_reduced_on_the_cpu(capsys):
    from repro_torch.launch import train

    assert train.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps", "4",
                       "--delta", "2", "--compress", "int8", "--seq", "16",
                       "--batch", "4"]) == 0
    out = capsys.readouterr().out
    assert "'synced': True" in out and "sync steps: 2" in out
    assert train.main(["--arch", "gemma-2b", "--device", "cpu"]) == 2
    assert train.main(["--arch", "gemma-2b", "--dry-run"]) == 2
