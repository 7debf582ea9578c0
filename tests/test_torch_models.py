"""The port's LM substrate (configs, common layers, attention, the dense
transformer) against the JAX reference on the same numpy inputs and
converted parameters, in f32 on the CPU.  Tolerance: atol = rtol = 1e-5
(both sides sum in f32 in orders their BLAS picks); prefill + decode
against forward within the reference's own 2e-4
(``tests/test_decode_consistency.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cache_specs as j_cache_specs
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.configs import list_archs as j_list_archs
from repro.configs import reduced as j_reduced
from repro.configs import shapes_for as j_shapes_for
from repro.configs.shapes import SHAPES_BY_NAME as J_SHAPES
from repro.models import attention as j_attn
from repro.models import build_model as j_build
from repro.models import common as j_common
from repro.models import mlp as j_mlp
from repro_torch import configs as tc
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model as t_build
from repro_torch.models import common as t_common
from repro_torch.models import mlp as t_mlp

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)

# reduced() alone gives qwen2 4/4 heads; n_kv_heads=2 exercises GQA with
# the qkv bias.  gemma-2b: MQA, GeGLU, tied and scaled embedding.
MODELS = [("gemma-2b", {}), ("qwen2-7b", {"n_kv_heads": 2}), ("phi4-mini-3.8b", {})]
MODEL_IDS = [a for a, _ in MODELS]


def _cfgs(arch, **over):
    return (j_reduced(j_get_config(arch), **over),
            tc.reduced(tc.get_config(arch), **over))


def _np_params(jcfg, seed=0):
    """The reference's parameters as numpy, with the zero-initialized norm
    weights and biases perturbed so that they matter."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.key(seed)))

    def perturb(path, a):
        name = path[-1].key
        if name.endswith("norm") or name in ("bq", "bk", "bv"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _both(np_tree):
    return jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree, device="cpu")


def _layer(tree, i=0):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i, 0]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


# ---- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch", j_list_archs())
def test_param_count_matches_reference(arch):
    jcfg, tcfg = j_get_config(arch), tc.get_config(arch)
    assert tc.list_archs() == j_list_archs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert [s.name for s in tc.shapes_for(tcfg)] == [s.name for s in j_shapes_for(jcfg)]


@pytest.mark.parametrize("arch,over", MODELS, ids=MODEL_IDS)
def test_specs_and_batch_match_reference(arch, over):
    jcfg, tcfg = _cfgs(arch, **over)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        js, ts = j_input_specs(jcfg, J_SHAPES[name]), tc.input_specs(tcfg, tc.SHAPES_BY_NAME[name])
        assert {k: (v.shape, str(v.dtype)) for k, v in js.items()} == {
            k: (v.shape, str(v.dtype).removeprefix("torch.")) for k, v in ts.items()}
    jc, t_c = j_cache_specs(jcfg, J_SHAPES["decode_32k"]), tc.cache_specs(
        tcfg, tc.SHAPES_BY_NAME["decode_32k"])
    assert {k: (v.shape, str(v.dtype)) for k, v in jc.items()} == {
        k: (v.shape, str(v.dtype).removeprefix("torch.")) for k, v in t_c.items()}
    shape = dataclasses.replace(tc.TRAIN_4K, seq_len=8, global_batch=2)
    batch = tc.make_batch(tcfg, shape, torch.Generator().manual_seed(3), device="cpu")
    assert {k: tuple(v.shape) for k, v in batch.items()} == {"tokens": (2, 8), "labels": (2, 8)}
    assert int(batch["tokens"].min()) >= 0 and int(batch["tokens"].max()) < tcfg.vocab_size
    # The port's initializer fills the reference's layout.
    jp = jax.tree.map(lambda a: (a.shape, str(a.dtype)), j_build(jcfg).init(jax.random.key(0)))
    tp = t_build(tcfg).init(0, device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
                        tp) == jp
    assert t_common.count_params(tp) == tcfg.param_count()


# ---- common layers ------------------------------------------------------------


def test_rms_norm_rope_softcap_loss():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 8, 4, 32), _rand(rng, 32)
    pos = rng.integers(0, 4096, (2, 8)).astype(np.int32)
    _close(t_common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           j_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    _close(t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    _close(t_common.softcap(torch.from_numpy(x) * 40, 30.0),
           j_common.softcap(jnp.asarray(x) * 40, 30.0))
    logits, labels = _rand(rng, 3, 5, 11), rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, :2] = -100
    _close(t_common.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                       z_loss=1e-3),
           j_common.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=1e-3))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlps_match_reference(kind):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 5, 64)
    p = {k: _rand(rng, *s) * 0.1 for k, s in (("w_up", (64, 96)), ("w_gate", (64, 96)),
                                               ("w_down", (96, 64)))}
    jp, tp = _both(p)
    _close(t_mlp.mlp(torch.from_numpy(x), tp, kind), j_mlp.mlp(jnp.asarray(x), jp, kind))


# ---- attention ----------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch,over", MODELS[:2], ids=MODEL_IDS[:2])
def test_full_attention_matches_reference(arch, over, flash):
    """With ``use_flash_kernel`` both sides take their kernel route (the
    reference's Pallas kernel in interpret mode, the port's plain flash
    version on the CPU)."""
    jcfg, tcfg = _cfgs(arch, use_flash_kernel=flash, **over)
    jp, tp = _both(_layer(_np_params(jcfg)["dense_blocks"]["attn"]))
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 16, jcfg.d_model)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    _close(t_attn.full_attention(torch.from_numpy(x), tp, tcfg, torch.from_numpy(pos)),
           j_attn.full_attention(jnp.asarray(x), jp, jcfg, jnp.asarray(pos)))


@pytest.mark.parametrize("window", [0, 5])
def test_chunked_prefill_attention_matches_reference(window):
    """``attn_chunk=4`` over 16 queries: four chunks through
    ``_masked_attention``, by itself and inside the prefill."""
    jcfg, tcfg = _cfgs("qwen2-7b", n_kv_heads=2, attn_chunk=4, sliding_window=window)
    jp, tp = _both(_layer(_np_params(jcfg)["dense_blocks"]["attn"]))
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 16, jcfg.d_model)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    got = t_attn.prefill_attention_with_cache(torch.from_numpy(x), tp, tcfg,
                                              torch.from_numpy(pos))
    want = j_attn.prefill_attention_with_cache(jnp.asarray(x), jp, jcfg, jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w)
    q, k, v = (_rand(rng, 2, 16, *s) for s in ((4, 32), (2, 32), (2, 32)))
    _close(t_attn._masked_attention(*map(torch.from_numpy, (q, k, v)), tcfg,
                                    torch.from_numpy(pos), torch.from_numpy(pos), True),
           j_attn._masked_attention(*map(jnp.asarray, (q, k, v)), jcfg, jnp.asarray(pos),
                                    jnp.asarray(pos), True))


@pytest.mark.parametrize("ring,window,pos", [(False, 0, 6), (True, 0, 13),
                                             (False, 4, [3, 7]), (True, 0, [2, 9])])
def test_decode_attention_matches_reference(ring, window, pos):
    jcfg, tcfg = _cfgs("qwen2-7b", n_kv_heads=2, sliding_window=window)
    jp, tp = _both(_layer(_np_params(jcfg)["dense_blocks"]["attn"]))
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 1, jcfg.d_model)
    kc, vc = _rand(rng, 2, 8, 2, 32), _rand(rng, 2, 8, 2, 32)
    pos = np.asarray(pos, np.int32)
    got = t_attn.decode_attention(torch.from_numpy(x), tp, tcfg, torch.from_numpy(kc),
                                  torch.from_numpy(vc), torch.from_numpy(pos), ring=ring)
    want = j_attn.decode_attention(jnp.asarray(x), jp, jcfg, jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pos), ring=ring)
    for g, w in zip(got, want):
        _close(g, w)


# ---- the model ----------------------------------------------------------------


@pytest.mark.parametrize("arch,over", MODELS, ids=MODEL_IDS)
def test_model_matches_reference(arch, over):
    """forward, loss, prefill (cache padded to max_seq) and three
    decode steps, on the reference's converted parameters."""
    jcfg, tcfg = _cfgs(arch, **over)
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp, tp = _both(_np_params(jcfg, seed=5))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    # The reference under jit (one compile per entry point, not one per op).
    j_loss = jax.jit(jm.loss)
    j_prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t, "max_seq": 12}))
    j_decode = jax.jit(jm.decode_step)
    _close(tm.forward(tp, tb)[0], jax.jit(jm.forward)(jp, jb)[0])
    _close(tm.loss(tp, tb)[0], j_loss(jp, jb)[0])
    jl, jcache = j_prefill(jp, jb["tokens"][:, :9])
    tl, tcache = tm.prefill(tp, {"tokens": tb["tokens"][:, :9], "max_seq": 12})
    _close(tl, jl)
    for k in ("k", "v", "pos"):
        _close(tcache[k], jcache[k])
    for t in range(9, 12):
        jl, jcache = j_decode(jp, jcache, jb["tokens"][:, t:t + 1])
        tl, tcache = tm.decode_step(tp, tcache, tb["tokens"][:, t:t + 1])
        _close(tl, jl)
    for k in ("k", "v", "pos"):
        _close(tcache[k], jcache[k])


@pytest.mark.parametrize("arch,over", MODELS, ids=MODEL_IDS)
def test_prefill_decode_matches_forward(arch, over):
    """The reference's invariant on the port alone, with the port's own
    initializer and ``attn_chunk=4``: prefill(tokens[:k]) + decode(rest)
    equals forward(tokens) position by position."""
    tcfg = tc.reduced(tc.get_config(arch), attn_chunk=4, **over)
    model = t_build(tcfg)
    params = model.init(1, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    full, _ = model.forward(params, {"tokens": tokens})
    lg, cache = model.prefill(params, {"tokens": tokens[:, :12], "max_seq": 16})
    errs = [float((lg[:, 0] - full[:, 11]).abs().max())]
    for t in range(12, 16):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, errs
    assert int(cache["pos"]) == 16 and cache["k"].shape[2] == 16
