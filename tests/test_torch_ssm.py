"""The port's hybrid and SSM families (``models/mamba2.py``,
``models/hybrid.py``, ``models/rwkv6.py``, ``models/ssm_model.py``)
against the JAX reference on the same numpy inputs and converted
parameters, in f32 on the CPU: zamba2 (Mamba2 layers, a shared
attention block, a tail of layers past the last group, the
sliding-window ring cache) and rwkv6.  Modules and models within atol =
rtol 1e-5 (see ``torch_family_ref``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TRAIN_4K as J_TRAIN_4K
from repro.configs import make_batch as j_make_batch
from repro.models import build_model as j_build
from repro.models import hybrid as j_hybrid
from repro.models import mamba2 as j_mamba2
from repro.models import rwkv6 as j_rwkv6
from repro_torch import configs as tc
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models import hybrid as t_hybrid
from repro_torch.models import mamba2 as t_mamba2
from repro_torch.models import rwkv6 as t_rwkv6
from torch_family_ref import (both, cfgs, check_decode_matches_forward, check_generate,
                              check_layout, check_model, close, close_tree, np_params)
from torch_jax_cache import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(1)

ZAMBA, RWKV = "zamba2-1.2b", "rwkv6-3b"
# reduced() gives zamba2 6 layers in 3 groups of 2; 5 layers give 2
# groups and a tail of 1 past the last group (``mamba_tail``), so the
# model-level tests take that one.
TAIL = {"n_layers": 5}


def _x(rng, jcfg, b, s):
    return rng.standard_normal((b, s, jcfg.d_model), np.float32)


def _mamba_params(jcfg):
    return both(jax.tree.map(lambda a: a[0, 0], np_params(jcfg)["mamba_blocks"]["mamba"]))


@pytest.mark.parametrize("s", [16, 48, 8])
def test_mamba2_forward_and_state_match_reference(s):
    """One chunk, three chunks, and a length below the chunk."""
    jcfg, tcfg = cfgs(ZAMBA)
    jp, tp = _mamba_params(jcfg)
    x = _x(np.random.default_rng(s), jcfg, 2, s)
    got = t_mamba2.mamba2_forward(torch.from_numpy(x), tp, tcfg, return_state=True)
    want = jax.jit(lambda x, p: j_mamba2.mamba2_forward(x, p, jcfg, return_state=True))(
        jnp.asarray(x), jp)
    close(got[0], want[0])
    close_tree(got[1], want[1])
    assert got[1]["ssm"].dtype == torch.float32
    close(t_mamba2.mamba2_forward(torch.from_numpy(x), tp, tcfg), want[0])


def test_mamba2_decode_matches_reference():
    jcfg, tcfg = cfgs(ZAMBA)
    jp, tp = _mamba_params(jcfg)
    rng = np.random.default_rng(3)
    x = _x(rng, jcfg, 2, 1)
    d_in, nh, hp, ns = t_mamba2.dims(tcfg)
    cache = {"ssm": rng.standard_normal((2, nh, ns, hp), np.float32),
             "conv": rng.standard_normal((2, 3, d_in + 2 * ns), np.float32)}
    got = t_mamba2.mamba2_decode(torch.from_numpy(x), tp, tcfg,
                                 {k: torch.from_numpy(v) for k, v in cache.items()})
    want = jax.jit(lambda x, p, c: j_mamba2.mamba2_decode(x, p, jcfg, c))(
        jnp.asarray(x), jp, {k: jnp.asarray(v) for k, v in cache.items()})
    close(got[0], want[0])
    close_tree(got[1], want[1])


def test_chunk_indivisible_lengths_raise():
    """Where the reference asserts, the port raises ``ValueError``."""
    zcfg, rcfg = (tc.reduced(tc.get_config(a)) for a in (ZAMBA, RWKV))
    zp = build_model(zcfg).init(0, device="cpu")["mamba_blocks"]["mamba"]
    with pytest.raises(ValueError, match="divisible"):
        t_mamba2.mamba2_forward(torch.zeros((1, 24, zcfg.d_model)),
                                {k: v[0, 0] for k, v in zp.items()}, zcfg)
    rp = build_model(rcfg).init(0, device="cpu")["blocks"]["rwkv"]
    with pytest.raises(ValueError, match="divisible"):
        t_rwkv6.rwkv6_time_mix(torch.zeros((1, 136, rcfg.d_model)),
                               {k: v[0] for k, v in rp.items()}, rcfg)


@pytest.mark.parametrize("s", [16, 256])
def test_rwkv6_time_mix_and_state_match_reference(s):
    """One chunk of 16, and two of 128."""
    jcfg, tcfg = cfgs(RWKV)
    jp, tp = both(jax.tree.map(lambda a: a[0], np_params(jcfg)["blocks"]["rwkv"]))
    x = _x(np.random.default_rng(s), jcfg, 2, s)
    got = t_rwkv6.rwkv6_time_mix(torch.from_numpy(x), tp, tcfg, return_state=True)
    want = jax.jit(lambda x, p: j_rwkv6.rwkv6_time_mix(x, p, jcfg, return_state=True))(
        jnp.asarray(x), jp)
    close(got[0], want[0])
    close(got[1], want[1])
    close(t_rwkv6.rwkv6_channel_mix(torch.from_numpy(x), tp),
          jax.jit(j_rwkv6.rwkv6_channel_mix)(jnp.asarray(x), jp))


def test_rwkv6_decode_matches_reference():
    jcfg, tcfg = cfgs(RWKV)
    jp, tp = both(jax.tree.map(lambda a: a[0], np_params(jcfg)["blocks"]["rwkv"]))
    rng = np.random.default_rng(4)
    x = _x(rng, jcfg, 2, 1)
    nh, hk = t_rwkv6.dims(tcfg)
    cache = {"state": rng.standard_normal((2, nh, hk, hk), np.float32),
             "tm_shift": rng.standard_normal((2, jcfg.d_model), np.float32),
             "cm_shift": rng.standard_normal((2, jcfg.d_model), np.float32)}
    tc_ = {k: torch.from_numpy(v) for k, v in cache.items()}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    t_out, t_none, t_c = t_rwkv6.rwkv6_decode(torch.from_numpy(x), tp, tcfg, tc_)
    j_out, j_none, j_c = jax.jit(lambda x, p, c: j_rwkv6.rwkv6_decode(x, p, jcfg, c))(
        jnp.asarray(x), jp, jc)
    assert t_none is None and j_none is None
    close(t_out, j_out)
    close_tree(t_c, j_c)
    t_out, t_c = t_rwkv6.rwkv6_channel_mix_step(torch.from_numpy(x), tp, t_c)
    j_out, j_c = jax.jit(j_rwkv6.rwkv6_channel_mix_step)(jnp.asarray(x), jp, j_c)
    close(t_out, j_out)
    close_tree(t_c, j_c)


@pytest.mark.parametrize("arch,over", [(ZAMBA, {}), (ZAMBA, TAIL), (RWKV, {})],
                         ids=["zamba2", "zamba2-tail", "rwkv6"])
def test_init_layout_matches_reference(arch, over):
    check_layout(arch, **over)
    tcfg = tc.reduced(tc.get_config(arch), **over)
    if arch == ZAMBA:
        assert t_hybrid.site_count(tcfg) == j_hybrid.site_count(cfgs(arch, **over)[0])
        assert t_hybrid._grouping(tcfg) == j_hybrid._grouping(cfgs(arch, **over)[0])


@pytest.mark.parametrize("arch,over", [(ZAMBA, TAIL), (RWKV, {})],
                         ids=["zamba2-tail", "rwkv6"])
def test_model_matches_reference(arch, over):
    check_model(arch, **over)


@pytest.mark.parametrize("arch,over", [(ZAMBA, TAIL), (RWKV, {})],
                         ids=["zamba2-tail", "rwkv6"])
def test_prefill_decode_matches_forward(arch, over):
    check_decode_matches_forward(arch, **over)


@pytest.mark.parametrize("arch", [ZAMBA, RWKV])
def test_generate_matches_reference_engine(arch):
    check_generate(arch)


def test_hybrid_sliding_window_ring_decode_matches_reference():
    """``tests/test_decode_consistency.py``'s ring setting (window 8, a
    16-token prompt, max_seq 32, twelve decode steps past the window
    twice over) on the reference's converted parameters: every step's
    logits and the final ring caches equal, the ring 8 long."""
    jcfg, tcfg = cfgs(ZAMBA, sliding_window=8)
    jm, tm = j_build(jcfg), build_model(tcfg)
    np_p = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(1)))
    jp, tp = jax.tree.map(jnp.asarray, np_p), params_from_numpy(np_p, device="cpu")
    shape = dataclasses.replace(J_TRAIN_4K, seq_len=16, global_batch=2)
    toks = np.array(j_make_batch(jcfg, shape)["tokens"])
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t, "max_seq": 32}))(
        jp, jnp.asarray(toks))
    tl, t_c = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "max_seq": 32})
    close(tl, jl)
    close_tree(t_c, jc)
    assert t_c["k"].shape[2] == 8
    j_decode = jax.jit(jm.decode_step)
    three = np.full((2, 1), 3, np.int32)
    for _ in range(12):
        jl, jc = j_decode(jp, jc, jnp.asarray(three))
        tl, t_c = tm.decode_step(tp, t_c, torch.from_numpy(three))
        close(tl, jl)
    close_tree(t_c, jc)
    assert bool(torch.isfinite(tl).all())


@pytest.mark.parametrize("s", [20])
def test_ring_prefill_rotation_matches_reference(s):
    """A prompt longer than the window that is not a multiple of it: the
    trailing keys rotated so position p sits at slot p % window."""
    jcfg, tcfg = cfgs(ZAMBA, sliding_window=8, ssm_chunk=4)
    jp, tp = both(np_params(jcfg, 2))
    toks = np.random.default_rng(s).integers(0, jcfg.vocab_size, (1, s)).astype(np.int32)
    _, jc = jax.jit(lambda p, t: jm_prefill(jcfg, p, t))(jp, jnp.asarray(toks))
    _, t_c = build_model(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks),
                                            "max_seq": 64})
    close_tree(t_c, jc)


def jm_prefill(jcfg, p, t):
    return j_build(jcfg).prefill(p, {"tokens": t, "max_seq": 64})


def test_long_500k_window_and_cache_specs():
    """``adjust_config``'s hybrid window for ``long_500k``, and the cache
    specs it gives (a ring of 4096 per site), as in the reference."""
    from repro.configs import cache_specs as j_cache_specs
    from repro.configs import get_config as j_get_config
    from repro.configs.shapes import SHAPES_BY_NAME as J_SHAPES

    for arch in (ZAMBA, RWKV):
        cfg = tc.get_config(arch)
        assert tc.adjust_config(cfg, tc.LONG_500K).sliding_window == (
            4096 if arch == ZAMBA else 0)
        want = {k: (v.shape, str(v.dtype)) for k, v in j_cache_specs(
            j_get_config(arch), J_SHAPES["long_500k"]).items()}
        got = {k: (v.shape, str(v.dtype).removeprefix("torch.")) for k, v in tc.cache_specs(
            cfg, tc.SHAPES_BY_NAME["long_500k"]).items()}
        assert got == want


@pytest.mark.parametrize("arch", [ZAMBA, RWKV])
def test_serve_launcher_runs_the_family_on_the_cpu(arch, capsys):
    """``launch.serve --reduced --device cpu``: every request served; a prompt that does not
    split into chunks is refused."""
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                       "--tokens", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("staleness=") and lines[-1].endswith("serves=2")
    # A prompt the chunked scan cannot split is refused with the reason.
    chunk = 16 if arch == ZAMBA else 128
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--prompt-len", str(chunk + 8)]) == 2
    assert "chunks of" in capsys.readouterr().err
