"""The port's audio family (``models/encdec.py``, with the cross attention
of ``models/attention.py`` and ``common.sinusoidal_positions``) against
the JAX reference on the same numpy inputs and converted parameters, in
f32 on the CPU: reduced whisper-large-v3.  Modules and models within
atol = rtol 1e-5 (see ``torch_family_ref``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import encdec as j_encdec
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import encdec as t_encdec
from torch_family_ref import (both, cfgs, check_decode_matches_forward, check_generate,
                              check_layout, check_model, close, np_params)
from torch_jax_cache import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(1)

WHISPER = "whisper-large-v3"


@pytest.mark.parametrize("n,d", [(32, 128), (448, 1280), (1500, 1280)])
def test_sinusoidal_positions_match_reference(n, d):
    """Whisper's decoder (448) and encoder (1500) lengths at full width:
    within one f32 ulp of the reference (its ``pow`` is correctly
    rounded, and so is the port's)."""
    close(t_common.sinusoidal_positions(n, d), j_common.sinusoidal_positions(n, d),
          atol=1.2e-7, rtol=0)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def test_encoder_matches_reference():
    jcfg, tcfg = cfgs(WHISPER)
    jp, tp = both(np_params(jcfg))
    frames = np.random.default_rng(1).standard_normal((2, jcfg.n_frames, jcfg.d_model),
                                                      np.float32)
    close(t_encdec.encode(tp, tcfg, torch.from_numpy(frames)),
          jax.jit(lambda p, f: j_encdec.encode(p, jcfg, f))(jp, jnp.asarray(frames)))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_attention_matches_reference(qkv_bias):
    """``full_attention(cross_kv=)`` over encoder keys longer than the
    queries, and one-token ``decode_attention(cross=True)``."""
    jcfg, tcfg = cfgs(WHISPER, qkv_bias=qkv_bias)
    jp, tp = both(_layer(np_params(jcfg)["dec_blocks"]["cross_attn"]))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, jcfg.d_model), np.float32)
    mem = rng.standard_normal((2, jcfg.n_frames, jcfg.d_model), np.float32)
    blk = {"cross_attn": jp}
    ck, cv = j_encdec._cross_kv(blk, jcfg, jnp.asarray(mem))
    tk, tv = t_encdec._cross_kv({"cross_attn": tp}, tcfg, torch.from_numpy(mem))
    close(tk, ck)
    close(tv, cv)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    close(t_attn.full_attention(torch.from_numpy(x), tp, tcfg, torch.from_numpy(pos),
                                cross_kv=(tk, tv)),
          j_attn.full_attention(jnp.asarray(x), jp, jcfg, jnp.asarray(pos),
                                cross_kv=(ck, cv)))
    got = t_attn.decode_attention(torch.from_numpy(x[:, :1]), tp, tcfg, tk, tv,
                                  torch.tensor(5), cross=True)
    want = j_attn.decode_attention(jnp.asarray(x[:, :1]), jp, jcfg, ck, cv,
                                   jnp.asarray(5), cross=True)
    for g, w in zip(got, want):
        close(g, w)
    assert got[1] is tk and got[2] is tv          # the fixed cache comes back as is


def test_init_layout_matches_reference():
    check_layout(WHISPER)


@pytest.mark.parametrize("over", [{}, {"use_flash_kernel": True}], ids=["plain", "flash"])
def test_model_matches_reference(over):
    """With ``use_flash_kernel`` the decoder's self-attention takes each
    side's kernel route (the reference's Pallas kernel in interpret mode,
    the port's plain flash version on the CPU); the encoder and the cross
    attention stay plain on both."""
    check_model(WHISPER, **over)


def test_prefill_decode_matches_forward():
    check_decode_matches_forward(WHISPER)


def test_generate_matches_reference_engine():
    check_generate(WHISPER)


def test_flash_route_counts_the_causal_layers(monkeypatch):
    """The decoder's causal self-attention goes through
    ``kernels.ops.flash_attention`` once per layer; the encoder's
    bidirectional attention and the cross attention do not."""
    from repro_torch import configs as tc
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from torch_port_helpers import causal_attention_layers, family_inputs, torch_batch

    cfg = dataclasses.replace(tc.reduced(tc.get_config(WHISPER)), use_flash_kernel=True)
    model = build_model(cfg)
    calls = []
    real = ops.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    model.forward(model.init(0, device="cpu"),
                  torch_batch(family_inputs(cfg, 1, 12, 0), "cpu"))
    assert len(calls) == causal_attention_layers(cfg) == cfg.n_layers


@pytest.mark.parametrize("arch", [WHISPER])
def test_serve_launcher_runs_the_family_on_the_cpu(arch, capsys):
    """``launch.serve --reduced --device cpu``: every request served."""
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                       "--tokens", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("staleness=") and lines[-1].endswith("serves=2")
