"""One training step's gradients of the port's chunked scans and the
encoder-decoder — the hybrid (``models/mamba2.py``, ``models/hybrid.py``:
zamba2's shared-attention block gets one gradient summed over its sites),
the SSM (``models/rwkv6.py``, ``models/ssm_model.py``) and the audio
family (``models/encdec.py``) — against ``jax.value_and_grad`` of the JAX
reference's loss, on the same numpy inputs and the reference's converted
parameters, in f32 on the CPU, within ``GRAD_TOL`` (``torch_family_ref``).

The SSD scan's masked exponential (``mamba2.masked_decay``): the
reference computes ``where(tri, exp(rel), 0)``, whose ``exp`` overflows
above the diagonal, so its gradients are NaN at reduced zamba2's 16-token
chunk for any weights (ROADMAP C).  The port masks ``rel`` first: its
forward is bit for bit the old one and its gradients are finite.  They
are held against the reference at a 2-token chunk, where the one masked
entry per chunk, one step's decay, stays far below the overflow: the SSD
is exact at any chunk length, so the two gradients are the same function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as j_mamba2
from repro_torch.models import build_model
from repro_torch.models import mamba2 as t_mamba2
from torch_family_ref import (all_finite, assert_grads_close, both, cfgs, close, np_params,
                              port_grads, reference_grads)
from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import family_inputs, torch_batch

torch.set_num_threads(1)

ZAMBA, RWKV, WHISPER = "zamba2-1.2b", "rwkv6-3b", "whisper-large-v3"
# The finite-reference chunk; 5 layers give zamba2 a tail past its groups.
SHORT = {"ssm_chunk": 2}
TAIL = {"n_layers": 5}


def _pre_repair(rel, keep):
    """The reference's (and the port's former) masked exponential."""
    return torch.where(keep, torch.exp(rel), torch.zeros((), device=rel.device))


@pytest.mark.parametrize("s", [48, 8])
def test_mamba2_forward_bit_equal_to_pre_repair(s, monkeypatch):
    """The repair changes no forward value: three chunks and a length
    below the chunk, bit for bit; and within 1e-5 of the reference."""
    jcfg, tcfg = cfgs(ZAMBA)
    jp, tp = both(jax.tree.map(lambda a: a[0, 0], np_params(jcfg)["mamba_blocks"]["mamba"]))
    x = np.random.default_rng(s).standard_normal((2, s, jcfg.d_model), np.float32)
    got, st = t_mamba2.mamba2_forward(torch.from_numpy(x), tp, tcfg, return_state=True)
    monkeypatch.setattr(t_mamba2, "masked_decay", _pre_repair)
    old, old_st = t_mamba2.mamba2_forward(torch.from_numpy(x), tp, tcfg, return_state=True)
    assert torch.equal(got, old) and torch.equal(st["ssm"], old_st["ssm"])
    want = jax.jit(lambda x, p: j_mamba2.mamba2_forward(x, p, jcfg))(jnp.asarray(x), jp)
    close(got, want)


def test_zamba2_loss_bit_equal_to_pre_repair(monkeypatch):
    jcfg, tcfg = cfgs(ZAMBA, **TAIL)
    model = build_model(tcfg)
    params = model.init(0, device="cpu")
    batch = torch_batch(family_inputs(tcfg, 2, 32, 4), "cpu")
    got = model.forward(params, batch)[0]
    monkeypatch.setattr(t_mamba2, "masked_decay", _pre_repair)
    assert torch.equal(got, model.forward(params, batch)[0])


def test_masked_decay_backward_is_finite():
    """Where ``rel`` overflows ``exp`` above the diagonal, the pre-repair
    form's gradient is NaN and the repaired one's finite (0 there)."""
    rel = torch.tensor([[0.0, 100.0], [-1.0, 0.0]], requires_grad=True)
    keep = torch.tril(torch.ones((2, 2), dtype=torch.bool))
    for fn, finite in ((t_mamba2.masked_decay, True), (_pre_repair, False)):
        out = fn(rel, keep)
        assert torch.equal(out.detach(), torch.tensor([[1.0, 0.0], [np.exp(-1.0), 1.0]],
                                                      dtype=torch.float32))
        (g,) = torch.autograd.grad(out.sum(), rel)
        assert bool(torch.isfinite(g).all()) is finite
        if finite:
            assert g[0, 1] == 0 and g[1, 0] == out[1, 0]


@pytest.fixture(scope="module")
def zamba_inputs():
    """Per layout (the reduced 3 groups, or 2 and a tail): the reference's
    parameters, a batch of 4 x 16 tokens (the trainer's) and the
    reference's loss and gradients at the 2-token chunk."""
    out = {}
    for name, over in (("groups", {}), ("tail", TAIL)):
        jcfg, _ = cfgs(ZAMBA, **over)
        params, batch = np_params(jcfg), family_inputs(jcfg, 4, 16, 3)
        short, _ = cfgs(ZAMBA, **over, **SHORT)
        out[name] = (params, batch, reference_grads(short, params, batch))
    return out


@pytest.mark.parametrize("layout", ["groups", "tail"])
@pytest.mark.parametrize("chunk", [None, 2])
def test_zamba2_gradients_match_reference(zamba_inputs, layout, chunk):
    """At the reduced chunk (16) and at 2, the port's gradients equal the
    reference's at 2."""
    params, batch, (jloss, jgrads) = zamba_inputs[layout]
    over = dict(TAIL if layout == "tail" else {}, **({"ssm_chunk": chunk} if chunk else {}))
    _, tcfg = cfgs(ZAMBA, **over)
    tloss, tgrads = port_grads(tcfg, params, batch)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    assert all_finite(jgrads) and all_finite(tgrads)
    assert_grads_close(tgrads, jgrads)
    # The shared block's one gradient sums its sites' contributions.
    assert np.abs(tgrads["shared_attn/attn/wq"]).max() > 0


def test_zamba2_gradients_finite_where_reference_is_nan(zamba_inputs):
    """Reduced zamba2 at its 16-token chunk: the reference's gradients are
    NaN in every leaf the SSD scan reaches; the port's are finite."""
    params, batch, _ = zamba_inputs["groups"]
    jcfg, tcfg = cfgs(ZAMBA)
    jloss, jgrads = reference_grads(jcfg, params, batch)
    tloss, tgrads = port_grads(tcfg, params, batch)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    nan = sorted(k for k, g in jgrads.items() if not np.isfinite(g).all())
    assert "mamba_blocks/mamba/in_proj" in nan and "embed" in nan
    assert all_finite(tgrads)


@pytest.mark.parametrize("arch", [RWKV, WHISPER])
def test_one_step_gradients_match_reference(arch):
    """rwkv6 over 2 chunks of 128 (the inter-chunk state carries a
    gradient) and whisper (encoder over its 32 frames, cross-attention)."""
    jcfg, tcfg = cfgs(arch)
    params = np_params(jcfg)
    batch = family_inputs(jcfg, 2, 256 if arch == RWKV else 32, 3)
    jloss, jgrads = reference_grads(jcfg, params, batch)
    tloss, tgrads = port_grads(tcfg, params, batch)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    assert all_finite(jgrads) and all_finite(tgrads)
    assert_grads_close(tgrads, jgrads)
    if arch == WHISPER:
        for key in ("enc_blocks/attn/wq", "dec_blocks/cross_attn/wk"):
            assert np.abs(tgrads[key]).max() > 0, key
