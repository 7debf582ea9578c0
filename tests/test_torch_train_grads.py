"""One training step's gradients of the port's MoE and VLM families
(``models/moe.py``, the groups and the ``vis_embeds`` prefix of
``models/transformer.py``) against ``jax.value_and_grad`` of the JAX
reference's loss, on the same numpy inputs and the reference's converted
parameters, in f32 on the CPU: reduced olmoe-1b-7b (the aux term enters
the loss as ``ce + 0.01 aux``), llama4-maverick (groups of a dense and an
MoE layer, a shared expert) and internvl2-2b.  olmoe and internvl2 also
run under ``remat="full"`` and ``"selective"`` (the reference under the
same policy), and olmoe with a capacity that drops slots.  Losses within
rtol 1e-6, gradients within ``GRAD_TOL`` (``torch_family_ref``).
"""

import numpy as np
import pytest
import torch

from repro_torch.models import moe as t_moe
from torch_family_ref import (all_finite, assert_grads_close, cfgs, np_params, port_grads,
                              reference_grads)
from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import family_inputs

torch.set_num_threads(1)

OLMOE, LLAMA4, INTERNVL = "olmoe-1b-7b", "llama4-maverick-400b-a17b", "internvl2-2b"
# A capacity factor that drops slots: T = 64 tokens x top-2 over 4 experts
# leave 16 slots an expert where 32 arrive on average.
DROPS = {"capacity_factor": 0.5}
CASES = [(OLMOE, {}), (OLMOE, {"remat": "full"}), (OLMOE, {"remat": "selective"}),
         (OLMOE, DROPS), (LLAMA4, {}), (INTERNVL, {}), (INTERNVL, {"remat": "full"}),
         (INTERNVL, {"remat": "selective"})]


def _case_id(case):
    arch, over = case
    return "/".join([arch] + [f"{k}={v}" for k, v in over.items()])


@pytest.fixture(scope="module")
def inputs():
    """Per arch: the reference's parameters (perturbed constants) and one
    batch of 2 x 32 tokens (with the VLM's image prefix)."""
    out = {}
    for arch in (OLMOE, LLAMA4, INTERNVL):
        jcfg, _ = cfgs(arch)
        out[arch] = (np_params(jcfg), family_inputs(jcfg, 2, 32, 3))
    return out


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_one_step_gradients_match_reference(inputs, case, monkeypatch):
    arch, over = case
    jcfg, tcfg = cfgs(arch, **over)
    params, batch = inputs[arch]
    dropped = []
    dispatch = t_moe._dispatch_local

    def counting(xt, probs, cfg, capacity):
        out = dispatch(xt, probs, cfg, capacity)
        dropped.append(int((out[-1] >= capacity).sum()))
        return out

    monkeypatch.setattr(t_moe, "_dispatch_local", counting)
    jloss, jgrads = reference_grads(jcfg, params, batch)
    tloss, tgrads = port_grads(tcfg, params, batch)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    assert all_finite(jgrads) and all_finite(tgrads)
    assert_grads_close(tgrads, jgrads)
    if arch == INTERNVL:
        assert not dropped
        assert np.abs(tgrads["vis_proj"]).max() > 0
        return
    # One dispatch per MoE layer (remat may run it again in the backward).
    assert len(dropped) >= tcfg.n_layers // tcfg.moe_interleave
    if over == DROPS:
        assert min(dropped) > 0
    for key in ("router", "expert_gate", "expert_up", "expert_down"):
        assert np.abs(tgrads[f"moe_blocks/moe/{key}"]).max() > 0, key


def test_aux_term_enters_the_gradient():
    """The router's gradient is the cross-entropy's plus ``0.01 x`` the aux
    loss's, and the aux part is not zero."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.tree import items
    from torch_port_helpers import torch_batch

    jcfg, tcfg = cfgs(OLMOE)
    tree = params_from_numpy(np_params(jcfg), device="cpu")
    router = dict(items(tree))["moe_blocks/moe/router"].requires_grad_()
    loss, metrics = build_model(tcfg).loss(
        tree, torch_batch(family_inputs(jcfg, 2, 32, 3), "cpu"))
    total, ce, aux = (torch.autograd.grad(v, router, retain_graph=True)[0]
                      for v in (loss, metrics["ce"], metrics["aux"]))
    assert float(metrics["aux"].detach()) > 0 and float(aux.abs().max()) > 0
    torch.testing.assert_close(total, ce + 0.01 * aux, rtol=1e-5, atol=1e-8)
