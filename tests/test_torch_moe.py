"""The port's MoE and VLM families (``models/moe.py`` and the MoE / VLM
parts of ``models/transformer.py``) against the JAX reference on the
same numpy inputs and converted parameters, in f32 on the CPU: olmoe
(all-MoE, top-k), llama4-maverick (top-1, a shared expert, interleave 2)
and internvl2 (the vision prefix).  Routing, dispatch, drops and the
combine exactly; modules and models within atol = rtol 1e-5 (see
``torch_family_ref``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.models import build_model as j_build
from repro.models import moe as j_moe
from repro.models import transformer as j_tr
from repro_torch import configs as tc
from repro_torch.models import abstract_params, build_model
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tr
from torch_family_ref import (both, cfgs, check_decode_matches_forward, check_generate,
                              check_layout, check_model, close, np_params)
from torch_jax_cache import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(1)

OLMOE, LLAMA4, VLM = "olmoe-1b-7b", "llama4-maverick-400b-a17b", "internvl2-2b"


def _probs(rng, t, e, *, ties: bool):
    """Router probabilities (T, E); with ``ties``, rows whose largest
    values repeat (planted ties across the top-k boundary)."""
    p = rng.random((t, e)).astype(np.float32)
    if ties:
        p[::3] = np.round(p[::3] * 4) / 4          # few distinct values per row
        p[1::3, :] = p[1::3, :1]                   # whole rows equal
    return p / p.sum(-1, keepdims=True)


# (experts, top_k, tokens, capacity factor): no drops, heavy drops, top-1.
ROUTES = [(4, 2, 32, 1.25), (4, 2, 32, 0.25), (8, 1, 24, 1.0), (64, 8, 40, 0.5)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("e,k,t,cf", ROUTES)
def test_route_dispatch_combine_exact(e, k, t, cf, ties):
    """Given the same probabilities: the sorted slots, the queue
    positions, the (E, C, D) buffer with its dropped slots, and the
    combine, all exactly equal to the reference's."""
    jcfg, tcfg = cfgs(OLMOE, n_experts=e, top_k=k, capacity_factor=cf)
    rng = np.random.default_rng(e * 100 + t + ties)
    probs, xt = _probs(rng, t, e, ties=ties), rng.standard_normal((t, 16), np.float32)
    cap = t_moe.capacity(tcfg, t)
    jcap = max(8, (max(1, int(cf * t * k / e)) + 7) // 8 * 8)
    assert cap == jcap
    want = jax.jit(j_moe._dispatch_local, static_argnums=(2, 3))(
        jnp.asarray(xt), jnp.asarray(probs), jcfg, cap)
    got = t_moe._dispatch_local(torch.from_numpy(xt), torch.from_numpy(probs), tcfg, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos = np.asarray(want[4])
    if cf < 1.0:
        assert (pos >= cap).any()          # some tokens overflow and are dropped
    out_buf = rng.standard_normal((e, cap, 16), np.float32)
    np.testing.assert_array_equal(
        t_moe._combine_local(torch.from_numpy(out_buf), *got[1:], t, cap, torch.float32),
        np.asarray(jax.jit(j_moe._combine_local, static_argnums=(5, 6, 7))(
            jnp.asarray(out_buf), *want[1:], t, cap, jnp.float32)))


@pytest.mark.parametrize("arch,over", [(OLMOE, {}), (OLMOE, {"capacity_factor": 0.5}),
                                       (LLAMA4, {})], ids=["olmoe", "olmoe-drops", "llama4"])
def test_moe_layer_matches_reference(arch, over):
    jcfg, tcfg = cfgs(arch, **over)
    blocks = np_params(jcfg)["moe_blocks"]["moe"]
    jp, tp = both(jax.tree.map(lambda a: a[0], blocks))
    x = np.random.default_rng(2).standard_normal((2, 16, jcfg.d_model), np.float32)
    (ty, taux), (jy, jaux) = (t_moe.moe(torch.from_numpy(x), tp, tcfg),
                              jax.jit(lambda x, p: j_moe.moe(x, p, jcfg))(jnp.asarray(x), jp))
    close(ty, jy)
    close(taux, jaux)


def test_group_structure_and_interleave():
    for arch in (OLMOE, LLAMA4, "gemma-2b"):
        cfg = tc.get_config(arch)
        assert t_tr.group_structure(cfg) == j_tr.group_structure(j_get_config(arch))
        assert t_tr.layers_per_group(cfg) == j_tr.layers_per_group(j_get_config(arch))
    with pytest.raises(ValueError):
        t_tr.group_structure(tc.reduced(tc.get_config(LLAMA4), n_layers=3))


@pytest.mark.parametrize("arch", [OLMOE, LLAMA4, VLM])
def test_init_layout_matches_reference(arch):
    check_layout(arch)


@pytest.mark.parametrize("arch,over", [(OLMOE, {}), (OLMOE, {"capacity_factor": 0.5}),
                                       (LLAMA4, {}), (VLM, {})],
                         ids=["olmoe", "olmoe-drops", "llama4", "internvl2"])
def test_model_matches_reference(arch, over):
    check_model(arch, **over)


@pytest.mark.parametrize("arch", [OLMOE, LLAMA4, VLM])
def test_prefill_decode_matches_forward(arch):
    over = {"capacity_factor": 8.0} if arch != VLM else {}
    check_decode_matches_forward(arch, **over)


@pytest.mark.parametrize("arch", [OLMOE, VLM])
def test_generate_matches_reference_engine(arch):
    check_generate(arch)


def test_vlm_prefix_shifts_the_tokens():
    """The projected prefix takes the first n_vis positions, and the
    tokens after it are the batch's first S - n_vis."""
    tcfg = tc.reduced(tc.get_config(VLM))
    params = build_model(tcfg).init(0, device="cpu")
    toks = torch.arange(16, dtype=torch.int32)[None] % tcfg.vocab_size
    vis = torch.randn((1, tcfg.n_vis_tokens, tcfg.d_model), generator=torch.Generator()
                      .manual_seed(0))
    x = t_tr.embed_tokens(params, tcfg, toks, {"vis_embeds": vis})
    assert x.shape == (1, 16, tcfg.d_model)
    torch.testing.assert_close(x[:, :8], vis @ params["vis_proj"])
    torch.testing.assert_close(x[:, 8:], params["embed"][toks[:, :8].long()])


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_builds_on_the_meta_device(arch):
    """``build_model`` takes every config at full size, and
    ``abstract_params`` gives the reference's shapes and dtypes without
    allocating (llama4-maverick's ~400 B parameters included)."""
    model = build_model(tc.get_config(arch))
    params = abstract_params(model)
    got = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
                       params)
    assert all(a.device.type == "meta" for a in jax.tree.leaves(params))
    jm = j_build(j_get_config(arch))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax.eval_shape(jm.init, jax.random.key(0)))
    assert got == want
    cache = model.init_cache(2, 64, device="meta")
    assert all(v.device.type == "meta" for v in cache.values())


@pytest.mark.parametrize("arch", [OLMOE, LLAMA4, VLM])
def test_serve_launcher_runs_the_family_on_the_cpu(arch, capsys):
    """``launch.serve --reduced --device cpu``: every request served (the VLM's
    default prompt is 16 tokens after its image prefix)."""
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                       "--tokens", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("staleness=") and lines[-1].endswith("serves=2")
    # The full config stays on the card: the CPU refuses it.
    assert serve.main(["--arch", arch, "--device", "cpu"]) == 2
