"""``ServingEngine.generate`` of the port on a real model, reduced
gemma-2b (MQA, GeGLU, tied and scaled embedding), against the
reference's engine on the same converted parameters and prompts: the
generated tokens, the replica of every request and the routing counters
must be equal.  Also the port's serving launcher on the CPU."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.consistency import ConsistencyLevel as JLevel
from repro.models import build_model as j_build
from repro.serve import ServeSession as JSession
from repro.serve import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.consistency import ConsistencyLevel
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model
from repro_torch.serve import ServeSession, ServingEngine
from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import (MODEL_SERVING, model_serving_counters,
                                model_serving_script)

torch.set_num_threads(1)
PROMPT, TOKENS = 8, 4


def _jitted(model, max_seq: int):
    """The reference model with its prefill and decode under ``jit`` (the
    engine is built with ``jit=False``: it would trace ``max_seq``)."""
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t, "max_seq": max_seq}))
    return types.SimpleNamespace(prefill=lambda p, b: prefill(p, b["tokens"]),
                                 decode_step=jax.jit(model.decode_step))


@pytest.mark.parametrize("level", ["X_STCC", "ONE"])
def test_generate_matches_reference_engine(level):
    jcfg, tcfg = j_reduced(j_get_config("gemma-2b")), reduced(get_config("gemma-2b"))
    jm = j_build(jcfg)
    np_params = [jax.tree.map(np.asarray, jm.init(jax.random.key(s))) for s in (0, 1)]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, (1, PROMPT)).astype(np.int32)
               for _ in range(MODEL_SERVING["n_requests"])]
    max_seq = PROMPT + TOKENS

    j_eng = JEngine(_jitted(jm, max_seq), JLevel[level], jit=False)
    want = model_serving_script(
        j_eng, [jax.tree.map(jnp.asarray, p) for p in np_params],
        lambda i: {"tokens": jnp.asarray(prompts[i]), "max_seq": max_seq}, JSession,
        n_tokens=TOKENS, **MODEL_SERVING)

    t_eng = ServingEngine(build_model(tcfg), ConsistencyLevel[level], device="cpu")
    got = model_serving_script(
        t_eng, [params_from_numpy(p, device="cpu") for p in np_params],
        lambda i: {"tokens": torch.from_numpy(prompts[i]), "max_seq": max_seq},
        ServeSession, n_tokens=TOKENS, **MODEL_SERVING)

    assert got == want
    assert model_serving_counters(t_eng) == model_serving_counters(j_eng)
    assert t_eng.failovers == 1 and t_eng.total_serves == MODEL_SERVING["n_requests"]


def test_serve_launcher_on_the_cpu(capsys):
    assert t_serve.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                         "--requests", "3", "--tokens", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" ->")[0] for ln in lines[:3]] == [
        f"request {i} (session {i})" for i in range(3)]
    assert lines[3].startswith("staleness=") and lines[3].endswith("serves=3")
    # The full config runs only on the card.
    assert t_serve.main(["--arch", "gemma-2b", "--device", "cpu"]) == 2
