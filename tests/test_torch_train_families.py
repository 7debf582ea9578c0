"""Training of every arch in the port, on the CPU at the reduced sizes:
one ``sync_step`` for each of the ten archs (X_STCC, Δ = 2, int8, 2 pods:
the merge over expert stacks, SSM leaves and encoder blocks), the
``Trainer`` for the six MoE / VLM / hybrid / SSM / audio configurations
under ``torch_port_helpers.FAMILY_TRAIN_CASE``, zamba2's ``Trainer``
beside the reference's (whose SSD gradient is NaN, ROADMAP C), and
``launch.train`` with its refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tc
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy_for
from repro_torch.launch import train
from repro_torch.models import abstract_params, build_model
from repro_torch.models.common import count_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_fns, split_batch_for_pods
from repro_torch.tree import leaves
from torch_family_ref import reference_family_run
from torch_jax_cache import compile_cache  # noqa: F401  (autouse)
from torch_port_helpers import (FAMILY_ARCHS, FAMILY_TRAIN_CASE, family_inputs,
                                family_trainer, torch_batch)

torch.set_num_threads(1)
CPU = "cpu"
# An H100's memory as the card reports it (80 GB).
H100_BYTES = 85_031_714_816


@pytest.mark.parametrize("arch", tc.list_archs())
def test_sync_step_trains_every_arch(arch):
    """The reference's ``test_models_smoke.test_train_step`` with 2 pods
    and the int8 merge: finite loss and grad norm, parameters moved, the
    pods equal after the merge."""
    cfg = tc.reduced(tc.get_config(arch))
    fns = make_train_fns(build_model(cfg), AdamWConfig(lr=1e-3),
                         policy_for("X_STCC", delta_steps=2, compress_inter_pod="int8"),
                         n_pods=2, device=CPU)
    state = fns.init(0)
    before = [x.clone() for x in leaves(state.params)]
    batch = family_inputs(cfg, 4, 16, 1)
    batch["labels"] = batch["tokens"]
    state, metrics = fns.sync_step(state, split_batch_for_pods(torch_batch(batch, CPU), 2))
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert state.step == 1 and int(metrics["merges"]) == 1
    after = leaves(state.params)
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    assert all(torch.equal(x[0], x[1]) and bool(torch.isfinite(x).all()) for x in after)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_trainer_runs(arch):
    """Every step's loss and grad norm finite, a merge every second step;
    the VLM's image prefix and the audio frames split over the pods."""
    tr = family_trainer(arch, CPU)
    batch = tr.batch_for(0)
    cfg = tr.model_cfg
    assert batch["tokens"].shape == (2, 2, 16)
    if cfg.n_vis_tokens:
        assert batch["vis_embeds"].shape == (2, 2, cfg.n_vis_tokens, cfg.d_model)
    if cfg.is_encdec:
        assert batch["frames"].shape == (2, 2, cfg.n_frames, cfg.d_model)
    state = tr.run()
    assert [h["synced"] for h in tr.history] == [False, True, False, True]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in tr.history)
    assert int(state.sync.merges) == 2 and state.opt.count == 4


def test_zamba2_trains_where_the_reference_goes_nan():
    """The reference's ``Trainer`` on reduced zamba2: its first loss is
    finite and every grad norm NaN, so every later loss is NaN.  The port
    from the same parameters and batches matches that first loss and
    trains on, finite."""
    want = reference_family_run("zamba2-1.2b")
    assert np.isfinite(want["history"][0]["loss"])
    assert all(np.isnan(h["grad_norm"]) for h in want["history"])
    assert all(np.isnan(h["loss"]) for h in want["history"][1:])
    tr = family_trainer("zamba2-1.2b", CPU)
    tr.batch_for = lambda s: {k: torch.from_numpy(v.copy())
                              for k, v in want["batches"][s].items()}
    tr.run(tr.init_state(params_from_numpy(want["params0"], device=CPU)))
    np.testing.assert_allclose(tr.history[0]["loss"], want["history"][0]["loss"], rtol=1e-5)
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in tr.history)
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]


# ---- the launcher -------------------------------------------------------------------


def test_launch_train_runs_reduced_olmoe(capsys):
    level, pods, steps, kw = FAMILY_TRAIN_CASE
    assert train.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", CPU,
                       "--steps", str(steps), "--pods", str(pods), "--delta", "2",
                       "--compress", kw["compress_inter_pod"], "--seq", "16",
                       "--batch", "4"]) == 0
    out = capsys.readouterr().out
    assert "'synced': True" in out and "sync steps: 2" in out and "nan" not in out


def test_launch_train_refuses_state_beyond_the_card(capsys, monkeypatch):
    """Two pods' state of olmoe-1b-7b (154.7 GiB) and llama4-maverick
    exceed an H100; olmoe at 5 layers and the other families at full
    depth fit.  Past the memory check, the CPU refuses a full config."""
    monkeypatch.setattr(train, "device_memory", lambda dev: H100_BYTES)
    for arch in ("olmoe-1b-7b", "llama4-maverick-400b-a17b"):
        assert train.main(["--arch", arch, "--device", CPU, "--seq", "512",
                           "--batch", "4"]) == 2
        err = capsys.readouterr().err
        assert "training state of 2 pods" in err and "--reduced" in err, err
    olmoe = tc.get_config("olmoe-1b-7b")
    assert "154.7 GiB" in train.refusal(olmoe, seq=512, batch=4, pods=2, memory=H100_BYTES)
    assert train.refusal(dataclasses.replace(olmoe, n_layers=5), seq=512, batch=4, pods=2,
                         memory=H100_BYTES) is None
    for arch in ("zamba2-1.2b", "internvl2-2b", "whisper-large-v3", "rwkv6-3b"):
        assert train.refusal(tc.get_config(arch), seq=512, batch=4, pods=2,
                             memory=H100_BYTES) is None, arch
        assert train.main(["--arch", arch, "--device", CPU, "--seq", "512",
                           "--batch", "4"]) == 2
        assert "full config on CPU" in capsys.readouterr().err


@pytest.mark.parametrize("arch,argv,why", [
    ("internvl2-2b", ["--seq", "8"], "image prefix"),
    ("zamba2-1.2b", ["--seq", "24"], "chunks of 16"),
    ("rwkv6-3b", ["--seq", "200"], "chunks of 128"),
    ("olmoe-1b-7b", ["--batch", "3"], "does not split over 2 pods"),
], ids=["vlm-prefix", "hybrid-chunk", "ssm-chunk", "batch"])
def test_launch_train_refuses_shapes_the_model_cannot_take(arch, argv, why, capsys):
    assert train.main(["--arch", arch, "--reduced", "--device", CPU, "--steps", "1"]
                      + argv) == 2
    assert why in capsys.readouterr().err


def test_train_state_bytes_counts_params_grads_and_moments():
    cfg = tc.reduced(tc.get_config("olmoe-1b-7b"))
    n = cfg.param_count()
    assert train.train_state_bytes(cfg, 1) == n * (4 + 4 + 8)      # f32 params
    # zamba2 keeps its norms and SSM scalars in f32, the rest in bf16.
    full = tc.get_config("zamba2-1.2b")
    n = count_params(abstract_params(build_model(full)))
    assert 2 * n * (2 + 2 + 8) < train.train_state_bytes(full, 2) < 2 * n * (4 + 4 + 8)
    assert (train.train_state_bytes(full, 2) - train.train_state_bytes(full, 2, "bfloat16")
            == 2 * n * 4)
