"""The port's meta-device dry run (``repro_torch.launch.dryrun``): exact
FLOPs of a reduced train cell, per-device state from the reference's
placements, one full-config cell per family, the CLI and
``launch.train --dry-run``, and the MoE dispatch on meta tensors."""

import dataclasses
import json

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import sharding as j_sharding
from repro_torch import configs as tc
from repro_torch.core.cost_model import PAPER_PRICING
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_launcher
from repro_torch.launch.train import train_state_bytes
from repro_torch.models import abstract_params, build_model, moe
from repro_torch.models.sharding import MeshShape

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(1)


class Args:
    policy, delta, compress, program, remat = "X_STCC", 8, "none", "sync", "full"


def test_reduced_train_cell_counts_the_closed_form():
    """Reduced qwen2-7b, B = 2, S = 32, no remat: forward 2·T·N_mm +
    4·B·H·S²·hd·L (N_mm: the projections, the MLP and the lm_head — the
    embedding lookup has no FLOPs), forward + backward three times that."""
    cfg = tc.reduced(tc.get_config("qwen2-7b"))
    assert cfg.remat == "none" and not cfg.tie_embeddings and cfg.mlp_kind == "swiglu"
    b, s = 2, 32
    d = cfg.d_model
    n_mm = cfg.n_layers * (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim + 3 * d * cfg.d_ff) \
        + d * cfg.vocab_size
    forward = 2 * (b * s) * n_mm + 4 * b * cfg.n_heads * s * s * cfg.head_dim * cfg.n_layers
    assert forward == 52_428_800
    res = dryrun.dry_run(cfg, tc.ShapeSpec("train_2x32", s, b, "train"),
                         MeshShape({"data": 1, "model": 1}), pricing=PAPER_PRICING,
                         program="local")
    assert res["status"] == "ok"
    assert res["flops"] == 3 * forward == 157_286_400
    assert res["roofline"]["flops_per_device"] == 157_286_400
    # On a 2 x 2 mesh every op of this config splits four ways (4 heads, 4
    # kv heads: "tp").
    res = dryrun.dry_run(cfg, tc.ShapeSpec("train_2x32", s, b, "train"),
                         MeshShape({"data": 2, "model": 2}), pricing=PAPER_PRICING,
                         program="local")
    assert res["attn_parallel_mode"] == "tp"
    assert res["roofline"]["flops_per_device"] == 157_286_400 / 4


def _reference_shard_bytes(cfg, axes: dict, itemsize: int | None = None,
                           pods: int = 0) -> int:
    """Σ over the reference's leaves of the shard its ``pspec_for_param``
    gives one device (with the ``(P, …)`` pod prefix when ``pods``), in
    ``itemsize``-byte elements (default: the leaf's dtype)."""
    tree = jax.eval_shape(j_build_model(cfg).init, jax.random.key(0))
    mesh = AbstractMesh(tuple(axes.values()), tuple(axes))
    j_sharding.set_mesh(mesh)
    try:
        total = 0
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            spec = j_sharding.pspec_for_param(
                tuple(str(getattr(k, "key", k)) for k in path), leaf.shape, cfg)
            shape, entries = tuple(leaf.shape), tuple(spec)
            if pods:
                shape, entries = (pods,) + shape, ("pod" if "pod" in axes else None,) + entries
            n = 1
            for i, dim in enumerate(shape):
                e = entries[i] if i < len(entries) else None
                split = 1
                for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
                    split *= axes[a]
                n *= -(-dim // split)
            total += n * (leaf.dtype.itemsize if itemsize is None else itemsize)
        return total
    finally:
        j_sharding.set_mesh(None)


@pytest.mark.parametrize("axes,pods", [({"pod": 2, "data": 16, "model": 16}, 2),
                                       ({"data": 16, "model": 16}, 1),
                                       ({"data": 1, "model": 1}, 2)],
                         ids=["multi", "single", "one_device_2_pods"])
def test_state_bytes_follow_the_reference_placements(axes, pods):
    """qwen2-7b at its published widths, 2 layers: parameters, AdamW's two
    moments (f32) with the pod prefix, one pod's gradients, the batch."""
    jcfg = dataclasses.replace(j_get_config("qwen2-7b"), n_layers=2)
    tcfg = dataclasses.replace(tc.get_config("qwen2-7b"), n_layers=2)
    b, s = 64, 16
    res = dryrun.dry_run(tcfg, tc.ShapeSpec("train_64x16", s, b, "train"), MeshShape(axes),
                         pods=pods, pricing=PAPER_PRICING, program="local")
    mem = res["memory"]
    assert mem["params_bytes"] == _reference_shard_bytes(jcfg, axes, pods=pods)
    assert mem["grads_bytes"] == _reference_shard_bytes(jcfg, axes)
    assert mem["opt_bytes"] == 2 * _reference_shard_bytes(jcfg, axes, 4, pods=pods)
    batch_split = axes["data"] * (axes.get("pod", 1))
    assert mem["batch_bytes"] == 2 * (b // batch_split) * s * 4
    assert mem["sync_bytes"] == 0
    assert mem["used_bytes_per_device"] == sum(
        mem[k] for k in ("params_bytes", "grads_bytes", "opt_bytes", "sync_bytes",
                         "batch_bytes"))
    assert mem["fits"] and mem["hbm_per_chip"] == 80e9
    if axes["data"] == 1:
        # One device holds every pod's state but one pod's gradients.
        grads = mem["grads_bytes"]
        assert mem["params_bytes"] + mem["opt_bytes"] + pods * grads == train_state_bytes(
            tcfg, pods)


@pytest.mark.parametrize("arch", ["gemma-2b", "olmoe-1b-7b", "internvl2-2b", "zamba2-1.2b",
                                  "rwkv6-3b", "whisper-large-v3"])
def test_one_full_config_cell_per_family_runs_on_meta(arch):
    res = dryrun.run_cell(arch, "decode_32k", "single", Args)
    assert res["status"] == "ok", res.get("traceback")
    r = res["roofline"]
    assert r["n_chips"] == 256 and r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert res["memory"]["fits"]
    assert res["depth"]["full_groups"] == dryrun.depth_info(tc.get_config(arch))[0]
    assert set(res["monetary_cost_1000_steps"]) >= {"total"}


def test_cli_writes_ok_and_skipped_cells(tmp_path):
    out = tmp_path / "dr"
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--mesh", "both",
                        "--out-dir", str(out)]) == 0
    for mk, chips, pods in (("single", 256, 1), ("multi", 512, 2)):
        res = json.loads((out / f"{mk}__gemma-2b__decode_32k.json").read_text())
        assert (res["status"], res["n_chips"], res["n_pods"]) == ("ok", chips, pods)
        assert res["rates"] == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 50e9}
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "long_500k",
                        "--out-dir", str(out)]) == 0
    res = json.loads((out / "single__gemma-2b__long_500k.json").read_text())
    assert res["status"] == "skipped" and "sub-quadratic" in res["reason"]


def test_train_launcher_dry_run_exits_zero(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert train_launcher.main(["--arch", "olmoe-1b-7b", "--dry-run"]) == 0
    for mk in ("single", "multi"):
        res = json.loads((tmp_path / "build" / "dryrun" /
                          f"{mk}__olmoe-1b-7b__train_4k.json").read_text())
        assert res["status"] == "ok" and res["program"] == "sync"
        assert (res["roofline"]["inter_pod_bytes"] > 0) == (mk == "multi")


def test_moe_dispatch_runs_on_meta():
    cfg = tc.reduced(tc.get_config("olmoe-1b-7b"))
    p = abstract_params(build_model(cfg))["moe_blocks"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.empty((2, 16, cfg.d_model), device="meta")
    y, aux = moe.moe(x, p, cfg)
    assert y.device.type == "meta" and tuple(y.shape) == (2, 16, cfg.d_model)
    assert aux.shape == ()
    probs = torch.empty((32, cfg.n_experts), device="meta")
    buf, se, st, sg, pos = moe._dispatch_local(x.reshape(32, -1), probs, cfg, 8)
    assert tuple(buf.shape) == (cfg.n_experts, 8, cfg.d_model)
