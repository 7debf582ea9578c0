"""The port's roofline against the JAX reference's (``repro.launch.roofline``):
the ring wire model, every ``Roofline`` property with the reference's TPU
rates injected, ``model_flops_for`` and the dry run's ``depth_info``; and
the collectives ``collectives_for`` derives from the placements."""

import ast
import dataclasses
import pathlib

import pytest

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.configs import shapes as j_shapes
from repro.launch import roofline as jrl
from repro_torch import configs as tc
from repro_torch.core import policy_for
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as trl
from repro_torch.models import abstract_params, build_model, sharding
from repro_torch.sync import SyncEngine

from torch_jax_cache import compile_cache  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = list_archs()
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def _reference_depth_info():
    """The reference's ``depth_info``, read from its source: importing
    ``repro.launch.dryrun`` would set ``XLA_FLAGS`` to 512 host devices
    for the whole test process."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    fn = next(n for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "depth_info")
    scope = {"dataclasses": dataclasses}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), scope)
    return scope["depth_info"]


@pytest.mark.parametrize("kind", KINDS + ("send",))
def test_ring_wire_bytes_matches_reference(kind):
    for gs in range(1, 17):
        for ng, rb in ((1, 1), (3, 4096), (16, 123_456_789)):
            assert trl._ring_wire_bytes(kind, rb, gs, ng) == jrl._ring_wire_bytes(
                kind, rb, gs, ng), (kind, gs, ng, rb)


ROOFS = [
    dict(flops_per_device=1.97e14, bytes_per_device=3e11, collective_bytes_total=5e12,
         inter_pod_bytes=1e12, intra_pod_bytes=4e12, n_chips=512, model_flops=4e16),
    dict(flops_per_device=3.5e12, bytes_per_device=8.19e12, collective_bytes_total=0.0,
         inter_pod_bytes=0.0, intra_pod_bytes=0.0, n_chips=256),
    dict(flops_per_device=0.0, bytes_per_device=0.0, collective_bytes_total=0.0,
         inter_pod_bytes=0.0, intra_pod_bytes=0.0, n_chips=1, model_flops=0.0),
    dict(flops_per_device=1e9, bytes_per_device=1e6, collective_bytes_total=9e15,
         inter_pod_bytes=9e15, intra_pod_bytes=0.0, n_chips=16, model_flops=2e10),
]
PROPS = ("compute_s", "memory_s", "collective_s", "dominant", "step_time_s",
         "useful_flops_fraction", "mfu")


@pytest.mark.parametrize("i", range(len(ROOFS)))
def test_roofline_matches_reference_with_its_rates(i):
    want = jrl.Roofline(**ROOFS[i])
    got = trl.Roofline(**ROOFS[i], peak_flops=jrl.PEAK_FLOPS, hbm_bw=jrl.HBM_BW,
                       link_bw=jrl.ICI_BW)
    for p in PROPS:
        assert getattr(got, p) == getattr(want, p), p
    assert got.as_dict() == want.as_dict()


def test_roofline_defaults_are_the_h100s():
    r = trl.Roofline(**ROOFS[0])
    assert (r.peak_flops, r.hbm_bw, r.link_bw) == (989e12, 3.35e12, 50e9)
    assert r.compute_s == ROOFS[0]["flops_per_device"] / 989e12
    assert r.collective_s == ROOFS[0]["collective_bytes_total"] / (512 * 50e9)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_depth_info_match_reference(arch):
    jcfg, tcfg = j_get_config(arch), tc.get_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert trl.model_flops_for(tcfg, tc.SHAPES_BY_NAME[name]) == jrl.model_flops_for(
            jcfg, j_shapes.SHAPES_BY_NAME[name]), name
    j_full, j_mk = _reference_depth_info()(jcfg)
    t_full, t_mk = dryrun.depth_info(tcfg)
    assert t_full == j_full
    for g in (1, 2, j_full):
        a, b = j_mk(g), t_mk(g)
        assert (b.n_layers, b.n_encoder_layers) == (a.n_layers, a.n_encoder_layers), g
        assert b.param_count() == a.param_count()


def _iota_line(axes: dict, group: tuple) -> str:
    """The replica groups XLA prints for a collective over ``group``."""
    names = list(axes)
    inner = [names.index(a) for a in group]
    outer = [i for i in range(len(names)) if i not in inner]
    n = 1
    for v in axes.values():
        n *= v
    gs = 1
    for i in inner:
        gs *= axes[names[i]]
    dims = ",".join(str(v) for v in axes.values())
    perm = ",".join(str(i) for i in outer + inner)
    return f"replica_groups=[{n // gs},{gs}]<=[{dims}]T({perm})"


@pytest.mark.parametrize("group", [("data",), ("model",), ("pod",), ("data", "model"),
                                   ("pod", "data")])
def test_device_groups_match_the_reference_parse(group):
    for axes in ({"pod": 2, "data": 16, "model": 16}, {"pod": 4, "data": 2, "model": 2}):
        pod_size = 16 * 16 if axes["data"] == 16 else 4
        want = jrl._parse_groups(_iota_line(axes, group), pod_size)
        assert trl.device_groups(axes, group) == want


def test_collectives_for_a_sync_step():
    """The single mesh never leaves a pod; on the pod mesh only the merge
    does, and its wire bytes are the engine's."""
    cfg = tc.get_config("qwen2-7b")
    params = abstract_params(build_model(cfg))
    for multi in (False, True):
        axes = {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16}
        mesh = sharding.MeshShape(axes)
        engine = SyncEngine(policy_for("X_STCC", delta_steps=8), 2, device="meta")
        stacked = {k: v.expand((2,) + tuple(v.shape)) for k, v in _flat(params).items()}
        payload = engine.payload_bytes(stacked)
        wire = engine.merge_wire_bytes(payload)
        colls = trl.collectives_for(params, cfg, mesh, kind="train", rows=8 * 4096,
                                    remat="full", attn_mode="dp",
                                    merge=("all-reduce", payload / 256, wire))
        spans = [c for c in colls if c.spans_pods]
        assert sum(c.wire_bytes for c in spans) == (wire if multi else 0.0)
        assert all(c.wire_bytes == trl._ring_wire_bytes(c.kind, c.result_bytes,
                                                         c.group_size, c.n_groups)
                   for c in colls[:-1])
        kinds = {c.kind for c in colls[:-1]}
        assert kinds == {"all-gather", "reduce-scatter", "all-reduce"}
        # dp attention: the only model-axis all-reduces are the MLP's, three
        # per layer under remat (forward, recompute, backward).
        tp = [c for c in colls if c.kind == "all-reduce" and c.group_size == 16
              and c.result_bytes == 8 * 4096 * cfg.d_model * 2]
        assert len(tp) == 3 * cfg.n_layers
    # Serving without FSDP: no gathers, one all-reduce per MLP application.
    serve = dataclasses.replace(cfg, fsdp_params=False)
    colls = trl.collectives_for(params, serve, sharding.MeshShape({"data": 16, "model": 16}),
                                kind="decode", rows=8, attn_mode="dp")
    assert [c.kind for c in colls] == ["all-reduce"] * cfg.n_layers
    assert {(c.result_bytes, c.group_size, c.n_groups, c.spans_pods) for c in colls} == {
        (8 * cfg.d_model * 2, 16, 16, False)}


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = v
    return out
