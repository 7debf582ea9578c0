"""The port stands alone: no JAX, no ``repro``, and no silent CPU
fallback of its entry points."""

import ast
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

torch.set_num_threads(1)


def _port_modules():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_every_module_imports_without_jax_or_repro():
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {str(ROOT / "src")!r})
        for name in {_port_modules()!r}:
            importlib.import_module(name)
        sys.path.insert(0, {str(ROOT)!r})
        importlib.import_module("chip_smoke")
        # chip_smoke.py uses the tests' helpers on the card's machine.
        sys.path.insert(0, {str(ROOT / "tests")!r})
        importlib.import_module("torch_port_helpers")
        print("ok", len({_port_modules()!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_mentions_jax_or_repro_imports():
    pat = re.compile(r"^\s*(import (jax|repro)\b|from (jax|repro)(\.| ))", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card behaviour")


def test_every_new_module_is_covered():
    """The fault-path, geo, adaptive, serving, model, sharded/scalar,
    training, model-family and mesh-tooling slices' modules are among
    those imported above."""
    mods = set(_port_modules())
    for name in ("core.availability", "gossip", "gossip.digest", "gossip.scheduler",
                 "kernels.digest_compare", "kernels.histogram", "obs", "obs.metrics",
                 "geo", "geo.topology", "geo.placement", "policy", "policy.sla",
                 "kernels.placement_score", "kernels.policy_score", "kernels.fp",
                 "policy.controller", "serve", "serve.engine",
                 "kernels.session_floor", "configs", "configs.base",
                 "configs.registry", "configs.shapes", "configs.gemma_2b",
                 "models", "models.common", "models.mlp", "models.attention",
                 "models.transformer", "models.model_zoo", "kernels.flash_attention",
                 "launch", "launch.serve", "core.odg", "core.staleness",
                 "sync", "sync.compression", "sync.engine", "optim", "optim.adamw",
                 "data", "data.synthetic", "train", "train.train_step",
                 "train.trainer", "checkpoint", "checkpoint.store", "runtime",
                 "runtime.fault_tolerance", "runtime.elastic", "runtime.recovery",
                 "launch.train", "tree", "models.moe", "models.mamba2",
                 "models.hybrid", "models.rwkv6", "models.ssm_model", "models.encdec",
                 "models.sharding", "launch.mesh", "launch.roofline", "launch.dryrun"):
        assert f"repro_torch.{name}" in mods, name


# What each package's __init__ leaves out: names whose module is not
# ported yet, and the reference's JAX-only programs.
NOT_EXPORTED = {
    "core": set(),
    "engine": {"jit_entries", "unified_runner"},
    "storage": set(),
    "kernels": {"ref"},
    "obs": set(),
    "configs": set(),
    "serve": set(),
    "models": set(),
    "sync": set(),
    "optim": set(),
    "data": set(),
    "train": set(),
    "checkpoint": set(),
    "runtime": set(),
}


def _reference_exports(pkg: str) -> set[str]:
    """The names the reference's ``__init__`` imports (read, not imported)."""
    tree = ast.parse((ROOT / "src" / "repro" / pkg / "__init__.py").read_text())
    return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names}


@pytest.mark.parametrize("pkg", sorted(NOT_EXPORTED))
def test_package_surfaces_mirror_the_reference(pkg):
    import importlib

    mod = importlib.import_module(f"repro_torch.{pkg}")
    want = _reference_exports(pkg)
    assert NOT_EXPORTED[pkg] <= want
    missing = {n for n in want - NOT_EXPORTED[pkg] if not hasattr(mod, n)}
    assert not missing, f"repro_torch.{pkg} lacks {sorted(missing)}"
    assert not any(hasattr(mod, n) for n in NOT_EXPORTED[pkg])


def test_documented_imports_work():
    from repro_torch.engine import EngineConfig
    from repro_torch.obs import ObsConfig
    from repro_torch.storage import run_protocol

    assert callable(run_protocol) and EngineConfig and ObsConfig


@pytest.mark.parametrize("entry", ["run_protocol", "evaluate_level", "engine", "store",
                                   "run_protocol_faulty", "run_protocol_geo",
                                   "plan_placement", "run_protocol_adaptive",
                                   "level_session_telemetry", "adaptive_controller",
                                   "cadence_controller", "level_table",
                                   "serving_engine", "sharded_serving_router",
                                   "admit_batch", "model_init", "init_cache",
                                   "make_batch", "params_from_numpy", "serve_launcher",
                                   "run_protocol_sharded", "run_protocol_scalar",
                                   "sharded_store", "trainer", "sync_engine",
                                   "train_launcher", "checkpoint_store", "batch_at",
                                   "moe_init", "hybrid_init", "ssm_init", "audio_init",
                                   "family_cache", "family_serve_launcher"])
def test_entry_points_refuse_cpu_fallback(no_card, entry, tmp_path):
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core.consistency import ConsistencyLevel, policy_for
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.launch import train as train_launcher
    from repro_torch.optim import AdamWConfig
    from repro_torch.sync import SyncEngine
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.core.replicated_store import ReplicatedStore, ShardedStore
    from repro_torch.engine.config import EngineConfig
    from repro_torch.engine.replay import EpochEngine
    from repro_torch.geo import placement
    from repro_torch.geo.topology import PAPER_TOPOLOGY
    from repro_torch.policy import controller
    from repro_torch.policy.sla import SLA_RELAXED, level_table
    from repro_torch import configs, convert, serve
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import build_model
    from repro_torch.storage import simulator
    from repro_torch.storage.ycsb import PHASED_RW, WORKLOAD_A

    gemma = configs.reduced(configs.get_config("gemma-2b"))

    def family(arch):
        return build_model(configs.reduced(configs.get_config(arch)))

    calls = {
        "run_protocol": lambda: simulator.run_protocol(
            ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=50),
        "evaluate_level": lambda: simulator.evaluate_level(
            ConsistencyLevel.ONE, WORKLOAD_A, engine_ops=50),
        "engine": lambda: EpochEngine(EngineConfig(ConsistencyLevel.ALL)),
        "store": lambda: ReplicatedStore(3, 4, 4),
        "run_protocol_faulty": lambda: simulator.run_protocol_faulty(
            ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=50),
        "run_protocol_geo": lambda: simulator.run_protocol_geo(
            ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=50),
        "plan_placement": lambda: placement.plan_placement(
            PAPER_TOPOLOGY, np.ones((4, 3), np.float32), np.ones((4, 3), np.float32),
            SLA_RELAXED),
        "run_protocol_adaptive": lambda: simulator.run_protocol_adaptive(
            PHASED_RW, SLA_RELAXED, n_ops=64),
        "level_session_telemetry": lambda: simulator.level_session_telemetry(
            ConsistencyLevel.X_STCC, {k: np.zeros(64, np.int32) for k in (
                "client", "kind", "resource", "home")},
            n_clients=4, n_resources=4, epoch_size=64),
        "adaptive_controller": lambda: controller.AdaptiveController(4, SLA_RELAXED),
        "cadence_controller": lambda: controller.CadenceController(),
        "level_table": lambda: level_table(),
        "serving_engine": lambda: serve.ServingEngine(object()),
        "sharded_serving_router": lambda: serve.ShardedServingRouter(2, 4),
        "admit_batch": lambda: ReplicatedStore(2, 2, 1).admit_batch(
            None, client=[0], replica=[0], resource=[0]),
        "model_init": lambda: build_model(gemma).init(0),
        "init_cache": lambda: build_model(gemma).init_cache(1, 8),
        "make_batch": lambda: configs.make_batch(gemma, configs.TRAIN_4K),
        "params_from_numpy": lambda: convert.params_from_numpy({"w": np.ones(2)}),
        "serve_launcher": lambda: serve_launcher.main(["--arch", "gemma-2b", "--reduced"]),
        "run_protocol_sharded": lambda: simulator.run_protocol_sharded(
            ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=50),
        "run_protocol_scalar": lambda: simulator.run_protocol_scalar(
            ConsistencyLevel.X_STCC, WORKLOAD_A, n_ops=50),
        "sharded_store": lambda: ShardedStore(ReplicatedStore(3, 4, 4), 2),
        "trainer": lambda: Trainer(gemma, DataConfig(512, 16, 4), AdamWConfig(),
                                   policy_for("X_STCC"), TrainerConfig(n_pods=2)),
        "sync_engine": lambda: SyncEngine(policy_for("X_STCC"), 2),
        "train_launcher": lambda: train_launcher.main(["--arch", "gemma-2b", "--reduced"]),
        "checkpoint_store": lambda: CheckpointStore(str(tmp_path)),
        "batch_at": lambda: batch_at(DataConfig(512, 16, 4), 0),
        "moe_init": lambda: family("olmoe-1b-7b").init(0),
        "hybrid_init": lambda: family("zamba2-1.2b").init(0),
        "ssm_init": lambda: family("rwkv6-3b").init(0),
        "audio_init": lambda: family("whisper-large-v3").init(0),
        "family_cache": lambda: family("zamba2-1.2b").init_cache(1, 8),
        "family_serve_launcher": lambda: serve_launcher.main(
            ["--arch", "whisper-large-v3", "--reduced"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_admit_batch_never_falls_back_to_the_plain_version():
    """A CPU store asked for the card's kernel raises; it does not run
    the plain version instead."""
    from repro_torch.core.replicated_store import ReplicatedStore

    store = ReplicatedStore(2, 2, 1, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        store.admit_batch(store.init(), client=[0], replica=[0], resource=[0],
                          impl="cuda")
    assert store.admit_batch(store.init(), client=[0], replica=[0],
                             resource=[0])[2].tolist() == [True]


def test_chip_smoke_refuses_to_run_without_a_card(no_card, tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # Alone in a directory, it cannot find the program and fails too.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
