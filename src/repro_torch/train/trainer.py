"""Training loop: policy-dispatched stepping, checkpointing, recovery
(port of ``repro.train.trainer``).

The trainer dispatches the two step functions (local / sync) by the
policy period; everything stateful (params, optimizer, protocol
bookkeeping) lives in the :class:`TrainState`, so failure recovery =
restore state + replay the deterministic data stream from the restored
step.

Attention trains through the plain masked attention, as the reference
does (its ``use_flash_kernel=False``): the hand-written attention kernel
(B.8) has no backward, so a config that asks for it is refused here.

Under ``sharding.use_mesh`` of a ``DeviceMesh`` the state is DTensors
(``train_step.distribute_state``): ``init_state`` and
``restore_checkpoint`` place it on the active mesh, and a checkpoint
holds pod 0's parameters made whole on every rank, so the store sees
plain tensors.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.consistency import ConsistencyPolicy
from repro_torch.data import DataConfig, batch_at, extra_inputs
from repro_torch.device import resolve_device
from repro_torch.models import abstract_params, build_model, sharding
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train.train_step import (
    TrainFns,
    TrainState,
    distribute_state,
    make_train_fns,
    split_batch_for_pods,
    stack_for_pods,
)
from repro_torch.tree import tree_map


@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 100
    n_pods: int = 1
    log_every: int = 10
    ckpt_every: int = 0            # 0 = no checkpointing
    seed: int = 0
    jit: bool = True               # the reference's jit switch; no effect here


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        data_cfg: DataConfig,
        opt_cfg: AdamWConfig,
        policy: ConsistencyPolicy,
        tcfg: TrainerConfig,
        ckpt_store=None,
        ckpt_session=None,
        health=None,
        device="cuda",
    ):
        if model_cfg.use_flash_kernel:
            raise ValueError(
                f"{model_cfg.name}: use_flash_kernel=True cannot train: the "
                "attention kernel has no backward (the reference trains with "
                "use_flash_kernel=False, through the plain attention)")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.policy = policy
        self.tcfg = tcfg
        self.model = build_model(model_cfg)
        self.fns: TrainFns = make_train_fns(
            self.model, opt_cfg, policy, tcfg.n_pods, device=self.device
        )
        self.ckpt_store = ckpt_store
        self.ckpt_session = ckpt_session
        self.health = health
        self._local = self.fns.local_step
        self._sync = self.fns.sync_step
        self.history: list[dict] = []

    # -- data ------------------------------------------------------------------

    def batch_for(self, step: int) -> dict:
        batch = batch_at(self.data_cfg, step, device=self.device)
        batch.update(extra_inputs(self.model_cfg, self.data_cfg.global_batch, step,
                                  device=self.device))
        return split_batch_for_pods(batch, self.tcfg.n_pods)

    # -- loop ------------------------------------------------------------------

    def init_state(self, params=None) -> TrainState:
        """From the model's own init (seeded with ``tcfg.seed``), or from
        ``params``, one pod's tree (the reference's, converted); placed on
        the active ``DeviceMesh``, if any."""
        return self.fns.init(self.tcfg.seed, params=params)

    def is_sync_step(self, step: int) -> bool:
        return (step + 1) % self.fns.engine.policy.inter_pod_period() == 0

    def run(self, state: TrainState | None = None, start_step: int = 0):
        state = self.init_state() if state is None else state
        for step in range(start_step, self.tcfg.n_steps):
            batch = self.batch_for(step)
            fn = self._sync if self.is_sync_step(step) else self._local
            t0 = time.perf_counter()
            state, metrics = fn(state, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            if (step % max(1, self.tcfg.log_every)) == 0 or step == self.tcfg.n_steps - 1:
                rec = {
                    "step": step,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "sec": dt,
                    "synced": self.is_sync_step(step),
                }
                if "inter_pod_gb" in metrics:
                    rec["inter_pod_gb"] = float(metrics["inter_pod_gb"])
                    rec["violations"] = int(metrics["violations"])
                    rec["severity"] = float(metrics["severity"])
                self.history.append(rec)
            if (
                self.ckpt_store is not None
                and self.tcfg.ckpt_every
                and (step + 1) % self.tcfg.ckpt_every == 0
            ):
                self.save_checkpoint(state, step + 1)
        return state

    # -- checkpoint / recovery ---------------------------------------------------

    def save_checkpoint(self, state: TrainState, step: int) -> int:
        merged = tree_map(lambda x: _whole(sharding.pod_row(x, 0)), state.params)
        return self.ckpt_store.save(merged, step, self.ckpt_session)

    def restore_checkpoint(self) -> tuple[TrainState, int]:
        """The state from the newest checkpoint (pod 0's parameters on every
        pod, fresh moments and sync state), placed on the active
        ``DeviceMesh``, if any, as ``init_state`` places it."""
        template = abstract_params(self.model)
        params, version, _ = self.ckpt_store.restore(template, self.ckpt_session)
        meta_step = 0
        for r in range(self.ckpt_store.n_replicas):
            e = self.ckpt_store._read_meta(r)["entries"].get(str(version))
            if e:
                meta_step = e["step"]
                break
        params = tree_map(lambda x: x.to(self.device), params)
        stacked = stack_for_pods(params, self.tcfg.n_pods)
        del params
        opt = adamw.init(stacked, self.opt_cfg)._replace(count=int(meta_step))
        state = TrainState(
            params=stacked,
            opt=opt,
            sync=self.fns.engine.init_state(stacked),
            step=int(meta_step),
        )
        return distribute_state(state, self.model_cfg), meta_step


def _whole(x):
    """A DTensor gathered on every rank; a plain tensor as it is."""
    return x.full_tensor() if sharding.is_dtensor(x) else x
