"""Training step construction: per-pod local steps + policy merges (port
of ``repro.train.train_step``).

``make_train_fns`` returns two step functions over pod-stacked state
(leaves carry a leading ``(n_pods, ...)`` replica dim):

  * ``local_step``  — per-pod grad + AdamW; zero inter-pod comm.
  * ``sync_step``   — local step followed by the consistency merge.

Each pod's gradient is one autograd pass over that pod's slice of the
stacked parameters (the reference ``vmap``s the pods), and the pods run
one after another, so only one pod's gradients and activations are live
at a time.  The step functions update the state's tensors in place and
return it: the state is donated, as the reference's jitted trainer
donates it.

Optimizer moments deliberately stay pod-local between merges (the
DiLoCo-style choice): the paper's protocol replicates the *data* (here:
parameters), not the optimizer's private scratch state.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.consistency import ConsistencyPolicy
from repro_torch.device import resolve_device
from repro_torch.kernels.fp import div_f32
from repro_torch.models.model_zoo import Model, abstract_params
from repro_torch.models.sharding import refuse_dtensors
from repro_torch.optim import adamw
from repro_torch.sync.engine import SyncEngine, SyncState
from repro_torch.tree import leaves, tree_map


class TrainState(NamedTuple):
    params: Any       # pod-stacked tree
    opt: adamw.AdamWState
    sync: SyncState
    step: int


class TrainFns(NamedTuple):
    init: Callable[..., TrainState]
    local_step: Callable[..., tuple[TrainState, dict]]
    sync_step: Callable[..., tuple[TrainState, dict]]
    engine: SyncEngine


def stack_for_pods(tree, n_pods: int):
    """Each leaf repeated along a new leading pod dim (materialized: the
    pods' copies diverge between merges)."""
    return tree_map(lambda x: x[None].repeat((n_pods,) + (1,) * x.dim()), tree)


def _index(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def make_train_fns(
    model: Model,
    opt_cfg: adamw.AdamWConfig,
    policy: ConsistencyPolicy,
    n_pods: int,
    device="cuda",
) -> TrainFns:
    n_pods = max(1, n_pods)
    dev = resolve_device(device)
    stacked_template = tree_map(
        lambda s: torch.empty((n_pods,) + tuple(s.shape), dtype=s.dtype, device="meta"),
        abstract_params(model))
    engine = SyncEngine(policy, n_pods, params_template=stacked_template, device=dev)

    def init(seed_or_gen=0, params=None) -> TrainState:
        """The state from ``model.init(seed_or_gen)`` on the device, or from
        ``params`` (one pod's tree; moved to the device).  DTensor
        parameters raise ``NotImplementedError`` (ROADMAP A.2), as do the
        step functions on a DTensor state."""
        refuse_dtensors(params or {}, "make_train_fns' init")
        if params is None:
            params = model.init(seed_or_gen, dev)
        else:
            params = tree_map(lambda x: x.to(dev), params)
        stacked = stack_for_pods(params, n_pods)
        del params
        return TrainState(
            params=stacked,
            opt=adamw.init(stacked, opt_cfg),
            sync=engine.init_state(stacked),
            step=0,
        )

    def one_pod(params, mu, nu, count, batch):
        """Gradient and AdamW update of one pod's slice, in place."""
        wrt = tree_map(lambda x: x.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, _ = model.loss(wrt, batch)
        grads = iter(torch.autograd.grad(loss, leaves(wrt)))
        gtree = tree_map(lambda _: next(grads), wrt)
        del wrt
        _, new_opt, om = adamw.apply(params, gtree, adamw.AdamWState(mu, nu, count),
                                     opt_cfg)
        return new_opt.count, loss.detach(), om

    def local_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        refuse_dtensors(state.params, "local_step / sync_step")
        losses, norms, count, lr = [], [], state.opt.count, None
        for p in range(n_pods):
            pod_batch = {k: v[p] for k, v in batch.items()}
            new_count, loss, om = one_pod(_index(state.params, p), _index(state.opt.mu, p),
                                          _index(state.opt.nu, p), state.opt.count,
                                          pod_batch)
            count, lr = new_count, om["lr"]
            losses.append(loss)
            norms.append(om["grad_norm"])
        new_state = TrainState(
            params=state.params,
            opt=adamw.AdamWState(mu=state.opt.mu, nu=state.opt.nu, count=count),
            sync=state.sync,
            step=state.step + 1,
        )
        metrics = {
            "loss": div_f32(torch.sum(torch.stack(losses)), n_pods),
            "grad_norm": div_f32(torch.sum(torch.stack(norms)), n_pods),
            "lr": lr,
        }
        return new_state, metrics

    def sync_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        state, metrics = local_step(state, batch)
        with torch.no_grad():
            new_params, new_sync = engine.merge(state.params, state.sync)
        state = state._replace(params=new_params, sync=new_sync)
        metrics = dict(
            metrics,
            merges=new_sync.merges,
            inter_pod_gb=new_sync.inter_pod_gb,
            violations=new_sync.violations,
            severity=new_sync.severity,
        )
        return state, metrics

    return TrainFns(init=init, local_step=local_step, sync_step=sync_step,
                    engine=engine)


def split_batch_for_pods(batch: dict, n_pods: int) -> dict:
    """(B, ...) -> (n_pods, B/n_pods, ...)."""
    def sp(x):
        b = x.shape[0]
        if b % n_pods:
            raise ValueError(f"batch {b} not divisible by {n_pods} pods")
        return x.reshape((n_pods, b // n_pods) + tuple(x.shape[1:]))

    return {k: sp(v) if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0 else v
            for k, v in batch.items()}
