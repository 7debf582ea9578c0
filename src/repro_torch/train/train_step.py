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

On a ``DeviceMesh`` the state is DTensors (:func:`distribute_state`, or
``init`` under ``sharding.use_mesh(mesh)``), placed as the reference's
dry run places it.  The pod loop then runs on each rank only the pods
its 'pod' coordinate holds (every pod on a mesh without a pod axis),
each pod's slice a DTensor on the mesh without its pod axis, sharded over
'data' / 'model' by the parameter rules; the gradients are placed as
their parameters before AdamW, and the metrics' per-pod losses and norms
are gathered over 'pod'.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.consistency import ConsistencyPolicy
from repro_torch.device import resolve_device
from repro_torch.kernels.fp import div_f32
from repro_torch.models.model_zoo import Model, abstract_params
from repro_torch.models import sharding
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


def _index(tree, j: int):
    """Row ``j`` of this rank's pod rows of every leaf (a view; on DTensor
    leaves a DTensor on the mesh without its pod axis, never gathered)."""
    return tree_map(lambda x: sharding.pod_slice(x, j), tree)


def _first(tree):
    return leaves(tree)[0]


def distribute_state(state: TrainState, cfg, mesh=None) -> TrainState:
    """``state`` (plain tensors, every rank holding the whole) placed on
    ``mesh`` (default: the active mesh; a ``DeviceMesh``) as the
    reference's dry run places it: parameters and AdamW moments
    ``P("pod" if the mesh has a pod axis else None, *pspec_for_param)``;
    the compression anchor placed as one pod's parameters and the top-k
    residual as the parameters (ROADMAP C: each rank merges its own
    block); the store's clocks, DUOT and counters replicated (every rank
    holds them whole); ``count`` and ``step`` host integers.  Each rank
    keeps only its blocks.  The identity off a ``DeviceMesh``."""
    with sharding.use_mesh(sharding.get_mesh() if mesh is None else mesh):
        place = lambda t, pods=True: None if t is None else sharding.distribute_pods(
            t, cfg, pods)
        return state._replace(
            params=place(state.params),
            opt=state.opt._replace(mu=place(state.opt.mu), nu=place(state.opt.nu)),
            sync=state.sync._replace(anchor=place(state.sync.anchor, False),
                                     residual=place(state.sync.residual)),
        )


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
        ``params`` (one pod's tree of plain tensors, or DTensors made whole
        first; moved to the device).  Under ``sharding.use_mesh`` of a
        ``DeviceMesh`` the state is placed there (:func:`distribute_state`)."""
        if params is None:
            params = model.init(seed_or_gen, dev)
        else:
            params = tree_map(lambda x: (x.full_tensor() if sharding.is_dtensor(x) else x)
                              .to(dev), params)
        stacked = stack_for_pods(params, n_pods)
        del params
        state = TrainState(
            params=stacked,
            opt=adamw.init(stacked, opt_cfg),
            sync=engine.init_state(stacked),
            step=0,
        )
        return distribute_state(state, model.cfg)

    def one_pod(params, mu, nu, count, batch):
        """Gradient and AdamW update of one pod's slice, in place (DTensor
        slices under their own mesh)."""
        placed = sharding.is_dtensor(_first(params))
        wrt = tree_map(lambda x: x.detach().requires_grad_(), params)
        with (sharding.use_mesh(_first(wrt).device_mesh) if placed
              else contextlib.nullcontext()):
            with torch.enable_grad(), sharding.spmd(wrt):
                loss, _ = model.loss(wrt, batch)
                if placed:
                    loss = sharding.replicate(loss)
                grads = iter(torch.autograd.grad(loss, leaves(wrt)))
            gtree = tree_map(lambda _: next(grads), wrt)
            del wrt
            _, new_opt, om = adamw.apply(params, gtree, adamw.AdamWState(mu, nu, count),
                                         opt_cfg)
        return new_opt.count, sharding.local(loss.detach()), om

    def local_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        losses, norms, count, lr = [], [], state.opt.count, None
        lead = _first(state.params)
        for j, p in enumerate(sharding.pod_rows(lead)):
            pod_batch = {k: v[p] for k, v in batch.items()}
            new_count, loss, om = one_pod(_index(state.params, j), _index(state.opt.mu, j),
                                          _index(state.opt.nu, j), state.opt.count,
                                          pod_batch)
            count, lr = new_count, om["lr"]
            losses.append(loss)
            norms.append(om["grad_norm"])
        losses = sharding.pod_gather(torch.stack(losses), lead)
        norms = sharding.pod_gather(torch.stack(norms), lead)
        new_state = TrainState(
            params=state.params,
            opt=adamw.AdamWState(mu=state.opt.mu, nu=state.opt.nu, count=count),
            sync=state.sync,
            step=state.step + 1,
        )
        metrics = {
            "loss": div_f32(torch.sum(losses), n_pods),
            "grad_norm": div_f32(torch.sum(norms), n_pods),
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
