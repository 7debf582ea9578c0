"""Elastic scaling: change the pod count without losing replica state
(port of ``repro.runtime.elastic``).

Because replicas are an explicit leading dimension, rescaling is a pure
tensor operation on the train state:

  * grow  (P -> P'): new pods bootstrap from the deterministic causal
    merge of the survivors (they join with the merged snapshot and a
    zeroed session — exactly a new client in the paper's protocol);
  * shrink (P -> P'): departing pods' un-merged deltas are folded into
    the survivors via one final merge (their writes are not lost — MW
    holds across the membership change).

The rebuilt engine has no params template, as in the reference, so its
``inter_pod_gb`` does not grow after a rescale.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fp import div_f32
from repro_torch.sync.engine import SyncEngine
from repro_torch.tree import tree_map


def _rescale(x: torch.Tensor, new_pods: int) -> torch.Tensor:
    p = x.shape[0]
    if new_pods == p:
        return x
    x32 = x.to(torch.float32)
    merged = div_f32(torch.sum(x32, dim=0, keepdim=True), p)
    if new_pods > p:
        extra = merged.expand((new_pods - p,) + tuple(x.shape[1:])).to(x.dtype)
        return torch.cat([x, extra], dim=0)
    # shrink: fold departing deltas into the survivors.
    departing = torch.sum(x32[new_pods:], dim=0, keepdim=True)
    correction = div_f32(departing - (p - new_pods) * merged, new_pods)
    return (x32[:new_pods] + correction).to(x.dtype)


def rescale_stacked(tree, new_pods: int):
    """Resize the leading replica dim of a pod-stacked tree."""
    return tree_map(lambda x: _rescale(x, new_pods), tree)


def rescale_train_state(state, engine: SyncEngine, new_pods: int):
    """Remap a TrainState to a new pod count (fresh sync bookkeeping —
    membership change resets sessions, as in the paper's model where a
    new client starts with a zero clock)."""
    from repro_torch.train.train_step import TrainState

    new_params = rescale_stacked(state.params, new_pods)
    new_opt = state.opt._replace(
        mu=rescale_stacked(state.opt.mu, new_pods),
        nu=rescale_stacked(state.opt.nu, new_pods),
    )
    new_engine = SyncEngine(engine.policy, new_pods, device=engine.device)
    return TrainState(
        params=new_params,
        opt=new_opt,
        sync=new_engine.init_state(new_params),
        step=state.step,
    ), new_engine
