"""AdamW with dtype-configurable state (port of ``repro.optim.adamw``).

``apply`` keeps the reference's f32 operation order leaf by leaf: the
moments as ``b1·m + (1-b1)·g`` and ``b2·v + (1-b2)·g²`` in f32, stored in
``state_dtype``; the bias-corrected step ``m̂ / (√v̂ + eps)``; decoupled
weight decay only for leaves with ndim ≥ 2; the parameter cast back to
its dtype.  The scalars of a step (learning rate, bias corrections) are
f32 values computed on the host, so a step never waits for the device.

Unlike the reference's functional ``apply``, the port writes the new
parameters and moments into the tensors it is given and returns them: a
full-width model's parameters and moments are never held twice.

DTensor leaves (training on a ``DeviceMesh``): the global norm is the one
norm of the whole tree on every rank (each leaf's sum of squares over its
local block, all-reduced over the mesh dimensions that shard it), and
the update runs in place on each leaf's local block, the gradient first
placed as its parameter (its partial sums reduced).  Weight decay keeps
the ``ndim >= 2`` rule, which the global and the local shapes share.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.kernels.fp import div_f32
from repro_torch.models import sharding
from repro_torch.tree import leaves, tree_map

Tensor = torch.Tensor
_F32 = torch.float32


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    mu: Any       # tree like params
    nu: Any
    count: int    # steps taken (the reference's () int32, kept on the host)


def init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments placed as ``params`` (DTensor leaves: each rank's
    block)."""
    dt = getattr(torch, cfg.state_dtype)
    z = lambda p: sharding.map_local(
        lambda b: torch.zeros(b.shape, dtype=dt, device=b.device), p)
    return AdamWState(mu=tree_map(z, params), nu=tree_map(z, params), count=0)


def _f32(x: float) -> Tensor:
    return torch.tensor(x, dtype=_F32)


def schedule(cfg: AdamWConfig, step) -> float:
    """Linear warmup + cosine decay to min_lr_ratio: the reference's f32
    arithmetic on the host.  Its ``cos`` may differ from XLA's in the
    last bit."""
    step = torch.as_tensor(step).to(_F32).cpu()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return float(cfg.lr * warm * frac)


def _bias_correction(b: float, count: int) -> float:
    """``1 - b ** count`` in f32 (the reference's ``jnp.power``; its XLA
    implementation may differ in the last bit)."""
    return float(1.0 - torch.pow(_f32(b), float(count)))


def global_norm(tree) -> Tensor:
    """The norm of the whole tree, a plain scalar (the same on every rank
    for DTensor leaves: each leaf's local sum of squares is all-reduced
    over the mesh dimensions that shard it)."""
    sq = [sharding.shards_reduce(torch.sum(torch.square(sharding.local(x).to(_F32))), x)
          for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float) -> tuple[Any, Tensor]:
    norm = global_norm(grads)
    ceiling = torch.full((), max_norm, dtype=_F32, device=norm.device)
    scale = torch.clamp(ceiling / torch.clamp(norm, min=1e-9), max=1.0)
    clip = lambda g: sharding.map_local(lambda b: (b.to(_F32) * scale).to(b.dtype), g)
    return tree_map(clip, grads), norm


def _update(p: Tensor, g: Tensor, m: Tensor, v: Tensor, cfg: AdamWConfig,
            lr: float, b1c: float, b2c: float) -> None:
    """One leaf, in place.  Temporaries are reused where the reference's
    operation order allows it (each op still rounds once, as there)."""
    g32 = g.to(_F32)
    m32 = m if m.dtype == _F32 else m.to(_F32)
    m32.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    v32 = v if v.dtype == _F32 else v.to(_F32)
    v32.mul_(cfg.b2).add_(torch.square(g32).mul_(1 - cfg.b2))
    del g32
    step = div_f32(m32, b1c)
    den = div_f32(v32, b2c).sqrt_().add_(cfg.eps)
    step.div_(den)
    if p.dim() >= 2:
        step.add_(den.copy_(p).mul_(cfg.weight_decay))
    del den
    step.mul_(lr)
    if p.dtype == _F32:
        p.sub_(step)
    else:
        p.copy_(p.to(_F32).sub_(step))
    if m32 is not m:
        m.copy_(m32)
    if v32 is not v:
        v.copy_(v32)


def apply(params, grads, state: AdamWState, cfg: AdamWConfig) -> tuple[Any, AdamWState, dict]:
    """One AdamW step, in place.  Returns (params, new_state, metrics).
    DTensor leaves update their local blocks (each gradient placed as its
    parameter first); ``grad_norm`` is the whole tree's."""
    grads = tree_map(sharding.placed_like, grads, params)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = _bias_correction(cfg.b1, count)
    b2c = _bias_correction(cfg.b2, count)
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                              leaves(state.nu)):
            _update(*map(sharding.local, (p, g, m, v)), cfg, lr, b1c, b2c)
    return (
        params,
        AdamWState(mu=state.mu, nu=state.nu, count=count),
        {"grad_norm": gnorm, "lr": lr},
    )
