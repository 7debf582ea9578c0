"""Mixture-of-Experts layer with sort-based dispatch (port of
``repro.models.moe``).

Used by olmoe-1b-7b (64 experts, top-8) and llama4-maverick (128
experts, top-1 + a shared expert, on alternate layers).

The reference runs dispatch and combine inside ``shard_map`` over the
mesh's data axis when it has one, with a capacity per data shard; that
per-shard dispatch is not ported yet (it waits for the mesh's
collectives).  The port runs the reference's ``shards == 1`` branch: one
capacity over all ``T`` tokens, with no host read, so the layer also
runs on meta tensors (the dry run).  Three rules are explicit here where
the reference relies on XLA's:

  * the top-k keeps the lower expert index first among equal
    probabilities (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none on CUDA), through ``sync.compression.topk_index``;
  * the slots are sorted by expert with a stable sort (``jnp.argsort``
    is stable), which decides the tokens an expert's capacity drops;
  * the combine gathers each token's ``k`` slots and adds them one after
    another in ascending expert order, the order of the reference's
    scatter-add over the sorted slots, instead of an ``index_add_``
    whose atomic order on CUDA would change from run to run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import fan_in_init, normal_init
from repro_torch.models.mlp import init_mlp_params, mlp
from repro_torch.sync.compression import topk_index

Tensor = torch.Tensor


def init_moe_params(gen: torch.Generator | None, cfg, dtype,
                    stack: tuple[int, ...] = ()) -> dict:
    """``stack`` prefixes every leaf with layer dims (one draw per leaf)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": normal_init(gen, stack + (d, e), dtype, scale=d ** -0.5),
        "expert_gate": fan_in_init(gen, stack + (e, d, ff), dtype),
        "expert_up": fan_in_init(gen, stack + (e, d, ff), dtype),
        "expert_down": fan_in_init(gen, stack + (e, ff, d), dtype),
    }
    if cfg.shared_expert:
        p["shared"] = init_mlp_params(gen, d, ff, dtype, cfg.mlp_kind, stack)
    return p


def capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens: ``max(1, int(cf * t * k / E))``
    in the host's float arithmetic, rounded up to a multiple of 8, at
    least 8 (``moe.py:122-123`` of the reference)."""
    c = max(1, int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts))
    return max(8, (c + 7) // 8 * 8)


def _route(probs: Tensor, cfg) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """probs (T, E) -> the slots sorted by expert: ``(expert, token, gate,
    position in the expert's queue)``, each (T * k,); indices int64."""
    k, e = cfg.top_k, cfg.n_experts
    t = probs.shape[0]
    expert_ids = topk_index(probs, k)                           # (T, k)
    gate_vals = torch.gather(probs, 1, expert_ids)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat_expert = expert_ids.reshape(t * k)
    flat_gate = gate_vals.reshape(t * k)
    flat_token = torch.arange(t, device=probs.device).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], flat_gate[order]
    first = torch.searchsorted(se, torch.arange(e, device=probs.device))
    pos = torch.arange(t * k, device=probs.device) - first[se]
    return se, st, sg, pos


def _dispatch_local(xt: Tensor, probs: Tensor, cfg, capacity: int):
    """xt (T, D), probs (T, E) -> ``(buf (E, C, D), se, st, sg, pos)``.
    A slot at ``pos >= capacity`` is dropped: it is written to a spare row
    ``C`` that the returned view leaves out, never clamped into the
    buffer.  No mask is read on the host, so the dispatch runs on meta
    tensors and never waits for the device."""
    se, st, sg, pos = _route(probs, cfg)
    buf = xt.new_zeros((cfg.n_experts, capacity + 1, xt.shape[-1]))
    buf[se, torch.clamp(pos, max=capacity)] = xt[st]
    return buf[:, :capacity], se, st, sg, pos


def _combine_local(out_buf: Tensor, se, st, sg, pos, t_loc: int, capacity: int,
                   dtype) -> Tensor:
    """out_buf (E, C, D) -> yt (T, D): each token's gated expert outputs,
    its dropped slots zero, added one after another in ascending expert
    order (deterministic on any device)."""
    k = se.numel() // t_loc
    by_token = torch.argsort(st, stable=True)       # each token's slots, by expert
    e_t, p_t, g_t = se[by_token], pos[by_token], sg[by_token]
    gathered = out_buf[e_t, torch.clamp(p_t, max=capacity - 1)]
    contrib = torch.where((p_t < capacity)[:, None], gathered * g_t[:, None].to(dtype),
                          torch.zeros((), dtype=dtype, device=out_buf.device))
    contrib = contrib.reshape(t_loc, k, -1)
    yt = contrib[:, 0]
    for j in range(1, k):
        yt = yt + contrib[:, j]
    return yt


def moe(x: Tensor, p: dict, cfg) -> tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  The expert products run through
    ``torch.bmm`` (the reference computes them outside any Pallas
    kernel)."""
    b, sl, d = x.shape
    e = cfg.n_experts
    t = b * sl
    xt = x.reshape(t, d)

    logits = (xt @ p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)

    # Load-balancing aux loss (Switch / OLMoE style).
    top1 = torch.argmax(probs, dim=-1)
    dispatch_frac = F.one_hot(top1, e).to(torch.float32).mean(dim=0)
    prob_frac = probs.mean(dim=0)
    aux = e * torch.sum(dispatch_frac * prob_frac)

    cap = capacity(cfg, t)
    buf, se, st, sg, pos = _dispatch_local(xt, probs, cfg, cap)
    gate_h = torch.bmm(buf, p["expert_gate"])
    up_h = torch.bmm(buf, p["expert_up"])
    out_buf = torch.bmm(F.silu(gate_h) * up_h, p["expert_down"])
    yt = _combine_local(out_buf, se, st, sg, pos, t, cap, x.dtype)

    if cfg.shared_expert:
        yt = yt + mlp(xt[None], p["shared"], cfg.mlp_kind)[0]
    return yt.reshape(b, sl, d), aux.to(torch.float32)
