"""Mixture-of-Experts layer with sort-based dispatch (port of
``repro.models.moe``).

Used by olmoe-1b-7b (64 experts, top-8) and llama4-maverick (128
experts, top-1 + a shared expert, on alternate layers).

With more than ``_SMALL_T`` tokens under a mesh with a data axis that
divides them, the reference runs dispatch and combine inside
``shard_map`` over 'data': each data shard routes its own contiguous
block of tokens under its own capacity ``cf * T_loc * k / E``.  The
port runs those blocks stacked on a leading shard dimension, every
block on every rank (a ``DeviceMesh`` rank too: the region has no
collective, and each rank holds the global batch), with no host read,
so the layer also runs on meta tensors (the dry run).  Off a mesh, or
at up to ``_SMALL_T`` tokens, the whole batch is one block.  On DTensor
activations (SPMD on a ``DeviceMesh``) each rank routes its own data
block instead, with the experts parallel over 'model' (:func:`_moe_spmd`).  Within each
block three rules are explicit here where the reference relies on XLA's:

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

from repro_torch.models import sharding
from repro_torch.models.common import fan_in_init, normal_init
from repro_torch.models.mlp import init_mlp_params, mlp
from repro_torch.sync.compression import topk_index

Tensor = torch.Tensor

# Up to this many tokens (decode steps, short prefills) the whole batch
# routes as one block, as in the reference.
_SMALL_T = 2048


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


def _n_data_shards(t: int) -> int:
    """The data shards that route their own tokens: the mesh's ``batch``
    axis when it divides ``t``, else 1."""
    mesh = sharding.get_mesh()
    if mesh is None:
        return 1
    axis = sharding.get_rule("batch")
    shape = sharding.mesh_shape(mesh)
    if axis is None or axis not in shape:
        return 1
    n = int(shape[axis])
    return n if (n > 1 and t % n == 0) else 1


def _route(probs: Tensor, cfg) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """probs (S, T, E), S blocks routed apart -> each block's slots sorted
    by expert: ``(expert, token, gate, position in the expert's queue)``,
    each (S, T * k), token indices local to the block; indices int64."""
    k, e = cfg.top_k, cfg.n_experts
    s, t = probs.shape[:2]
    expert_ids = topk_index(probs.reshape(s * t, e), k).reshape(s, t, k)
    gate_vals = torch.gather(probs, 2, expert_ids)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat_expert = expert_ids.reshape(s, t * k)
    flat_gate = gate_vals.reshape(s, t * k)
    flat_token = torch.arange(t, device=probs.device).repeat_interleave(k).expand(s, t * k)
    order = torch.argsort(flat_expert, dim=1, stable=True)
    se, st, sg = (torch.gather(a, 1, order) for a in (flat_expert, flat_token, flat_gate))
    first = torch.searchsorted(se, torch.arange(e, device=probs.device).repeat(s, 1))
    pos = torch.arange(t * k, device=probs.device) - torch.gather(first, 1, se)
    return se, st, sg, pos


def _dispatch_local(xt: Tensor, probs: Tensor, cfg, capacity: int):
    """One data shard: xt (T, D), probs (T, E) -> ``(buf (E, C, D), se,
    st, sg, pos)``; or S shards stacked, xt (S, T, D), probs (S, T, E) ->
    buf (S, E, C, D) and slots (S, T * k), each shard on its own.  A slot
    at ``pos >= capacity`` is dropped: it is written to a spare row ``C``
    that the returned view leaves out, never clamped into the buffer.  No
    mask is read on the host, so the dispatch runs on meta tensors and
    never waits for the device."""
    if xt.dim() == 2:
        return tuple(a[0] for a in _dispatch_local(xt[None], probs[None], cfg, capacity))
    se, st, sg, pos = _route(probs, cfg)
    s = xt.shape[0]
    shard = torch.arange(s, device=xt.device)[:, None].expand_as(se)
    buf = xt.new_zeros((s, cfg.n_experts, capacity + 1, xt.shape[-1]))
    buf[shard, se, torch.clamp(pos, max=capacity)] = xt[shard, st]
    return buf[:, :, :capacity], se, st, sg, pos


def _combine_local(out_buf: Tensor, se, st, sg, pos, t_loc: int, capacity: int,
                   dtype) -> Tensor:
    """One data shard: out_buf (E, C, D) -> yt (T, D); or S shards stacked,
    out_buf (S, E, C, D) and slots (S, T * k) -> (S, T, D).  Each token's
    gated expert outputs, its dropped slots zero, added one after another
    in ascending expert order (deterministic on any device)."""
    if out_buf.dim() == 3:
        return _combine_local(out_buf[None], se[None], st[None], sg[None], pos[None],
                              t_loc, capacity, dtype)[0]
    s = out_buf.shape[0]
    k = se.shape[1] // t_loc
    by_token = torch.argsort(st, dim=1, stable=True)     # each token's slots, by expert
    e_t, p_t, g_t = (torch.gather(a, 1, by_token) for a in (se, pos, sg))
    shard = torch.arange(s, device=out_buf.device)[:, None].expand_as(e_t)
    gathered = out_buf[shard, e_t, torch.clamp(p_t, max=capacity - 1)]
    contrib = torch.where((p_t < capacity)[..., None], gathered * g_t[..., None].to(dtype),
                          torch.zeros((), dtype=dtype, device=out_buf.device))
    contrib = contrib.reshape(s, t_loc, k, -1)
    yt = contrib[:, :, 0]
    for j in range(1, k):
        yt = yt + contrib[:, :, j]
    return yt


def _experts(buf: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    """The expert SwiGLU on every shard's buffer: (S, E, C, D) -> (S, E,
    C, D), one ``bmm`` per weight over the E experts, the shards' slots
    side by side (the weights are never copied per shard)."""
    s, e, c, d = buf.shape
    h = buf.transpose(0, 1).reshape(e, s * c, d)
    act = F.silu(torch.bmm(h, w_gate)) * torch.bmm(h, w_up)
    out = torch.bmm(act, w_down)
    return out.reshape(e, s, c, -1).transpose(0, 1)


def _aux_loss(probs: Tensor, e: int) -> Tensor:
    """Load-balancing aux loss (Switch / OLMoE style) over all tokens."""
    top1 = torch.argmax(probs, dim=-1)
    dispatch_frac = F.one_hot(top1, e).to(torch.float32).mean(dim=0)
    prob_frac = probs.mean(dim=0)
    return e * torch.sum(dispatch_frac * prob_frac)


def moe(x: Tensor, p: dict, cfg) -> tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  With more than ``_SMALL_T`` tokens
    under a mesh whose ``batch`` axis divides them, each data shard's
    contiguous block of tokens routes on its own, under its own capacity
    (the reference's ``shard_map`` over 'data'); the aux loss stays over
    all tokens.  DTensor activations (SPMD on a ``DeviceMesh``) take
    :func:`_moe_spmd`."""
    if sharding.is_dtensor(x):
        return _moe_spmd(x, p, cfg)
    b, sl, d = x.shape
    e = cfg.n_experts
    t = b * sl
    xt = x.reshape(t, d)

    logits = (xt @ p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    aux = _aux_loss(probs, e)

    shards = _n_data_shards(t) if t > _SMALL_T else 1
    t_loc = t // shards
    cap = capacity(cfg, t_loc)
    buf, se, st, sg, pos = _dispatch_local(xt.reshape(shards, t_loc, d),
                                           probs.reshape(shards, t_loc, e), cfg, cap)
    out = _experts(buf, p["expert_gate"], p["expert_up"], p["expert_down"])
    yt = _combine_local(out, se, st, sg, pos, t_loc, cap, x.dtype).reshape(t, d)

    if cfg.shared_expert:
        yt = yt + mlp(xt[None], p["shared"], cfg.mlp_kind)[0]
    return yt.reshape(b, sl, d), aux.to(torch.float32)


_SLOTS = ("batch", None)
_BUF = ("batch", "experts", None, None)


def _moe_spmd(x: Tensor, p: dict, cfg) -> tuple[Tensor, Tensor]:
    """The layer on DTensors, as the reference runs it under a mesh: the
    router's logits made whole over 'model' (it is placed (fsdp, model),
    so they come out sharded on E) before the softmax and top-k; above
    ``_SMALL_T`` tokens with a ``batch`` axis that divides them, each
    rank dispatches and combines its own data block (the reference's
    ``shard_map`` over 'data'), else every rank routes the whole batch as
    one block (the tokens gathered over 'data' first); the dispatch and
    combine are index plumbing with no DTensor rule, run on local blocks
    (``sharding.local_map``).  The buffer is placed (batch, experts):
    each rank runs its experts only, their d_in gathered over 'data'
    (FSDP), and the output buffer is gathered over 'model' before the
    combine (the reference's MoE all-to-all).  The aux loss is computed
    whole on every rank from the probabilities replicated over the mesh,
    a DTensor: made whole with ``full_tensor`` it would be a plain
    tensor, which the DTensor loss adds as a replicated value, so its
    gradient would come back a DTensor, which ``full_tensor``'s backward
    refuses (ROADMAP C)."""
    b, sl, d = x.shape
    e = cfg.n_experts
    t = b * sl
    xt = sharding.shard(x.reshape(t, d), "batch", None)
    logits = sharding.shard(xt @ p["router"], "batch", None).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    aux = _aux_loss(sharding.replicate(probs), e)

    shards = _n_data_shards(t) if t > _SMALL_T else 1
    t_loc = t // shards
    cap = capacity(cfg, t_loc)
    tokens = _SLOTS if shards > 1 else (None, None)

    def dispatch(xt_, probs_):
        return _dispatch_local(xt_[None], probs_[None], cfg, cap)

    buf, se, st, sg, pos = sharding.local_map(
        dispatch, (tokens, tokens), (_BUF,) + (_SLOTS,) * 4)(xt, probs)
    buf = sharding.shard(buf, *_BUF)
    experts = ("experts", None, None)
    out = sharding.local_map(_experts, (_BUF, experts, experts, experts), _BUF)(
        buf, p["expert_gate"], p["expert_up"], p["expert_down"])
    out = sharding.shard(out, "batch", None, None, None)

    def combine(out_, se_, st_, sg_, pos_):
        return _combine_local(out_, se_, st_, sg_, pos_, t_loc, cap, x.dtype)

    yt = sharding.local_map(combine, (("batch", None, None, None),) + (_SLOTS,) * 4,
                            ("batch", None, None))(out, se, st, sg, pos)
    yt = sharding.shard(yt.reshape(t, d), "batch", None)
    if cfg.shared_expert:
        yt = yt + mlp(xt[None], p["shared"], cfg.mlp_kind)[0]
    return yt.reshape(b, sl, d), aux.to(torch.float32)
