"""Decoder-only transformer LM: the dense, MoE and VLM families (port of
``repro.models.transformer``).

Parameters keep the reference's layout.  Layers come in G groups
(super-layers): ``params["dense_blocks"]`` leaves have leading dims
(G, dense_per), ``params["moe_blocks"]`` leaves (G,).  A dense model is
G = n_layers groups of one dense layer; an MoE model with
``moe_interleave`` i has groups of i - 1 dense layers and one MoE layer
(llama4-maverick: 2, one of each; olmoe: 1, all MoE).  The KV cache
stacks the layers group by group, in that order.

The VLM family (internvl2) consumes a stubbed patch-embedding prefix:
``batch["vis_embeds"]`` (B, n_vis, D) is projected by ``vis_proj`` and
prepended to the token embeddings, and the sequence is cut back to S,
so position p >= n_vis holds token p - n_vis (decode feeds tokens in
that shifted order, as the reference's consistency test does).

The reference runs the groups under ``lax.scan`` (``cfg.scan_layers``, a
JAX compile knob the port accepts and ignores: it runs a Python loop
over the layers, eagerly, with the same values).  ``cfg.remat`` is
honoured under autograd as the reference's ``jax.checkpoint``, one group
at a time: ``"full"`` recomputes each group in the backward pass
(``torch.utils.checkpoint``, non-reentrant), ``"selective"`` keeps the
group's matmuls without batch dims (the projections) and recomputes the
rest, ``"none"`` keeps everything.

On a ``DeviceMesh`` with DTensor parameters (``sharding.
distribute_params``) the dense family runs as SPMD, as the reference runs
under a mesh: the entry points run under ``sharding.spmd`` and the
reference's ``shard`` constraints sit at its sites (the embedding, each
block's residual, the serve layer, the prefill cache, the vocab-sharded
logits).  The embedding table stays vocab-sharded: a lookup is a masked
partial sum over the vocab shards.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import attention, mlp, moe, sharding
from repro_torch.models.common import (
    arange_positions,
    const_init,
    cross_entropy_loss,
    dtype_of,
    fan_in_init,
    init_generator,
    layer,
    normal_init,
    rms_norm,
)

Tensor = torch.Tensor


def group_structure(cfg) -> tuple[int, int, bool]:
    """(n_groups, dense_per_group, has_moe)."""
    if cfg.n_experts == 0:
        return cfg.n_layers, 1, False
    g = cfg.moe_interleave
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.n_layers} layers do not divide moe_interleave {g}")
    return cfg.n_layers // g, g - 1, True


def layers_per_group(cfg) -> int:
    _, dense_per, has_moe = group_structure(cfg)
    return dense_per + (1 if has_moe else 0)


# ---- parameter construction -------------------------------------------------


def _layer_params(gen, cfg, dtype, stack, ffn: str) -> dict:
    d = cfg.d_model
    p = {
        "attn_norm": const_init(gen, stack + (d,), 0.0, torch.float32),
        "attn": attention.init_attention_params(gen, cfg, dtype, stack),
        "mlp_norm": const_init(gen, stack + (d,), 0.0, torch.float32),
    }
    if ffn == "moe":
        p["moe"] = moe.init_moe_params(gen, cfg, dtype, stack)
    else:
        p["mlp"] = mlp.init_mlp_params(gen, d, cfg.d_ff, dtype, cfg.mlp_kind, stack)
    return p


def init_params(seed_or_gen, cfg, device="cuda") -> dict:
    """Random parameters from the port's own initializer (its draws differ
    from ``jax.random``'s; ``repro_torch.convert`` brings the reference's
    parameters over instead).  ``device="meta"`` gives the shapes and
    dtypes without allocating (``model_zoo.abstract_params``)."""
    gen = init_generator(seed_or_gen, device)
    dtype = dtype_of(cfg)
    n_groups, dense_per, has_moe = group_structure(cfg)
    d = cfg.d_model

    params: dict[str, Any] = {
        "embed": normal_init(gen, (cfg.vocab_size, d), dtype),
        "final_norm": const_init(gen, (d,), 0.0, torch.float32),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (d, cfg.vocab_size), dtype)
    if cfg.n_vis_tokens:
        params["vis_proj"] = fan_in_init(gen, (d, d), dtype)
    if dense_per > 0:
        params["dense_blocks"] = _layer_params(gen, cfg, dtype, (n_groups, dense_per),
                                               "mlp")
    if has_moe:
        params["moe_blocks"] = _layer_params(gen, cfg, dtype, (n_groups,), "moe")
    return params


def _groups(params, cfg):
    """Each group's ``(dense layers, moe layer or None)``, in order."""
    n_groups, dense_per, has_moe = group_structure(cfg)
    out = []
    for g in range(n_groups):
        dense = [layer(params["dense_blocks"], g, i) for i in range(dense_per)]
        out.append((dense, layer(params["moe_blocks"], g) if has_moe else None))
    return out


# ---- blocks -----------------------------------------------------------------


def _dense_block(x, blk, cfg, positions):
    h = rms_norm(x, blk["attn_norm"], cfg.norm_eps)
    x = x + attention.full_attention(h, blk["attn"], cfg, positions)
    h = rms_norm(x, blk["mlp_norm"], cfg.norm_eps)
    x = x + mlp.mlp(h, blk["mlp"], cfg.mlp_kind)
    return sharding.shard(x, "batch", "residual", None)


def _moe_block(x, blk, cfg, positions):
    h = rms_norm(x, blk["attn_norm"], cfg.norm_eps)
    x = x + attention.full_attention(h, blk["attn"], cfg, positions)
    h = rms_norm(x, blk["mlp_norm"], cfg.norm_eps)
    y, aux = moe.moe(h, blk["moe"], cfg)
    return x + y, aux


def _save_projections(ctx, op, *args, **kwargs):
    """``"selective"`` remat: the reference's
    ``checkpoint_dots_with_no_batch_dims`` — keep plain 2-D matmuls (the
    projections), recompute the attention's batched products and the
    elementwise work."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``fn`` under the config's rematerialization, when a backward pass
    will follow (``torch.is_grad_enabled()``)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "selective":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _save_projections)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=context)
    if cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)


def _group(x, dense, moe_blk, cfg, positions):
    """One group (the reference's super-layer): its dense layers, then its
    MoE layer.  Returns ``(x, the group's aux loss)``."""
    for blk in dense:
        x = _dense_block(x, blk, cfg, positions)
    if moe_blk is None:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return _moe_block(x, moe_blk, cfg, positions)


def backbone(params, cfg, x, positions):
    """Run all layers.  x: (B, S, D) -> (x, aux_loss summed over the MoE
    layers).  Each group is rematerialized as one unit, as the reference
    rematerializes its super-layer."""
    group = _remat(_group, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for dense, moe_blk in _groups(params, cfg):
        x, a = group(x, dense, moe_blk, cfg, positions)
        aux = aux + a
    return x, aux


# ---- embedding / head -------------------------------------------------------


def _scale_embed(x, cfg):
    if cfg.family == "dense" and cfg.name.startswith("gemma"):
        # gemma scales by sqrt(d_model) in the activation dtype.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _lookup(table, tokens):
    """The rows of ``tokens`` in the embedding table.  A DTensor table is
    read by ``F.embedding``, which keeps it vocab-sharded (a masked
    partial sum, reduced by the constraint after it) where an index
    would gather it; its rows are placed on the batch."""
    if not sharding.is_dtensor(table):
        return table[tokens.long()]
    x = torch.nn.functional.embedding(tokens.long(), table)
    return sharding.shard(x, "batch", None, None)


def embed_tokens(params, cfg, tokens, batch):
    """(B, S, D) embeddings; with the VLM prefix, the projected
    ``vis_embeds`` first and the tokens cut to keep S positions."""
    x = _lookup(params["embed"], tokens)
    if cfg.n_vis_tokens and "vis_embeds" in batch:
        vis = batch["vis_embeds"].to(x.dtype) @ params["vis_proj"]
        x = torch.cat([vis, x[:, : x.shape[1] - vis.shape[1]]], dim=1)
    return sharding.shard(_scale_embed(x, cfg), "batch", None, None)


def lm_logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return sharding.shard(logits, "batch", None, "vocab")


# ---- public entry points ----------------------------------------------------


def forward(params, cfg, batch) -> tuple[Tensor, Tensor]:
    tokens = batch["tokens"]
    b, s = tokens.shape
    with sharding.spmd(params):
        x = embed_tokens(params, cfg, tokens, batch)
        x, aux = backbone(params, cfg, x, arange_positions(b, s, tokens.device))
        return lm_logits(params, cfg, x), aux


def loss_fn(params, cfg, batch) -> tuple[Tensor, dict]:
    """Mean token cross-entropy (+ 0.01 x aux); differentiable through
    autograd, with the layers rematerialized per ``cfg.remat``."""
    logits, aux = forward(params, cfg, batch)
    ce = cross_entropy_loss(logits, batch["labels"])
    total = ce + 0.01 * aux
    return total, {"ce": ce, "aux": aux}


# ---- serving ----------------------------------------------------------------


def init_cache(cfg, batch_size: int, max_seq: int, device="cuda") -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _serve_layer(x, blk, cfg, attend):
    """One layer in serve mode; ``attend(h, attn_params)`` is the prefill
    or decode attention returning ``(out, k, v)``."""
    h = rms_norm(x, blk["attn_norm"], cfg.norm_eps)
    att, k, v = attend(h, blk["attn"])
    x = x + att
    h = rms_norm(x, blk["mlp_norm"], cfg.norm_eps)
    if "moe" in blk:
        y, _ = moe.moe(h, blk["moe"], cfg)
        return x + y, k, v
    x = x + mlp.mlp(h, blk["mlp"], cfg.mlp_kind)
    return sharding.shard(x, "batch", None, None), k, v


def _serve_layers(params, cfg):
    """Every layer's parameters in cache order (group by group)."""
    return [blk for dense, moe_blk in _groups(params, cfg)
            for blk in dense + ([moe_blk] if moe_blk is not None else [])]


def prefill(params, cfg, batch) -> tuple[Tensor, dict]:
    """Full-sequence prefill; returns (last-position logits, filled cache
    padded to ``batch["max_seq"]``)."""
    with sharding.spmd(params):
        return _prefill(params, cfg, batch)


def _prefill(params, cfg, batch):
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = arange_positions(b, s, tokens.device)
    x = embed_tokens(params, cfg, tokens, batch)

    def attend(h, p):
        return attention.prefill_attention_with_cache(h, p, cfg, positions)

    ks, vs = [], []
    for blk in _serve_layers(params, cfg):
        x, k, v = _serve_layer(x, blk, cfg, attend)
        ks.append(k)
        vs.append(v)
    max_seq = int(batch.get("max_seq", s))
    pad = max_seq - s
    k_stack, v_stack = torch.stack(ks), torch.stack(vs)       # (L, B, S, Hkv, hd)
    if pad > 0:
        k_stack = torch.nn.functional.pad(k_stack, (0, 0, 0, 0, 0, pad))
        v_stack = torch.nn.functional.pad(v_stack, (0, 0, 0, 0, 0, pad))
    cache = {
        "k": sharding.shard(k_stack, None, "batch", "kv_seq", None, None),
        "v": sharding.shard(v_stack, None, "batch", "kv_seq", None, None),
        "pos": torch.tensor(s, dtype=torch.int32, device=tokens.device),
    }
    return lm_logits(params, cfg, x[:, -1:, :]), cache


def decode_step(params, cfg, cache, tokens) -> tuple[Tensor, dict]:
    """One token for every sequence.  tokens: (B, 1)."""
    with sharding.spmd(params):
        return _decode_step(params, cfg, cache, tokens)


def _decode_step(params, cfg, cache, tokens):
    pos = cache["pos"]
    x = _scale_embed(_lookup(params["embed"], tokens), cfg)
    nks, nvs = [], []
    for li, blk in enumerate(_serve_layers(params, cfg)):
        def attend(h, p, li=li):
            return attention.decode_attention(h, p, cfg, cache["k"][li], cache["v"][li],
                                              pos)

        x, nk, nv = _serve_layer(x, blk, cfg, attend)
        nks.append(nk)
        nvs.append(nv)
    cache = {"k": torch.stack(nks), "v": torch.stack(nvs), "pos": pos + 1}
    return lm_logits(params, cfg, x), cache
