"""Decoder-only transformer LM, dense family (port of
``repro.models.transformer``).

Parameters keep the reference's layout: the layer leaves are stacked as
``params["dense_blocks"]`` with leading dims (G, 1) — G groups of one
dense layer each.  The reference runs the layers under ``lax.scan``
(``cfg.scan_layers``, a JAX compile knob the port accepts and ignores:
it runs a Python loop over the layers, eagerly, with the same values).
``cfg.remat`` is honoured under autograd as the reference's
``jax.checkpoint`` of each super-layer: ``"full"`` recomputes each
layer in the backward pass (``torch.utils.checkpoint``, non-reentrant),
``"selective"`` keeps the layer's matmuls without batch dims (the
projections) and recomputes the rest, ``"none"`` keeps everything.

MoE (``n_experts > 0``) and the VLM family raise ``NotImplementedError``
until their slice is ported.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import attention, mlp
from repro_torch.models.common import (
    cross_entropy_loss,
    dtype_of,
    normal_init,
    rms_norm,
)

Tensor = torch.Tensor


def _check_ported(cfg) -> None:
    if cfg.n_experts > 0 or cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: the MoE and VLM families of the transformer are not "
            "ported yet (dense only)")


def group_structure(cfg) -> tuple[int, int, bool]:
    """(n_groups, dense_per_group, has_moe); the port's dense family is
    (n_layers, 1, False)."""
    _check_ported(cfg)
    return cfg.n_layers, 1, False


# ---- parameter construction -------------------------------------------------


def _generator(seed_or_gen, device="cuda") -> torch.Generator | None:
    """A ``torch.Generator`` on ``device``: ``seed_or_gen`` itself (which
    must live there) or a new one seeded with the int; ``None`` on the
    meta device, where the initializers only give shapes and dtypes."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return None
    if isinstance(seed_or_gen, torch.Generator):
        if seed_or_gen.device.type != dev.type:
            raise ValueError(f"generator on {seed_or_gen.device}, params on {dev}")
        return seed_or_gen
    return torch.Generator(device=dev).manual_seed(int(seed_or_gen))


def init_params(seed_or_gen, cfg, device="cuda") -> dict:
    """Random parameters from the port's own initializer (its draws differ
    from ``jax.random``'s; ``repro_torch.convert`` brings the reference's
    parameters over instead).  ``device="meta"`` gives the shapes and
    dtypes without allocating (``model_zoo.abstract_params``)."""
    _check_ported(cfg)
    gen = _generator(seed_or_gen, device)
    dev = gen.device if gen is not None else torch.device("meta")
    dtype = dtype_of(cfg)
    n_groups, dense_per, _ = group_structure(cfg)
    d = cfg.d_model
    stack = (n_groups, dense_per)

    params: dict[str, Any] = {
        "embed": normal_init(gen, (cfg.vocab_size, d), dtype),
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (d, cfg.vocab_size), dtype)
    params["dense_blocks"] = {
        "attn_norm": torch.zeros(stack + (d,), dtype=torch.float32, device=dev),
        "attn": attention.init_attention_params(gen, cfg, dtype, stack),
        "mlp_norm": torch.zeros(stack + (d,), dtype=torch.float32, device=dev),
        "mlp": mlp.init_mlp_params(gen, d, cfg.d_ff, dtype, cfg.mlp_kind, stack),
    }
    return params


def _index(tree, i: int, j: int):
    if isinstance(tree, dict):
        return {k: _index(v, i, j) for k, v in tree.items()}
    return tree[i, j]


def _layers(params, cfg):
    """Each layer's parameter dict, in order."""
    n_groups, dense_per, _ = group_structure(cfg)
    blocks = params["dense_blocks"]
    return [_index(blocks, g, i) for g in range(n_groups) for i in range(dense_per)]


# ---- blocks -----------------------------------------------------------------


def _dense_block(x, blk, cfg, positions):
    h = rms_norm(x, blk["attn_norm"], cfg.norm_eps)
    x = x + attention.full_attention(h, blk["attn"], cfg, positions)
    h = rms_norm(x, blk["mlp_norm"], cfg.norm_eps)
    return x + mlp.mlp(h, blk["mlp"], cfg.mlp_kind)


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


def backbone(params, cfg, x, positions):
    """Run all layers.  x: (B, S, D) -> (x, aux_loss)."""
    block = _remat(_dense_block, cfg)
    for blk in _layers(params, cfg):
        x = block(x, blk, cfg, positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---- embedding / head -------------------------------------------------------


def _scale_embed(x, cfg):
    if cfg.family == "dense" and cfg.name.startswith("gemma"):
        # gemma scales by sqrt(d_model) in the activation dtype.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def embed_tokens(params, cfg, tokens, batch):
    _check_ported(cfg)
    return _scale_embed(params["embed"][tokens.long()], cfg)    # (B, S, D)


def lm_logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


# ---- public entry points ----------------------------------------------------


def forward(params, cfg, batch) -> tuple[Tensor, Tensor]:
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params, cfg, tokens, batch)
    x, aux = backbone(params, cfg, x, _positions(b, s, tokens.device))
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


def prefill(params, cfg, batch) -> tuple[Tensor, dict]:
    """Full-sequence prefill; returns (last-position logits, filled cache
    padded to ``batch["max_seq"]``)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = embed_tokens(params, cfg, tokens, batch)
    ks, vs = [], []
    for blk in _layers(params, cfg):
        h = rms_norm(x, blk["attn_norm"], cfg.norm_eps)
        att, k, v = attention.prefill_attention_with_cache(h, blk["attn"], cfg, positions)
        x = x + att
        h = rms_norm(x, blk["mlp_norm"], cfg.norm_eps)
        x = x + mlp.mlp(h, blk["mlp"], cfg.mlp_kind)
        ks.append(k)
        vs.append(v)
    max_seq = int(batch.get("max_seq", s))
    pad = max_seq - s
    k_stack, v_stack = torch.stack(ks), torch.stack(vs)       # (L, B, S, Hkv, hd)
    if pad > 0:
        k_stack = torch.nn.functional.pad(k_stack, (0, 0, 0, 0, 0, pad))
        v_stack = torch.nn.functional.pad(v_stack, (0, 0, 0, 0, 0, pad))
    cache = {
        "k": k_stack,
        "v": v_stack,
        "pos": torch.tensor(s, dtype=torch.int32, device=tokens.device),
    }
    return lm_logits(params, cfg, x[:, -1:, :]), cache


def decode_step(params, cfg, cache, tokens) -> tuple[Tensor, dict]:
    """One token for every sequence.  tokens: (B, 1)."""
    pos = cache["pos"]
    x = _scale_embed(params["embed"][tokens.long()], cfg)
    nks, nvs = [], []
    for li, blk in enumerate(_layers(params, cfg)):
        h = rms_norm(x, blk["attn_norm"], cfg.norm_eps)
        att, nk, nv = attention.decode_attention(
            h, blk["attn"], cfg, cache["k"][li], cache["v"][li], pos)
        x = x + att
        h = rms_norm(x, blk["mlp_norm"], cfg.norm_eps)
        x = x + mlp.mlp(h, blk["mlp"], cfg.mlp_kind)
        nks.append(nk)
        nvs.append(nv)
    cache = {"k": torch.stack(nks), "v": torch.stack(nvs), "pos": pos + 1}
    return lm_logits(params, cfg, x), cache
