"""Zamba2-style hybrid backbone: Mamba2 layers + one *shared* attention
block applied every ``cfg.attn_every`` layers (port of
``repro.models.hybrid``).

The shared block (attention + MLP) is one parameter set reused at every
application site; serving keeps one KV cache per site.  Layout:
``params["mamba_blocks"]`` leaves (G, per, ...), ``params["mamba_tail"]``
leaves (rem, ...) for the layers past the last whole group, and
``params["shared_attn"]``.  With ``cfg.sliding_window`` (the launcher's
``long_500k`` setting) the sites keep a ring buffer of the last
``sliding_window`` keys: position p sits at slot ``p % kv_len``.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, mamba2, mlp
from repro_torch.models.common import (
    arange_positions,
    const_init,
    cross_entropy_loss,
    dtype_of,
    init_generator,
    layer,
    normal_init,
    rms_norm,
)

Tensor = torch.Tensor


def site_count(cfg) -> int:
    """Number of shared-attention application sites."""
    if not cfg.attn_every:
        return 0
    return cfg.n_layers // cfg.attn_every


def _grouping(cfg) -> tuple[int, int, int]:
    """(n_groups, per_group, remainder) over mamba layers."""
    per = cfg.attn_every if cfg.attn_every else cfg.n_layers
    return cfg.n_layers // per, per, cfg.n_layers % per


def _mamba_layers(gen, cfg, dtype, stack) -> dict:
    return {
        "norm": const_init(gen, stack + (cfg.d_model,), 0.0, torch.float32),
        "mamba": mamba2.init_mamba2_params(gen, cfg, dtype, stack),
    }


def init_params(seed_or_gen, cfg, device="cuda") -> dict:
    """Random parameters from the port's own initializer (``device="meta"``:
    shapes and dtypes only)."""
    gen = init_generator(seed_or_gen, device)
    dtype = dtype_of(cfg)
    n_groups, per, rem = _grouping(cfg)
    d = cfg.d_model
    params = {
        "embed": normal_init(gen, (cfg.vocab_size, d), dtype),
        "final_norm": const_init(gen, (d,), 0.0, torch.float32),
        "lm_head": normal_init(gen, (d, cfg.vocab_size), dtype),
        "mamba_blocks": _mamba_layers(gen, cfg, dtype, (n_groups, per)),
    }
    if rem:
        params["mamba_tail"] = _mamba_layers(gen, cfg, dtype, (rem,))
    if site_count(cfg):
        params["shared_attn"] = {
            "attn_norm": const_init(gen, (d,), 0.0, torch.float32),
            "attn": attention.init_attention_params(gen, cfg, dtype),
            "mlp_norm": const_init(gen, (d,), 0.0, torch.float32),
            "mlp": mlp.init_mlp_params(gen, d, cfg.d_ff, dtype, cfg.mlp_kind),
        }
    return params


def _layout(params, cfg):
    """``(groups, tail)``: each group's mamba layers in order, then the
    tail's (the shared block follows every group)."""
    n_groups, per, rem = _grouping(cfg)
    groups = [[layer(params["mamba_blocks"], g, i) for i in range(per)]
              for g in range(n_groups)]
    tail = [layer(params["mamba_tail"], i) for i in range(rem)]
    return groups, tail


def _mamba_block(x, blk, cfg):
    h = rms_norm(x, blk["norm"], cfg.norm_eps)
    return x + mamba2.mamba2_forward(h, blk["mamba"], cfg)


def _shared_block(x, blk, cfg, positions):
    h = rms_norm(x, blk["attn_norm"], cfg.norm_eps)
    x = x + attention.full_attention(h, blk["attn"], cfg, positions)
    h = rms_norm(x, blk["mlp_norm"], cfg.norm_eps)
    return x + mlp.mlp(h, blk["mlp"], cfg.mlp_kind)


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


def forward(params, cfg, batch) -> tuple[Tensor, Tensor]:
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = arange_positions(b, s, tokens.device)
    x = params["embed"][tokens.long()]
    shared = params.get("shared_attn")
    groups, tail = _layout(params, cfg)
    for grp in groups:
        for blk in grp:
            x = _mamba_block(x, blk, cfg)
        if shared is not None:
            x = _shared_block(x, shared, cfg, positions)
    for blk in tail:
        x = _mamba_block(x, blk, cfg)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg, batch):
    logits, aux = forward(params, cfg, batch)
    ce = cross_entropy_loss(logits, batch["labels"])
    return ce, {"ce": ce, "aux": aux}


# ---- serving ----------------------------------------------------------------


def _kv_len(cfg, max_seq: int) -> int:
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq


def init_cache(cfg, batch_size: int, max_seq: int, device="cuda") -> dict:
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    n_sites = site_count(cfg)
    d_in, nh, hp, ns = mamba2.dims(cfg)
    conv_ch = d_in + 2 * ns
    cache = {
        "ssm": torch.zeros((cfg.n_layers, batch_size, nh, ns, hp), dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((cfg.n_layers, batch_size, mamba2.CONV_WIDTH - 1, conv_ch),
                            dtype=dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if n_sites:
        shape = (n_sites, batch_size, _kv_len(cfg, max_seq), cfg.n_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def prefill(params, cfg, batch) -> tuple[Tensor, dict]:
    """Exact one-pass prefill: the chunked SSD yields each layer's
    end-of-sequence state; the shared attention sites fill their KV
    caches (the trailing ``kv_len`` positions, rotated so position p sits
    at ring slot ``p % kv_len``)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = arange_positions(b, s, tokens.device)
    x = params["embed"][tokens.long()]
    shared = params.get("shared_attn")
    kv_len = _kv_len(cfg, int(batch.get("max_seq", s)))
    groups, tail = _layout(params, cfg)

    states, ks, vs = [], [], []

    def mamba_pre(x, blk):
        h = rms_norm(x, blk["norm"], cfg.norm_eps)
        out, st = mamba2.mamba2_forward(h, blk["mamba"], cfg, return_state=True)
        states.append(st)
        return x + out

    for grp in groups:
        for blk in grp:
            x = mamba_pre(x, blk)
        if shared is not None:
            h = rms_norm(x, shared["attn_norm"], cfg.norm_eps)
            att, k, v = attention.prefill_attention_with_cache(
                h, shared["attn"], cfg, positions)
            x = x + att
            h = rms_norm(x, shared["mlp_norm"], cfg.norm_eps)
            x = x + mlp.mlp(h, shared["mlp"], cfg.mlp_kind)
            k, v = k[:, -kv_len:], v[:, -kv_len:]
            if cfg.sliding_window and s > kv_len and s % kv_len:
                k = torch.roll(k, s % kv_len, dims=1)
                v = torch.roll(v, s % kv_len, dims=1)
            ks.append(k)
            vs.append(v)
    for blk in tail:
        x = mamba_pre(x, blk)

    cache = {
        "ssm": torch.stack([st["ssm"] for st in states]),
        "conv": torch.stack([st["conv"] for st in states]),
        "pos": torch.tensor(s, dtype=torch.int32, device=tokens.device),
    }
    if shared is not None:
        pad = kv_len - min(kv_len, s)
        k_stack, v_stack = torch.stack(ks), torch.stack(vs)
        if pad > 0:
            k_stack = torch.nn.functional.pad(k_stack, (0, 0, 0, 0, 0, pad))
            v_stack = torch.nn.functional.pad(v_stack, (0, 0, 0, 0, 0, pad))
        cache["k"], cache["v"] = k_stack, v_stack
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg, cache, tokens) -> tuple[Tensor, dict]:
    pos = cache["pos"]
    x = params["embed"][tokens.long()]
    shared = params.get("shared_attn")
    groups, tail = _layout(params, cfg)
    new_ssm, new_conv, new_k, new_v = [], [], [], []

    def mamba_step(x, blk):
        li = len(new_ssm)
        h = rms_norm(x, blk["norm"], cfg.norm_eps)
        out, st = mamba2.mamba2_decode(
            h, blk["mamba"], cfg, {"ssm": cache["ssm"][li], "conv": cache["conv"][li]})
        new_ssm.append(st["ssm"])
        new_conv.append(st["conv"])
        return x + out

    for gi, grp in enumerate(groups):
        for blk in grp:
            x = mamba_step(x, blk)
        if shared is not None:
            h = rms_norm(x, shared["attn_norm"], cfg.norm_eps)
            att, nk, nv = attention.decode_attention(
                h, shared["attn"], cfg, cache["k"][gi], cache["v"][gi], pos,
                ring=cfg.sliding_window > 0)
            x = x + att
            h = rms_norm(x, shared["mlp_norm"], cfg.norm_eps)
            x = x + mlp.mlp(h, shared["mlp"], cfg.mlp_kind)
            new_k.append(nk)
            new_v.append(nv)
    for blk in tail:
        x = mamba_step(x, blk)

    new_cache = {"ssm": torch.stack(new_ssm), "conv": torch.stack(new_conv),
                 "pos": pos + 1}
    if shared is not None:
        new_cache["k"], new_cache["v"] = torch.stack(new_k), torch.stack(new_v)
    return _logits(params, cfg, x), new_cache
