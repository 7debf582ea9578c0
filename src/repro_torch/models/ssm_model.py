"""RWKV6 ("Finch") language model, the attention-free family (port of
``repro.models.ssm_model``).

Block = LayerNorm -> time-mix (+residual) -> LayerNorm -> channel-mix
(+residual), with an extra LayerNorm after the embedding (RWKV
convention).  Decode is O(1) per token with a (B, H, K, V) state per
layer; prefill is one chunked pass that also returns the states and the
two token-shift inputs of every layer.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import rwkv6
from repro_torch.models.common import (
    const_init,
    cross_entropy_loss,
    dtype_of,
    init_generator,
    layer,
    layer_norm,
    normal_init,
)

Tensor = torch.Tensor


def init_params(seed_or_gen, cfg, device="cuda") -> dict:
    """Random parameters from the port's own initializer (``device="meta"``:
    shapes and dtypes only).  ``blocks`` leaves are stacked (L, ...)."""
    gen = init_generator(seed_or_gen, device)
    dtype = dtype_of(cfg)
    d, L = cfg.d_model, cfg.n_layers
    f32 = torch.float32
    return {
        "embed": normal_init(gen, (cfg.vocab_size, d), dtype),
        "ln0_w": const_init(gen, (d,), 1.0, f32),
        "ln0_b": const_init(gen, (d,), 0.0, f32),
        "final_ln_w": const_init(gen, (d,), 1.0, f32),
        "final_ln_b": const_init(gen, (d,), 0.0, f32),
        "lm_head": normal_init(gen, (d, cfg.vocab_size), dtype),
        "blocks": {
            "ln1_w": const_init(gen, (L, d), 1.0, f32),
            "ln1_b": const_init(gen, (L, d), 0.0, f32),
            "ln2_w": const_init(gen, (L, d), 1.0, f32),
            "ln2_b": const_init(gen, (L, d), 0.0, f32),
            "rwkv": rwkv6.init_rwkv6_params(gen, cfg, dtype, (L,)),
        },
    }


def _blocks(params, cfg):
    return [layer(params["blocks"], i) for i in range(cfg.n_layers)]


def _embed(params, cfg, tokens):
    x = params["embed"][tokens.long()]
    return layer_norm(x, params["ln0_w"], params["ln0_b"], cfg.norm_eps)


def _logits(params, cfg, x):
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], cfg.norm_eps)
    return x @ params["lm_head"]


def _block(x, blk, cfg):
    h = layer_norm(x, blk["ln1_w"], blk["ln1_b"], cfg.norm_eps)
    x = x + rwkv6.rwkv6_time_mix(h, blk["rwkv"], cfg)
    h = layer_norm(x, blk["ln2_w"], blk["ln2_b"], cfg.norm_eps)
    return x + rwkv6.rwkv6_channel_mix(h, blk["rwkv"])


def forward(params, cfg, batch) -> tuple[Tensor, Tensor]:
    x = _embed(params, cfg, batch["tokens"])
    for blk in _blocks(params, cfg):
        x = _block(x, blk, cfg)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg, batch):
    logits, aux = forward(params, cfg, batch)
    ce = cross_entropy_loss(logits, batch["labels"])
    return ce, {"ce": ce, "aux": aux}


# ---- serving ----------------------------------------------------------------


def init_cache(cfg, batch_size: int, max_seq: int, device="cuda") -> dict:
    del max_seq  # O(1) state: the point of this family
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    nh, hk = rwkv6.dims(cfg)
    d, L = cfg.d_model, cfg.n_layers
    return {
        "state": torch.zeros((L, batch_size, nh, hk, hk), dtype=torch.float32, device=dev),
        "tm_shift": torch.zeros((L, batch_size, d), dtype=dtype, device=dev),
        "cm_shift": torch.zeros((L, batch_size, d), dtype=dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def decode_step(params, cfg, cache, tokens) -> tuple[Tensor, dict]:
    x = _embed(params, cfg, tokens)
    sts, tms, cms = [], [], []
    for i, blk in enumerate(_blocks(params, cfg)):
        h = layer_norm(x, blk["ln1_w"], blk["ln1_b"], cfg.norm_eps)
        tm_out, _, c1 = rwkv6.rwkv6_decode(
            h, blk["rwkv"], cfg, {"state": cache["state"][i],
                                  "tm_shift": cache["tm_shift"][i],
                                  "cm_shift": cache["cm_shift"][i]})
        x = x + tm_out
        h = layer_norm(x, blk["ln2_w"], blk["ln2_b"], cfg.norm_eps)
        cm_out, c2 = rwkv6.rwkv6_channel_mix_step(h, blk["rwkv"], c1)
        x = x + cm_out
        sts.append(c2["state"])
        tms.append(c2["tm_shift"])
        cms.append(c2["cm_shift"])
    return _logits(params, cfg, x), {
        "state": torch.stack(sts), "tm_shift": torch.stack(tms),
        "cm_shift": torch.stack(cms), "pos": cache["pos"] + 1}


def prefill(params, cfg, batch) -> tuple[Tensor, dict]:
    """Exact one-pass prefill: the chunked-parallel forward also yields the
    end-of-sequence states and each layer's last normalized inputs (the
    token shifts)."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    sts, tms, cms = [], [], []
    for blk in _blocks(params, cfg):
        h = layer_norm(x, blk["ln1_w"], blk["ln1_b"], cfg.norm_eps)
        tm_out, s_final = rwkv6.rwkv6_time_mix(h, blk["rwkv"], cfg, return_state=True)
        x = x + tm_out
        h2 = layer_norm(x, blk["ln2_w"], blk["ln2_b"], cfg.norm_eps)
        x = x + rwkv6.rwkv6_channel_mix(h2, blk["rwkv"])
        sts.append(s_final)
        tms.append(h[:, -1])
        cms.append(h2[:, -1])
    dtype = dtype_of(cfg)
    cache = {
        "state": torch.stack(sts),
        "tm_shift": torch.stack(tms).to(dtype),
        "cm_shift": torch.stack(cms).to(dtype),
        "pos": torch.tensor(s, dtype=torch.int32, device=tokens.device),
    }
    return _logits(params, cfg, x[:, -1:]), cache
