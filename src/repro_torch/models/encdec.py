"""Whisper-style encoder-decoder backbone, the audio family (port of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: ``batch["frames"]``
holds precomputed frame embeddings (B, n_frames, D).  The encoder is a
bidirectional transformer over them (the plain attention: B.8 is causal
only); the decoder is a causal transformer (B.8 on its self-attention
with ``cfg.use_flash_kernel``) with cross attention to the encoder's
memory.  Positions are fixed sinusoids, MLPs plain GELU, the LM head
tied to the embedding.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, mlp
from repro_torch.models.common import (
    arange_positions,
    const_init,
    cross_entropy_loss,
    dtype_of,
    init_generator,
    layer,
    layer_norm,
    normal_init,
    sinusoid_timescales,
    sinusoidal_positions,
)

Tensor = torch.Tensor


def _init_ln(gen, d, stack=()):
    return {"w": const_init(gen, stack + (d,), 1.0, torch.float32),
            "b": const_init(gen, stack + (d,), 0.0, torch.float32)}


def init_params(seed_or_gen, cfg, device="cuda") -> dict:
    """Random parameters from the port's own initializer (``device="meta"``:
    shapes and dtypes only).  Layer leaves are stacked (L, ...)."""
    gen = init_generator(seed_or_gen, device)
    dtype = dtype_of(cfg)
    d = cfg.d_model
    enc, dec = (cfg.n_encoder_layers,), (cfg.n_layers,)
    return {
        "embed": normal_init(gen, (cfg.vocab_size, d), dtype),
        "enc_blocks": {
            "ln1": _init_ln(gen, d, enc),
            "attn": attention.init_attention_params(gen, cfg, dtype, enc),
            "ln2": _init_ln(gen, d, enc),
            "mlp": mlp.init_mlp_params(gen, d, cfg.d_ff, dtype, "gelu", enc),
        },
        "enc_final_ln": _init_ln(gen, d),
        "dec_blocks": {
            "ln1": _init_ln(gen, d, dec),
            "self_attn": attention.init_attention_params(gen, cfg, dtype, dec),
            "ln2": _init_ln(gen, d, dec),
            "cross_attn": attention.init_attention_params(gen, cfg, dtype, dec),
            "ln3": _init_ln(gen, d, dec),
            "mlp": mlp.init_mlp_params(gen, d, cfg.d_ff, dtype, "gelu", dec),
        },
        "dec_final_ln": _init_ln(gen, d),
    }


def _ln(x, p, eps):
    return layer_norm(x, p["w"], p["b"], eps)


def encode(params, cfg, frames: Tensor) -> Tensor:
    """frames: (B, F, D) stub embeddings -> encoder memory (B, F, D)."""
    b, f, d = frames.shape
    x = frames + sinusoidal_positions(f, d, frames.device).to(frames.dtype)[None]
    positions = arange_positions(b, f, frames.device)
    for i in range(cfg.n_encoder_layers):
        blk = layer(params["enc_blocks"], i)
        h = _ln(x, blk["ln1"], cfg.norm_eps)
        x = x + attention.full_attention(h, blk["attn"], cfg, positions, causal=False)
        h = _ln(x, blk["ln2"], cfg.norm_eps)
        x = x + mlp.mlp(h, blk["mlp"], "gelu")
    return _ln(x, params["enc_final_ln"], cfg.norm_eps)


def _cross_kv(blk, cfg, memory):
    b, f, _ = memory.shape
    k = memory @ blk["cross_attn"]["wk"]
    v = memory @ blk["cross_attn"]["wv"]
    if cfg.qkv_bias:
        k = k + blk["cross_attn"]["bk"]
        v = v + blk["cross_attn"]["bv"]
    return (k.reshape(b, f, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, f, cfg.n_kv_heads, cfg.head_dim))


def _dec_block(x, blk, cfg, positions, memory):
    h = _ln(x, blk["ln1"], cfg.norm_eps)
    x = x + attention.full_attention(h, blk["self_attn"], cfg, positions)
    h = _ln(x, blk["ln2"], cfg.norm_eps)
    x = x + attention.full_attention(h, blk["cross_attn"], cfg, positions,
                                     cross_kv=_cross_kv(blk, cfg, memory))
    h = _ln(x, blk["ln3"], cfg.norm_eps)
    return x + mlp.mlp(h, blk["mlp"], "gelu")


def _embed(params, cfg, tokens):
    s = tokens.shape[1]
    x = params["embed"][tokens.long()]
    return x + sinusoidal_positions(s, cfg.d_model, x.device).to(x.dtype)[None]


def _logits(params, cfg, x):
    x = _ln(x, params["dec_final_ln"], cfg.norm_eps)
    return x @ params["embed"].T                                     # tied head


def forward(params, cfg, batch) -> tuple[Tensor, Tensor]:
    tokens = batch["tokens"]
    b, s = tokens.shape
    memory = encode(params, cfg, batch["frames"].to(dtype_of(cfg)))
    positions = arange_positions(b, s, tokens.device)
    x = _embed(params, cfg, tokens)
    for i in range(cfg.n_layers):
        x = _dec_block(x, layer(params["dec_blocks"], i), cfg, positions, memory)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg, batch):
    logits, aux = forward(params, cfg, batch)
    ce = cross_entropy_loss(logits, batch["labels"])
    return ce, {"ce": ce, "aux": aux}


# ---- serving ----------------------------------------------------------------


def init_cache(cfg, batch_size: int, max_seq: int, device="cuda") -> dict:
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((L, batch_size, max_seq, kvh, hd), dtype=dtype, device=dev),
        "v": torch.zeros((L, batch_size, max_seq, kvh, hd), dtype=dtype, device=dev),
        "ck": torch.zeros((L, batch_size, cfg.n_frames, kvh, hd), dtype=dtype, device=dev),
        "cv": torch.zeros((L, batch_size, cfg.n_frames, kvh, hd), dtype=dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def prefill(params, cfg, batch) -> tuple[Tensor, dict]:
    """Encode + decoder prefill; fills the self- and cross-attention
    caches (the self cache padded to ``batch["max_seq"]``)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    memory = encode(params, cfg, batch["frames"].to(dtype_of(cfg)))
    positions = arange_positions(b, s, tokens.device)
    x = _embed(params, cfg, tokens)
    ks, vs, cks, cvs = [], [], [], []
    for i in range(cfg.n_layers):
        blk = layer(params["dec_blocks"], i)
        h = _ln(x, blk["ln1"], cfg.norm_eps)
        att, k, v = attention.prefill_attention_with_cache(h, blk["self_attn"], cfg,
                                                           positions)
        x = x + att
        h = _ln(x, blk["ln2"], cfg.norm_eps)
        ck, cv = _cross_kv(blk, cfg, memory)
        x = x + attention.full_attention(h, blk["cross_attn"], cfg, positions,
                                         cross_kv=(ck, cv))
        h = _ln(x, blk["ln3"], cfg.norm_eps)
        x = x + mlp.mlp(h, blk["mlp"], "gelu")
        ks.append(k)
        vs.append(v)
        cks.append(ck)
        cvs.append(cv)
    pad = int(batch.get("max_seq", s)) - s
    k_stack, v_stack = torch.stack(ks), torch.stack(vs)
    if pad > 0:
        k_stack = torch.nn.functional.pad(k_stack, (0, 0, 0, 0, 0, pad))
        v_stack = torch.nn.functional.pad(v_stack, (0, 0, 0, 0, 0, pad))
    return _logits(params, cfg, x[:, -1:]), {
        "k": k_stack, "v": v_stack, "ck": torch.stack(cks), "cv": torch.stack(cvs),
        "pos": torch.tensor(s, dtype=torch.int32, device=tokens.device)}


def decode_step(params, cfg, cache, tokens) -> tuple[Tensor, dict]:
    pos = cache["pos"]
    x = params["embed"][tokens.long()]
    # The new token's sinusoidal position.
    ang = pos.to(torch.float32) / sinusoid_timescales(cfg.d_model, x.device)
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :].to(x.dtype)
    nks, nvs = [], []
    for i in range(cfg.n_layers):
        blk = layer(params["dec_blocks"], i)
        h = _ln(x, blk["ln1"], cfg.norm_eps)
        att, nk, nv = attention.decode_attention(h, blk["self_attn"], cfg, cache["k"][i],
                                                 cache["v"][i], pos)
        x = x + att
        h = _ln(x, blk["ln2"], cfg.norm_eps)
        catt, _, _ = attention.decode_attention(h, blk["cross_attn"], cfg, cache["ck"][i],
                                                cache["cv"][i], pos, cross=True)
        x = x + catt
        h = _ln(x, blk["ln3"], cfg.norm_eps)
        x = x + mlp.mlp(h, blk["mlp"], "gelu")
        nks.append(nk)
        nvs.append(nv)
    return _logits(params, cfg, x), dict(cache, k=torch.stack(nks), v=torch.stack(nvs),
                                         pos=pos + 1)
