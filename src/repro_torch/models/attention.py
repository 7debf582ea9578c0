"""GQA attention: training / prefill over the whole sequence, prefill
with the KV cache, and one-token decode (port of
``repro.models.attention``).

:func:`attn_parallel_mode` reads the active mesh
(``repro_torch.models.sharding``) as the reference's does.  The mesh's
collectives are not ported yet: the reference's sharding constraints,
its ring attention over ``kv_seq`` (context parallelism) and its
``lse_shardmap`` flash-decode combine run here as the reference's own
one-device path, the plain code below (``_ring_applicable`` is False
without a mesh, and ``decode_comm="lse_shardmap"`` falls through to
``_decode_xla``).
"""

from __future__ import annotations

import torch

from repro_torch.models import sharding
from repro_torch.models.common import apply_rope, fan_in_init, softcap, zeros_init

Tensor = torch.Tensor
NEG_INF = -2.0 ** 30  # large-but-finite; avoids NaN from (-inf) - (-inf)


def init_attention_params(gen: torch.Generator, cfg, dtype,
                          stack: tuple[int, ...] = ()) -> dict:
    """``stack`` prefixes every leaf with layer dims (one draw per leaf)."""
    d = cfg.d_model
    p = {
        "wq": fan_in_init(gen, stack + (d, cfg.q_dim), dtype),
        "wk": fan_in_init(gen, stack + (d, cfg.kv_dim), dtype),
        "wv": fan_in_init(gen, stack + (d, cfg.kv_dim), dtype),
        "wo": fan_in_init(gen, stack + (cfg.q_dim, d), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init(gen, stack + (cfg.q_dim,), dtype)
        p["bk"] = zeros_init(gen, stack + (cfg.kv_dim,), dtype)
        p["bv"] = zeros_init(gen, stack + (cfg.kv_dim,), dtype)
    return p


def _model_axis_size() -> int:
    mesh = sharding.get_mesh()
    if mesh is None:
        return 1
    axis = sharding.get_rule("heads")
    shape = sharding.mesh_shape(mesh)
    if axis is None or axis not in shape:
        return 1
    return int(shape[axis])


def attn_parallel_mode(cfg) -> str:
    """'tp' (shard heads over 'model') when both n_heads and n_kv_heads
    divide the model axis, or off a mesh; otherwise 'dp' — attention
    internals shard over 'data' only (compute duplicated across 'model';
    zero model-axis collectives).  The grouped score/value tensors are
    kv-head-major, so a non-dividing kv count would replicate the
    quadratic intermediates."""
    m = _model_axis_size()
    if m == 1:
        return "tp"
    if cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0:
        return "tp"
    return "dp"


def _project_q(x, p, cfg):
    """x: (B, S, D) -> q (B,S,H,hd), no rotary embedding (cross attention)."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return q.reshape(b, s, cfg.n_heads, cfg.head_dim)


def _project_qkv(x, p, cfg, positions):
    """x: (B, S, D) -> q (B,S,H,hd), k,v (B,S,Hkv,hd)."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k, cfg):
    """(B,S,H,hd) x (B,T,Hkv,hd) -> (B,Hkv,G,S,T) grouped scores."""
    b, s, h, hd = q.shape
    g = h // cfg.n_kv_heads
    qg = q.reshape(b, s, cfg.n_kv_heads, g, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / (hd ** 0.5)


def _gqa_out(weights, v, cfg):
    """(B,Hkv,G,S,T) x (B,T,Hkv,hd) -> (B,S,H,hd)."""
    b = v.shape[0]
    out = torch.einsum("bkgst,btkd->bskgd", weights, v)
    return out.reshape(b, out.shape[1], cfg.n_heads, cfg.head_dim)


def _attend_block(q_i, k, v, cfg, qpos_i, kpos, causal):
    """One query block vs the full key range.

    q_i: (B, Sq, H, hd); k/v: (B, T, Hkv, hd); qpos_i: (B, Sq);
    kpos: (B, T).  Returns (B, Sq, H, hd).  The softmax weights are cast
    to q's dtype before the P.V product, as in the reference."""
    scores = _gqa_scores(q_i, k, cfg)             # (B,Hkv,G,Sq,T)
    scores = softcap(scores, cfg.attn_logit_softcap)
    if causal:
        mask = kpos[:, None, :] <= qpos_i[:, :, None]        # (B,Sq,T)
        if cfg.sliding_window > 0:
            mask = mask & (kpos[:, None, :] > qpos_i[:, :, None] - cfg.sliding_window)
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    weights = torch.softmax(scores.to(torch.float32), dim=-1).to(q_i.dtype)
    return _gqa_out(weights, v, cfg)


def _masked_attention(q, k, v, cfg, qpos, kpos, causal):
    """Query-chunked attention: O(chunk x T) live scores instead of
    O(S x T), in chunks of ``cfg.attn_chunk`` queries when they divide S
    (the reference's ``lax.scan`` over chunks, as a loop)."""
    b, s, h, hd = q.shape
    chunk = cfg.attn_chunk
    if not chunk or s <= chunk or s % chunk:
        return _attend_block(q, k, v, cfg, qpos, kpos, causal)
    outs = [_attend_block(q[:, i:i + chunk], k, v, cfg, qpos[:, i:i + chunk],
                          kpos, causal)
            for i in range(0, s, chunk)]
    return torch.cat(outs, dim=1)


def flash_block(s: int) -> int:
    """The block the port passes to ``kernels.ops.flash_attention`` for a
    length-``s`` sequence: the largest power of two up to 128 dividing
    ``s``.  The kernels tile by their own blocks and take any length; the
    block only meets the wrapper's divisibility rule (the reference's
    default 128 refuses, e.g., whisper's 448 decoder positions)."""
    return min(s & -s, 128)


def full_attention(
    x: Tensor,
    p: dict,
    cfg,
    positions: Tensor,
    *,
    causal: bool = True,
    cross_kv: tuple[Tensor, Tensor] | None = None,
) -> Tensor:
    """Training / prefill attention over the whole sequence.

    ``cross_kv`` switches to encoder-decoder cross attention (k, v are
    precomputed from the encoder; no causal mask, no rotary embedding).
    With ``cfg.use_flash_kernel``, a causal self-attention with no logit
    softcap runs through ``kernels.ops.flash_attention`` (the
    hand-written kernel on CUDA tensors); everything else takes the plain
    chunked attention, as in the reference.
    """
    b, s, _ = x.shape
    if cross_kv is not None:
        q = _project_q(x, p, cfg)
        k, v = cross_kv
        causal = False
    else:
        q, k, v = _project_qkv(x, p, cfg, positions)
        if cfg.use_flash_kernel and causal and cfg.attn_logit_softcap == 0.0:
            from repro_torch.kernels import ops as kernel_ops

            blk = flash_block(s)
            out = kernel_ops.flash_attention(q, k, v, causal=True,
                                             window=cfg.sliding_window,
                                             block_q=blk, block_k=blk)
            return out.reshape(b, s, cfg.q_dim) @ p["wo"]
    t = k.shape[1]
    kpos = (positions[:, :t] if positions.shape[1] >= t
            else torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t))
    out = _masked_attention(q, k, v, cfg, positions, kpos, causal)
    return out.reshape(b, s, cfg.q_dim) @ p["wo"]


def prefill_attention_with_cache(
    x: Tensor, p: dict, cfg, positions: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """Prefill: returns (output, k, v) so the caller can fill the cache.
    Runs the plain chunked attention, as the reference's prefill does."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = _masked_attention(q, k, v, cfg, positions, positions, True)
    return out.reshape(b, s, cfg.q_dim) @ p["wo"], k, v


# ---- decode -----------------------------------------------------------------


def decode_attention(
    x: Tensor,
    p: dict,
    cfg,
    k_cache: Tensor,
    v_cache: Tensor,
    pos,
    *,
    cross: bool = False,
    ring: bool = False,
) -> tuple[Tensor, Tensor, Tensor]:
    """One-token decode.  x: (B, 1, D); caches: (B, S, Hkv, hd);
    pos: () or (B,) current position (the new token's index).

    ``cross=True`` attends to a fixed (encoder) cache: every slot is
    valid and the caches come back as they are.  ``ring=True`` treats the
    cache as a sliding-window ring buffer of length ``k_cache.shape[1]``
    (the hybrid's long-context path): the new entry lands at
    ``pos % len`` and every populated slot is valid.

    Returns (output (B,1,D), new_k_cache, new_v_cache); the input caches
    are left untouched, as in the reference."""
    b = x.shape[0]
    zeros = torch.zeros((b,), dtype=torch.int32, device=x.device)
    if cross:
        q = _project_q(x, p, cfg)
        valid_len = torch.full((b,), k_cache.shape[1], dtype=torch.int32, device=x.device)
        out = _decode_xla(q, k_cache, v_cache, valid_len, zeros, cfg)
        return out.reshape(b, 1, cfg.q_dim) @ p["wo"], k_cache, v_cache
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    posb = torch.atleast_1d(pos).expand(b)
    kv_len = k_cache.shape[1]
    scatter = (posb % kv_len if ring else posb).long()
    q, k, v = _project_qkv(x, p, cfg, posb[:, None])
    rows = torch.arange(b, device=x.device)
    new_k = k_cache.clone()
    new_v = v_cache.clone()
    new_k[rows, scatter] = k[:, 0]
    new_v[rows, scatter] = v[:, 0]
    if ring:
        valid_len = torch.clamp(posb + 1, max=kv_len)
        window_lo = zeros
    else:
        valid_len = posb + 1
        window_lo = (torch.clamp(valid_len - cfg.sliding_window, min=0)
                     if cfg.sliding_window > 0 else zeros)

    out = _decode_xla(q, new_k, new_v, valid_len, window_lo, cfg)
    out = out.reshape(b, 1, cfg.q_dim)
    return out @ p["wo"], new_k, new_v


def _decode_scores_masked(q, k, valid_len, window_lo, cfg):
    scores = _gqa_scores(q, k, cfg)  # (B,Hkv,G,1,T)
    scores = softcap(scores, cfg.attn_logit_softcap)
    t = k.shape[1]
    idx = torch.arange(t, dtype=torch.int32, device=k.device)[None, :]
    mask = (idx < valid_len[:, None]) & (idx >= window_lo[:, None])  # (B,T)
    return torch.where(mask[:, None, None, None, :], scores, NEG_INF)


def _decode_xla(q, k, v, valid_len, window_lo, cfg):
    """The reference's plain decode (its name kept)."""
    scores = _decode_scores_masked(q, k, valid_len, window_lo, cfg)
    weights = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return _gqa_out(weights, v, cfg)
