"""GQA attention: training / prefill over the whole sequence, prefill
with the KV cache, and one-token decode (port of
``repro.models.attention``).

:func:`attn_parallel_mode` reads the active mesh
(``repro_torch.models.sharding``) as the reference's does, and the
mesh's two collective regions run through ``sharding.shard_map``:

  * ring attention over ``kv_seq`` (context parallelism): in "dp" mode,
    when the axis divides the sequence, ``forward``, training and prefill
    rotate K/V blocks around the ring (``_ring_applicable`` /
    ``_ring_attention``); B.8's ``use_flash_kernel`` path keeps its
    priority, as in the reference's ``full_attention``;
  * the ``lse_shardmap`` flash-decode combine (``cfg.decode_comm``):
    each ``kv_seq`` shard of the cache computes a partial decode and the
    shards combine with a ``pmax`` and two ``psum``s; self, ring-buffer
    and cross decodes all take it (``_decode_lse_shardmap``).

Off a mesh both fall through to the plain code, the reference's own
one-device path.

The reference's sharding constraints sit at its sites (``_project_qkv``,
``_shard_scores``, ``full_attention``'s output, the decode's cache): the
identity on plain tensors, a redistribution of DTensors on a
``DeviceMesh``.  There B.8 runs on each rank's local heads or batch
rows (:func:`flash_attention_spmd`) and the decode writes each rank's
block of the sequence-sharded cache (:func:`write_cache`).
"""

from __future__ import annotations

import functools

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


def split_heads(t, n: int, cfg, logical: str):
    """(B, S, n·hd) -> (B, S, n, hd).  In "tp" mode the flat projection is
    placed on ``logical`` ("heads" / "kv_heads") before the reshape and
    the heads after it, as :func:`_project_qkv` places q/k/v; otherwise
    on the batch only."""
    b, s, _ = t.shape
    tp = attn_parallel_mode(cfg) == "tp"
    t = sharding.shard(t, "batch", None, logical if tp else None)
    t = t.reshape(b, s, n, cfg.head_dim)
    return sharding.shard(t, "batch", None, logical if tp else None, None)


def _project_q(x, p, cfg):
    """x: (B, S, D) -> q (B,S,H,hd), no rotary embedding (cross attention)."""
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return split_heads(q, cfg.n_heads, cfg, "heads")


def _project_qkv(x, p, cfg, positions, *, flash: bool = False):
    """x: (B, S, D) -> q (B,S,H,hd), k,v (B,S,Hkv,hd), constrained as the
    reference's: heads over 'model' in "tp" mode, else the sequence over
    ``kv_seq`` where the ring runs (not for the flash kernel, which runs
    on whole sequences), else the batch only.  The flat projections are
    placed before the reshape into heads, whose split of a model-sharded
    dim needs the heads to divide the axis ("tp")."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    tp = attn_parallel_mode(cfg) == "tp"
    q = sharding.shard(q, "batch", None, "heads" if tp else None)
    k = sharding.shard(k, "batch", None, "kv_heads" if tp else None)
    v = sharding.shard(v, "batch", None, "kv_heads" if tp else None)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if tp:
        q = sharding.shard(q, "batch", None, "heads", None)
        k = sharding.shard(k, "batch", None, "kv_heads", None)
        v = sharding.shard(v, "batch", None, "kv_heads", None)
    elif not flash and _ring_applicable(cfg, s, s):
        q, k, v = (sharding.shard(t, "batch", "kv_seq", None, None) for t in (q, k, v))
    else:  # batch-only: no model-axis collectives inside attention
        q, k, v = (sharding.shard(t, "batch", None, None, None) for t in (q, k, v))
    return q, k, v


def _shard_scores(scores, cfg):
    """scores: (B, Hkv, G, S, T) — shard heads (tp) or batch only (dp)."""
    if attn_parallel_mode(cfg) == "tp":
        return sharding.shard(scores, "batch", "kv_heads", None, None, None)
    return sharding.shard(scores, "batch", None, None, None, None)


def _gqa_scores(q, k, cfg):
    """(B,S,H,hd) x (B,T,Hkv,hd) -> (B,Hkv,G,S,T) grouped scores."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]                  # a rank's local kv heads inside local_map
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / (hd ** 0.5)


def _gqa_out(weights, v, cfg):
    """(B,Hkv,G,S,T) x (B,T,Hkv,hd) -> (B,S,H,hd)."""
    out = torch.einsum("bkgst,btkd->bskgd", weights, v)
    b, s, kvh, g, hd = out.shape
    return out.reshape(b, s, kvh * g, hd)


def _ring_body(ax, q, k, v, qpos, kpos, *, cfg, causal):
    """One ring over the ``ax.size`` shards (each a leading-dim slice).

    q: (X, B, S/P, H, hd); k, v: (X, B, S/P, Hkv, hd); qpos, kpos:
    (X, B, S/P).  Shard j meets key blocks j, j-1, ..., j-P+1 (mod P),
    keeping flash-style running (max, sum, out) statistics in f32."""
    x_, b, sl, h, hd = q.shape
    kvh = cfg.n_kv_heads
    g = h // kvh
    perm = [(j, (j + 1) % ax.size) for j in range(ax.size)]
    qg = q.reshape(x_, b, sl, kvh, g, hd)
    m = torch.full((x_, b, kvh, g, sl, 1), NEG_INF, dtype=torch.float32, device=q.device)
    acc_l = torch.zeros_like(m)
    acc_o = torch.zeros((x_, b, kvh, g, sl, hd), dtype=torch.float32, device=q.device)
    for step in range(ax.size):
        scores = torch.einsum("xbskgd,xbtkd->xbkgst", qg, k).to(torch.float32) / (hd ** 0.5)
        if cfg.attn_logit_softcap > 0.0:
            scores = cfg.attn_logit_softcap * torch.tanh(scores / cfg.attn_logit_softcap)
        if causal:
            mask = kpos[:, :, None, :] <= qpos[:, :, :, None]          # (X,B,S,T)
            if cfg.sliding_window > 0:
                mask = mask & (kpos[:, :, None, :] > qpos[:, :, :, None] - cfg.sliding_window)
            scores = torch.where(mask[:, :, None, None], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(scores - m_new)
        acc_l = acc_l * alpha + pexp.sum(dim=-1, keepdim=True)
        acc_o = acc_o * alpha + torch.einsum(
            "xbkgst,xbtkd->xbkgsd", pexp.to(v.dtype), v).to(torch.float32)
        m = m_new
        if step < ax.size - 1:
            k, v, kpos = (ax.permute(t, perm) for t in (k, v, kpos))
    out = acc_o / torch.clamp(acc_l, min=1e-30)
    out = out.permute(0, 1, 4, 2, 3, 5)               # (X,B,kv,g,S,hd) -> (X,B,S,kv,g,hd)
    return out.reshape(x_, b, sl, h, hd).to(q.dtype)


def _ring_attention(q, k, v, cfg, qpos, kpos, causal):
    """Ring attention (context parallelism) over the ``kv_seq`` axis.

    q/k/v are sequence-sharded across the ring; K/V blocks rotate by
    ``permute`` while each shard keeps flash-style running statistics
    (:func:`sharding.shard_map`: the ring's ranks on a ``DeviceMesh``, or
    all its shards stacked in one process on a ``MeshShape``).
    Differentiable: the ring is a Python loop over a static P, the
    permute's backward the inverse permute."""
    axis = sharding.get_rule("kv_seq")
    data = sharding.get_rule("batch")
    seq = (data, axis, None, None)
    fn = sharding.shard_map(
        functools.partial(_ring_body, cfg=cfg, causal=causal),
        in_specs=(seq, seq, seq, (data, axis), (data, axis)),
        out_specs=seq, axis=axis)
    return fn(q, k, v, qpos, kpos)


def _ring_applicable(cfg, s: int, t: int) -> bool:
    mesh = sharding.get_mesh()
    if mesh is None or cfg.attn_impl != "auto":
        return False
    axis = sharding.get_rule("kv_seq")
    shape = sharding.mesh_shape(mesh)
    if axis is None or axis not in shape:
        return False
    p = int(shape[axis])
    return p > 1 and s == t and s % p == 0 and attn_parallel_mode(cfg) != "tp"


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
    scores = _shard_scores(scores, cfg)
    weights = torch.softmax(scores.to(torch.float32), dim=-1).to(q_i.dtype)
    return _gqa_out(weights, v, cfg)


def _masked_attention(q, k, v, cfg, qpos, kpos, causal):
    """Query-chunked attention: O(chunk x T) live scores instead of
    O(S x T), in chunks of ``cfg.attn_chunk`` queries when they divide S
    (the reference's ``lax.scan`` over chunks, as a loop).  Under a mesh
    whose ``kv_seq`` axis splits the sequence in "dp" mode, the ring
    attention runs instead, as in the reference.  On DTensors the chunks
    run on each rank's local heads ("tp") or batch rows ("dp")
    (``sharding.local_map``), as B.8 does: DTensor's rules would split the
    grouped score products' flattened batch into strided shards."""
    if _ring_applicable(cfg, q.shape[1], k.shape[1]):
        return _ring_attention(q, k, v, cfg, qpos, kpos, causal)
    if attn_parallel_mode(cfg) == "tp":
        q_axes, kv_axes = ("batch", None, "heads", None), ("batch", None, "kv_heads", None)
    else:
        q_axes = kv_axes = ("batch", None, None, None)

    def run(q_, k_, v_, qpos_, kpos_):
        return _chunked_attention(q_, k_, v_, cfg, qpos_, kpos_, causal)

    return sharding.local_map(run, (q_axes, kv_axes, kv_axes, ("batch", None), ("batch", None)),
                              q_axes)(q, k, v, qpos, kpos)


def _chunked_attention(q, k, v, cfg, qpos, kpos, causal):
    """:func:`_masked_attention`'s chunks, on whole tensors."""
    s = q.shape[1]
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


def flash_attention_spmd(q, k, v, cfg):
    """B.8, ``kernels.ops.flash_attention`` (causal, the config's window),
    on q (B, S, H, hd) and k/v (B, S, Hkv, hd).  On DTensors it runs on
    each rank's local block (``sharding.local_map``): in "tp" mode its
    H/m query heads and Hkv/m kv heads, so every GQA group stays whole on
    one rank, in "dp" mode its batch rows; the output is wrapped with the
    placement it was computed under.  On plain tensors it is the wrapper
    itself."""
    from repro_torch.kernels import ops as kernel_ops

    blk = flash_block(q.shape[1])
    if attn_parallel_mode(cfg) == "tp":
        q_axes, kv_axes = ("batch", None, "heads", None), ("batch", None, "kv_heads", None)
    else:
        q_axes = kv_axes = ("batch", None, None, None)

    def run(q_, k_, v_):
        return kernel_ops.flash_attention(q_, k_, v_, causal=True, window=cfg.sliding_window,
                                          block_q=blk, block_k=blk)

    return sharding.local_map(run, (q_axes, kv_axes, kv_axes), q_axes)(q, k, v)


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
    elif cfg.use_flash_kernel and causal and cfg.attn_logit_softcap == 0.0:
        q, k, v = _project_qkv(x, p, cfg, positions, flash=True)
        out = flash_attention_spmd(q, k, v, cfg)
        return out.reshape(b, s, cfg.q_dim) @ p["wo"]
    else:
        q, k, v = _project_qkv(x, p, cfg, positions)
    t = k.shape[1]
    kpos = (positions[:, :t] if positions.shape[1] >= t
            else torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t))
    out = _masked_attention(q, k, v, cfg, positions, kpos, causal)
    if attn_parallel_mode(cfg) == "tp":
        out = sharding.shard(out, "batch", None, "heads", None)
    else:
        out = sharding.shard(out, "batch", None, None, None)
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

CACHE_AXES = ("batch", "kv_seq", None, None)


def write_cache(cache, new, slot):
    """A copy of the DTensor ``cache`` (B, T, Hkv, hd) with row b's slot
    ``slot[b]`` (a plain tensor) set to ``new[b, 0]``.  Each rank writes
    its own block of the cache (sequence-sharded over ``kv_seq``), and
    only the rows whose slot falls in it: DTensor has no rule for writing
    one position of a sharded dim."""
    spec = sharding.resolve(cache.shape, CACHE_AXES)
    b0 = sharding.block_start(cache.shape, spec, 0)
    t0 = sharding.block_start(cache.shape, spec, 1)

    def write(c, n):
        bl, tl = c.shape[:2]
        local = slot[b0:b0 + bl] - t0
        mine = (local >= 0) & (local < tl)
        local = local.clamp(0, tl - 1)
        rows = torch.arange(bl, device=c.device)
        out = c.clone()
        out[rows, local] = torch.where(mine[:, None, None], n[:, 0], c[rows, local])
        return out

    return sharding.local_map(write, (CACHE_AXES, ("batch", None, None, None)),
                              CACHE_AXES)(cache, new)


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
    are left untouched, as in the reference.  With
    ``cfg.decode_comm == "lse_shardmap"`` under a mesh, the attention runs
    as a flash-decode over the cache's ``kv_seq`` shards
    (:func:`_decode_lse_shardmap`)."""
    b = x.shape[0]
    zeros = torch.zeros((b,), dtype=torch.int32, device=x.device)
    if cross:
        q = _project_q(x, p, cfg)
        new_k, new_v = k_cache, v_cache
        valid_len = torch.full((b,), k_cache.shape[1], dtype=torch.int32, device=x.device)
        window_lo = zeros
    else:
        pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
        posb = torch.atleast_1d(pos).expand(b)
        kv_len = k_cache.shape[1]
        scatter = (posb % kv_len if ring else posb).long()
        q, k, v = _project_qkv(x, p, cfg, posb[:, None])
        if sharding.is_dtensor(k_cache):
            new_k = write_cache(k_cache, k, scatter)
            new_v = write_cache(v_cache, v, scatter)
        else:
            rows = torch.arange(b, device=x.device)
            new_k = k_cache.clone()
            new_v = v_cache.clone()
            new_k[rows, scatter] = k[:, 0]
            new_v[rows, scatter] = v[:, 0]
        new_k = sharding.shard(new_k, *CACHE_AXES)
        new_v = sharding.shard(new_v, *CACHE_AXES)
        if ring:
            valid_len = torch.clamp(posb + 1, max=kv_len)
            window_lo = zeros
        else:
            valid_len = posb + 1
            window_lo = (torch.clamp(valid_len - cfg.sliding_window, min=0)
                         if cfg.sliding_window > 0 else zeros)

    if cfg.decode_comm == "lse_shardmap" and sharding.get_mesh() is not None:
        out = _decode_lse_shardmap(q, new_k, new_v, valid_len, window_lo, cfg)
    else:
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


def _lse_body(ax, q, k, v, valid, lo, base, *, cfg):
    """One shard's partial flash-decode, combined over the shards.

    q: (X, B, 1, H, hd) (every shard's copy); k, v: (X, B, T/P, Hkv, hd),
    the shard's slice of the cache; valid, lo: (X, B); base: (X, 1), the
    shard's global offset.  Returns (X, B, 1, Hkv, G, hd)."""
    x_, b, tl = k.shape[:3]
    scores = _gqa_scores(q.flatten(0, 1), k.flatten(0, 1), cfg)     # (XB,K,G,1,Tl)
    scores = softcap(scores, cfg.attn_logit_softcap).unflatten(0, (x_, b))
    idx = base[:, :, None] + torch.arange(tl, dtype=torch.int32, device=k.device)
    mask = (idx < valid[:, :, None]) & (idx >= lo[:, :, None])        # (X,B,Tl)
    scores = torch.where(mask[:, :, None, None, None], scores, NEG_INF)
    scores = scores.to(torch.float32)
    m_glob = ax.pmax(scores.amax(dim=-1, keepdim=True))                # (X,B,K,G,1,1)
    e = torch.exp(scores - m_glob)
    denom = ax.psum(e.sum(dim=-1, keepdim=True))
    part = torch.einsum("xbkgst,xbtkd->xbskgd", e.to(q.dtype), v)
    num = ax.psum(part.to(torch.float32))                              # (X,B,1,K,G,hd)
    d = denom[:, :, :, :, 0, 0][:, :, None]                            # (X,B,1,K,G)
    return (num / torch.clamp(d[..., None], min=1e-30)).to(q.dtype)


def _decode_lse_shardmap(q, k, v, valid_len, window_lo, cfg):
    """Flash-decode combine across the sequence-sharded KV cache: each
    ``kv_seq`` shard computes its local max, sum of exponentials and
    weighted values, and the shards combine them with a ``pmax`` and two
    ``psum``s (:func:`sharding.shard_map`).  Without a ``kv_seq`` axis on
    the mesh, or with a cache length it does not divide, the plain
    decode runs, as in the reference."""
    axis = sharding.get_rule("kv_seq")
    shape = sharding.mesh_shape(sharding.get_mesh())
    if axis is None or axis not in shape:
        return _decode_xla(q, k, v, valid_len, window_lo, cfg)
    n_shards = int(shape[axis])
    t = k.shape[1]
    if t % n_shards != 0:
        return _decode_xla(q, k, v, valid_len, window_lo, cfg)
    data = sharding.get_rule("batch")
    offsets = torch.arange(n_shards, dtype=torch.int32, device=k.device) * (t // n_shards)
    fn = sharding.shard_map(
        functools.partial(_lse_body, cfg=cfg),
        in_specs=((data, None, None, None),        # q replicated over the axis
                  (data, axis, None, None),        # k sequence-sharded
                  (data, axis, None, None),        # v sequence-sharded
                  (data,), (data,),                # valid_len, window_lo
                  (axis,)),                        # each shard's base offset
        out_specs=(data, None, None, None, None), axis=axis)
    out = fn(q, k, v, valid_len, window_lo, offsets)                  # (B,1,K,G,hd)
    return out.reshape(q.shape[0], 1, cfg.n_heads, cfg.head_dim)
