"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix
(port of ``repro.models.rwkv6``).

Chunked-parallel linear attention: within a chunk of 128 the per-channel
decays are taken relative to the chunk start and the interaction is a
masked matmul; across chunks a Python loop (the reference's
``lax.scan``) carries the (B, H, K, V) state.  Decode is O(1) per token.
The arithmetic is the reference's, ``exp(-cum)`` inside a chunk
included.

The data-dependent decay is the LoRA form:
``w_t = exp(-exp(w0 + tanh(x_t A) B))`` per channel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import const_init, fan_in_init, normal_init

Tensor = torch.Tensor

DECAY_LORA = 64
# The time-mix's chunk length (the reference's default).
CHUNK = 128


def dims(cfg) -> tuple[int, int]:
    """(n_heads, head_dim)."""
    head_dim = cfg.head_dim if cfg.head_dim else 64
    return cfg.d_model // head_dim, head_dim


def init_rwkv6_params(gen: torch.Generator | None, cfg, dtype,
                      stack: tuple[int, ...] = ()) -> dict:
    """``stack`` prefixes every leaf with layer dims (one draw per leaf)."""
    d = cfg.d_model
    nh, hk = dims(cfg)
    f32 = torch.float32

    def mu():
        return normal_init(gen, stack + (d,), f32, 0.02) + 0.5

    return {
        # time-mix
        "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_w": mu(),
        "w_r": fan_in_init(gen, stack + (d, d), dtype),
        "w_k": fan_in_init(gen, stack + (d, d), dtype),
        "w_v": fan_in_init(gen, stack + (d, d), dtype),
        "w_g": fan_in_init(gen, stack + (d, d), dtype),
        "w_o": fan_in_init(gen, stack + (d, d), dtype),
        "decay_w0": const_init(gen, stack + (d,), -6.0, f32),
        "decay_a": normal_init(gen, stack + (d, DECAY_LORA), f32, 0.01),
        "decay_b": const_init(gen, stack + (DECAY_LORA, d), 0.0, f32),
        "bonus_u": const_init(gen, stack + (nh, hk), 0.0, f32),
        # channel-mix
        "cm_mu_k": mu(), "cm_mu_r": mu(),
        "cm_k": fan_in_init(gen, stack + (d, cfg.d_ff), dtype),
        "cm_r": fan_in_init(gen, stack + (d, d), dtype),
        "cm_v": fan_in_init(gen, stack + (cfg.d_ff, d), dtype),
    }


def _token_shift(x: Tensor, prev: Tensor | None = None) -> Tensor:
    """x_{t-1} (zeros / ``prev`` for t=0).  x: (B, L, D)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    elif prev.dim() == 2:
        prev = prev[:, None, :]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    # mu is f32; keep the activation dtype (bf16) on the mixed stream.
    return (x * mu + xs * (1.0 - mu)).to(x.dtype)


def _decay(xw: Tensor, p: dict) -> Tensor:
    """Data-dependent per-channel log-decay (<= 0)."""
    lora = xw.to(torch.float32) @ p["decay_a"]
    w = p["decay_w0"] + torch.tanh(lora) @ p["decay_b"]
    return -torch.exp(w)  # log w_t


def rwkv6_time_mix(x: Tensor, p: dict, cfg, *, chunk: int = CHUNK,
                   return_state: bool = False):
    """Full-sequence chunked time-mix.  x: (B, L, D) -> (B, L, D).

    ``return_state=True`` also returns the (B, H, K, V) state at the end
    of the sequence (exact one-pass prefill).  Raises ``ValueError``
    where the reference asserts: ``L`` not a multiple of the chunk."""
    bsz, l, d = x.shape
    nh, hk = dims(cfg)
    q = min(chunk, l)
    if q <= 0 or l % q:
        raise ValueError(f"seq {l} not divisible by chunk {q}")
    g = l // q

    xs = _token_shift(x)
    r = _mix(x, xs, p["mu_r"]) @ p["w_r"]
    k = _mix(x, xs, p["mu_k"]) @ p["w_k"]
    v = _mix(x, xs, p["mu_v"]) @ p["w_v"]
    gate = F.silu(_mix(x, xs, p["mu_w"]) @ p["w_g"])
    logw = _decay(_mix(x, xs, p["mu_w"]), p)                        # (B,L,D) <= 0

    # Heads.
    rh = r.reshape(bsz, g, q, nh, hk).to(torch.float32)
    kh = k.reshape(bsz, g, q, nh, hk).to(torch.float32)
    vh = v.reshape(bsz, g, q, nh, hk).to(torch.float32)
    lw = logw.reshape(bsz, g, q, nh, hk)

    cum = torch.cumsum(lw, dim=2)                                   # (B,G,Q,H,K)
    total = cum[:, :, -1]                                           # (B,G,H,K)

    # Intra-chunk (strictly causal): score[i,j] = (r_i*exp(cum_{i-1}-cum_j)).k_j
    # with the per-step bonus u on the diagonal.
    cum_prev = cum - lw                                             # cum_{i-1}
    ri = rh * torch.exp(cum_prev)                                   # (B,G,Q,H,K)
    kj = kh * torch.exp(-cum)                                       # relative
    scores = torch.einsum("bgihk,bgjhk->bghij", ri, kj)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device), diagonal=-1)
    scores = torch.where(tri[None, None, None], scores, torch.zeros((), device=x.device))
    y_intra = torch.einsum("bghij,bgjhk->bgihk", scores, vh)
    diag = torch.einsum("bgihk,bgihk->bgih", rh, kh * p["bonus_u"][None, None, None])
    y_intra = y_intra + diag[..., None] * vh

    # Chunk-final state increments: S += sum_j exp(total - cum_j) k_j (x) v_j.
    wj = torch.exp(total[:, :, None] - cum)                         # (B,G,Q,H,K)
    s_chunk = torch.einsum("bgjhk,bgjhv->bghkv", kh * wj, vh)

    s_cur = torch.zeros((bsz, nh, hk, hk), dtype=torch.float32, device=x.device)
    s_prevs = []
    for gi in range(g):
        s_prevs.append(s_cur)
        s_cur = s_cur * torch.exp(total[:, gi])[..., None] + s_chunk[:, gi]
    s_prevs = torch.stack(s_prevs, dim=1)                           # (B,G,H,K,V)

    y_inter = torch.einsum("bgihk,bghkv->bgihv", ri, s_prevs)
    y = (y_intra + y_inter).reshape(bsz, l, d).to(x.dtype)
    out = (y * gate) @ p["w_o"]
    if not return_state:
        return out
    return out, s_cur


def rwkv6_channel_mix(x: Tensor, p: dict) -> Tensor:
    xs = _token_shift(x)
    k = _mix(x, xs, p["cm_mu_k"]) @ p["cm_k"]
    k = torch.square(F.relu(k))
    r = torch.sigmoid(_mix(x, xs, p["cm_mu_r"]) @ p["cm_r"])
    return r * (k @ p["cm_v"])


def init_rwkv6_cache(bsz: int, cfg, dtype, device) -> dict:
    nh, hk = dims(cfg)
    d = cfg.d_model
    return {
        "state": torch.zeros((bsz, nh, hk, hk), dtype=torch.float32, device=device),
        "tm_shift": torch.zeros((bsz, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros((bsz, d), dtype=dtype, device=device),
    }


def rwkv6_decode(x: Tensor, p: dict, cfg, cache: dict) -> tuple[Tensor, None, dict]:
    """One-token step: ``(time-mix out, None, new cache)``; the caller
    runs the channel mix through :func:`rwkv6_channel_mix_step` on its
    own post-time-mix residual (the reference's three-value signature)."""
    bsz, _, d = x.shape
    nh, hk = dims(cfg)
    xt = x[:, 0]
    xs = cache["tm_shift"].to(xt.dtype)

    def mix1(mu):
        return (xt * mu + xs * (1.0 - mu)).to(xt.dtype)

    r = (mix1(p["mu_r"]) @ p["w_r"]).reshape(bsz, nh, hk).to(torch.float32)
    k = (mix1(p["mu_k"]) @ p["w_k"]).reshape(bsz, nh, hk).to(torch.float32)
    v = (mix1(p["mu_v"]) @ p["w_v"]).reshape(bsz, nh, hk).to(torch.float32)
    gate = F.silu(mix1(p["mu_w"]) @ p["w_g"])
    lora = torch.tanh(mix1(p["mu_w"]).to(torch.float32) @ p["decay_a"])
    logw = -torch.exp(p["decay_w0"] + lora @ p["decay_b"])
    w = torch.exp(logw).reshape(bsz, nh, hk)

    s = cache["state"]                                              # (B,H,K,V)
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r, s + p["bonus_u"][None, :, :, None] * kv)
    s_new = s * w[..., None] + kv
    tm_out = (out.reshape(bsz, d) * gate).to(x.dtype) @ p["w_o"]
    new_cache = dict(cache, state=s_new, tm_shift=xt)
    return tm_out[:, None, :], None, new_cache


def rwkv6_channel_mix_step(x: Tensor, p: dict, cache: dict) -> tuple[Tensor, dict]:
    xt = x[:, 0]
    xs = cache["cm_shift"].to(xt.dtype)
    mk = (xt * p["cm_mu_k"] + xs * (1 - p["cm_mu_k"])).to(xt.dtype)
    mr = (xt * p["cm_mu_r"] + xs * (1 - p["cm_mu_r"])).to(xt.dtype)
    k = torch.square(F.relu(mk @ p["cm_k"]))
    r = torch.sigmoid(mr @ p["cm_r"])
    out = (r * (k @ p["cm_v"])).to(xt.dtype)
    return out[:, None, :], dict(cache, cm_shift=xt)
