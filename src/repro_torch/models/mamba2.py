"""Mamba2 block (SSD — state-space duality), chunked-parallel form (port
of ``repro.models.mamba2``).

Used by zamba2-1.2b's backbone.  The sequence is processed in chunks of
``q = min(cfg.ssm_chunk, L)``: quadratic attention-like compute within a
chunk, linear state passing across chunks (a Python loop over the
chunks, the reference's ``lax.scan``), so the full (L, H, N, P) state
tensor never materializes.

The reference's three-operand einsums are written as two products each,
in the contraction order XLA's ``einsum`` picks for them (opt_einsum's
path, the same at the reduced and the full widths): a product that
contracts a sequence or state axis never meets a (B, G, Q, Q, H, P)
outer product, which would take 8.6 GB per layer at zamba2's width.

Decode carries the per-head state ``(B, H, N, P)`` in f32 plus a short
depthwise-conv window in the activation dtype — O(1) per token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import const_init, fan_in_init, init_device, normal_init

Tensor = torch.Tensor

CONV_WIDTH = 4


def dims(cfg) -> tuple[int, int, int, int]:
    """(d_in, n_heads, head_dim, state)."""
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba2_params(gen: torch.Generator | None, cfg, dtype,
                       stack: tuple[int, ...] = ()) -> dict:
    """``stack`` prefixes every leaf with layer dims (one draw per leaf)."""
    d = cfg.d_model
    d_in, nh, _, ns = dims(cfg)
    conv_ch = d_in + 2 * ns
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                     device=init_device(gen)))
    return {
        # in_proj -> [z (d_in), x (d_in), B (ns), C (ns), dt (nh)]
        "in_proj": fan_in_init(gen, stack + (d, 2 * d_in + 2 * ns + nh), dtype),
        "conv_w": normal_init(gen, stack + (CONV_WIDTH, conv_ch), dtype, scale=0.1),
        "conv_b": const_init(gen, stack + (conv_ch,), 0.0, dtype),
        "a_log": a_log.expand(stack + (nh,)).clone(),
        "dt_bias": const_init(gen, stack + (nh,), 0.0, torch.float32),
        "d_skip": const_init(gen, stack + (nh,), 1.0, torch.float32),
        "out_proj": fan_in_init(gen, stack + (d_in, d), dtype),
    }


def _split_proj(xz: Tensor, cfg):
    """[z, x, B, C, dt] along the last axis."""
    d_in, nh, _, ns = dims(cfg)
    return torch.split(xz, [d_in, d_in, ns, ns, nh], dim=-1)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv, x: (B, L, C), w: (W, C); taps added in
    order, as the reference does."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return F.silu(out + b)


def mamba2_forward(x: Tensor, p: dict, cfg, *, return_state: bool = False):
    """Full-sequence chunked SSD.  x: (B, L, D) -> (B, L, D).

    ``return_state=True`` also returns the decode cache at the end of the
    sequence (exact prefill in one linear pass).  Raises ``ValueError``
    where the reference asserts: ``L`` not a multiple of the chunk."""
    bsz, l, _ = x.shape
    d_in, nh, hp, ns = dims(cfg)
    q = min(cfg.ssm_chunk, l)
    if q <= 0 or l % q:
        raise ValueError(f"seq {l} not divisible by chunk {q}")
    g = l // q

    xz = x @ p["in_proj"]
    z, xin, bmat, cmat, dt = _split_proj(xz, cfg)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xin, bmat, cmat = torch.split(conv_out, [d_in, ns, ns], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])            # (B,L,H)
    a = -torch.exp(p["a_log"])                                      # (H,)
    log_decay = dt * a[None, None, :]                               # (B,L,H) <= 0

    xh = xin.reshape(bsz, l, nh, hp).to(torch.float32)
    xbar = xh * dt[..., None]                                       # (B,L,H,P)
    bmat = bmat.to(torch.float32)                                   # (B,L,N)
    cmat = cmat.to(torch.float32)

    # Chunked views.
    xb = xbar.reshape(bsz, g, q, nh, hp)
    bv = bmat.reshape(bsz, g, q, ns)
    cv = cmat.reshape(bsz, g, q, ns)
    ld = log_decay.reshape(bsz, g, q, nh)
    cum = torch.cumsum(ld, dim=2)                                   # (B,G,Q,H)
    total = cum[:, :, -1, :]                                        # (B,G,H)

    # Intra-chunk: scores[i,j] = (C_i . B_j) * exp(cum_i - cum_j), j <= i.
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]             # (B,G,Q,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay_ij = torch.where(tri[None, None, :, :, None], torch.exp(rel),
                           torch.zeros((), device=x.device))
    cb = torch.einsum("bgin,bgjn->bgij", cv, bv)                    # (B,G,Q,Q)
    # "bgij,bgijh,bgjhp->bgihp": (decay * cb), then the sum over j.
    y_intra = torch.einsum("bgijh,bgjhp->bgihp", decay_ij * cb[..., None], xb)

    # Chunk-final contributions to the running state:
    # S_g_in = sum_j exp(total - cum_j) B_j (x)_j   -> (B,G,H,N,P)
    w_j = torch.exp(total[:, :, None, :] - cum)                     # (B,G,Q,H)
    # "bgjn,bgjh,bgjhp->bghnp": (x * w), then the sum over j with B.
    s_chunk = torch.einsum("bgjhp,bgjn->bghnp", xb * w_j[..., None], bv)

    # Inter-chunk recurrence: H_g = exp(total_g) * H_{g-1} + S_chunk_g.
    h_cur = torch.zeros((bsz, nh, ns, hp), dtype=torch.float32, device=x.device)
    h_prevs = []
    for gi in range(g):
        h_prevs.append(h_cur)
        h_cur = h_cur * torch.exp(total[:, gi])[:, :, None, None] + s_chunk[:, gi]
    h_prevs = torch.stack(h_prevs, dim=1)                           # (B,G,H,N,P)

    # Inter-chunk output: y_i += C_i . H_{g-1} * exp(cum_i).
    # "bgin,bgih,bghnp->bgihp": (C x exp(cum)), then the sum over n.
    y_inter = torch.einsum("bgihn,bghnp->bgihp",
                           torch.exp(cum)[..., None] * cv[:, :, :, None, :], h_prevs)

    y = (y_intra + y_inter).reshape(bsz, l, nh, hp)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, l, d_in).to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    # Decode cache at position l: final SSM state + conv tail window.
    tail = conv_in[:, l - (CONV_WIDTH - 1):, :]
    return out, {"ssm": h_cur, "conv": tail}


def init_mamba2_cache(bsz: int, cfg, dtype, device) -> dict:
    d_in, nh, hp, ns = dims(cfg)
    conv_ch = d_in + 2 * ns
    return {
        "ssm": torch.zeros((bsz, nh, ns, hp), dtype=torch.float32, device=device),
        "conv": torch.zeros((bsz, CONV_WIDTH - 1, conv_ch), dtype=dtype, device=device),
    }


def mamba2_decode(x: Tensor, p: dict, cfg, cache: dict) -> tuple[Tensor, dict]:
    """One-token step.  x: (B, 1, D) -> ((B, 1, D), new cache)."""
    bsz = x.shape[0]
    d_in, nh, hp, ns = dims(cfg)

    xz = (x @ p["in_proj"])[:, 0]
    z, xin, bmat, cmat, dt = _split_proj(xz, cfg)

    conv_in = torch.cat([xin, bmat, cmat], dim=-1)                  # (B,C)
    window = torch.cat([cache["conv"], conv_in[:, None, :]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    xin, bmat, cmat = torch.split(conv_out, [d_in, ns, ns], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])            # (B,H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a[None, :])                              # (B,H)

    xh = xin.reshape(bsz, nh, hp).to(torch.float32)
    xbar = xh * dt[..., None]
    bmat = bmat.to(torch.float32)
    cmat = cmat.to(torch.float32)

    h = cache["ssm"] * decay[:, :, None, None] + torch.einsum("bn,bhp->bhnp", bmat, xbar)
    y = torch.einsum("bn,bhnp->bhp", cmat, h) + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, d_in).to(x.dtype)
    y = y * F.silu(z)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"ssm": h, "conv": window[:, 1:, :]}
