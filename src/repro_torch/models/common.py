"""Shared model components: norms, RoPE, initializers, the loss (port of
``repro.models.common``)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def rms_norm(x: Tensor, weight: Tensor, eps: float) -> Tensor:
    """RMSNorm in f32 accumulation, scaled by ``(1 + weight)``."""
    orig = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(orig)


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float) -> Tensor:
    orig = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32) + bias.to(torch.float32)).to(orig)


def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    """Inverse frequencies for rotary embeddings, f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary position embedding, half-split (not interleaved): the first
    and second halves of ``head_dim`` form the rotated pairs.

    Args:
      x: (..., seq, heads, head_dim)
      positions: (..., seq) int32 absolute positions.
    """
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, x.device)       # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * inv_freq  # (.., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                      # (.., s, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: Tensor, cap: float) -> Tensor:
    """Gemma-style logit soft-capping; no-op when cap == 0."""
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)


# ---- initializers -----------------------------------------------------------
# The port's own draws: a torch.Generator gives other numbers than
# jax.random from the same seed, so a test that compares the two models
# converts the reference's parameters (``repro_torch.convert``).  With
# ``gen=None`` each returns an empty meta tensor: shapes and dtypes only.


def _meta(shape, dtype) -> Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def normal_init(gen: torch.Generator | None, shape, dtype, scale: float = 0.02) -> Tensor:
    if gen is None:
        return _meta(shape, dtype)
    return (scale * torch.randn(shape, generator=gen, device=gen.device,
                                dtype=torch.float32)).to(dtype)


def fan_in_init(gen: torch.Generator | None, shape, dtype) -> Tensor:
    """Truncated normal on ±2 with ``fan_in ** -0.5`` scale (fan_in is the
    next-to-last dim, so a layer-stacked leaf keeps its layer's scale)."""
    if gen is None:
        return _meta(shape, dtype)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t.mul_(fan_in ** -0.5)).to(dtype)


def zeros_init(gen: torch.Generator | None, shape, dtype) -> Tensor:
    if gen is None:
        return _meta(shape, dtype)
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())


def cross_entropy_loss(logits: Tensor, labels: Tensor, *, z_loss: float = 0.0) -> Tensor:
    """Mean token cross-entropy in f32 with optional z-loss.

    logits: (..., V); labels: (...,) int.  Ignores label == -100 (any
    negative label).
    """
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss > 0.0:
        nll = nll + z_loss * torch.square(lse)
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
