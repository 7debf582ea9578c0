"""Shared model components: norms, RoPE, sinusoidal positions,
initializers, the loss (port of ``repro.models.common``).

On DTensors (the dense transformer's SPMD on a ``DeviceMesh``)
``rms_norm``, ``apply_rope`` and ``softcap`` run through DTensor's own
rules, each on the placement the caller's constraint gave: they reduce
only over the last, unsharded dim, and the plain tensors they make
(rope's angles) meet DTensors as replicated values under
``sharding.spmd``.  No op here needs a gather."""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

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


def sinusoid_timescales(d_model: int, device=None) -> Tensor:
    """``10000 ** (2i / d_model)`` for every even dim ``2i``, f32.  The
    power is taken in f64 and rounded once: XLA's f32 ``pow`` is correctly
    rounded, torch's f32 ``pow`` is not, and one ulp here moves a
    position-1500 angle by ~1e-4."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    return torch.pow(10000.0, (dim / d_model).to(torch.float64)).to(torch.float32)


def sinusoidal_positions(n_positions: int, d_model: int, device=None) -> Tensor:
    """Whisper-style fixed sinusoidal embeddings (f32), (n_positions,
    d_model): the sines of every even dim's angle, then the cosines."""
    pos = torch.arange(n_positions, dtype=torch.float32, device=device)[:, None]
    angle = pos / sinusoid_timescales(d_model, device)[None, :]
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def arange_positions(b: int, s: int, device) -> Tensor:
    """(B, S) int32 absolute positions 0 .. S-1."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def layer(tree, *idx):
    """One layer's parameters: every leaf of a stacked tree indexed by
    ``idx`` (the reference's ``jax.tree.map(lambda a: a[i], ...)``)."""
    if isinstance(tree, dict):
        return {k: layer(v, *idx) for k, v in tree.items()}
    return tree[idx]


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


def init_generator(seed_or_gen, device="cuda") -> torch.Generator | None:
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


def init_device(gen: torch.Generator | None) -> torch.device:
    """Where ``gen``'s parameters live (``meta`` without a generator)."""
    return gen.device if gen is not None else torch.device("meta")


def const_init(gen: torch.Generator | None, shape, value, dtype) -> Tensor:
    """A constant leaf (norm weights and biases, fixed decays)."""
    return torch.full(shape, value, dtype=dtype, device=init_device(gen))


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
