"""Deterministic synthetic token pipeline (port of
``repro.data.synthetic``).

Reproducible LM batches from a stateless draw per step
(``batch_at(step)``), so every pod/worker derives identical data order
without coordination — restart-safe by construction (the fault-tolerance
path replays from the step counter alone).

A Zipf-ish unigram marginal plus a short-range copy structure makes the
loss curve non-trivial.  The reference draws with ``jax.random``
(``categorical`` over the Zipf logits), which torch cannot reproduce:
the port draws the same distribution from a CPU ``torch.Generator``
seeded with ``(seed, step)`` and moves the batch to the device, so a
step's batch is the same on the card and on the CPU.  Tests that compare
the port with the reference inject the reference's batches.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    copy_prob: float = 0.3   # probability a token repeats k-back (structure)
    copy_back: int = 4


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for one ``(seed, step)`` pair."""
    return torch.Generator().manual_seed((int(seed) << 32) ^ int(step))


def _zipf_probs(cfg: DataConfig) -> Tensor:
    ranks = torch.arange(1, cfg.vocab_size + 1, dtype=torch.float64)
    return torch.softmax(-cfg.zipf_alpha * torch.log(ranks), dim=0)


def batch_at(cfg: DataConfig, step: int, device="cuda") -> dict[str, Tensor]:
    """The (deterministic) batch for a given step: int32 ``tokens`` and
    ``labels`` (next token; -100 at the last position)."""
    dev = resolve_device(device)
    gen = _generator(cfg.seed, step)
    b, s = cfg.global_batch, cfg.seq_len
    base = torch.multinomial(_zipf_probs(cfg), b * s, replacement=True,
                             generator=gen).reshape(b, s).to(torch.int32)
    # Inject copy structure: with prob copy_prob, token t = token t-k.
    copy_mask = torch.rand((b, s), generator=gen) < cfg.copy_prob
    tokens = torch.where(copy_mask, torch.roll(base, cfg.copy_back, dims=1), base)
    labels = torch.cat([tokens[:, 1:], torch.full((b, 1), -100, dtype=torch.int32)], dim=1)
    return {"tokens": tokens.to(dev), "labels": labels.to(dev)}


def extra_inputs(model_cfg, global_batch: int, step: int, dtype=None,
                 device="cuda") -> dict:
    """Stub modality inputs (vis_embeds / frames) for vlm/audio archs;
    empty for the other families."""
    out = {}
    if model_cfg.family != "vlm" and not model_cfg.is_encdec:
        return out
    dev = resolve_device(device)
    gen = _generator(777, step)
    dt = getattr(torch, dtype or model_cfg.dtype)
    if model_cfg.family == "vlm":
        out["vis_embeds"] = torch.randn(
            (global_batch, model_cfg.n_vis_tokens, model_cfg.d_model),
            generator=gen).to(device=dev, dtype=dt)
    if model_cfg.is_encdec:
        out["frames"] = torch.randn(
            (global_batch, model_cfg.n_frames, model_cfg.d_model),
            generator=gen).to(device=dev, dtype=dt)
    return out
