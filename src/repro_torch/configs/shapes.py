"""Input specs for every (architecture x shape) cell (port of
``repro.configs.shapes``).

``input_specs(cfg, shape)`` and ``cache_specs(cfg, shape)`` return
:class:`TensorSpec` (shape, torch dtype) stand-ins, allocating nothing.
The port runs on one device, so there is no mesh and no sharding.

``make_batch(cfg, shape, generator)`` materializes small concrete batches
for smoke tests and examples.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.configs.base import (
    ALL_SHAPES,
    LONG_500K,
    ModelConfig,
    ShapeSpec,
)
from repro_torch.device import resolve_device

SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


class TensorSpec(NamedTuple):
    """Shape and dtype of one input (the reference's ``ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def adjust_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Per-shape config tweaks (the reference's, unchanged)."""
    if shape is LONG_500K or shape.name == "long_500k":
        if cfg.family == "hybrid":
            # Sliding-window ring-buffer KV for the shared attention.
            return dataclasses.replace(cfg, sliding_window=4096)
    return cfg


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, TensorSpec]:
    """Specs of the step function's ``batch`` argument.

    train:   {tokens, labels [, vis_embeds | frames]}
    prefill: {tokens [, vis_embeds | frames]}
    decode:  {tokens (B, 1)} (the cache comes from ``cache_specs``).
    """
    b, s = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    if shape.kind == "train":
        specs = {"tokens": TensorSpec((b, s), torch.int32),
                 "labels": TensorSpec((b, s), torch.int32)}
    elif shape.kind == "prefill":
        specs = {"tokens": TensorSpec((b, s), torch.int32)}
    else:  # decode: one new token against a seq_len-deep cache
        specs = {"tokens": TensorSpec((b, 1), torch.int32)}
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["vis_embeds"] = TensorSpec((b, cfg.n_vis_tokens, cfg.d_model), act)
    if cfg.is_encdec and shape.kind != "decode":
        specs["frames"] = TensorSpec((b, cfg.n_frames, cfg.d_model), act)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, TensorSpec]:
    """Specs of the decode cache at ``shape.seq_len`` (built on the
    ``meta`` device: no memory is allocated)."""
    from repro_torch.models import build_model

    cfg = adjust_config(cfg, shape)
    model = build_model(cfg)
    cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
    return {k: TensorSpec(tuple(v.shape), v.dtype) for k, v in cache.items()}


def make_batch(cfg: ModelConfig, shape: ShapeSpec,
               generator: torch.Generator | None = None, *,
               device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Concrete batch on ``device``: tokens uniform in ``[0, vocab)``,
    float inputs standard normal, drawn from ``generator`` (seed 0 when
    omitted).  The draws differ from the reference's ``jax.random``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if spec.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=generator, device=dev,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(spec.shape, generator=generator, device=dev,
                                    dtype=torch.float32).to(spec.dtype)
    return out
