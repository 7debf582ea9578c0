"""Input specs for every (architecture x shape) cell (port of
``repro.configs.shapes``).

``input_specs(cfg, shape, mesh=...)`` and ``cache_specs(cfg, shape,
mesh=...)`` return :class:`TensorSpec` (shape, torch dtype, placement)
stand-ins, allocating nothing.  Off a mesh the placement is ``None``; on
one it is the reference's ``PartitionSpec`` as a tuple
(``repro_torch.models.sharding``), read from the mesh's axis sizes alone,
so the dry run's device-free stand-in will do.

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
    """Shape, dtype and placement of one input (the reference's
    ``ShapeDtypeStruct`` and its sharding's spec; ``None`` off a mesh)."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    placement: tuple | None = None


def adjust_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Per-shape config tweaks (the reference's, unchanged)."""
    if shape is LONG_500K or shape.name == "long_500k":
        if cfg.family == "hybrid":
            # Sliding-window ring-buffer KV for the shared attention.
            return dataclasses.replace(cfg, sliding_window=4096)
    return cfg


def _axes(mesh) -> dict[str, int] | None:
    """The mesh's axis sizes; ``None`` off a mesh."""
    from repro_torch.models.sharding import mesh_shape

    return None if mesh is None else mesh_shape(mesh)


def _placement(axes: dict[str, int] | None, *entries):
    """The reference's ``_sharding``: ``"data"`` is ``("pod", "data")`` on
    a pod mesh; ``None`` off a mesh."""
    if axes is None:
        return None
    return tuple(("pod", "data") if a == "data" and "pod" in axes else a for a in entries)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> dict[str, TensorSpec]:
    """Specs of the step function's ``batch`` argument.

    train:   {tokens, labels [, vis_embeds | frames]}
    prefill: {tokens [, vis_embeds | frames]}
    decode:  {tokens (B, 1)} (the cache comes from ``cache_specs``).
    """
    b, s = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    axes = _axes(mesh)
    batch_pl = _placement(axes, "data", None)
    batch3_pl = _placement(axes, "data", None, None)
    if shape.kind == "train":
        specs = {"tokens": TensorSpec((b, s), torch.int32, batch_pl),
                 "labels": TensorSpec((b, s), torch.int32, batch_pl)}
    elif shape.kind == "prefill":
        specs = {"tokens": TensorSpec((b, s), torch.int32, batch_pl)}
    else:  # decode: one new token against a seq_len-deep cache
        specs = {"tokens": TensorSpec((b, 1), torch.int32, batch_pl)}
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["vis_embeds"] = TensorSpec((b, cfg.n_vis_tokens, cfg.d_model), act, batch3_pl)
    if cfg.is_encdec and shape.kind != "decode":
        specs["frames"] = TensorSpec((b, cfg.n_frames, cfg.d_model), act, batch3_pl)
    return specs


def _cache_placement(axes: dict[str, int], name: str, shape: tuple[int, ...]):
    """One cache leaf's placement (the reference's ``shard_leaf``)."""
    from repro_torch.models.sharding import axis_size

    nd = len(shape)
    if nd == 0:
        return None
    spec: list = [None] * nd
    # Layer-stacked leaves: dim0 = layers; dim1 = batch.
    bdim = 1 if nd >= 2 else 0
    spec[bdim] = ("pod", "data") if "pod" in axes else "data"
    if name in ("k", "v", "ck", "cv") and nd == 5:
        spec[2] = "model"        # sequence-sharded KV
    elif name in ("state", "ssm") and nd == 5:
        spec[2] = "model"        # rwkv / mamba heads
    # Drop axes that do not divide their dim (batch=1, 40 heads on a
    # 16-way axis, ...) — replicate instead of padding.
    for d in range(nd):
        if spec[d] is not None:
            n = axis_size(axes, spec[d])
            if n <= 1 or shape[d] % n != 0:
                spec[d] = None
    # If the batch could not shard over (pod, data), try data alone.
    if spec[bdim] is None and "pod" in axes:
        if shape[bdim] % axis_size(axes, "data") == 0:
            spec[bdim] = "data"
    return tuple(spec)


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> dict[str, TensorSpec]:
    """Specs of the decode cache at ``shape.seq_len`` (built on the
    ``meta`` device: no memory is allocated)."""
    from repro_torch.models import build_model

    cfg = adjust_config(cfg, shape)
    model = build_model(cfg)
    cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
    axes = _axes(mesh)
    return {k: TensorSpec(tuple(v.shape), v.dtype,
                          None if axes is None else _cache_placement(axes, k, tuple(v.shape)))
            for k, v in cache.items()}


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
