"""Unified model interface (port of ``repro.models.model_zoo``).

``build_model(cfg)`` returns a :class:`Model` with the reference's
functional API, used by the serving engine and the launchers:

  init(seed_or_generator, device="cuda") -> params
  loss(params, batch) -> (scalar, metrics)        [differentiable]
  forward(params, batch) -> (logits, aux)
  prefill(params, batch) -> (last_logits, cache)
  decode_step(params, cache, tokens) -> (logits, cache)
  init_cache(batch_size, max_seq, device="cuda") -> cache

Parameters are a plain dict of tensors, so each serving replica holds
its own and calls ``model.prefill(params, batch)``.  Only the dense
family is ported; the others raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ModelConfig

_NOT_PORTED = ("moe", "vlm", "hybrid", "ssm", "audio")


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    forward: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (dense only)")
    if cfg.family != "dense":
        raise ValueError(f"unknown family {cfg.family!r}")
    from repro_torch.models import transformer as m

    return Model(
        cfg=cfg,
        init=lambda seed_or_gen, device="cuda": m.init_params(seed_or_gen, cfg, device),
        loss=lambda params, batch: m.loss_fn(params, cfg, batch),
        forward=lambda params, batch: m.forward(params, cfg, batch),
        prefill=lambda params, batch: m.prefill(params, cfg, batch),
        decode_step=lambda params, cache, tokens: m.decode_step(
            params, cfg, cache, tokens
        ),
        init_cache=lambda batch_size, max_seq, device="cuda": m.init_cache(
            cfg, batch_size, max_seq, device
        ),
    )


def abstract_params(model: Model, seed: int = 0):
    """The parameter tree as meta tensors: shapes and dtypes, no
    allocation (the reference's ``jax.eval_shape`` of ``init``)."""
    del seed  # shapes do not depend on the draws
    return model.init(0, device="meta")
