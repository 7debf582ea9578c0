"""Architecture configs (the 10 assigned archs) + shape cells (port of
``repro.configs``)."""

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    ShapeSpec,
    reduced,
    shapes_for,
)
from repro_torch.configs.registry import ARCH_IDS, get_config, list_archs
from repro_torch.configs.shapes import (
    SHAPES_BY_NAME,
    TensorSpec,
    adjust_config,
    cache_specs,
    input_specs,
    make_batch,
)

__all__ = [
    "ALL_SHAPES",
    "ARCH_IDS",
    "DECODE_32K",
    "LONG_500K",
    "ModelConfig",
    "PREFILL_32K",
    "SHAPES_BY_NAME",
    "ShapeSpec",
    "TRAIN_4K",
    "TensorSpec",
    "adjust_config",
    "cache_specs",
    "get_config",
    "input_specs",
    "list_archs",
    "make_batch",
    "reduced",
    "shapes_for",
]
