"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``
(port of ``repro.configs.registry``; the configs are data only)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "internvl2-2b",
    "phi4-mini-3.8b",
    "gemma-2b",
    "qwen2-7b",
    "qwen1.5-4b",
    "zamba2-1.2b",
    "llama4-maverick-400b-a17b",
    "olmoe-1b-7b",
    "whisper-large-v3",
    "rwkv6-3b",
)

_MODULES = {
    "internvl2-2b": "internvl2_2b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "gemma-2b": "gemma_2b",
    "qwen2-7b": "qwen2_7b",
    "qwen1.5-4b": "qwen1_5_4b",
    "zamba2-1.2b": "zamba2_1_2b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "whisper-large-v3": "whisper_large_v3",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS
