"""Gated MLPs: SwiGLU (llama/qwen/phi family), GeGLU (gemma) and the
plain GELU MLP (port of ``repro.models.mlp``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.common import fan_in_init

Tensor = torch.Tensor


def init_mlp_params(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                    kind: str = "swiglu", stack: tuple[int, ...] = ()) -> dict:
    """``stack`` prefixes every leaf with layer dims (one draw per leaf)."""
    p = {
        "w_up": fan_in_init(gen, stack + (d_model, d_ff), dtype),
        "w_down": fan_in_init(gen, stack + (d_ff, d_model), dtype),
    }
    if kind != "gelu":  # gated variants
        p["w_gate"] = fan_in_init(gen, stack + (d_model, d_ff), dtype)
    return p


def mlp(x: Tensor, p: dict, kind: str) -> Tensor:
    """x: (B, S, D) -> (B, S, D).  GELU is the tanh form, as the
    reference's ``jax.nn.gelu(approximate=True)``."""
    up = x @ p["w_up"]
    if kind == "gelu":  # plain 2-matrix MLP (whisper)
        h = F.gelu(up, approximate="tanh")
    else:
        gate = x @ p["w_gate"]
        if kind == "swiglu":
            act = F.silu(gate)
        elif kind == "geglu":
            act = F.gelu(gate, approximate="tanh")
        else:
            raise ValueError(f"unknown mlp kind {kind!r}")
        h = act * up
    h = sharding.shard(h, "batch", None, "ff")
    return h @ p["w_down"]
