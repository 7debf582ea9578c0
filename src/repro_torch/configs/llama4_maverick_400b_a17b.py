"""llama4-maverick-400b-a17b [moe]: 128 experts top-1, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  MoE on alternating
layers (interleave=2) with a shared expert — the published Maverick
layout — which lands the total at ~400B with ~17B active.  Training
fits 256 x 16 GB via FSDP + EP and bf16 optimizer state.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    mlp_kind="swiglu",
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    moe_interleave=2,
    shared_expert=True,
    optimizer_state_dtype="bfloat16",
)
