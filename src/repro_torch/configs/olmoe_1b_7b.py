"""olmoe-1b-7b [moe]: 64 experts top-8, every layer.

16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304
[arXiv:2409.02060; hf].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    n_experts=64,
    top_k=8,
    moe_interleave=1,
)
