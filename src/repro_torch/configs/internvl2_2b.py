"""internvl2-2b [vlm]: InternViT + InternLM2 backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf].  The ViT frontend is a stub: ``input_specs``
provides (B, 256, d_model) precomputed patch embeddings prepended to the
token embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    n_vis_tokens=256,
)
