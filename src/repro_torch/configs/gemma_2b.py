"""gemma-2b [dense]: GeGLU, head_dim=256, MQA (kv=1).

18L d_model=2048 8H d_ff=16384 vocab=256000 [arXiv:2403.08295; hf].
Embedding is tied and scaled by sqrt(d_model) (gemma convention).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    mlp_kind="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
