"""whisper-large-v3 [audio]: encoder-decoder, conv frontend stubbed.

32L (decoder) d_model=1280 20H (kv=20) d_ff=5120 vocab=51866
[arXiv:2212.04356; unverified].  32 encoder layers over 1500 stub frame
embeddings; sinusoidal positions; plain GELU MLPs; tied LM head.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    mlp_kind="gelu",
    use_rope=False,
    tie_embeddings=True,
    is_encdec=True,
    n_encoder_layers=32,
    n_frames=1500,
)
