"""qwen1.5-4b [dense]: QKV bias, full MHA-equivalent GQA (kv=20).

40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936
[hf:Qwen/Qwen1.5-0.5B scaled family; hf].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    head_dim=128,
    mlp_kind="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
