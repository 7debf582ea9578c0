"""rwkv6-3b [ssm]: Finch — attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536 [arXiv:2404.05892; hf].
O(1)-state decode; runs the ``long_500k`` cell natively.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,        # d_model / head_dim(64) time-mix heads
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    norm_eps=1e-5,
)
