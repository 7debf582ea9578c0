"""Unified model configuration for all assigned architectures (port of
``repro.configs.base``, a copy: the port imports nothing of ``repro``).
``param_count()`` and ``active_param_count()`` equal the reference's."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config describes every family in the pool.

    Families: dense | moe | hybrid | ssm | audio | vlm.
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # Transformer details
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sliding_window: int = 0          # 0 = full causal
    attn_logit_softcap: float = 0.0
    attn_chunk: int = 512            # query-chunked attention (0 = off)
    attn_impl: str = "auto"          # auto (ring when applicable) | dp

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_interleave: int = 1          # MoE on layers where i % interleave == interleave-1
    shared_expert: bool = False
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: attention block every k-th layer
    # RWKV6 uses d_ff and head_dim from above; no extra knobs.

    # Encoder-decoder (audio)
    is_encdec: bool = False
    n_encoder_layers: int = 0
    n_frames: int = 1500             # stub frontend sequence length

    # VLM
    n_vis_tokens: int = 0            # stub ViT patch-embedding prefix length

    # Numerics / performance knobs (hillclimb surface)
    dtype: str = "bfloat16"
    remat: str = "full"              # none | full | selective (JAX only)
    use_flash_kernel: bool = False   # hand-written flash-attention kernel
    decode_comm: str = "xla"         # xla | lse_shardmap
    scan_layers: bool = True         # JAX only: the port loops in Python
    unroll_scans: bool = False       # unroll inner chunk scans (cost probes)
    fsdp_params: bool = True         # shard params over 'data' too (ZeRO-3 style)
    optimizer_state_dtype: str = "float32"  # bf16 for the 400B config

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.family not in ("dense", "moe", "hybrid", "ssm", "audio", "vlm"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.mlp_kind not in ("swiglu", "geglu", "gelu"):
            raise ValueError(f"unknown mlp_kind {self.mlp_kind!r}")

    # ---- derived quantities -------------------------------------------------

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists (long_500k eligibility)."""
        return self.family in ("ssm", "hybrid")

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return (i % self.moe_interleave) == (self.moe_interleave - 1)

    @property
    def n_moe_layers(self) -> int:
        return sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))

    def param_count(self) -> int:
        """Total parameters (embedding + blocks + head), exact per family."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n_emb = v * d * (1 if self.tie_embeddings else 2)
        n = n_emb
        for i in range(self.n_layers):
            n += self._block_params(i)
        n += d  # final norm
        if self.family == "hybrid" and self.attn_every:
            # ONE shared attention+MLP block (Zamba parameter sharing),
            # regardless of how many sites apply it.
            n += self._attn_params() + self._mlp_params() + 2 * d
        if self.is_encdec:
            n += self.n_encoder_layers * self._encoder_block_params() + d
            # Decoder cross-attention sub-layer per decoder layer.
            n += self.n_layers * (self._attn_params() + d)
        if self.n_vis_tokens:
            n += d * d  # vision projection stub
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        n = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            n += self.q_dim + 2 * self.kv_dim
        return n

    def _mlp_params(self, ff: int | None = None) -> int:
        ff = self.d_ff if ff is None else ff
        mats = 2 if self.mlp_kind == "gelu" else 3  # gated adds w_gate
        return mats * self.d_model * ff

    def _ssm_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        nh = d_in // self.ssm_head_dim
        # in_proj -> (z, x, B, C, dt) ; out_proj; conv (skipped: fused stub); A, D
        return (
            d * (2 * d_in + 2 * self.ssm_state + nh)
            + d_in * d
            + 2 * nh
        )

    def _rwkv_params(self) -> int:
        d = self.d_model
        # time-mix: r,k,v,g,w projections + decay LoRA + out proj
        tm = 5 * d * d + 2 * d * 64 + d * d
        # channel-mix: key (d->ff), receptance (d->d), value (ff->d)
        cm = d * self.d_ff + d * d + self.d_ff * d
        return tm + cm

    def _block_params(self, i: int) -> int:
        d = self.d_model
        norms = 2 * d
        if self.family == "ssm":  # rwkv6: time-mix + channel-mix per block
            return self._rwkv_params() + norms
        if self.family == "hybrid":
            # Mamba block only; the shared attention block is counted
            # once at the model level (Zamba parameter sharing).
            return self._ssm_params() + d  # single pre-norm
        n = self._attn_params() + norms
        if self.is_moe_layer(i):
            n += self.n_experts * self._mlp_params() + d * self.n_experts
            if self.shared_expert:
                n += self._mlp_params()
        else:
            n += self._mlp_params()
        return n

    def _encoder_block_params(self) -> int:
        return self._attn_params() + self._mlp_params() + 2 * self.d_model

    def active_param_count(self) -> int:
        """Active parameters per token (for MoE: top_k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2) + d
        for i in range(self.n_layers):
            if self.is_moe_layer(i):
                nb = self._attn_params() + 2 * d
                nb += self.top_k * self._mlp_params() + d * self.n_experts
                if self.shared_expert:
                    nb += self._mlp_params()
                n += nb
            else:
                n += self._block_params(i)
        return n


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> tuple[ShapeSpec, ...]:
    """The shape cells assigned to an architecture.

    ``long_500k`` requires a sub-quadratic path — run for ssm/hybrid,
    skip for pure full-attention archs.
    """
    if cfg.supports_long_context:
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test-sized variant of the same family (CPU-runnable)."""
    small = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.attn_every else cfg.attn_every),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=16,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        n_frames=32 if cfg.is_encdec else cfg.n_frames,
        n_vis_tokens=8 if cfg.n_vis_tokens else 0,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        scan_layers=False,
        dtype="float32",
        remat="none",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
