"""Unified model configuration covering all ten assigned architectures
(a field-for-field copy of the JAX package's, so the port stands alone)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                    # query heads (0 for attention-free)
    n_kv_heads: int                 # GQA KV heads
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # --- attention ---
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0      # partial rotary (glm4: 0.5, stablelm2: 0.25)
    sliding_window: Optional[int] = None  # SWA (h2o-danube)
    attn_logit_softcap: Optional[float] = None  # grok-1: 30.0
    qkv_bias: bool = False          # glm4 / stablelm2 use qkv bias

    # --- block layout ---
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # gated mlp activation: silu | gelu
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0       # top-k
    moe_layer_period: int = 1       # every k-th layer is MoE (llama4: 2)
    n_shared_experts: int = 0       # llama4: 1 shared expert
    capacity_factor: float = 1.25
    moe_groups: int = 0             # dispatch groups (0 = auto from sharding)

    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_variant: str = "mamba1"     # mamba1 | mamba2
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64          # mamba2 head dim
    ssm_chunk: int = 256            # chunked-scan block length

    # --- hybrid (zamba2): shared attn+mlp block every k ssm layers ---
    shared_attn_period: int = 0

    # --- encoder-decoder (seamless-m4t) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- modality frontend stub ---
    frontend: Optional[str] = None  # vision | audio
    frontend_dim: int = 0           # dim of the precomputed patch/frame embeds
    frontend_len: int = 0           # number of prefix embeddings

    # --- numerics / memory ---
    param_dtype: str = "bfloat16"   # storage dtype of the weights
    optimizer_dtype: str = "float32"  # adam moment dtype (bf16 for 300B+ MoE)
    remat: str = "full"             # none | full | dots (activation ckpt policy)

    def __post_init__(self):
        if self.n_heads and self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and self.shared_attn_period == 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.shared_attn_period > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def moe_layer_mask(self) -> tuple[bool, ...]:
        """Which layers carry experts (True) vs a dense MLP."""
        if not self.is_moe:
            return tuple(False for _ in range(self.n_layers))
        # llama4-style interleave: layers (period-1, 2*period-1, ...) are MoE
        return tuple(
            (i % self.moe_layer_period) == self.moe_layer_period - 1
            for i in range(self.n_layers)
        )
