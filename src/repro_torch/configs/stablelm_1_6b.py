"""stablelm-1.6b [dense] — 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352.  Partial rotary (25%), LayerNorm, QKV bias.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab_size=100352,
    rope_theta=10_000.0, rope_fraction=0.25, qkv_bias=True,
    norm="layernorm", act="silu",
)

SMOKE = ModelConfig(
    name="stablelm-1.6b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    rope_fraction=0.25, qkv_bias=True,
    norm="layernorm", act="silu",
)
