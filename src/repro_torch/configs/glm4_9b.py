"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE (partial, GLM uses half-rotary), GQA with 2 KV heads, QKV bias.
[hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    rope_theta=10_000.0, rope_fraction=0.5, qkv_bias=True,
    norm="rmsnorm", act="silu",
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    rope_theta=10_000.0, rope_fraction=0.5, qkv_bias=True,
    norm="rmsnorm", act="silu",
)
