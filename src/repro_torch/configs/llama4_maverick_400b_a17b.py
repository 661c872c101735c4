"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048; MoE 128 experts top-1 + 1 shared expert, MoE every
2nd layer (interleaved with dense).  bf16 optimizer moments to fit the
16 GB/chip x 512 envelope (documented in DESIGN.md §6).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    n_experts=128, n_experts_active=1, moe_layer_period=2,
    n_shared_experts=1, capacity_factor=1.25,
    rope_theta=500_000.0,
    norm="rmsnorm", act="silu",
    optimizer_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    n_experts=4, n_experts_active=1, moe_layer_period=2,
    n_shared_experts=1,
    norm="rmsnorm", act="silu",
)
