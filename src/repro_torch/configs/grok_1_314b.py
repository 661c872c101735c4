"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072; 8 experts top-2 every layer; 30.0 attention logit softcap.
bf16 optimizer moments (DESIGN.md §6).
[hf:xai-org/grok-1; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    n_experts=8, n_experts_active=2, moe_layer_period=1,
    attn_logit_softcap=30.0,
    norm="rmsnorm", act="gelu",
    optimizer_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="grok-1-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    n_experts=4, n_experts_active=2, moe_layer_period=1,
    attn_logit_softcap=30.0,
    norm="rmsnorm", act="gelu",
)
