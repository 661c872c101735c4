"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256.  Small llama3: rope_theta=500k, tied embeddings.
[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    rope_theta=500_000.0, tie_embeddings=True,
    norm="rmsnorm", act="silu",
)

SMOKE = ModelConfig(
    name="llama3.2-3b-smoke",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
    d_ff=96, vocab_size=256,
    rope_theta=500_000.0, tie_embeddings=True,
    norm="rmsnorm", act="silu",
)
