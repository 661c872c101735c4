"""internvl2-2b [vlm] — InternLM2-1.8B backbone: 24L d_model=2048 16H
(GQA kv=8) d_ff=8192 vocab=92553.  InternViT frontend is a STUB:
input_specs() supplies 256 precomputed 1024-dim patch embeddings; the
2-layer MLP projector IS part of the backbone.  [arXiv:2404.16821; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    rope_theta=1_000_000.0,
    frontend="vision", frontend_dim=1024, frontend_len=256,
    norm="rmsnorm", act="silu",
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    frontend="vision", frontend_dim=32, frontend_len=8,
    norm="rmsnorm", act="silu",
)
