"""seamless-m4t-large-v2 [audio] — enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (MHA kv=16) d_ff=8192 vocab=256206.  Speech frontend is a
STUB: input_specs() supplies precomputed 160-dim fbank-frame embeddings; the
linear frame projector IS part of the backbone.  [arXiv:2308.11596; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    is_encoder_decoder=True, n_encoder_layers=24,
    frontend="audio", frontend_dim=160, frontend_len=1536,
    norm="layernorm", act="gelu",
)

SMOKE = ModelConfig(
    name="seamless-m4t-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    is_encoder_decoder=True, n_encoder_layers=2,
    frontend="audio", frontend_dim=20, frontend_len=24,
    norm="layernorm", act="gelu",
)
