"""zamba2-2.7b [hybrid] — 54 Mamba2 layers d_model=2560, ssm_state=64,
plus ONE shared attention+MLP block (32H kv=32, d_ff=10240) applied after
every 6 Mamba2 layers with reused weights (Zamba's defining trick).
vocab=32000.  [arXiv:2411.15242; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_variant="mamba2", ssm_expand=2,
    ssm_conv=4, ssm_head_dim=64, ssm_chunk=256,
    shared_attn_period=6,
    norm="rmsnorm", act="gelu",
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    ssm_state=8, ssm_variant="mamba2", ssm_expand=2,
    ssm_conv=4, ssm_head_dim=16, ssm_chunk=8,
    shared_attn_period=2,
    norm="rmsnorm", act="gelu",
)
