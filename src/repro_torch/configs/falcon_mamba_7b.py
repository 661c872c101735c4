"""falcon-mamba-7b [ssm] — 64 Mamba1 layers, d_model=4096 (attn-free),
d_inner=8192, ssm_state=16, conv=4, vocab=65024.  [arXiv:2410.05355;
unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_variant="mamba1", ssm_expand=2,
    ssm_conv=4, ssm_chunk=256,
    norm="rmsnorm", act="silu",
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=256,
    ssm_state=8, ssm_variant="mamba1", ssm_expand=2,
    ssm_conv=4, ssm_chunk=8,
    norm="rmsnorm", act="silu",
)
