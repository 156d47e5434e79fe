"""zamba2-2.7b [arXiv:2411.15242; hf] — Mamba2 backbone + one *shared*
attention(+MLP) block applied every 6 mamba layers.  ssm_state=64,
ssm heads: d_inner=2·2560=5120, head_dim 64 → 80 heads."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, ssm_state=64, ssm_heads=80,
    attn_every=6, act="gelu",
)
