"""rwkv6-1.6b (Finch) [arXiv:2404.05892] — attention-free, data-dependent
per-channel decay; chunked WKV.  heads = d/64 = 32."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, act="relu2",
)
