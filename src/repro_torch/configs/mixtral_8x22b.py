"""mixtral-8x22b [arXiv:2401.04088; hf] — 8 experts top-2, SWA."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, n_experts=8, top_k=2,
    sliding_window=4096, act="silu", optimizer="adafactor",
)
