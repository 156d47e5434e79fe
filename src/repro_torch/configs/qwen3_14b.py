"""qwen3-14b [hf:Qwen/Qwen3-14B] — qk_norm, GQA."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, act="silu", qk_norm=True,
    head_dim=128,
)
