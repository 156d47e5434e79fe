"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B] — small llama3."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128256, act="silu", tie_embeddings=True,
    rope_theta=5e5,
)
