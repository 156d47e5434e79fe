"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab=32768, act="silu", optimizer="adafactor",
)
