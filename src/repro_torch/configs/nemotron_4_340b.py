"""nemotron-4-340b [arXiv:2402.16819] — GQA, squared-ReLU, 340B params.
Adafactor: Adam's 12 B/param does not fit 256×16 GiB (DESIGN.md §6)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, act="relu2", optimizer="adafactor",
    rope_theta=1e4,
)
