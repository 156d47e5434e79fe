"""chameleon-34b [arXiv:2405.09818] — early fusion VLM: text and VQ image
tokens share one 65536 vocabulary, so the backbone consumes a single token
stream (the VQ tokenizer frontend is a stub; input_specs provides ids).
Chameleon uses qk-norm for training stability."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, act="silu", qk_norm=True,
)
