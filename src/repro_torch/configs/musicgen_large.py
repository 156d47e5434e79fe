"""musicgen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec
tokens, 4 codebooks × 2048 vocab.  The EnCodec frontend is a stub:
input_specs() provides precomputed frame embeddings (B,S,d); the model owns
4 output heads and the delay-pattern loss surface."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, n_codebooks=4, act="gelu",
)
