"""Architecture registry: --arch <id> → ModelConfig."""
from . import (chameleon_34b, granite_moe_1b_a400m, llama3_2_1b,
               mistral_large_123b, mixtral_8x22b, musicgen_large,
               nemotron_4_340b, qwen3_14b, rwkv6_1_6b, zamba2_2_7b)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    mixtral_8x22b, granite_moe_1b_a400m, nemotron_4_340b, llama3_2_1b,
    qwen3_14b, mistral_large_123b, chameleon_34b, zamba2_2_7b,
    musicgen_large, rwkv6_1_6b)}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)
