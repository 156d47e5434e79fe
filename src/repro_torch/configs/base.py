"""Config system: model configs (one per assigned architecture), input
shapes, and reduced smoke configs.

A copy of ``repro/configs/base.py``, field for field: the port imports
nothing of the JAX package, so it keeps its own."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_impl: str = "sort"            # sort | dense
    moe_tp_fused: bool = False        # §Perf: shard_map TP-MoE (psum tokens,
                                      # not the capacity buffer)
    # attention
    sliding_window: Optional[int] = None
    qk_norm: bool = False
    act: str = "silu"                 # silu (gated) | relu2 | gelu
    rope_theta: float = 1e6
    swa_banded: bool = False          # §Perf: skip out-of-window KV blocks
    prefill_last_only: bool = False   # §Perf: slice last token before head
    act_seq_shard: bool = False       # §Perf: sequence-parallel activations
                                      # (scan carry sharded over model)
    attn_context_parallel: bool = False  # §Perf: shard query blocks over
                                         # model (any head count)
    ddp: bool = False                 # §Perf: replicate weights, batch over
                                      # data×model (small-model regime)
    # ssm / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    attn_every: int = 0               # zamba2 shared block period
    # audio
    n_codebooks: int = 0
    # misc
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"               # none | dots | full
    optimizer: str = "adamw"          # adamw | adafactor
    # which paper algorithm backs MoE dispatch / data pipeline sorting
    sort_algorithm: str = "auto"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or bool(self.sliding_window)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        H, KV, hd = self.n_heads, self.n_kv_heads, self.head_dim
        emb = V * d if self.family != "audio" else 0
        head = (self.n_codebooks or 1) * d * V if not self.tie_embeddings else 0
        if self.family == "ssm":                    # rwkv6
            per = 5 * d * d + 2 * d * f + d * 64 * 2   # time + channel + lora
        elif self.family == "hybrid":               # zamba2 mamba layers
            di = 2 * d
            per = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) + di * d
            shared = 2 * d * (H + 2 * KV) * hd + (H * hd) * d + 3 * d * f
            return emb + head + L * per + shared
        else:
            attn = d * (H + 2 * KV) * hd + H * hd * d
            if self.family == "moe":
                per = attn + self.n_experts * 3 * d * f + d * self.n_experts
            else:
                nmat = 3 if self.act == "silu" else 2
                per = attn + nmat * d * f
        return emb + head + L * per

    def active_param_count(self) -> int:
        """6·N_active·D convention for MoE rooflines."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        H, KV, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * (H + 2 * KV) * hd + H * hd * d
        act = attn + self.top_k * 3 * d * f + d * self.n_experts
        emb = self.vocab * d + (0 if self.tie_embeddings else self.d_model * self.vocab)
        return emb + L * act


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Per the brief: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (DESIGN.md)"
    return True, ""


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2,
        d_ff=128, vocab=256, head_dim=16, remat="none")
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2)
    if cfg.family == "hybrid":
        kw.update(ssm_state=16, ssm_heads=8, attn_every=1, n_kv_heads=4)
    if cfg.family == "ssm":
        kw.update(n_kv_heads=4)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    if cfg.family == "audio":
        kw.update(n_codebooks=cfg.n_codebooks)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
