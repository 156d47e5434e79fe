"""Unified model (counterpart of ``repro/models/transformer.py``): the
per-family blocks, the whole-model forward and the one-token decode step.

One config-driven model covers all ten architectures:

  dense/vlm : [attn + mlp] × L                   (llama, qwen, nemotron,
              mistral-large, chameleon)
  moe       : [attn + moe] × L                   (mixtral, granite)
  audio     : [attn + mlp] × L over frame embeddings, n_codebooks heads
  ssm       : [rwkv6 timemix + channelmix] × L   (rwkv6)
  hybrid    : mamba2 × L with a *shared* attn+mlp block applied every
              ``attn_every`` layers (zamba2)

A :class:`Transformer` holds an ``nn.ModuleList`` of blocks where the
reference stacks (L, …) leaves and scans them; its weights carry the
reference's parameter names (``blocks.3.attn.wq``, ``shared.mlp.up``,
…), which ``convert.params_from_jax`` relies on.  Entry points run on the
card unless the caller passes ``device="cpu"``.  A mesh reaches the MoE
layers (``moe.moe_apply``) and is otherwise a layout hint the port does
not need on one device.

``cfg.remat`` applies where gradients are taken: ``"full"`` recomputes
each block in the backward pass (``torch.utils.checkpoint``, hybrid's
shared block included), as the reference's ``jax.checkpoint`` of its scan
body saves nothing; ``"none"`` keeps every activation.  ``"dots"`` (save
the matmuls' outputs) is set only by the reference's dry-run variants,
which are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device

from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import (Attention, KVCache, attention, decode_attention,
                        init_cache)
from .layers import MLP, cross_entropy, embed, init_rms, mlp, normal, \
    rms_norm


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class AttnBlock(nn.Module):
    def __init__(self, cfg, device, gen=None):
        super().__init__()
        dtype = _dtype(cfg)
        self.ln1 = init_rms(cfg.d_model, device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.qk_norm, dtype, device, gen)
        self.ln2 = init_rms(cfg.d_model, device)
        if cfg.family == "moe":
            self.moe = moe_mod.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts,
                                   dtype, device, gen)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act == "silu", dtype,
                           device, gen)


def _apply_attn_block(x, p, cfg, mesh, data_axes):
    h = attention(rms_norm(x, p.ln1), p.attn, cfg, mesh=mesh)
    x = x + h
    if hasattr(p, "moe"):
        y, aux = moe_mod.moe_apply(rms_norm(x, p.ln2), p.moe, cfg, mesh,
                                   data_axes=data_axes)
    else:
        y, aux = mlp(rms_norm(x, p.ln2), p.mlp, cfg.act), 0.0
    return x + y, aux


class RWKVBlock(nn.Module):
    def __init__(self, cfg, device, gen=None):
        super().__init__()
        dtype = _dtype(cfg)
        self.ln1 = init_rms(cfg.d_model, device)
        self.time = ssm_mod.RWKV6(cfg.d_model, cfg.n_heads, dtype, device,
                                  gen)
        self.ln2 = init_rms(cfg.d_model, device)
        self.chan = ssm_mod.ChannelMix(cfg.d_model, cfg.d_ff, dtype, device,
                                       gen)


def _apply_rwkv_block(x, p, cfg):
    h = ssm_mod.rwkv6(rms_norm(x, p.ln1), p.time, cfg)
    x = x + h
    xn = rms_norm(x, p.ln2)
    xprev = torch.cat([torch.zeros_like(xn[:, :1]), xn[:, :-1]], dim=1)
    return x + ssm_mod.rwkv_channelmix(xn, xprev, p.chan), 0.0


class MambaBlock(nn.Module):
    def __init__(self, cfg, device, gen=None):
        super().__init__()
        self.ln = init_rms(cfg.d_model, device)
        self.mamba = ssm_mod.Mamba2(cfg.d_model, cfg.ssm_heads,
                                    cfg.ssm_state, _dtype(cfg), device, gen)


def _apply_mamba_block(x, p, cfg):
    return x + ssm_mod.mamba2(rms_norm(x, p.ln), p.mamba, cfg), 0.0


_BLOCKS = {"dense": AttnBlock, "vlm": AttnBlock, "audio": AttnBlock,
           "moe": AttnBlock, "ssm": RWKVBlock, "hybrid": MambaBlock}


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """The model of ``cfg``: ``embed`` (but audio, whose frontend is a
    stub), ``norm_f``, ``heads`` (audio) or ``head`` (untied), the
    ``blocks`` and, hybrid, the ``shared`` attention block.  With a
    generator the weights are drawn from it in the reference's
    distributions; without one they are left uninitialised, to be
    loaded."""

    def __init__(self, cfg, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in _BLOCKS:
            raise ValueError(cfg.family)
        dtype = _dtype(cfg)
        d, V = cfg.d_model, cfg.vocab
        if cfg.family != "audio":
            self.embed = normal(gen, (V, d), dtype, 0.02, device)
        self.norm_f = init_rms(d, device)
        if cfg.family == "audio":
            self.heads = normal(gen, (cfg.n_codebooks, d, V), dtype, 0.02,
                                device)
        elif not cfg.tie_embeddings:
            self.head = normal(gen, (d, V), dtype, 0.02, device)
        if cfg.family == "hybrid":
            self.shared = AttnBlock(cfg, device, gen)
        self.blocks = nn.ModuleList(_BLOCKS[cfg.family](cfg, device, gen)
                                    for _ in range(cfg.n_layers))


def init_params(cfg, generator: torch.Generator, device=None) -> Transformer:
    """The model of ``cfg`` with random weights drawn from ``generator``
    (on its own device, then moved to ``device``: the card unless
    ``device="cpu"``)."""
    return Transformer(cfg, resolve_device(device), generator)


def _logits(x, model, cfg):
    if cfg.family == "audio":
        return torch.einsum("bsd,cdv->bscv", x, model.heads)
    if cfg.tie_embeddings:
        return x @ model.embed.T
    return x @ model.head


def _inputs(model, inputs, cfg):
    if cfg.family == "audio":
        return inputs["embeds"].to(_dtype(cfg))
    return embed(inputs["tokens"], model.embed)


def _remat(fn, mode: str):
    """``fn`` recomputed in the backward pass under ``"full"`` (only where
    autograd records it), as it is under ``"none"``."""
    if mode == "dots":
        raise NotImplementedError(
            'remat="dots" is set by the dry-run variants '
            "(repro/launch/dryrun.py), which are not ported")
    if mode != "full":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def forward(model: Transformer, inputs: Dict[str, torch.Tensor], cfg,
            mesh=None, data_axes=("data",), last_only: bool = False):
    """Returns (logits, aux_loss).  inputs: {'tokens'} or {'embeds'}."""
    x = _inputs(model, inputs, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        block = _remat(lambda h, p: _apply_attn_block(h, p, cfg, mesh,
                                                      data_axes), cfg.remat)
        for p in model.blocks:
            x, a = block(x, p)
            aux = aux + a
    elif cfg.family == "ssm":
        block = _remat(lambda h, p: _apply_rwkv_block(h, p, cfg), cfg.remat)
        for p in model.blocks:
            x, a = block(x, p)
            aux = aux + a
    else:
        x, aux = _hybrid_forward(x, model, cfg, mesh, data_axes)
    if last_only:
        x = x[:, -1:]                # prefill serves next-token logits only
    return _logits(rms_norm(x, model.norm_f), model, cfg), aux


def _hybrid_forward(x, model, cfg, mesh, data_axes):
    """zamba2: groups of ``attn_every`` mamba layers + the shared attn
    block after each group; the remaining layers last."""
    every = cfg.attn_every
    n_groups = cfg.n_layers // every
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    mamba = _remat(lambda h, p: _apply_mamba_block(h, p, cfg), cfg.remat)
    shared = _remat(lambda h, p: _apply_attn_block(h, p, cfg, mesh,
                                                   data_axes), cfg.remat)
    for g in range(n_groups):
        for p in model.blocks[g * every:(g + 1) * every]:
            x, _ = mamba(x, p)
        x, aux = shared(x, model.shared)
        aux_total = aux_total + aux
    for p in model.blocks[n_groups * every:]:
        x, _ = mamba(x, p)
    return x, aux_total


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor], cfg,
            mesh=None, data_axes=("data",)) -> torch.Tensor:
    logits, aux = forward(model, batch, cfg, mesh, data_axes)
    # audio: logits (B,S,Cb,V) vs labels (B,S,Cb); LM: (B,S,V) vs (B,S)
    loss = cross_entropy(logits, batch["labels"])
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    caches: List[Any]          # per layer: KVCache / MambaState / RWKVState
    shared_caches: Optional[List[KVCache]]   # hybrid only, per group
    pos: int


def init_decode_state(cfg, B: int, cache_len: int, dtype,
                      device=None) -> DecodeState:
    dev = resolve_device(device)
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        S = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        return DecodeState([init_cache(B, S, cfg, dtype, dev)
                            for _ in range(L)], None, 0)
    if cfg.family == "ssm":
        hd = cfg.d_model // cfg.n_heads
        return DecodeState([ssm_mod.RWKVState(
            wkv=torch.zeros((B, cfg.n_heads, hd, hd), dtype=torch.float32,
                            device=dev),
            last=torch.zeros((B, cfg.d_model), dtype=torch.float32,
                             device=dev)) for _ in range(L)], None, 0)
    if cfg.family == "hybrid":
        di = 2 * cfg.d_model
        hd = di // cfg.ssm_heads
        caches = [ssm_mod.MambaState(
            ssm=torch.zeros((B, cfg.ssm_heads, hd, cfg.ssm_state),
                            dtype=torch.float32, device=dev),
            conv=torch.zeros((B, 3, di + 2 * cfg.ssm_state),
                             dtype=_dtype(cfg), device=dev))
            for _ in range(L)]
        n_sh = cfg.n_layers // cfg.attn_every
        return DecodeState(caches, [init_cache(B, cache_len, cfg, dtype, dev)
                                    for _ in range(n_sh)], 0)
    raise ValueError(cfg.family)


def decode_step(model: Transformer, state: DecodeState,
                inputs: Dict[str, torch.Tensor], cfg, mesh=None,
                data_axes=("data",)):
    """One-token decode.  inputs: {'tokens': (B, 1)} or {'embeds': (B, 1,
    D)}.  Returns (logits, new state); the KV caches are updated in
    place."""
    x = _inputs(model, inputs, cfg)
    pos = state.pos
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        caches = []
        for p, cache in zip(model.blocks, state.caches):
            a, new_cache = decode_attention(
                rms_norm(x, p.ln1), p.attn, cfg,
                KVCache(cache.k, cache.v, pos))
            x = x + a
            if hasattr(p, "moe"):
                y, _ = moe_mod.moe_apply(rms_norm(x, p.ln2), p.moe, cfg,
                                         mesh, data_axes=data_axes)
            else:
                y = mlp(rms_norm(x, p.ln2), p.mlp, cfg.act)
            x = x + y
            caches.append(new_cache)
        new_state = DecodeState(caches, None, pos + 1)
    elif cfg.family == "ssm":
        caches = []
        for p, st in zip(model.blocks, state.caches):
            a, new_st = ssm_mod.rwkv6_decode(rms_norm(x, p.ln1), p.time,
                                             cfg, st)
            x = x + a
            xn = rms_norm(x, p.ln2)
            # decode-time token shift: the channel mix gets a zero shift,
            # as in the reference (the time-mix state is exact)
            x = x + ssm_mod.rwkv_channelmix(
                xn[:, 0], torch.zeros_like(xn[:, 0]), p.chan)[:, None]
            caches.append(new_st)
        new_state = DecodeState(caches, None, pos + 1)
    elif cfg.family == "hybrid":
        every = cfg.attn_every
        caches, shared = [], []
        for g in range(cfg.n_layers // every):
            for i in range(g * every, (g + 1) * every):
                p = model.blocks[i]
                out, st = ssm_mod.mamba2_decode(rms_norm(x, p.ln), p.mamba,
                                                cfg, state.caches[i])
                x = x + out
                caches.append(st)
            sh, shc = model.shared, state.shared_caches[g]
            a, nshc = decode_attention(rms_norm(x, sh.ln1), sh.attn, cfg,
                                       KVCache(shc.k, shc.v, pos))
            x = x + a
            x = x + mlp(rms_norm(x, sh.ln2), sh.mlp, cfg.act)
            shared.append(nshc)
        # the reference's decode runs the grouped layers only (zamba2's
        # 54 = 9 × 6 leave none over); a remainder's state passes as it is
        caches += list(state.caches[len(caches):])
        new_state = DecodeState(caches, shared, pos + 1)
    else:
        raise ValueError(cfg.family)
    return _logits(rms_norm(x, model.norm_f), model, cfg), new_state
