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
card unless the caller passes ``device="cpu"``.

On a mesh (a ``DeviceMesh`` with ``data``/``pod`` and ``model`` axes)
``forward`` and ``decode_step`` run SPMD: every rank passes the whole
batch, keeps its rows (``dist.sharding.shard_act``), runs each block on
them with the block's weights whole, and returns the logits of its rows,
where the reference's GSPMD keeps them.  A model sharded at rest
(``convert.shard_params``) holds each rank's slice of every weight, as
``make_shardings`` places it; a block's slices are
gathered over ``model`` when the block starts and dropped after it, so
one block's weights are whole at a time.  Where rows mix, the MoE layer,
the rows are gathered and it runs on the whole batch, as the reference's
does under jit; context-parallel attention splits the query blocks over
``model``.  The gathers only concatenate, so each rank computes what one
device computes on its rows.  The decode state holds a rank's rows, each
KV cache split over ``model`` by the reference's rule
(``init_decode_state(..., mesh=)``): its KV heads when ``model`` divides
them, else its length, and decode attention runs over the rank's heads
or slots (``attention.decode_attention``).

Gradients on a mesh pass every gather as its transpose, a reduce-scatter
(``dist.sharding``).  ``loss_fn`` sums the token losses of a rank's rows
over the global token count and sums that over the axes the rows split
over (``dist.sharding.sum_over``: every rank gets the global loss, and
its backward is the rank's own part).  The ranks along ``model`` hold
the same rows, so a caller that backpropagates ``1 / (ranks sharing the
rows)`` of it (``launch.steps.loss_and_grads``) and then sums each
weight's gradient over the axes it is replicated along gets the global
gradient of its slices.

``cfg.remat`` applies where gradients are taken: ``"full"`` recomputes
each block in the backward pass (``torch.utils.checkpoint``, hybrid's
shared block included), as the reference's ``jax.checkpoint`` of its scan
body saves nothing; ``"none"`` keeps every activation.  A block's gather
at use runs inside the recomputed function, so under ``"full"`` the
backward gathers its weights again, as the reference's recompute does,
and no layer's whole weights outlive its block.  ``"dots"`` keeps the
outputs of the matmuls without batch dimensions (``aten.mm``/``addmm``,
an activation times a weight) and recomputes the rest, the reference's
``checkpoint_dots_with_no_batch_dims`` (``torch.utils.checkpoint`` with a
selective policy); its loss and gradients are ``"full"``'s.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.dist.sharding import (act_axes, batch_axes_of,
                                       gather_blocks, gather_model,
                                       local_rows, mesh_sizes, shard_act,
                                       sum_over)

from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import (Attention, KVCache, attention, decode_attention,
                        init_cache)
from .layers import MLP, cross_entropy, cross_entropy_sum, embed, \
    init_rms, mlp, normal, rms_norm


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


def _apply_attn_block(x, p, cfg, mesh, data_axes, rows=()):
    h = attention(rms_norm(x, p.ln1), p.attn, cfg, mesh=mesh,
                  batch_axes=rows)
    x = x + h
    if hasattr(p, "moe"):
        y, aux = _moe(rms_norm(x, p.ln2), p.moe, cfg, mesh, data_axes, rows)
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


def _moe(x, p, cfg, mesh, data_axes, rows):
    """``moe_apply`` on the whole batch, back on this rank's ``rows``: its
    capacity buffers and the distributed layouts take every row, as the
    reference's layer does under jit."""
    if not rows:
        return moe_mod.moe_apply(x, p, cfg, mesh, data_axes=data_axes)
    y, aux = moe_mod.moe_apply(gather_blocks(x, mesh, rows), p, cfg, mesh,
                               data_axes=data_axes)
    return shard_act(y, mesh, axes=rows), aux


# ---------------------------------------------------------------------------
# On a mesh: weights whole at use, the batch's rows
# ---------------------------------------------------------------------------


def _namespace(mod, full, path: str, only):
    ns = SimpleNamespace()
    for n, t in mod.named_parameters(recurse=False):
        if only is None or n in only:
            setattr(ns, n, full.get(path + n, t))
    if only is None:
        for n, child in mod.named_children():
            setattr(ns, n, _namespace(child, full, f"{path}{n}.", None))
    return ns


def _whole(model, mesh):
    """``whole(part, prefix, only=None)``: ``part`` of ``model`` (a block
    named ``prefix``, or the model itself for the top-level weights named
    in ``only``) with every weight whole.  On a model sharded at rest the
    part's slices are gathered over ``model`` in one transfer and handed
    out in a namespace of the part's layout, freed when the caller drops
    it; a whole model gives the part itself."""
    at_rest = getattr(model, "at_rest", None)
    if at_rest is None:
        return lambda part, prefix, only=None: part
    if mesh is None or mesh_sizes(mesh) != at_rest["mesh"]:
        raise ValueError(f"the weights are sharded at rest on the mesh "
                         f"{at_rest['mesh']}; got "
                         f"{None if mesh is None else mesh_sizes(mesh)}")
    dims = at_rest["dims"]

    def whole(part, prefix, only=None):
        split = [n for n, _ in part.named_parameters(recurse=only is None)
                 if prefix + n in dims and (only is None or n in only)]
        full = dict(zip(split, gather_model(
            [part.get_parameter(n) for n in split],
            [dims[prefix + n] for n in split], mesh)))
        return _namespace(part, full, "", only)
    return whole


def _head_names(cfg) -> set:
    if cfg.family == "audio":
        return {"norm_f", "heads"}
    return {"norm_f", "embed" if cfg.tie_embeddings else "head"}


def _top(model, cfg, whole):
    """(the input embedding's part, a function giving the head's): a tied
    embedding is gathered once, for the input and the head both."""
    if "embed" in _head_names(cfg):
        top = whole(model, "", _head_names(cfg))
        return top, lambda: top
    return whole(model, "", {"embed"}), lambda: whole(model, "",
                                                      _head_names(cfg))


def row_axes(mesh, cfg, batch: int) -> tuple:
    """The axes a batch of ``batch`` rows splits over on ``mesh``:
    ``shard_act``'s default, or under ``cfg.ddp`` ``batch_axes_of``'s (()
    without a mesh)."""
    if mesh is None:
        return ()
    return act_axes(mesh, batch, batch_axes_of(mesh, cfg, batch=batch)
                    if getattr(cfg, "ddp", False) else None)


def _on_mesh(inputs, mesh, cfg=None) -> Tuple[dict, tuple]:
    """(``inputs`` with this rank's rows of the token ids or embeddings,
    the axes those rows split over, :func:`row_axes`); every row and ()
    without a mesh."""
    if mesh is None:
        return inputs, ()
    key = "embeds" if "embeds" in inputs else "tokens"
    rows = row_axes(mesh, cfg, inputs[key].shape[0])
    return dict(inputs, **{key: shard_act(inputs[key], mesh, axes=rows)}), \
        rows


# the matmuls without batch dimensions: a (…, K) activation times a (K, N)
# weight dispatches to one of these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The reference's ``checkpoint_dots_with_no_batch_dims``: keep the
    outputs of matmuls without batch dimensions, recompute everything
    else (``bmm``, the attention's and the experts' batched products,
    among them)."""
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_save_dots)


def _remat(fn, mode: str):
    """``fn`` recomputed in the backward pass under ``"full"`` and, but
    for its unbatched matmuls' outputs, which are kept, under ``"dots"``
    (only where autograd records it); as it is under ``"none"``."""
    if mode not in ("full", "dots"):
        return fn
    kw = {"context_fn": _dots_context} if mode == "dots" else {}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def forward(model: Transformer, inputs: Dict[str, torch.Tensor], cfg,
            mesh=None, data_axes=("data",), last_only: bool = False):
    """Returns (logits, aux_loss).  inputs: {'tokens'} or {'embeds'}; on a
    mesh the whole batch on every rank, which keeps its rows (the data
    axes, and ``model`` under ``cfg.ddp``, as ``batch_axes_of`` drops
    them) and returns the logits of those rows (:func:`row_axes`)."""
    whole = _whole(model, mesh)
    inputs, rows = _on_mesh(inputs, mesh, cfg)
    first, head = _top(model, cfg, whole)
    x = _inputs(first, inputs, cfg)
    del first
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        block = _remat(lambda h, i: _apply_attn_block(
            h, whole(model.blocks[i], f"blocks.{i}."), cfg, mesh, data_axes,
            rows), cfg.remat)
    elif cfg.family == "ssm":
        block = _remat(lambda h, i: _apply_rwkv_block(
            h, whole(model.blocks[i], f"blocks.{i}."), cfg), cfg.remat)
    if cfg.family != "hybrid":
        for i in range(len(model.blocks)):
            x, a = block(x, i)
            aux = aux + a
    else:
        x, aux = _hybrid_forward(x, model, cfg, mesh, data_axes, whole, rows)
    if last_only:
        x = x[:, -1:]                # prefill serves next-token logits only
    top = head()
    return _logits(rms_norm(x, top.norm_f), top, cfg), aux


def _hybrid_forward(x, model, cfg, mesh, data_axes, whole, rows):
    """zamba2: groups of ``attn_every`` mamba layers + the shared attn
    block after each group; the remaining layers last."""
    every = cfg.attn_every
    n_groups = cfg.n_layers // every
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    mamba = _remat(lambda h, i: _apply_mamba_block(
        h, whole(model.blocks[i], f"blocks.{i}."), cfg), cfg.remat)
    # the shared block is gathered at each of its uses; its gradient is
    # the sum over them
    shared = _remat(lambda h: _apply_attn_block(
        h, whole(model.shared, "shared."), cfg, mesh, data_axes, rows),
        cfg.remat)
    for g in range(n_groups):
        for i in range(g * every, (g + 1) * every):
            x, _ = mamba(x, i)
        x, aux = shared(x)
        aux_total = aux_total + aux
    for i in range(n_groups * every, cfg.n_layers):
        x, _ = mamba(x, i)
    return x, aux_total


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor], cfg,
            mesh=None, data_axes=("data",)) -> torch.Tensor:
    """The mean token loss (z-loss included) plus 0.01 of the MoE aux.  On
    a mesh each rank sums the token losses of its rows over the global
    token count, and the parts are summed over the axes the rows split
    over (one float32 all-reduce of a scalar, in rank order): every rank
    returns the global loss.  Its backward on a rank is the rank's own
    part, and ``1 / blocks`` of the aux's gradient (``blocks`` the row
    blocks: every rank computes the aux alike); backpropagated on every
    rank scaled by one over the ranks that share a row block
    (``launch.steps.loss_and_grads``), each term counts once."""
    logits, aux = forward(model, batch, cfg, mesh, data_axes)
    # audio: logits (B,S,Cb,V) vs labels (B,S,Cb); LM: (B,S,V) vs (B,S)
    if mesh is None:
        return cross_entropy(logits, batch["labels"]) + 0.01 * aux
    labels = batch["labels"]
    rows = row_axes(mesh, cfg, labels.shape[0])
    part = cross_entropy_sum(logits, shard_act(labels, mesh, axes=rows)) \
        / labels.numel()
    blocks = math.prod(mesh_sizes(mesh)[a] for a in rows)
    aux = aux.detach() + (aux - aux.detach()) / blocks
    return sum_over(part, mesh, rows) + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    caches: List[Any]          # per layer: KVCache / MambaState / RWKVState
    shared_caches: Optional[List[KVCache]]   # hybrid only, per group
    pos: int


def init_decode_state(cfg, B: int, cache_len: int, dtype, device=None,
                      mesh=None) -> DecodeState:
    """The decode state of ``B`` sequences over ``cache_len`` slots (a
    sliding window's ring: the window's).  On a mesh ``B`` is the whole
    batch and the state holds the rank's slice: its rows
    (``dist.sharding.local_rows``), and of each KV cache the part the
    reference's rule puts on its ``model`` index (``init_cache``)."""
    dev = resolve_device(device)
    L = cfg.n_layers
    if mesh is not None:
        rows = local_rows(B, mesh)
        B = rows.stop - rows.start
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        S = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        return DecodeState([init_cache(B, S, cfg, dtype, dev, mesh)
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
        return DecodeState(caches, [init_cache(B, cache_len, cfg, dtype, dev,
                                               mesh) for _ in range(n_sh)],
                           0)
    raise ValueError(cfg.family)


def decode_step(model: Transformer, state: DecodeState,
                inputs: Dict[str, torch.Tensor], cfg, mesh=None,
                data_axes=("data",)):
    """One-token decode.  inputs: {'tokens': (B, 1)} or {'embeds': (B, 1,
    D)}.  Returns (logits, new state); the KV caches are updated in
    place.  On a mesh every rank passes the whole batch and gets the
    logits of its rows, and ``state`` holds this rank's slice: its rows,
    those ``shard_act`` gives it, and of each KV cache its part over
    ``model`` (:func:`init_decode_state` with the mesh)."""
    whole = _whole(model, mesh)
    inputs, rows = _on_mesh(inputs, mesh)
    first, head = _top(model, cfg, whole)
    x = _inputs(first, inputs, cfg)
    del first
    held = _state_rows(state)
    if held is not None and held != x.shape[0]:
        raise ValueError(f"the decode state holds {held} rows; this rank "
                         f"holds {x.shape[0]} of the batch")
    pos = state.pos
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        caches = []
        for i, (p, cache) in enumerate(zip(model.blocks, state.caches)):
            p = whole(p, f"blocks.{i}.")
            a, new_cache = decode_attention(
                rms_norm(x, p.ln1), p.attn, cfg, cache._replace(pos=pos),
                mesh)
            x = x + a
            if hasattr(p, "moe"):
                y, _ = _moe(rms_norm(x, p.ln2), p.moe, cfg, mesh, data_axes,
                            rows)
            else:
                y = mlp(rms_norm(x, p.ln2), p.mlp, cfg.act)
            x = x + y
            caches.append(new_cache)
        new_state = DecodeState(caches, None, pos + 1)
    elif cfg.family == "ssm":
        caches = []
        for i, (p, st) in enumerate(zip(model.blocks, state.caches)):
            p = whole(p, f"blocks.{i}.")
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
                p = whole(model.blocks[i], f"blocks.{i}.")
                out, st = ssm_mod.mamba2_decode(rms_norm(x, p.ln), p.mamba,
                                                cfg, state.caches[i])
                x = x + out
                caches.append(st)
            sh = whole(model.shared, "shared.")
            shc = state.shared_caches[g]
            a, nshc = decode_attention(rms_norm(x, sh.ln1), sh.attn, cfg,
                                       shc._replace(pos=pos), mesh)
            x = x + a
            x = x + mlp(rms_norm(x, sh.ln2), sh.mlp, cfg.act)
            shared.append(nshc)
        # the reference's decode runs the grouped layers only (zamba2's
        # 54 = 9 × 6 leave none over); a remainder's state passes as it is
        caches += list(state.caches[len(caches):])
        new_state = DecodeState(caches, shared, pos + 1)
    else:
        raise ValueError(cfg.family)
    top = head()
    return _logits(rms_norm(x, top.norm_f), top, cfg), new_state


def _state_rows(state) -> Optional[int]:
    """The batch rows a decode state holds (None: no layer)."""
    if not state.caches:
        return None
    return int(state.caches[0][0].shape[0])
