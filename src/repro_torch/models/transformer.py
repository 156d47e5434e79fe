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
them, and returns the logits of its rows, where the reference's GSPMD
keeps them.  With ``model`` > 1 and no ``cfg.ddp`` the ranks along
``model`` split the products as GSPMD does: an attention block and a
dense MLP multiply each rank's slices of their weights, where
``make_shardings`` puts them, and sum the partial products over
``model`` (``layers.tp_project``, ``attention``); the head and the loss
work on a rank's slice of the vocabulary, which a tied embedding takes
from its slice of ``d`` by one all-to-all (``dist.sharding.recut``) and
looks its tokens up in, summed over ``model``; an untied embedding looks
up its slice of ``d`` and gathers the rows' vectors.  ``forward`` and
``decode_step`` gather the logits over ``model`` once, at the end;
``loss_fn`` never holds the whole vocabulary.  The residual stream is a
rank's rows, whole over ``d``, the same bits on every rank along
``model``.  The MoE layer takes the rank's rows and returns them
(``moe.moe_rows``), and its experts where each layout of the reference
holds them (``layers.Split.take``): the expert-parallel dispatch the
rank's ``E / model`` experts, re-cut from where ``make_shardings`` puts
them by one all-to-all; ``moe_tp_fused`` their slices of the hidden
width; ``moe_local`` multiplies the slices in place, its aux loss summed
over the rows' axes.  rwkv6's time mix and mamba2 take their slices the
same way and run on the rank's block of heads where ``model`` divides
them (``models.ssm``), and rwkv6's channel mix is the dense MLP's
pattern.  What stays gathered at use, one block at a time and in one
transfer (``dist.sharding.gather_model``): the norms, the MoE router,
the channel mix's ``mu``, rwkv6's and mamba2's blocks where ``model``
divides none of their heads, musicgen's codebook heads where the rule
splits their ``d``, and a tied embedding whose vocabulary ``model`` does
not divide (its logits and loss then whole on every rank); under
``cfg.ddp`` every weight.  A model sharded at rest
(``convert.shard_params``) holds each rank's slices; a whole model on a
mesh cuts the same slices of its weights at use, with the same bits.
Context-parallel attention splits the query blocks over ``model``.  The
decode state holds a rank's rows, each KV cache and recurrent state
split over ``model`` by the reference's rule (``init_decode_state(...,
mesh=)``): a KV cache's heads when ``model`` divides them, which are
then the heads the rank attends with, else its length, and decode
attention runs over the rank's heads or slots
(``attention.decode_attention``); rwkv6's ``wkv`` on every head's slice
of hd_k and mamba2's ``ssm`` on every head's slice of P (else their
heads), and the decode steps run on those slices (``models.ssm``).

Gradients on a mesh pass every collective as its transpose
(``dist.sharding``).  ``loss_fn`` sums the token losses of a rank's rows
over the global token count and sums that over the axes the rows split
over (``dist.sharding.sum_over``: every rank gets the global loss, and
its backward is the rank's own part).  The ranks along ``model`` hold
the same rows, so a caller backpropagates ``1 / (ranks sharing the
rows)`` of it on each (``launch.steps.loss_and_grads``): each rank along
``model`` then holds a share of the gradient of every activation they
hold alike, the sums over ``model`` hand each partial product the whole
gradient, a weight the rank multiplies in place gets its slice's
gradient of the rank's rows, and one gathered or replicated gets a share
that the gather's reduce-scatter, or the sum over the axes it is
replicated along, adds up.

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

import functools
import math
from types import SimpleNamespace
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.dist.sharding import (act_axes, batch_axes_of,
                                       cache_slice_shape, gather_blocks,
                                       gather_model, local_rows, mesh_coord,
                                       mesh_sizes, recut, recut_many,
                                       shard_act, split_dims, sum_over,
                                       sum_partials)

from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import (Attention, KVCache, attention, decode_attention,
                        init_cache)
from .layers import MLP, Split, cross_entropy, cross_entropy_sum, embed, \
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
    """The time and channel mixes (on a mesh each on the rank's slices of
    its weights that its part's ``Split`` gives: ``models.ssm``)."""
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
    """mamba2 (on a mesh on the rank's slices of its weights that its
    part's ``Split`` gives: ``models.ssm``)."""
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


def _logits(x, top, cfg):
    """(logits, the first word of the rank's slice of the vocabulary
    they cover, or None where they cover all of it)."""
    sp = getattr(top, "tp", None)
    dims = sp.dims if sp is not None else {}
    if cfg.family == "audio":
        lo = sp.r * top.heads.shape[2] if dims.get("heads") == 2 else None
        return torch.einsum("bsd,cdv->bscv", x, top.heads), lo
    if cfg.tie_embeddings:
        lo = sp.r * top.embed.shape[0] if dims.get("embed") == 0 else None
        return x @ top.embed.T, lo
    lo = sp.r * top.head.shape[1] if dims.get("head") == 1 else None
    return x @ top.head, lo


def _inputs(top, inputs, cfg):
    """The input vectors: a lookup in the whole embedding, in the rank's
    slice of the vocabulary (the rows outside it zero, summed over
    ``model``), or in its slice of ``d`` (gathered over ``model``)."""
    if cfg.family == "audio":
        return inputs["embeds"].to(_dtype(cfg))
    tokens = inputs["tokens"]
    sp = getattr(top, "tp", None)
    dim = sp.dims.get("embed") if sp is not None else None
    if dim == 0:
        n = top.embed.shape[0]
        at = tokens - sp.r * n
        mine = (at >= 0) & (at < n)
        rows = embed(at.clamp(0, n - 1), top.embed)
        return sum_partials(torch.where(mine[..., None], rows, 0), sp.mesh)
    if dim == 1:
        return gather_blocks(embed(tokens, top.embed), sp.mesh, ("model",),
                             dim=tokens.ndim)
    return embed(tokens, top.embed)


def _moe(x, p, cfg, mesh, data_axes, rows):
    """The MoE layer on this rank's ``rows`` (``moe.moe_rows``; no mesh:
    ``moe_apply``)."""
    if mesh is None:
        return moe_mod.moe_apply(x, p, cfg)
    return moe_mod.moe_rows(x, p, cfg, mesh, data_axes=data_axes,
                            rows=rows)


# ---------------------------------------------------------------------------
# On a mesh: the weights where make_shardings puts them, the batch's rows
# ---------------------------------------------------------------------------

# the weights a tensor-parallel block multiplies where they lie, by part
_TP = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("up", "gate", "down"),
       "chan": ("wk", "wv")}
# the weights a part takes where its layout needs them (``Split.take``)
_TAKEN = {"moe": ("up", "gate", "down"), "time": ssm_mod._TIME,
          "mamba": ssm_mod._MAMBA}


def _namespace(mod, values, path: str, only):
    ns = SimpleNamespace()
    for n, t in mod.named_parameters(recurse=False):
        if only is None or n in only:
            setattr(ns, n, values.get(path + n, t))
    if only is None:
        for n, child in mod.named_children():
            setattr(ns, n, _namespace(child, values, f"{path}{n}.", None))
    return ns


def _head_names(cfg) -> set:
    if cfg.family == "audio":
        return {"norm_f", "heads"}
    return {"norm_f", "embed" if cfg.tie_embeddings else "head"}


class _Held:
    """A model's weights as this rank uses them.  ``part(mod, prefix,
    only=None)`` hands out a part of the model (a block named ``prefix``,
    or the model itself for the top-level weights in ``only``) in a
    namespace of its layout.  No mesh: the part itself.  On a mesh the
    weights ``_TP`` names, a V-split head and the embedding (see the
    module's docstring) are this rank's slices, and a part holding them
    carries their :class:`~repro_torch.models.layers.Split` as ``tp``;
    the weights ``_TAKEN`` names (the MoE experts, rwkv6's time mix,
    mamba2) are handed out as held, and the part's ``Split.take`` gives
    the layer its slices split where it needs them, or whole; every
    other split weight is gathered whole over ``model`` in one
    transfer, freed when the caller drops the namespace.  A model
    sharded at rest holds the slices; a whole model's are cut from its
    weights (contiguous copies, so the products are the at-rest ones)."""

    def __init__(self, model, cfg, mesh):
        at_rest = getattr(model, "at_rest", None)
        if at_rest is not None and (mesh is None
                                    or mesh_sizes(mesh) != at_rest["mesh"]):
            raise ValueError(f"the weights are sharded at rest on the mesh "
                             f"{at_rest['mesh']}; got "
                             f"{None if mesh is None else mesh_sizes(mesh)}")
        self.model, self.cfg, self.mesh = model, cfg, mesh
        self.at_rest = at_rest is not None
        if mesh is None:
            return
        self.dims = at_rest["dims"] if at_rest is not None else split_dims(
            model, cfg, mesh)
        self.m = mesh_sizes(mesh).get("model", 1)
        self.tp = self.m > 1 and not getattr(cfg, "ddp", False)
        self.r = mesh_coord(mesh)["model"] if self.tp else 0

    def _slice(self, t, dim: int, at: int = None):
        """This rank's slice of a weight split on ``dim`` (held at rest,
        or cut from the whole), or of a whole weight on ``at``."""
        if at is None and self.at_rest:
            return t
        at = dim if at is None else at
        n = t.shape[at] // self.m
        t = t.narrow(at, self.r * n, n)
        return t if t.is_contiguous() else t.contiguous()

    def _local(self, name: str, t, dim: int):
        """(this rank's slice of the weight ``name`` split on ``dim``, its
        part's name, the weight's name there, the dimension the slice
        splits), or None where the weight is gathered."""
        owner, _, leaf = name.rpartition(".")
        if leaf in _TP.get(owner, ()):
            return self._slice(t, dim), owner, leaf, dim
        if owner:
            return None
        if (name, dim) in (("head", 1), ("heads", 2)):
            return self._slice(t, dim), "", name, dim
        if name == "embed" and dim == 1 and not self.cfg.tie_embeddings:
            return self._slice(t, dim), "", name, 1
        if name == "embed" and dim == 1 and t.shape[0] % self.m == 0:
            # a tied embedding serves the head and the lookup from its
            # slice of the vocabulary, re-cut from its slice of d
            v = recut(t, self.mesh, 1, 0) if self.at_rest else \
                self._slice(t, 1, at=0)
            return v, "", name, 0
        return None

    def _take(self, held: dict, want: dict) -> dict:
        """``Split.take`` of a part whose weights ``held`` maps to (the
        weight as held: a rank's slice at rest, else whole; the dimension
        ``make_shardings`` splits): this rank's slice of each weight
        ``want`` names split on the dimension it gives, or the whole
        weight (None).  At rest a slice on another dimension is re-cut,
        all of them in one all-to-all (``dist.sharding.recut_many``), and
        a whole weight is gathered; from a whole model the slices are cut
        directly, with the same bits."""
        out, moves, wholes = {}, [], []
        for n, dst in want.items():
            t, src = held[n]
            if not self.at_rest or src is None:
                out[n] = t if dst is None else self._slice(t, src, at=dst)
            elif dst == src:
                out[n] = t
            else:
                (wholes if dst is None else moves).append((n, t, src, dst))
        if moves:
            out.update(zip([n for n, *_ in moves], recut_many(
                [t for _, t, _, _ in moves], self.mesh,
                [s for _, _, s, _ in moves], [d for *_, d in moves])))
        if wholes:
            out.update(zip([n for n, *_ in wholes], gather_model(
                [t for _, t, _, _ in wholes], [s for _, _, s, _ in wholes],
                self.mesh)))
        return out

    def part(self, mod, prefix: str, only=None):
        if self.mesh is None:
            return mod
        values, splits, gather, held = {}, {}, [], {}
        for n, t in mod.named_parameters(recurse=only is None):
            dim = self.dims.get(prefix + n)
            owner, _, leaf = n.rpartition(".")
            if self.tp and leaf in _TAKEN.get(owner, ()):
                # handed out as held (a slice on ``dim``, or whole)
                held.setdefault(owner, {})[leaf] = (t, dim)
                if dim is not None:
                    splits.setdefault(owner, {})[leaf] = dim
                continue
            if dim is None or (only is not None and n not in only):
                continue
            got = self._local(n, t, dim) if self.tp else None
            if got is None:
                gather.append((n, t, dim))
                continue
            values[n], owner, leaf, d = got
            splits.setdefault(owner, {})[leaf] = d
        if gather and self.at_rest:
            values.update(zip([n for n, _, _ in gather], gather_model(
                [t for _, t, _ in gather], [d for _, _, d in gather],
                self.mesh)))
        ns = _namespace(mod, values, "", only)
        for owner, dims in splits.items():
            sub = getattr(ns, owner) if owner else ns
            take = functools.partial(self._take, held[owner]) \
                if owner in _TAKEN else None
            sub.tp = Split(self.mesh, self.m, self.r, dims, take)
        return ns

    def top(self):
        """(the input embedding's part, a function giving the head's): a
        tied embedding is taken once, for the input and the head both."""
        names = _head_names(self.cfg)
        if "embed" in names:
            top = self.part(self.model, "", names)
            return top, lambda: top
        return self.part(self.model, "", {"embed"}), \
            lambda: self.part(self.model, "", names)


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
    logits, lo, aux = _forward(model, inputs, cfg, mesh, data_axes,
                               last_only)
    return _whole_vocab(logits, lo, mesh), aux


def next_tokens(model: Transformer, inputs: Dict[str, torch.Tensor], cfg,
                mesh=None, data_axes=("data",), last_only: bool = False):
    """The greedy next token (int32) of each of the rank's rows after
    :func:`forward`: the argmax of the last position's logits.  Where the
    head splits the vocabulary over ``model``, only that position's
    logits are gathered."""
    logits, lo, _ = _forward(model, inputs, cfg, mesh, data_axes, last_only)
    last = _whole_vocab(logits[:, -1], lo, mesh)
    return torch.argmax(last, dim=-1).to(torch.int32)


def _whole_vocab(logits, lo, mesh):
    """Logits over the whole vocabulary: a rank's slice (``lo`` not None)
    gathered over ``model``."""
    if lo is None:
        return logits
    return gather_blocks(logits, mesh, ("model",), dim=logits.ndim - 1)


def _forward(model, inputs, cfg, mesh, data_axes, last_only=False):
    """:func:`forward`'s (logits, the first word of the rank's slice of
    the vocabulary they cover or None, aux)."""
    parts = _Held(model, cfg, mesh)
    inputs, rows = _on_mesh(inputs, mesh, cfg)
    first, head = parts.top()
    x = _inputs(first, inputs, cfg)
    del first
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        block = _remat(lambda h, i: _apply_attn_block(
            h, parts.part(model.blocks[i], f"blocks.{i}."), cfg, mesh,
            data_axes, rows), cfg.remat)
    elif cfg.family == "ssm":
        block = _remat(lambda h, i: _apply_rwkv_block(
            h, parts.part(model.blocks[i], f"blocks.{i}."), cfg), cfg.remat)
    if cfg.family != "hybrid":
        for i in range(len(model.blocks)):
            x, a = block(x, i)
            aux = aux + a
    else:
        x, aux = _hybrid_forward(x, model, cfg, mesh, data_axes, parts, rows)
    if last_only:
        x = x[:, -1:]                # prefill serves next-token logits only
    top = head()
    logits, lo = _logits(rms_norm(x, top.norm_f), top, cfg)
    return logits, lo, aux


def _hybrid_forward(x, model, cfg, mesh, data_axes, parts, rows):
    """zamba2: groups of ``attn_every`` mamba layers + the shared attn
    block after each group; the remaining layers last."""
    every = cfg.attn_every
    n_groups = cfg.n_layers // every
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    mamba = _remat(lambda h, i: _apply_mamba_block(
        h, parts.part(model.blocks[i], f"blocks.{i}."), cfg), cfg.remat)
    # the shared block is taken at each of its uses; its gradient is the
    # sum over them
    shared = _remat(lambda h: _apply_attn_block(
        h, parts.part(model.shared, "shared."), cfg, mesh, data_axes, rows),
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
    a mesh each rank sums the token losses of its rows (over its slice of
    the vocabulary, where the head splits it) over the global token
    count, and the parts are summed over the axes the rows split
    over (one float32 all-reduce of a scalar, in rank order): every rank
    returns the global loss.  Its backward on a rank is the rank's own
    part, and ``1 / blocks`` of the aux's gradient (``blocks`` the row
    blocks: every rank computes the aux alike); backpropagated on every
    rank scaled by one over the ranks that share a row block
    (``launch.steps.loss_and_grads``), each term counts once."""
    logits, lo, aux = _forward(model, batch, cfg, mesh, data_axes)
    # audio: logits (B,S,Cb,V) vs labels (B,S,Cb); LM: (B,S,V) vs (B,S)
    if mesh is None:
        return cross_entropy(logits, batch["labels"]) + 0.01 * aux
    labels = batch["labels"]
    rows = row_axes(mesh, cfg, labels.shape[0])
    part = cross_entropy_sum(logits, shard_act(labels, mesh, axes=rows),
                             mesh=mesh, vocab_lo=lo) / labels.numel()
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
    (``dist.sharding.local_rows``), and of each KV cache and recurrent
    state the part the reference's rule puts on its ``model`` index
    (``init_cache``; ``dist.sharding.cache_split_dim``: rwkv6's ``wkv``
    on hd_k, mamba2's ``ssm`` on P, else their heads; mamba2's conv
    window on its 3 slots where ``model`` divides them)."""
    dev = resolve_device(device)
    L = cfg.n_layers
    if mesh is not None:
        rows = local_rows(B, mesh)
        B = rows.stop - rows.start

    def zeros(shape, dt):
        return torch.zeros(cache_slice_shape(shape, mesh), dtype=dt,
                           device=dev)
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        S = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        return DecodeState([init_cache(B, S, cfg, dtype, dev, mesh)
                            for _ in range(L)], None, 0)
    if cfg.family == "ssm":
        hd = cfg.d_model // cfg.n_heads
        return DecodeState([ssm_mod.RWKVState(
            wkv=zeros((B, cfg.n_heads, hd, hd), torch.float32),
            last=zeros((B, cfg.d_model), torch.float32))
            for _ in range(L)], None, 0)
    if cfg.family == "hybrid":
        di = 2 * cfg.d_model
        hd = di // cfg.ssm_heads
        caches = [ssm_mod.MambaState(
            ssm=zeros((B, cfg.ssm_heads, hd, cfg.ssm_state), torch.float32),
            conv=zeros((B, 3, di + 2 * cfg.ssm_state), _dtype(cfg)))
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
    those ``shard_act`` gives it, and of each KV cache and recurrent
    state its part over ``model`` (:func:`init_decode_state` with the
    mesh)."""
    parts = _Held(model, cfg, mesh)
    inputs, rows = _on_mesh(inputs, mesh)
    first, head = parts.top()
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
            p = parts.part(p, f"blocks.{i}.")
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
            p = parts.part(p, f"blocks.{i}.")
            a, new_st = ssm_mod.rwkv6_decode(rms_norm(x, p.ln1), p.time,
                                             cfg, st, mesh)
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
                p = parts.part(model.blocks[i], f"blocks.{i}.")
                out, st = ssm_mod.mamba2_decode(rms_norm(x, p.ln), p.mamba,
                                                cfg, state.caches[i], mesh)
                x = x + out
                caches.append(st)
            sh = parts.part(model.shared, "shared.")
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
    logits, lo = _logits(rms_norm(x, top.norm_f), top, cfg)
    return _whole_vocab(logits, lo, mesh), new_state


def _state_rows(state) -> Optional[int]:
    """The batch rows a decode state holds (None: no layer)."""
    if not state.caches:
        return None
    return int(state.caches[0][0].shape[0])
