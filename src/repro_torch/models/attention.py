"""GQA attention (counterpart of ``repro/models/attention.py``): the
chunked prefill (online softmax over 1024-key blocks), sliding window,
qk-norm, and single-token decode against a KV cache.

The chunked path keeps a (B, H, block, block) score block instead of the
(B, H, S, S) one: queries run block by block, each scanning the key
blocks at or before it with a running (max, denominator), as the
reference's ``lax.map`` over query blocks and ``lax.scan`` over key blocks
do, masked steps included.  ``banded`` scans only the key blocks of the
sliding-window band.  On a mesh with ``cfg.attn_context_parallel``,
``_attend_cp`` splits the query blocks over ``model``, and a decode
cache split over ``model`` by the reference's rule (its KV heads, else
its length) is attended over the rank's heads or slots.  Plain torch, as
the reference is plain ``jnp``.

With its weights where ``make_shardings`` puts them (``p.tp``, a
``layers.Split``), a rank multiplies its slice of the input by its rows
of ``wq``/``wk``/``wv`` (their input, ``d``, split over ``model``).
Where ``model`` divides the query heads the partial products are
reduce-scattered onto the rank's query heads, and onto its KV heads when
``model`` divides those too; otherwise k and v are summed whole and the
rank keeps the KV heads its query heads read (query head h reads KV head
h // (H / KV), so they are contiguous).  The rank runs RoPE, qk-norm and
attention on its heads, multiplies by its rows of ``wo`` (its heads) and
sums over ``model`` once.  Context-parallel attention, a decode cache
split on its length or not at all, and query heads ``model`` does not
divide (or divides into blocks that straddle KV groups) take q, k and v
summed whole and attend as on one device, and ``wo`` multiplies the
rank's rows of the heads' output.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.dist.sharding import (cache_slice_shape, cache_split_dim,
                                       gather_blocks, mesh_coord,
                                       mesh_sizes)

from .layers import (apply_rope, init_rms, normal, rms_norm, tp_matmul,
                     tp_project)

NEG_INF = -1e30


class Attention(nn.Module):
    """``wq`` (d, H·hd), ``wk``/``wv`` (d, KV·hd), ``wo`` (H·hd, d), and
    with qk-norm ``q_norm``/``k_norm`` (hd,)."""

    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int,
                 qk_norm: bool, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        s = 1.0 / math.sqrt(d)
        self.wq = normal(gen, (d, n_heads * head_dim), dtype, s, device)
        self.wk = normal(gen, (d, n_kv * head_dim), dtype, s, device)
        self.wv = normal(gen, (d, n_kv * head_dim), dtype, s, device)
        self.wo = normal(gen, (n_heads * head_dim, d), dtype,
                         1.0 / math.sqrt(n_heads * head_dim), device)
        self.q_norm = init_rms(head_dim, device) if qk_norm else None
        self.k_norm = init_rms(head_dim, device) if qk_norm else None


def _qkv(x, p, cfg, positions, heads: bool = False):
    """(q, k, v, rep): (B, S, ·, hd) each, and the number of consecutive
    query heads that read one KV head (:func:`_repeat_kv`).  With
    ``p.tp`` and ``heads`` the rank's query heads and the KV heads they
    read; with ``p.tp`` alone every head, summed over ``model``."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = getattr(p, "tp", None)
    rep = H // KV
    if sp is None:
        q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    else:
        kv_split = heads and KV % sp.m == 0
        q, k, v = tp_project(x, sp, [("wq", p.wq, heads),
                                     ("wk", p.wk, kv_split),
                                     ("wv", p.wv, kv_split)])
        if heads and not kv_split:       # the KV heads of the rank's heads
            h0, h1 = sp.r * H // sp.m, (sp.r + 1) * H // sp.m
            lo, hi = h0 // rep, (h1 - 1) // rep + 1
            k, v = k[..., lo * hd:hi * hd], v[..., lo * hd:hi * hd]
            rep = min(rep, h1 - h0)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if getattr(p, "q_norm", None) is not None:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, rep


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def _heads(cfg, sp) -> bool:
    """Whether a rank of a tensor-parallel block attends with its own
    query heads: ``model`` divides them, and they read whole groups of
    one or more KV heads or lie in one group."""
    if sp is None or cfg.n_heads % sp.m:
        return False
    mine, rep = cfg.n_heads // sp.m, cfg.n_heads // cfg.n_kv_heads
    return mine % rep == 0 or rep % mine == 0


def _out(out, p, sp, heads: bool):
    """``out @ wo``: whole, or with ``p.tp`` the rank's rows of ``wo``
    times its heads' (``heads``) or its block of every head's output,
    summed over ``model``."""
    if sp is None:
        return out @ p.wo
    return tp_matmul(out, "wo", p.wo, sp, heads)


def attention(x: torch.Tensor, p, cfg, *, block: int = 1024,
              banded: Optional[bool] = None, mesh=None,
              batch_axes=()) -> torch.Tensor:
    """Causal self-attention for prefill.  x: (B, S, D), on a mesh this
    rank's rows, split over ``batch_axes``."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.arange(S, device=x.device)[None, :]
    cp = getattr(cfg, "attn_context_parallel", False) and mesh is not None \
        and S > block
    sp = getattr(p, "tp", None)
    heads = _heads(cfg, sp) and not cp
    q, k, v, rep = _qkv(x, p, cfg, positions, heads)
    window = cfg.sliding_window
    if banded is None:
        banded = bool(window) and getattr(cfg, "swa_banded", False)

    if cp:
        out = _attend_cp(q, k, v, rep, window, block, mesh, batch_axes)
    elif S <= block:
        out = _attend_dense(q, k, v, rep, window)
    else:
        out = _attend_chunked(q, k, v, rep, window, block, banded)
    return _out(out.reshape(B, S, q.shape[2] * hd), p, sp, heads)


def _attend_cp(q, k, v, n_rep, window, block, mesh, batch_axes=()):
    """Context-parallel attention (the reference's ``_attend_cp``): this
    rank's query blocks, the ``nq / model`` of its ``model`` index when
    ``model`` divides nq (and does not already split the rows), else all
    of them, against K and V whole, in one online-softmax pass over every
    key block with the causal and window masks; the output gathered over
    ``model``.  q: (B, S, H, hd) of this rank's rows."""
    B, S, H, hd = q.shape
    nq = S // block
    m = mesh_sizes(mesh).get("model", 1)
    split = m > 1 and nq % m == 0 and "model" not in batch_axes
    n_loc = nq // m if split else nq
    lo = mesh_coord(mesh)["model"] * n_loc if split else 0
    qb = q.reshape(B, nq, block, H, hd)[:, lo:lo + n_loc]
    ar = torch.arange(block, device=q.device)
    qpos = (lo + torch.arange(n_loc, device=q.device))[:, None] * block \
        + ar[None, :]                                   # (n_loc, block)
    acc = torch.zeros((B, n_loc, block, H, hd), dtype=torch.float32,
                      device=q.device)
    m_run = torch.full((B, n_loc, H, block), NEG_INF, dtype=torch.float32,
                       device=q.device)
    denom = torch.zeros((B, n_loc, H, block), dtype=torch.float32,
                        device=q.device)
    for kj in range(nq):
        kb = _repeat_kv(k[:, kj * block:(kj + 1) * block], n_rep)
        vb = _repeat_kv(v[:, kj * block:(kj + 1) * block], n_rep)
        s = torch.einsum("bnqhd,bkhd->bnhqk", qb, kb).float()
        s = s * (1.0 / math.sqrt(hd))
        kpos = kj * block + ar
        mask = kpos[None, None, :] <= qpos[:, :, None]
        if window:
            mask &= kpos[None, None, :] > qpos[:, :, None] - window
        s = torch.where(mask[None, :, None], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        scale = torch.exp(m_run - m_new)
        pr = torch.exp(s - m_new[..., None])
        denom = denom * scale + pr.sum(dim=-1)
        acc = acc * scale.transpose(2, 3)[..., None] + torch.einsum(
            "bnhqk,bkhd->bnqhd", pr.to(qb.dtype), vb).float()
        m_run = m_new
    out = acc / torch.clamp(denom.transpose(2, 3)[..., None], min=1e-30)
    if split:
        out = gather_blocks(out, mesh, ("model",), dim=1)
    return out.reshape(B, S, H, hd).to(q.dtype)


def _attend_dense(q, k, v, n_rep, window):
    B, S, H, hd = q.shape
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = ki <= qi
    if window:
        mask &= ki > qi - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend_chunked(q, k, v, n_rep, window, block, banded):
    """Online softmax over key blocks; with ``banded`` (and a window) each
    query block scans only the ``window // block + 2`` blocks of its band,
    the leading ones clamped to block 0 and masked out, as the
    reference's scan runs them."""
    B, S, H, hd = q.shape
    nq = S // block
    qs = q.reshape(B, nq, block, H, hd)
    band = bool(banded and window)
    nkv = min(nq, window // block + 2) if band else nq
    ar = torch.arange(block, device=q.device)
    outs = []
    for qi in range(nq):
        qb = qs[:, qi]                                  # (B, block, H, hd)
        acc = torch.zeros((B, H, block, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, H, block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        denom = torch.zeros((B, H, block), dtype=torch.float32,
                            device=q.device)
        # the reference scans nq steps and keeps the carry past qi: those
        # steps change nothing, so they are not run
        for kj in range(nkv if band else qi + 1):
            kb_idx = qi - (nkv - 1) + kj if band else kj
            c = min(max(kb_idx, 0), nq - 1)
            kb = _repeat_kv(k[:, c * block:(c + 1) * block], n_rep)
            vb = _repeat_kv(v[:, c * block:(c + 1) * block], n_rep)
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb).float()
            s = s * (1.0 / math.sqrt(hd))
            qpos = qi * block + ar[:, None]
            kpos = c * block + ar[None, :]
            mask = (kpos <= qpos) & (kb_idx >= 0)
            if window:
                mask &= kpos > qpos - window
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            scale = torch.exp(m - m_new)
            pr = torch.exp(s - m_new[..., None])
            denom = denom * scale + pr.sum(dim=-1)
            acc = acc * scale[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", pr.to(qb.dtype), vb).float()
            m = m_new
        out = acc / torch.clamp(denom[..., None], min=1e-30)
        outs.append(out.transpose(1, 2).to(qb.dtype))   # (B, block, H, hd)
    return torch.stack(outs, dim=1).reshape(B, S, H, hd)


# --- decode ----------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, KV, hd); on a mesh, the rank's slice
    v: torch.Tensor
    pos: int              # next write position (same for the batch)
    # on a mesh, the dimension of the whole cache split over ``model``: 1
    # the length, 2 the KV heads (``dist.sharding.cache_split_dim``); None
    # where the rank holds every slot and head of its rows
    split: Optional[int] = None


def init_cache(B: int, S_max: int, cfg, dtype, device, mesh=None
               ) -> KVCache:
    """Zeros for ``B`` rows and ``S_max`` slots; on a mesh, the rank's
    slice over ``model`` by the reference's rule: its ``KV / model``
    heads, else its ``S_max / model`` slots, else every one."""
    whole = (B, S_max, cfg.n_kv_heads, cfg.head_dim)
    split = cache_split_dim(whole, mesh)
    shape = cache_slice_shape(whole, mesh)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=0, split=split)


def decode_attention(x: torch.Tensor, p, cfg, cache: KVCache, mesh=None):
    """One-token decode: x (B, 1, D); returns (out (B, 1, D), new cache).

    The new key and value are written into the cache's buffers in place
    (the reference donates them to its step), at the absolute position, or
    for a sliding window at its slot in the ring; like the reference's
    ``dynamic_update_slice`` a write past the end lands on the last slot,
    and keys of another dtype than the cache's are refused.

    On a mesh a cache split over ``model`` holds the rank's slice
    (``cache.split``).  Heads: the rank attends with the query heads of
    its KV heads' groups (``_repeat_kv`` is contiguous: query head h reads
    KV head h // (H / KV)); with ``p.tp`` its q, k and v are those heads'
    alone and its rows of ``wo`` take their output, else the heads'
    outputs are gathered over ``model`` before ``wo``.  Length: the rank
    owns a contiguous block of slots, and only the owner of the slot
    writes; each rank reduces its block to a (max, sum of exponentials,
    weighted values) per head, and the partials, gathered over
    ``model``, are combined in rank order."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    split = cache.split if mesh is not None else None
    m = mesh_sizes(mesh)["model"] if split is not None else 1
    mi = mesh_coord(mesh)["model"] if split is not None else 0
    S_loc = cache.k.shape[1]
    S_max = S_loc * m if split == 1 else S_loc
    window = cfg.sliding_window
    abs_pos = int(cache.pos)
    slot = min(abs_pos % S_max if window else abs_pos, S_max - 1)
    sp = getattr(p, "tp", None)
    heads = sp is not None and split == 2
    q, k, v, rep = _qkv(x, p, cfg, torch.full((B, 1), abs_pos,
                                             device=x.device), heads)
    if k.dtype != cache.k.dtype:
        raise TypeError(f"lax.dynamic_update_slice requires arguments to "
                        f"have the same dtypes, got {cache.k.dtype}, "
                        f"{k.dtype}")
    lo = mi * S_loc if split == 1 else 0
    if split == 2 and not heads:    # this rank's KV heads and their queries
        q = q[:, :, mi * (H // m):(mi + 1) * (H // m)]
        k = k[:, :, mi * (KV // m):(mi + 1) * (KV // m)]
        v = v[:, :, mi * (KV // m):(mi + 1) * (KV // m)]
    if lo <= slot < lo + S_loc:
        cache.k[:, slot - lo] = k[:, 0]
        cache.v[:, slot - lo] = v[:, 0]
    kk = _repeat_kv(cache.k, rep)
    vv = _repeat_kv(cache.v, rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * (1.0 / math.sqrt(hd))
    kpos = lo + torch.arange(S_loc, device=x.device)
    if window:                      # ring: every filled slot is in window
        valid = kpos < min(abs_pos + 1, S_max)
    else:
        valid = kpos <= abs_pos
    if split == 1:
        out = _combine_blocks(s, valid, vv, mesh).to(x.dtype)
    else:
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", pr, vv)
        if split == 2 and not heads:
            out = gather_blocks(out, mesh, ("model",), dim=2)
    # the heads ``out`` holds: the rank's with ``p.tp``, else every one
    out = _out(out.reshape(B, 1, out.shape[2] * hd), p, sp, heads)
    return out, cache._replace(pos=abs_pos + 1)


def _combine_blocks(s, valid, vv, mesh):
    """Decode attention over slots split over ``model``: this rank's
    scores ``s`` (B, H, 1, block) of its slots, ``valid`` (block,), and
    values ``vv`` (B, block, H, hd) give a (max, sum of exponentials,
    weighted values) per head; every rank's are gathered over ``model``
    and combined in rank order: (B, 1, H, hd) float32.  A block with no
    valid slot (its max −inf) weighs 0."""
    s = torch.where(valid[None, None, None, :], s, -math.inf)
    mx = s.amax(dim=-1)                                  # (B, H, 1)
    e = torch.exp(s - torch.where(torch.isfinite(mx), mx, 0.0)[..., None])
    num = torch.einsum("bhqk,bkhd->bhqd", e.to(vv.dtype), vv).float()
    part = torch.cat([num, mx[..., None], e.sum(dim=-1)[..., None]], dim=-1)
    parts = gather_blocks(part[None], mesh, ("model",))  # (m, B, H, 1, hd+2)
    top = parts[..., -2].amax(dim=0)
    num, den = 0.0, 0.0
    for r in range(parts.shape[0]):
        w = torch.exp(parts[r, ..., -2] - top)[..., None]
        num = num + w * parts[r, ..., :-2]
        den = den + w * parts[r, ..., -1:]
    return (num / den).transpose(1, 2)                  # (B, 1, H, hd)
