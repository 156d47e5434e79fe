"""Mixture-of-Experts with sort-based token dispatch (counterpart of
``repro/models/moe.py``).

Token routing gives n keys drawn from E ≤ 64 distinct values, the paper's
DeterDupl instance.  The expert-parallel dispatch exchanges items by
expert ownership (exact splitters: expert e lives on PE e // e_per) with
the port's slotted all-to-all (``core.hypercube._alltoall_route``, its
feature vectors a (P, C, D) payload), groups them by local expert,
computes, and routes them back; items past a capacity are dropped, as in
the reference.  Layouts:

  * ``moe_local`` — the one-device layout: group per batch row, run every
    expert on its capacity buffer (what ``moe_apply`` runs without a mesh,
    and what serving runs on one card);
  * ``moe_dense`` — the one-hot baseline: every expert on every token;
  * ``moe_ep_sim`` — the expert-parallel body over an emulated (d, ep)
    mesh, d·ep PEs as rows under ``comm.batched(d)``;
  * ``moe_ep_shardmap`` / ``moe_tp_shardmap`` — the same on the ranks of
    a ``DeviceMesh`` with ``data`` and ``model`` dimensions
    (``comm.distributed``): every rank passes the whole x, takes its
    block, and gets y back whole, as the port's ``psort`` does.  Each
    cuts the rank's rows and runs its per-rank body, ``moe_ep_rows`` /
    ``moe_tp_rows``, which the model calls on a rank's rows
    (``moe_rows``): they return the rank's rows of y, and take the
    experts where the reference's ``shard_map`` holds them (``P(model,
    None, None)``; ``up``/``gate`` on f and ``down`` on its rows f) from
    where ``make_shardings`` puts them (``layers.Split.take``: one
    all-to-all re-cut);
  * ``moe_local`` on a mesh (decode, or ``model`` not dividing the
    experts or the sequence) runs on a rank's rows, its aux loss the
    whole batch's, and multiplies the rank's slices of the experts in
    place, as GSPMD does.

Gradients pass both distributed layouts as the reference's transposes
them: the feature payloads and combine weights go back along the
exchange's blocks (``comm.all_to_all`` is its own transpose), the slot
maps are integers and carry none, ``moe_tp_shardmap``'s ``psum``
transposes to a ``psum``, and the gathers of y to reduce-scatters.

Floats are computed PE by PE in both expert-parallel layouts (the
router, each PE's experts on its (e_per, cap, D) buffer, the route-back
sum), so the emulated and the distributed runs are equal bit for bit: a
matmul batched over the PEs may take another algorithm than one PE's.
The route-back adds each token's items in a fixed order, their arrival
order, never by atomics, so repeated runs are equal too.  Router ties go
to the lower expert, as ``jax.lax.top_k``'s do.  The grouping is the
reference's one-hot scan in plain torch; it reaches no kernel, as in the
reference.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import comm
from repro_torch.core.hypercube import _alltoall_route
from repro_torch.core.types import SortShard, along_rows
from repro_torch.dist.sharding import (gather_blocks, mesh_sizes, shard_act,
                                       sum_partials)

from .layers import normal

_FLIP = -(1 << 31)          # uint32 expert id ↔ the port's sign-flipped key


class MoE(nn.Module):
    """``router`` (d, E) float32, ``up``/``gate`` (E, d, f), ``down``
    (E, f, d)."""

    def __init__(self, d: int, f: int, n_experts: int, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        self.router = normal(gen, (d, n_experts), torch.float32, s_in,
                             device)
        self.up = normal(gen, (n_experts, d, f), dtype, s_in, device)
        self.gate = normal(gen, (n_experts, d, f), dtype, s_in, device)
        self.down = normal(gen, (n_experts, f, d), dtype, s_out, device)


def _router(x, w, top_k: int, mesh=None, rows=()):
    """x: (..., D) → (probs (..., k) f32, ids (..., k) int64, aux loss).
    A stable descending sort picks the top k: equal probabilities go to
    the lower expert, as ``jax.lax.top_k`` orders them.  ``x`` a rank's
    rows of a batch split over ``rows`` on ``mesh``: the aux loss is the
    whole batch's, its mean probabilities and routed fractions the
    rank's sums added up over ``rows`` in rank order (one float32
    all-reduce an axis; backward the same all-reduce) over the global
    counts of tokens and of routed items."""
    logits = x.float() @ w
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = srt[..., :top_k], idx[..., :top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # load-balancing aux loss (Switch): E · Σ_e f_e · p_e
    E = w.shape[1]
    hits = (top_i[..., None] == torch.arange(E, device=x.device)).reshape(
        -1, E).float()
    if not rows:
        me = probs.reshape(-1, E).mean(dim=0)
        fr = hits.mean(dim=0)
    else:
        sums = torch.cat([probs.reshape(-1, E).sum(dim=0), hits.sum(dim=0)])
        for a in rows:
            sums = sum_partials(sums, mesh, a)
        tokens = probs[..., 0].numel() * math.prod(
            mesh_sizes(mesh)[a] for a in rows)
        me, fr = sums.split(E)
        me, fr = me / tokens, fr / (tokens * top_k)
    aux = E * (me * fr).sum()
    return top_p, top_i, aux


def _expert_ffn(buf, up, gate, down):
    """buf: (E, C, D); weights (E, D, F)/(E, F, D)."""
    h = torch.bmm(buf, up)
    g = torch.bmm(buf, gate)
    h = F.silu(g) * h
    return torch.bmm(h, down)


def _group_by_expert(eids, n_experts: int, capacity: int):
    """One-hot scan grouping along the last dimension: eids (..., N) →
    (slot (..., N), kept (..., N) bool); slot is the item's position in
    its expert's capacity buffer (ids outside [0, n_experts) get 0)."""
    onehot = eids[..., None] == torch.arange(n_experts, device=eids.device)
    pos = torch.cumsum(onehot, dim=-2) - 1
    slot = torch.where(onehot, pos, 0).sum(dim=-1)
    return slot, slot < capacity


def _experts(p, want, m: int = 1, r: int = 0):
    """The experts ``up``/``gate``/``down`` that ``want`` names, each as
    this rank's slice split on the dimension it gives over ``m`` ranks
    (``r`` this rank's index), or whole (None): from ``p.tp.take`` where
    the part holds them where ``make_shardings`` puts them, else cut from
    the whole weights."""
    sp = getattr(p, "tp", None)
    if sp is not None and sp.take is not None:
        return sp.take(want)
    out = {}
    for n, dim in want.items():
        w = getattr(p, n)
        out[n] = w if dim is None else w.narrow(dim, r * (
            w.shape[dim] // m), w.shape[dim] // m)
    return out


def _expert_ffn_split(buf, sp, f: int):
    """:func:`_expert_ffn` of ``buf`` (E, C, D), the same on every rank
    along ``model``, on this rank's slices of the experts of hidden width
    ``f`` where ``make_shardings`` puts them (``sp``, the part's
    ``Split``), as ``layers.mlp`` multiplies a dense MLP's: a weight
    split on its input dimension multiplies the rank's slice of the
    buffer, and the partial products are summed over ``model`` (onto the
    hidden width's blocks where ``model`` divides it); one split on its
    output dimension gives its block of columns, gathered where the next
    product needs it whole.  Experts split on E, or whole, are re-cut to
    blocks of the hidden width (gathered whole where ``model`` does not
    divide it)."""
    from .layers import Split, tp_matmul, tp_project
    dims = {n: sp.dims.get(n) for n in ("up", "gate", "down")}
    if not all(d in (1, 2) for d in dims.values()):
        if f % sp.m:
            w = sp.take(dict.fromkeys(dims))
            return _expert_ffn(buf, w["up"], w["gate"], w["down"])
        dims = {"up": 2, "gate": 2, "down": 1}
    w = sp.take(dims)
    mat = Split(sp.mesh, sp.m, sp.r, {n: d - 1 for n, d in dims.items()})
    split = f % sp.m == 0
    h, g = tp_project(buf, mat, [(n, w[n], split) for n in ("up", "gate")])
    return tp_matmul(F.silu(g) * h, "down", w["down"], mat, split)


def moe_local(x, p, cfg, *, capacity_factor: float = 2.0, mesh=None,
              rows=()):
    """Group locally per batch row, run every expert on its buffer.  The
    grouping and the capacity are per batch row, so ``x`` may be a
    rank's rows of a batch split over the axes ``rows`` of ``mesh``: its
    rows of y are the whole batch's, and the aux loss is the whole
    batch's (:func:`_router`).  With ``p.tp`` the experts are this
    rank's slices and multiply in place (:func:`_expert_ffn_split`)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    w, ids, aux = _router(x, p.router, k, mesh, rows)  # (B, S, k)
    N = S * k
    cap = int(capacity_factor * N / E) + 1
    ids2 = ids.reshape(B, N)
    slot, kept = _group_by_expert(ids2, E, cap)
    xrep = x.repeat_interleave(k, dim=1)                # item i ← token i//k
    flat = torch.where(kept, ids2 * cap + slot, E * cap)
    # dropped items all land in one dump slot, sliced off
    buf = x.new_zeros((B, E * cap + 1, D)).scatter_(
        1, along_rows(flat, xrep), xrep)
    buf = buf[:, :-1].reshape(B, E, cap, D)
    buf = buf.transpose(0, 1).reshape(E, B * cap, D)
    sp = getattr(p, "tp", None)
    out = _expert_ffn(buf, p.up, p.gate, p.down) if sp is None else \
        _expert_ffn_split(buf, sp, cfg.d_ff)
    out = out.reshape(E, B, cap, D).transpose(0, 1).reshape(B, E * cap, D)
    gathered = torch.gather(out, 1, along_rows(flat.clamp(max=E * cap - 1),
                                               out))
    gathered = torch.where(kept[..., None], gathered, 0.0)
    y = (gathered.reshape(B, S, k, D) * w.to(x.dtype)[..., None]).sum(dim=2)
    return y, aux


def moe_dense(x, p, cfg, *, mesh=None, rows=()):
    """Dense one-hot dispatch baseline: every expert on every token, a
    masked combine — simple, robust, E× the FLOPs.  ``x`` may be a rank's
    rows, as :func:`moe_local`'s; the experts are taken whole."""
    E, k = cfg.n_experts, cfg.top_k
    w, ids, aux = _router(x, p.router, k, mesh, rows)
    onehot = F.one_hot(ids, E).float()                          # (B,S,k,E)
    cw = (onehot * w[..., None]).sum(dim=2)                     # (B,S,E)
    ex = _experts(p, dict.fromkeys(("up", "gate", "down")))
    h = torch.einsum("bsd,edf->bsef", x, ex["up"])
    g = torch.einsum("bsd,edf->bsef", x, ex["gate"])
    h = F.silu(g) * h
    y = torch.einsum("bsef,efd->bsed", h, ex["down"])
    y = (y * cw[..., None].to(x.dtype)).sum(dim=2)
    return y, aux


def _ep_dispatch(x_blk, router, experts, cfg, ep: int,
                 capacity_factor: float, slot_factor: float):
    """The expert-parallel dispatch of every PE held here (the reference's
    ``_ep_dispatch_body``): x_blk (P, B, S_loc, D), PE r's model-axis
    index from ``comm.axis_index``; PE r holds the experts ``[i·e_per,
    (i+1)·e_per)`` of its index i, ``experts(i)`` (up, gate, down).
    Every collective runs on the sort axis of the open scope: the ep PEs
    of one data row.  Returns (y (P, B, S_loc, D), aux (P,), drops
    (P,))."""
    E, k = cfg.n_experts, cfg.top_k
    e_per = E // ep
    P, B, S_loc, D = x_blk.shape
    dev = x_blk.device
    T = B * S_loc
    me_host = comm.axis_index(ep).tolist()              # no device read
    me = torch.as_tensor(me_host, device=dev)
    xt = x_blk.reshape(P, T, D)
    routed = [_router(xt[r], router, k) for r in range(P)]
    w = torch.stack([a[0] for a in routed])             # (P, T, k)
    ids = torch.stack([a[1] for a in routed])
    aux = torch.stack([a[2] for a in routed])
    N = T * k
    eids = ids.reshape(P, N)
    shard = SortShard(
        keys=(eids.to(torch.int32) ^ _FLIP),
        vals={"feat": xt.repeat_interleave(k, dim=1),
              "src": (torch.arange(N, device=dev) // k).expand(P, N),
              "w": w.reshape(P, N),
              "org": me[:, None].expand(P, N)},
        count=torch.full((P,), N, dtype=torch.int64, device=dev))
    dest = eids // e_per                                # exact splitters
    slot_cap = int(slot_factor * N / ep) + 8
    recv, drop1 = _alltoall_route(shard, dest, ep, slot_cap)
    del shard
    # group received items by local expert (the SSSS partition step)
    valid = recv.valid_mask()
    leid = (recv.keys ^ _FLIP).to(torch.int64) - me[:, None] * e_per
    leid = torch.where(valid, leid.clamp(0, e_per - 1), e_per)
    cap_e = int(capacity_factor * k * T / E) + 8
    slot, kept = _group_by_expert(leid, e_per, cap_e)
    kept &= valid
    flat = torch.where(kept, leid * cap_e + slot, e_per * cap_e)
    feat = recv.vals["feat"]
    # items not kept all land in one dump slot, sliced off
    buf = feat.new_zeros((P, e_per * cap_e + 1, D)).scatter_(
        1, along_rows(flat, feat), feat)
    buf = buf[:, :-1].reshape(P, e_per, cap_e, D)
    out = torch.stack([_expert_ffn(buf[r], *experts(i))
                       for r, i in enumerate(me_host)])
    del buf
    out = out.reshape(P, e_per * cap_e, D)
    yitem = torch.gather(out, 1, along_rows(
        flat.clamp(max=e_per * cap_e - 1), out))
    yitem.masked_fill_(~kept[..., None], 0)
    del out
    # route items back to their origin PE
    back = SortShard(keys=recv.keys,
                     vals={"feat": yitem, "src": recv.vals["src"],
                           "w": recv.vals["w"]},
                     count=recv.count)
    back_dest = torch.where(valid, recv.vals["org"], ep)
    del recv
    ret, drop2 = _alltoall_route(back, back_dest, ep, slot_cap)
    del back
    y = _combine(ret, T, k).to(x_blk.dtype).reshape(P, B, S_loc, D)
    return y, aux, drop1 + drop2


def _combine(ret, T: int, k: int) -> torch.Tensor:
    """``y[t] = Σ feat · w`` over token t's returned items, in float32, in
    the items' arrival order (the reference's ``y.at[src].add``): each
    token's at most k items are ranked by arrival and added rank by rank,
    starting from zero.  (P, T, D)."""
    P, D = ret.keys.shape[0], ret.vals["feat"].shape[-1]
    n = min(ret.capacity, T * k)            # the valid prefix is ≤ T·k long
    valid = ret.valid_mask()[:, :n]
    src = torch.where(valid, ret.vals["src"][:, :n], T)
    contrib = ret.vals["feat"][:, :n].float() * ret.vals["w"][:, :n, None]
    srt, order = torch.sort(src, dim=1, stable=True)
    first = torch.searchsorted(srt, srt)
    rank = torch.arange(n, device=src.device) - first
    at = torch.where(srt < T, srt * k + rank, T * k)
    items = contrib.new_zeros((P, T * k + 1, D)).scatter_(
        1, along_rows(at, contrib),
        torch.gather(contrib, 1, along_rows(order, contrib)))
    items = items[:, :-1].reshape(P, T, k, D)
    y = contrib.new_zeros((P, T, D))
    for j in range(k):
        y = y + items[:, :, j]
    return y


def _ep_layout(x, cfg, d: int, ep: int):
    B, S, D = x.shape
    E = cfg.n_experts
    if B % d or S % ep or E % ep:
        raise ValueError(f"B={B} S={S} E={E} not divisible by (d={d}, "
                         f"ep={ep})")
    return B, S, D


def _ep_sim(x, p, cfg, d: int, ep: int, capacity_factor: float,
            slot_factor: float):
    """:func:`moe_ep_sim` with its per-PE results: (y (B, S, D), aux
    (d·ep,), drops (d·ep,))."""
    B, S, D = _ep_layout(x, cfg, d, ep)
    # (B, S, D) → (d, ep, B/d, S/ep, D): batch over data rows, sequence
    # over expert-parallel blocks, PE i of data row r at row r·ep + i
    xb = x.reshape(d, B // d, ep, S // ep, D).movedim(2, 1)
    xb = xb.reshape(d * ep, B // d, S // ep, D)
    e_per = cfg.n_experts // ep
    ws = [w.reshape((ep, e_per) + tuple(w.shape[1:]))
          for w in (p.up, p.gate, p.down)]
    with comm.batched(d):
        y, aux, drops = _ep_dispatch(xb, p.router, lambda i: tuple(
            w[i] for w in ws), cfg, ep, capacity_factor, slot_factor)
    y = y.reshape(d, ep, B // d, S // ep, D).movedim(1, 2).reshape(B, S, D)
    return y, aux, drops


def moe_ep_sim(x, p, cfg, *, d: int = 1, ep: Optional[int] = None,
               capacity_factor: float = 2.0, slot_factor: float = 2.0):
    """EP dispatch over an emulated (d, ep) mesh: the batch splits into d
    data rows, the sequence into ep expert-parallel blocks, and each row's
    dispatch exchanges within its own ep PEs (``comm.batched(d)``).
    Returns (y, aux) like the distributed path."""
    ep = ep or cfg.n_experts
    y, aux, _ = _ep_sim(x, p, cfg, d, ep, capacity_factor, slot_factor)
    return y, aux.mean()


def _mesh_block(mesh, data_axes, model_axis: str):
    """(d, ep, this rank's data index, its model index) of a mesh whose
    batch splits over ``data_axes`` (the first major)."""
    sizes = mesh_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    di = 0
    for a in data_axes:
        di = di * sizes[a] + coord[names.index(a)]
    d = int(np.prod([sizes[a] for a in data_axes]))
    return d, sizes[model_axis], di, coord[names.index(model_axis)]


def _gather_whole(t, mesh, axes):
    """Every rank's block ``t`` over ``axes`` (the first varying fastest),
    concatenated: the whole result on every rank (its backward a
    reduce-scatter, ``dist.sharding.gather_blocks``)."""
    return gather_blocks(t.reshape(-1), mesh, tuple(axes)[::-1])


def _row0_mean(aux):
    """The mean of row 0 of aux (d, ep): the reference's ``out_specs
    P(model_axis)`` reads data row 0.  Its gradient is the mean's over
    every row, as the reference's ``shard_map`` transposes an output it
    does not map over the data axes: the cotangent divided by d on every
    data row."""
    spread = aux.mean()
    return aux[0].mean().detach() + (spread - spread.detach())


def _axes(axes) -> tuple:
    return tuple([axes] if isinstance(axes, str) else axes)


def moe_ep_rows(x, p, cfg, mesh, *, data_axes, model_axis="model",
                capacity_factor: float = 2.0, slot_factor: float = 2.0):
    """The EP dispatch of this rank's rows: ``x`` (B/d, S, D), the rank's
    block of the batch over ``data_axes`` (the first major), the same on
    the ranks of its ``model_axis`` slice.  The rank takes its block of
    the sequence and the experts of its model index (``p.tp.take`` where
    they lie where ``make_shardings`` puts them, else cut from the whole
    weights), exchanges items with the ranks of its model-axis slice, and
    gets its rows of y back, the sequence blocks gathered over
    ``model_axis``.  aux as :func:`moe_ep_shardmap`'s."""
    data_axes = _axes(data_axes)
    d, ep, di, mi = _mesh_block(mesh, data_axes, model_axis)
    b, S, D = x.shape
    if S % ep or cfg.n_experts % ep:
        raise ValueError(f"S={S} E={cfg.n_experts} not divisible by "
                         f"ep={ep}")
    mine = _experts(p, {"up": 0, "gate": 0, "down": 0}, ep, mi)
    mine = (mine["up"], mine["gate"], mine["down"])
    x_blk = x.reshape(b, ep, S // ep, D)[:, mi][None]
    with comm.distributed(mesh, axis=model_axis):
        y, aux, _ = _ep_dispatch(x_blk, p.router, lambda i: mine, cfg, ep,
                                 capacity_factor, slot_factor)
    y = gather_blocks(y[0], mesh, (model_axis,), dim=1)
    aux = _gather_whole(aux, mesh, (model_axis,) + data_axes[::-1])
    return y, _row0_mean(aux.reshape(d, ep))


def _rows_of(x, d: int, di: int):
    """Block ``di`` of the whole batch ``x`` cut into ``d``."""
    return x.reshape((d, x.shape[0] // d) + tuple(x.shape[1:]))[di]


def moe_ep_shardmap(x, p, cfg, mesh, *, data_axes, model_axis="model",
                    capacity_factor: float = 2.0, slot_factor: float = 2.0):
    """EP dispatch on the ranks of ``mesh`` (a ``DeviceMesh``), SPMD: every
    rank passes the whole x and gets the whole y.  Each takes its block
    of x (batch over ``data_axes``, sequence over ``model_axis``) and
    the experts of its model index, exchanges items with the ranks of
    its model-axis slice (:func:`moe_ep_rows`), and the rows are gathered
    over ``data_axes``.  Bit for bit :func:`moe_ep_sim` at the mesh's
    (d, ep).  aux is the mean over the model axis of data row 0 (the
    reference's ``out_specs P(model_axis)`` reads one data slice)."""
    data_axes = _axes(data_axes)
    d, ep, di, _ = _mesh_block(mesh, data_axes, model_axis)
    _ep_layout(x, cfg, d, ep)
    y, aux = moe_ep_rows(_rows_of(x, d, di), p, cfg, mesh,
                         data_axes=data_axes, model_axis=model_axis,
                         capacity_factor=capacity_factor,
                         slot_factor=slot_factor)
    return gather_blocks(y, mesh, data_axes), aux


def moe_tp_rows(x, p, cfg, mesh, *, data_axes,
                capacity_factor: float = 2.0):
    """The TP layout on this rank's rows ``x`` (B/d, S, D) over
    ``data_axes``: the experts replicated with the FFN hidden width split
    over ``model`` (``up``/``gate`` on their columns, ``down`` on its
    rows: ``p.tp.take`` where they lie where ``make_shardings`` puts
    them, else cut from the whole weights); the rank groups its rows
    locally, runs its slice of every expert, and the model axis sums the
    combined tokens (``comm.psum``, in rank order).  aux as
    :func:`moe_ep_shardmap`'s."""
    from types import SimpleNamespace
    data_axes = _axes(data_axes)
    d, m, _, mi = _mesh_block(mesh, data_axes, "model")
    if cfg.d_ff % m:
        raise ValueError(f"d_ff={cfg.d_ff} not divisible by model={m}")
    part = SimpleNamespace(router=p.router, **_experts(
        p, {"up": 2, "gate": 2, "down": 1}, m, mi))
    y, aux = moe_local(x, part, cfg, capacity_factor=capacity_factor)
    with comm.distributed(mesh, axis="model"):
        y = comm.psum(y[None])[0]
    aux = _gather_whole(aux.reshape(1), mesh, ("model",) + data_axes[::-1])
    return y, _row0_mean(aux.reshape(d, m))


def moe_tp_shardmap(x, p, cfg, mesh, *, data_axes,
                    capacity_factor: float = 2.0):
    """TP layout: experts replicated with the FFN hidden dim split over
    the ``model`` axis; every rank passes the whole x, runs its rows
    (:func:`moe_tp_rows`), and gets the whole y back, gathered over
    ``data_axes``; aux as :func:`moe_ep_shardmap` does."""
    data_axes = _axes(data_axes)
    d, m, di, _ = _mesh_block(mesh, data_axes, "model")
    if x.shape[0] % d or cfg.d_ff % m:
        raise ValueError(f"B={x.shape[0]} d_ff={cfg.d_ff} not divisible "
                         f"by (d={d}, model={m})")
    y, aux = moe_tp_rows(_rows_of(x, d, di), p, cfg, mesh,
                         data_axes=data_axes,
                         capacity_factor=capacity_factor)
    return gather_blocks(y, mesh, data_axes), aux


def _layout(impl: str, cfg, S: int, sizes) -> str:
    """The reference's choice of layout: ``"dense"``; ``"ep"`` where
    ``model`` divides the experts and the sequence (decode, S = 1, never);
    ``"tp"`` under ``cfg.moe_tp_fused`` on a mesh; else ``"local"``."""
    m = sizes.get("model")
    if impl == "dense":
        return "dense"
    if impl == "sort" and m is not None and cfg.n_experts % m == 0 \
            and S % m == 0:
        return "ep"
    if impl == "sort" and getattr(cfg, "moe_tp_fused", False) \
            and m is not None:
        return "tp"
    return "local"


def moe_apply(x, p, cfg, mesh=None, *, data_axes=("data",),
              impl: Optional[str] = None):
    """The MoE layer on the whole batch ``x`` (every rank passes it on a
    mesh, and gets the whole y)."""
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    layout = _layout(impl or cfg.moe_impl, cfg, x.shape[1], sizes)
    if layout == "ep":
        return moe_ep_shardmap(x, p, cfg, mesh, data_axes=data_axes)
    if layout == "tp":
        return moe_tp_shardmap(x, p, cfg, mesh, data_axes=data_axes)
    if layout == "dense":
        return moe_dense(x, p, cfg)
    return moe_local(x, p, cfg)                          # local grouping


def moe_rows(x, p, cfg, mesh, *, data_axes=("data",), rows=(),
             impl: Optional[str] = None):
    """:func:`moe_apply` on this rank's rows ``x`` of a batch split over
    the axes ``rows`` of ``mesh`` (``dist.sharding.shard_act``'s): this
    rank's rows of y, and aux.  The rows over ``data_axes`` go to the
    layout's body as they are (:func:`moe_ep_rows`, :func:`moe_tp_rows`,
    :func:`moe_local`); under ``ddp`` (rows over ``data_axes`` and
    ``model``) the ranks along ``model`` put their data block together
    for the EP and TP bodies, and keep their own rows of y; any other
    split of the rows goes whole through :func:`moe_apply`."""
    data_axes, rows = _axes(data_axes), tuple(rows)
    layout = _layout(impl or cfg.moe_impl, cfg, x.shape[1],
                     mesh_sizes(mesh))
    if layout == "dense":
        return moe_dense(x, p, cfg, mesh=mesh, rows=rows)
    if layout == "local":
        return moe_local(x, p, cfg, mesh=mesh, rows=rows)
    body = moe_ep_rows if layout == "ep" else moe_tp_rows
    if rows == data_axes:
        return body(x, p, cfg, mesh, data_axes=data_axes)
    if rows == data_axes + ("model",):
        y, aux = body(gather_blocks(x, mesh, ("model",)), p, cfg, mesh,
                      data_axes=data_axes)
        return shard_act(y, mesh, axes=("model",)), aux
    y, aux = moe_apply(gather_blocks(x, mesh, rows), p, cfg, mesh,
                       data_axes=data_axes, impl=impl)
    return shard_act(y, mesh, axes=rows), aux
