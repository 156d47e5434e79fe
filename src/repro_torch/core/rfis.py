"""Robust Fast Work-Inefficient Sorting over PE-batched shards
(counterpart of ``repro/core/rfis.py``; see there for the algorithm, paper
§V).

The PEs form a 2^rb × 2^cb grid: the column index is the low ``cb`` bits
of the PE index, the row index the high ``rb`` bits.  Local sort,
all-gather-merge within rows and within columns, rank every element of my
row among my column's elements under the order (key, origin row, origin
column, local index), sum the partial ranks over the row, and deliver each
element to PE rank·p/n through a route within its column.

The reference counts the ties of the rank with an (Nr, Nc) compare matrix
per PE.  Here the column's gathered data is already ordered by (key,
origin row R, local index j): the local sort is stable, the local index is
the position after it, and every gather step puts the lower origin block
first on ties.  So the rank is one ``searchsorted`` per PE on the int64
composite ``key << (rb + L) | R << L | j`` (L bits hold a local index),
with each row element's threshold mapped to the same composite.  An 8-byte
key leaves no room beside it, so it enters the composite as its dense rank
among the column's distinct keys (``_dense_keys``), which keeps the order
and the ties of the keys.

The gathers, the rank and the delivery run under ``torch.profiler``
scopes ``gather``, ``rank`` and ``route``.  The column's gather and the
route carry fewer payloads than the reference's; they record the
reference's exchanges into an open ``comm.counting`` scope
(``ref_vals``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from . import comm
from .hypercube import allgather_merge, butterfly_sum, route_by_target
from .types import SortShard, compact, local_sort, resize

_MAX = (1 << 63) - 1               # above every valid column composite


class RFISResult(NamedTuple):
    shard: SortShard
    overflow: torch.Tensor         # (p,) int64


class RFISRanks(NamedTuple):
    """My row's gathered elements and their global ranks."""
    row_data: SortShard
    ranks: torch.Tensor            # (p, |row_data|) int64, valid in the row
    total: torch.Tensor            # (p,) global element count


def grid_shape(p: int):
    d = p.bit_length() - 1
    cb = d // 2               # column bits (low): row size 2^cb
    return d - cb, cb         # (rb, cb): column size 2^rb


def _itemsizes(vals) -> dict:
    """Payload name → bytes an element, in order (the reference's
    payloads are uint32, the port's int32)."""
    return {k: v.element_size() for k, v in vals.items()}


def _with_origin(shard: SortShard, p: int) -> SortShard:
    """Add the payloads ``_orig`` (the PE index) and ``_lidx`` (the slot
    index), both uint32 words in int32."""
    rows, cap = shard.keys.shape
    dev = shard.keys.device
    vals = dict(shard.vals)
    vals["_orig"] = comm.axis_index(p, dev).to(torch.int32)[:, None].expand(
        rows, cap).contiguous()
    vals["_lidx"] = torch.arange(cap, dtype=torch.int32, device=dev).expand(
        rows, cap).contiguous()
    return shard.replace(vals=vals)


def _dense_keys(col: SortShard, query: torch.Tensor):
    """8-byte keys → dense ranks that order and tie as the keys do, for
    the column's valid keys and for the ``query`` keys of the row: each
    column key takes the count of distinct column keys below it (a cumsum
    of key changes along the sorted column), and a query key the same count
    among the keys below it — the dense rank of its first column key ≥ it
    (one ``searchsorted``, clamped to the count, so a valid key equal to
    the pad word is found by the count).  Returns (column ranks, query
    ranks, whether each query key occurs in the column)."""
    keys = torch.where(col.valid_mask(), col.keys, col.pad)
    count = col.count[:, None]
    at = torch.minimum(torch.searchsorted(keys, query), count)
    width = keys.shape[1]
    found = (at < count) & (torch.gather(keys, 1, at.clamp(max=width - 1))
                            == query)
    step = torch.zeros_like(keys, dtype=torch.bool)
    torch.ne(keys[:, 1:], keys[:, :-1], out=step[:, 1:])
    del keys
    dense = torch.cumsum(step, dim=1)
    del step
    # past the count: the number of distinct valid keys
    last = torch.gather(dense, 1, (count - 1).clamp(min=0))
    distinct = torch.where(count > 0, last + 1, 0)
    dense = torch.where(col.valid_mask(), dense, distinct)
    q_dense = torch.where(at < width, torch.gather(
        dense, 1, at.clamp(max=width - 1)), distinct)
    return dense, q_dense, found


def rfis_rank(shard: SortShard, p: int) -> RFISRanks:
    """Global ranks of all elements of my row (steps 1–4).  The returned
    row data keeps ``_orig`` and ``_lidx``, as the reference's does."""
    rb, cb = grid_shape(p)
    cap = shard.capacity
    lbits = max(1, (cap - 1).bit_length())          # j < 2^lbits
    me = comm.axis_index(p, shard.keys.device)
    my_row, my_col = (me >> cb)[:, None], (me & ((1 << cb) - 1))[:, None]
    shift = rb + lbits
    # a 4-byte key takes 32 bits; a dense rank is at most the column's
    # 2^rb · capacity ≤ 2^shift slots, and a query may carry one more
    key_bits = 32 if shard.keys.dtype == torch.int32 else shift + 1
    if key_bits + shift > 63:
        raise ValueError(f"rfis ranks on int64 composites: capacity {cap} "
                         f"at p = {p} needs {key_bits} + {rb} + {lbits} > "
                         f"63 bits")
    with record_function("gather"):
        shard = _with_origin(local_sort(shard), p)
        row = allgather_merge(shard, p, dims=range(cb))
        # the column's payloads other than the origin are never read
        col = allgather_merge(shard.replace(vals={
            k: shard.vals[k] for k in ("_orig", "_lidx")}), p,
            dims=range(cb, cb + rb), ref_vals=_itemsizes(shard.vals))
        del shard
    with record_function("rank"):
        col_key, row_key, found = col.keys, row.keys, None
        if row.keys.dtype == torch.int64:
            col_key, row_key, found = _dense_keys(col, row.keys)

        def composite(key, r, j):
            return (key.to(torch.int64) << shift) | (r << lbits) | j

        # column element b = (x, R_b, j); invalid slots above every query
        col_comp = torch.where(
            col.valid_mask(),
            composite(col_key, col.vals["_orig"].to(torch.int64) >> cb,
                      col.vals["_lidx"].to(torch.int64)), _MAX)
        col_count = col.count
        del col, col_key
        # row element a = (y, my_row, C_a, i) counts the b below (y, thr):
        # C_a > my_col: R_b ≤ my_row; C_a < my_col: R_b < my_row;
        # C_a == my_col: R_b < my_row, or R_b == my_row and j < i.  In
        # the last row (my_row + 1) << lbits carries into the key: every b
        # with x ≤ y.  A dense rank of a key that is not in the column
        # counts the keys below it only (threshold 0).
        ca = row.vals["_orig"].to(torch.int64) & ((1 << cb) - 1)
        i_idx = row.vals["_lidx"].to(torch.int64)
        thr = torch.where(ca > my_col, (my_row + 1) << lbits,
                          torch.where(ca < my_col, my_row << lbits,
                                      (my_row << lbits) | i_idx))
        del ca, i_idx
        if found is not None:
            thr = torch.where(found, thr, 0)
        query = (row_key.to(torch.int64) << shift) + thr
        del thr, row_key, found
        partial = torch.searchsorted(col_comp, query)
        del col_comp, query
        partial = torch.where(row.valid_mask(), partial, 0)
        ranks = butterfly_sum(partial, p, dims=range(cb))
        total = butterfly_sum(col_count, p, dims=range(cb))
    return RFISRanks(row_data=row, ranks=ranks, total=total)


def rfis(shard: SortShard, p: int, *,
         capacity: Optional[int] = None) -> RFISResult:
    """Full RFIS: rank, then balanced delivery (step 5).

    The ``_orig`` and ``_lidx`` payloads go before the route and ``_tgt``
    after it: a payload never changes where an element goes, so the output
    equals the reference's, which drops them at the end; the final local
    sort then carries one payload and runs through the sort kernels."""
    rb, cb = grid_shape(p)
    dev = shard.keys.device
    my_col = (comm.axis_index(p, dev) & ((1 << cb) - 1))[:, None]
    out_cap = capacity or shard.capacity

    row, ranks, total = rfis_rank(shard, p)
    out_per = torch.clamp((total + p - 1) // p, min=1)[:, None]
    target = ranks // out_per
    del ranks
    keep = row.valid_mask() & ((target & ((1 << cb) - 1)) == my_col)
    ref_vals = {**_itemsizes(row.vals), "_tgt": 4}
    vals = {k: v for k, v in row.vals.items() if not k.startswith("_")}
    vals["_tgt"] = target.to(torch.int32)          # < p
    del target
    with record_function("route"):
        kept = compact(row.replace(vals=vals), keep)
        del row, vals, keep
        # the whole column's volume bounds any intermediate load
        routed, overflow = route_by_target(
            kept, p, dims=range(cb, cb + rb),
            capacity=max(out_cap, kept.capacity), ref_vals=ref_vals)
        del kept
        routed = local_sort(routed.replace(vals={
            k: v for k, v in routed.vals.items() if not k.startswith("_")}))
        out, ovf = resize(routed, out_cap)
    return RFISResult(out, overflow + ovf)
