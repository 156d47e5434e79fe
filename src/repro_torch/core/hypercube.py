"""Hypercube patterns over the leading PE dimension (counterpart of
``repro/core/hypercube.py``): XOR exchange of tensors and shards, subcube
groups, the all-gather-merge, butterfly sums and prefix sums, the one-shot
and the hypercube random shuffles, the slotted all-to-all route (the
barrier path, and the streamed path that merges the source blocks as
they arrive) and the route by explicit target PE.

Each exchange records the reference's ``ppermute`` (``hc_exchange``) into
an open ``comm.counting`` scope, one event per tensor, at the reference's
bytes: a shard's count is the reference's int32 (4 bytes), and where the
port carries fewer payloads than the reference (``ref_vals``) the events
are those of the reference's payloads.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import comm, prng
from .types import (SortShard, compact, local_sort, merge_shards,
                    merge_sorted_shards, resize)


def subcube_groups(p: int, dims: int):
    """PE groups sharing bits ``dims..`` — the 2^dims-sized subcubes."""
    size = 1 << dims
    return [[h * size + l for l in range(size)] for h in range(p // size)]


_COUNT_BYTES = 4                   # the reference's int32 shard count


def _swap(x: torch.Tensor, p: int, j: int) -> torch.Tensor:
    rest = tuple(x.shape[1:])
    return x.reshape((p >> (j + 1), 2, 1 << j) + rest).flip(1).reshape(
        x.shape)


def hc_exchange(x: torch.Tensor, p: int, j: int,
                itemsize: Optional[int] = None) -> torch.Tensor:
    """Every PE receives its partner ``i ^ 2^j``'s value: a swap of the
    halves of every 2^(j+1) block of rows, with no index table.  Recorded
    as one ``ppermute`` (elements of ``itemsize`` bytes in the
    reference)."""
    comm.note("ppermute", x, itemsize)
    return _swap(x, p, j)


def exchange_shard(shard: SortShard, p: int, j: int,
                   ref_vals: Optional[Dict[str, int]] = None) -> SortShard:
    """The partner's shard; ``ref_vals`` (payload name → bytes an
    element, in order) are the reference's payloads where the port's shard
    carries fewer, recorded in place of the shard's own."""
    keys = hc_exchange(shard.keys, p, j)
    if ref_vals is None:
        vals = {k: hc_exchange(v, p, j) for k, v in shard.vals.items()}
    else:
        for itemsize in ref_vals.values():
            comm.record("ppermute", shard.capacity * itemsize)
        vals = {k: _swap(v, p, j) for k, v in shard.vals.items()}
    return SortShard(keys=keys, vals=vals,
                     count=hc_exchange(shard.count, p, j, _COUNT_BYTES))


def allgather_merge(shard: SortShard, p: int,
                    dims: Optional[Sequence[int]] = None,
                    ref_vals: Optional[Dict[str, int]] = None
                    ) -> SortShard:
    """Recursive-doubling all-gather-merge over the hypercube ``dims``
    (low to high): after step t every PE holds the merged elements of its
    2^(t+1)-subcube, its capacity doubled at each step.

    Equal keys keep the order of their origin PEs: the two blocks of a
    step cover disjoint, ordered ranges of origin PEs, so the block of the
    lower half goes first on ties (the upper PE's partner holds the lower
    block).  ``ref_vals``: see :func:`exchange_shard`."""
    dims = list(dims) if dims is not None else list(range(p.bit_length() - 1))
    me = comm.axis_index(p, shard.keys.device)
    for t in dims:
        partner = exchange_shard(shard, p, t, ref_vals)
        tie_a = ((me >> t) & 1) == 0
        shard, _ = merge_shards(shard, partner,
                                capacity=shard.capacity + partner.capacity,
                                tie_a_first=tie_a)
        del partner
    return shard


def butterfly_sum(x: torch.Tensor, p: int, dims: Sequence[int],
                  itemsize: Optional[int] = None):
    """All-reduce(+) over the subcube spanned by ``dims`` (elements of
    ``itemsize`` bytes in the reference)."""
    for t in dims:
        x = x + hc_exchange(x, p, t, itemsize)
    return x


def subcube_prefix_sum(x: torch.Tensor, p: int, dims: Sequence[int]):
    """Exclusive prefix sum over PE order within the subcube spanned by
    ``dims`` (hypercube scan); returns (prefix, total), each shaped like x."""
    me = comm.axis_index(p, x.device)
    prefix = torch.zeros_like(x)
    total = x
    for t in dims:
        other = hc_exchange(total, p, t)
        upper = ((me >> t) & 1).reshape((p,) + (1,) * (x.dim() - 1)) == 1
        prefix = prefix + torch.where(upper, other, torch.zeros_like(other))
        total = total + other
    return prefix, total


def hypercube_shuffle(shard: SortShard, p: int, seed: int,
                      dims: Optional[Sequence[int]] = None
                      ) -> Tuple[SortShard, torch.Tensor]:
    """Random redistribution, one dimension at a time: every PE sends
    exactly ⌊m/2⌋ of its m elements, chosen at random, to its partner along
    the dimension and merges what it keeps with what it receives.

    The choice is the reference's: float64 ``uniform`` scores drawn with
    key ``fold_in(fold_in(PRNGKey(seed), t), me)``, +inf for invalid
    elements, and the ⌊m/2⌋ smallest in a stable sort are sent.  Returns
    the shuffled shard (sorted, since the merge sorts) and the per-PE
    overflow."""
    dims = list(dims) if dims is not None else list(range(p.bit_length() - 1))
    dev = shard.keys.device
    me = comm.axis_index(p, dev)
    overflow = torch.zeros(p, dtype=torch.int64, device=dev)
    cap = shard.capacity
    rank = torch.arange(cap, device=dev)[None, :]
    # every step's fold_in(PRNGKey(seed), t), made on the host, one copy
    steps = prng.fold_in(prng.PRNGKey(seed),
                         torch.tensor(dims, dtype=torch.int64)).to(dev)
    for i, t in enumerate(dims):
        key = prng.fold_in(steps[i], me)
        scores = torch.where(shard.valid_mask(), prng.uniform(key, cap),
                             torch.inf)
        order = torch.sort(scores, dim=1, stable=True)[1]
        del scores
        send_sorted = rank < (shard.count // 2)[:, None]
        send = torch.empty_like(send_sorted).scatter_(1, order, send_sorted)
        del order, send_sorted
        sent, kept = compact(shard, send), compact(shard, ~send)
        del shard, send
        shard, ovf = merge_shards(kept, exchange_shard(sent, p, t),
                                  capacity=cap)
        del sent, kept
        overflow += ovf
    return shard, overflow


def alltoall_shuffle(shard: SortShard, p: int, seed: int, slot_cap: int,
                     stream: bool = False
                     ) -> Tuple[SortShard, torch.Tensor]:
    """Direct random shuffle via one all-to-all: every valid element goes
    to a uniformly random PE drawn with the reference's threefry stream
    (``fold_in(PRNGKey(seed), me)``).  Returns the shard, unsorted (sorted
    with ``stream``, see :func:`_alltoall_route`), and the per-PE
    overflow."""
    dev = shard.keys.device
    key = prng.fold_in(prng.PRNGKey(seed, dev), comm.axis_index(p, dev))
    dest = prng.randint(key, shard.capacity, 0, p)
    dest = torch.where(shard.valid_mask(), dest, p)      # pads → nowhere
    return _alltoall_route(shard, dest, p, slot_cap, stream=stream)


def _alltoall_route(shard: SortShard, dest: torch.Tensor, p: int,
                    slot_cap: int, groups=None, stream: bool = False
                    ) -> Tuple[SortShard, torch.Tensor]:
    """Scatter elements to ``dest`` PEs via slotted all-to-all buffers.

    ``dest`` (P, C) holds per-element targets in [0, p) within the
    element's group of p PEs, and p for invalid elements.  An element's
    slot is its rank among the elements of its row with the same target,
    in row order; elements with slot ≥ slot_cap overflow, counted on the
    sender's side on both paths.  Returns (shard of capacity p·slot_cap;
    overflow (P,)): on the barrier path unsorted and compacted; with
    ``stream`` sorted, equal bit for bit to the barrier path followed by
    ``local_sort`` (:func:`_stream_route_merge`), so callers skip their
    sort."""
    P, C = dest.shape
    dev = dest.device
    sorted_dest, order = torch.sort(dest, dim=1, stable=True)
    targets = torch.arange(p + 1, device=dev).expand(P, p + 1).contiguous()
    bounds = torch.searchsorted(sorted_dest, targets)        # (P, p+1)
    del targets
    rank_sorted = torch.arange(C, device=dev)[None, :] - torch.gather(
        bounds, 1, sorted_dest)
    del sorted_dest
    slot = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    del order, rank_sorted
    sent = bounds[:, 1:] - bounds[:, :-1]                     # (P, p)
    overflow = torch.clamp(sent - slot_cap, min=0).sum(dim=1)
    ok = (dest < p) & (slot < slot_cap)
    # dropped and invalid elements all land in one dump slot, sliced off
    # below, so the order of those colliding writes does not matter
    flat = torch.where(ok, dest * slot_cap + slot, p * slot_cap)
    del ok, slot

    def slots(v, fill):                     # the (P, p·slot_cap) send slots
        buf = v.new_full((P, p * slot_cap + 1), fill)
        return buf.scatter_(1, flat, v)[:, :-1]

    if stream:
        keys = slots(shard.keys, shard.pad)
        vals = {k: slots(v, 0) for k, v in shard.vals.items()}
        del flat
        counts = torch.clamp(sent, max=slot_cap).to(torch.int32)
        return _stream_route_merge(keys, vals, counts, shard.pad, p,
                                   slot_cap, groups), overflow

    def scatter(v, fill):
        return comm.all_to_all(slots(v, fill).reshape(P, p, slot_cap),
                               groups).reshape(P, p * slot_cap)

    keys = scatter(shard.keys, shard.pad)
    vals = {k: scatter(v, 0) for k, v in shard.vals.items()}
    del flat
    counts = comm.all_to_all(torch.clamp(sent, max=slot_cap).reshape(P, p, 1),
                             groups, itemsize=_COUNT_BYTES).reshape(P, p)
    slot_idx = torch.arange(slot_cap, device=dev)
    valid = (slot_idx[None, None, :] < counts[:, :, None]).reshape(P, -1)
    full = torch.full((P,), p * slot_cap, dtype=torch.int64, device=dev)
    out = compact(SortShard(keys, vals, full), valid)
    return out, overflow


def _stream_route_merge(keys, vals, counts, pad: int, p: int, slot_cap: int,
                        groups) -> SortShard:
    """The streamed consumer of a slotted exchange (the reference's
    ``_stream_route_merge``).

    ``keys``/``vals`` (P, p·slot_cap) are the send slots, ``counts`` (P, p)
    int32 the valid prefix of each slot.  Each block that arrives through
    :func:`comm.alltoall_stream` is sorted (``local_sort``: the tile sort
    on the card) and staged at row ``src`` of a per-source run table; then
    the log2 p levels of a merge tree each merge all PEs' pairs of runs in
    one batched :func:`merge_sorted_shards`, lower source on the left.
    Ties therefore resolve by (source, slot), the order the barrier path's
    compaction and stable ``local_sort`` give, and staging by source makes
    the result independent of the delivery order.  A valid key equal to
    the pad word stays before every pad at each level."""
    if p & (p - 1):
        raise ValueError(f"the merge tree needs a power-of-two group, "
                         f"not {p}")
    P, dev = keys.shape[0], keys.device
    names = list(vals)
    # every block's sort runs the merge passes the longest block needs:
    # one read back here instead of one per block
    cmax = int(counts.max()) if counts.numel() else 0
    table = [torch.full((P, p, slot_cap), pad, dtype=keys.dtype,
                        device=dev)]
    table += [torch.zeros((P, p, slot_cap), dtype=vals[k].dtype, device=dev)
              for k in names]
    run_counts = torch.zeros((P, p), dtype=torch.int64, device=dev)
    rows = torch.arange(P, device=dev)

    def fold(acc, chunks, src):
        chunk_keys, *chunk_vals, chunk_count = chunks
        count = chunk_count[:, 0].to(torch.int64)
        run = local_sort(SortShard(chunk_keys, dict(zip(names, chunk_vals)),
                                   count), max_count=cmax)
        for t, v in zip(acc, [run.keys] + [run.vals[k] for k in names]):
            t[rows, src] = v
        run_counts[rows, src] = count
        return acc

    table = comm.alltoall_stream(
        [keys] + [vals[k] for k in names] + [counts], fold, table, p, groups)
    runs = SortShard(table[0].reshape(P * p, slot_cap),
                     {k: t.reshape(P * p, slot_cap)
                      for k, t in zip(names, table[1:])},
                     run_counts.reshape(P * p))
    del table
    width = slot_cap
    while runs.keys.shape[0] > P:
        def half(t, i):
            return t.reshape(-1, 2, width)[:, i]
        a = SortShard(half(runs.keys, 0),
                      {k: half(v, 0) for k, v in runs.vals.items()},
                      runs.count[0::2])
        b = SortShard(half(runs.keys, 1),
                      {k: half(v, 1) for k, v in runs.vals.items()},
                      runs.count[1::2])
        runs, _ = merge_sorted_shards(a, b, capacity=2 * width)
        del a, b
        width *= 2
    return runs


def route_by_target(shard: SortShard, p: int, dims: Sequence[int],
                    capacity: Optional[int] = None,
                    ref_vals: Optional[Dict[str, int]] = None
                    ) -> Tuple[SortShard, torch.Tensor]:
    """Route each element to the PE in its ``_tgt`` payload by per-dim
    exchanges, high dim to low: in step j an element moves iff its target
    differs from the current PE in bit j; what stays and what arrives
    merge.  Returns the routed shard (sorted, capacity ``capacity``) and
    the per-PE overflow of the resize and every merge.  ``ref_vals``: see
    :func:`exchange_shard`."""
    me = comm.axis_index(p, shard.keys.device)[:, None]
    cap = capacity or shard.capacity
    shard, overflow = resize(shard, cap)
    for j in sorted(dims, reverse=True):
        move = ((shard.vals["_tgt"].to(torch.int64) ^ me) >> j) & 1 == 1
        sent, kept = compact(shard, move), compact(shard, ~move)
        del shard, move
        shard, ovf = merge_shards(kept, exchange_shard(sent, p, j, ref_vals),
                                  capacity=cap)
        del sent, kept
        overflow = overflow + ovf
    return shard, overflow
