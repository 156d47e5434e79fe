"""Hypercube patterns over the leading PE dimension (counterpart of the
RAMS- and RQuick-path functions of ``repro/core/hypercube.py``): XOR
exchange of tensors and shards, subcube groups, butterfly sums and prefix
sums, the one-shot and the hypercube random shuffles, and the barrier path
of the slotted all-to-all route.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import comm, prng
from .types import SortShard, compact, merge_shards


def subcube_groups(p: int, dims: int):
    """PE groups sharing bits ``dims..`` — the 2^dims-sized subcubes."""
    size = 1 << dims
    return [[h * size + l for l in range(size)] for h in range(p // size)]


def hc_exchange(x: torch.Tensor, p: int, j: int) -> torch.Tensor:
    """Every PE receives its partner ``i ^ 2^j``'s value: a swap of the
    halves of every 2^(j+1) block of rows, with no index table."""
    rest = tuple(x.shape[1:])
    return x.reshape((p >> (j + 1), 2, 1 << j) + rest).flip(1).reshape(
        x.shape)


def exchange_shard(shard: SortShard, p: int, j: int) -> SortShard:
    return SortShard(keys=hc_exchange(shard.keys, p, j),
                     vals={k: hc_exchange(v, p, j)
                           for k, v in shard.vals.items()},
                     count=hc_exchange(shard.count, p, j))


def butterfly_sum(x: torch.Tensor, p: int, dims: Sequence[int]):
    """All-reduce(+) over the subcube spanned by ``dims``."""
    for t in dims:
        x = x + hc_exchange(x, p, t)
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


def alltoall_shuffle(shard: SortShard, p: int, seed: int, slot_cap: int
                     ) -> Tuple[SortShard, torch.Tensor]:
    """Direct random shuffle via one all-to-all: every valid element goes
    to a uniformly random PE drawn with the reference's threefry stream
    (``fold_in(PRNGKey(seed), me)``).  Returns the unsorted shard and the
    per-PE overflow."""
    dev = shard.keys.device
    key = prng.fold_in(prng.PRNGKey(seed, dev), comm.axis_index(p, dev))
    dest = prng.randint(key, shard.capacity, 0, p)
    dest = torch.where(shard.valid_mask(), dest, p)      # pads → nowhere
    return _alltoall_route(shard, dest, p, slot_cap)


def _alltoall_route(shard: SortShard, dest: torch.Tensor, p: int,
                    slot_cap: int, groups=None
                    ) -> Tuple[SortShard, torch.Tensor]:
    """Scatter elements to ``dest`` PEs via slotted all-to-all buffers
    (the reference's barrier path).

    ``dest`` (P, C) holds per-element targets in [0, p) within the
    element's group of p PEs, and p for invalid elements.  An element's
    slot is its rank among the elements of its row with the same target,
    in row order; elements with slot ≥ slot_cap overflow.  Returns (shard
    of capacity p·slot_cap, unsorted and compacted; overflow (P,))."""
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

    def scatter(v, fill):
        buf = v.new_full((P, p * slot_cap + 1), fill)
        buf.scatter_(1, flat, v)
        return comm.all_to_all(buf[:, :-1].reshape(P, p, slot_cap),
                               groups).reshape(P, p * slot_cap)

    keys = scatter(shard.keys, shard.pad)
    vals = {k: scatter(v, 0) for k, v in shard.vals.items()}
    del flat
    counts = comm.all_to_all(torch.clamp(sent, max=slot_cap).reshape(P, p, 1),
                             groups).reshape(P, p)
    slot_idx = torch.arange(slot_cap, device=dev)
    valid = (slot_idx[None, None, :] < counts[:, :, None]).reshape(P, -1)
    full = torch.full((P,), p * slot_cap, dtype=torch.int64, device=dev)
    out = compact(SortShard(keys, vals, full), valid)
    return out, overflow
