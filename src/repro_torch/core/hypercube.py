"""Hypercube patterns over the leading PE dimension (counterpart of the
RAMS-path functions of ``repro/core/hypercube.py``): XOR exchange,
subcube groups and prefix sums, the one-shot random shuffle and the
barrier path of the slotted all-to-all route.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import comm, prng
from .types import SortShard, compact


def xor_perm(p: int, j: int):
    return [(i, i ^ (1 << j)) for i in range(p)]


def subcube_groups(p: int, dims: int):
    """PE groups sharing bits ``dims..`` — the 2^dims-sized subcubes."""
    size = 1 << dims
    return [[h * size + l for l in range(size)] for h in range(p // size)]


def hc_exchange(x: torch.Tensor, p: int, j: int) -> torch.Tensor:
    """Every PE receives its partner ``i ^ 2^j``'s value."""
    return comm.ppermute(x, xor_perm(p, j))


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
