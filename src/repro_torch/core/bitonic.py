"""Distributed bitonic sort over PE-batched shards (counterpart of
``repro/core/bitonic.py``; see there for the algorithm, paper §IV-D2).

log²p compare-split rounds on always-ascending local blocks: every PE
merges its block with its partner's and keeps the lower or the upper half,
as the stage's direction says.  Both partners build the same merged
sequence (the lower PE's elements first on ties), so their halves are
disjoint.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import comm
from .hypercube import exchange_shard
from .types import SortShard, local_sort, merge_shards


class BitonicResult(NamedTuple):
    shard: SortShard
    overflow: torch.Tensor         # (p,) int64


def _split_half(merged: SortShard, cap: int, keep_low: torch.Tensor
                ) -> SortShard:
    """Slots [0, cap) of a sorted padded 2·cap shard where ``keep_low``
    (one bool per PE), else slots [cap, 2·cap)."""
    low = keep_low[:, None]
    count = torch.where(keep_low, torch.clamp(merged.count, max=cap),
                        torch.clamp(merged.count - cap, min=0))

    def half(v):
        return torch.where(low, v[:, :cap], v[:, cap:])
    keys = half(merged.keys)
    idx = torch.arange(cap, device=keys.device)
    keys = torch.where(idx[None, :] < count[:, None], keys, merged.pad)
    return SortShard(keys, {k: half(v) for k, v in merged.vals.items()},
                     count)


def bitonic(shard: SortShard, p: int) -> BitonicResult:
    d = p.bit_length() - 1
    cap = shard.capacity
    me = comm.axis_index(p, shard.keys.device)
    shard = local_sort(shard)
    for k in range(d):                     # stage: sorted blocks of 2^(k+1)
        for j in range(k, -1, -1):         # substage distance 2^j
            lower = ((me >> j) & 1) == 0           # me < partner me ^ 2^j
            ascending = ((me >> (k + 1)) & 1) == 0
            merged, _ = merge_shards(shard, exchange_shard(shard, p, j),
                                     capacity=2 * cap, tie_a_first=lower)
            del shard
            shard = _split_half(merged, cap, lower == ascending)
            del merged
    return BitonicResult(shard, torch.zeros_like(shard.count))
