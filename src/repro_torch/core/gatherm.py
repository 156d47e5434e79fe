"""GatherM and AllGatherM over PE-batched shards (counterpart of
``repro/core/gatherm.py``): the very-sparse-input regime.

GatherM is a binomial-tree gather-merge: after step t the PEs whose t low
bits are zero hold the merged data of their 2^t-subcube, and PE 0 ends with
everything.  AllGatherM is the recursive-doubling all-gather-merge: every
PE ends with everything.  Neither balances its output; ``psort`` gives them
a concentrated output capacity of p·⌈n/p⌉.

In the sim layout every PE carries the capacity that doubles at each step,
so a run holds p · p · capacity slots per tensor at the end.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from . import comm
from .hypercube import allgather_merge, exchange_shard
from .types import SortShard, local_sort, merge_shards


class GatherResult(NamedTuple):
    shard: SortShard
    overflow: torch.Tensor         # (p,) int64


def gather_merge(shard: SortShard, p: int,
                 dims: Optional[Sequence[int]] = None) -> GatherResult:
    """Binomial-tree gather-merge to the lowest PE of each subcube."""
    dims = list(dims) if dims is not None else list(range(p.bit_length() - 1))
    shard = local_sort(shard)
    dev = shard.keys.device
    me = comm.axis_index(p, dev)
    overflow = torch.zeros_like(shard.count)
    for t in dims:
        # the senders: bits below t zero, bit t one
        sender = ((me & ((1 << t) - 1)) == 0) & (((me >> t) & 1) == 1)
        col = sender[:, None]
        send = SortShard(
            keys=torch.where(col, shard.keys, shard.pad),
            vals={k: torch.where(col, v, 0) for k, v in shard.vals.items()},
            count=torch.where(sender, shard.count, 0))
        keep = shard.replace(keys=torch.where(col, shard.pad, shard.keys),
                             count=torch.where(sender, 0, shard.count))
        recv = exchange_shard(send, p, t)
        del send, shard
        shard, ovf = merge_shards(keep, recv, capacity=2 * keep.capacity)
        del keep, recv
        overflow += ovf
    return GatherResult(shard, overflow)


def allgather_merge_sort(shard: SortShard, p: int,
                         dims: Optional[Sequence[int]] = None
                         ) -> GatherResult:
    """All-gather-merge: every PE ends with the full sorted input."""
    out = allgather_merge(local_sort(shard), p, dims=dims)
    return GatherResult(out, torch.zeros_like(out.count))
