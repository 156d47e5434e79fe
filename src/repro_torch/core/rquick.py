"""Robust Quicksort on hypercubes over PE-batched shards (counterpart of
``repro/core/rquick.py``; see there for the algorithm, paper §VI).

Per iteration, dimensions d−1 … 0: the approximate median of the
(j+1)-dimensional subcube from the butterfly windows (``median.py``), the
local tie-break split, the exchange along dimension j (the 0-bit PE keeps
both lower parts, the 1-bit PE both upper parts) and the merge with what
arrives.  An initial hypercube shuffle makes a fixed capacity sound.
``robust=False`` is NTB-Quick: no shuffle, no tie-breaking.

The shuffle and each iteration run under a ``torch.profiler``
``record_function`` scope (``shuffle``, ``iter0``, ``iter1``, …).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch.profiler import record_function

from . import comm
from .hypercube import butterfly_sum, exchange_shard, hypercube_shuffle
from .median import (butterfly_median_window, lift, planes,
                     splitter_from_window)
from .types import SortShard, compact, local_sort, merge_shards, resize
from repro_torch.kernels.partition import partition_buckets


class RQuickResult(NamedTuple):
    shard: SortShard
    overflow: torch.Tensor         # (p,) int64, elements dropped


def _split_point(shard: SortShard, splitter_lifted: torch.Tensor,
                 tie_break: bool) -> torch.Tensor:
    """Per PE, the index splitting its sorted data into L = [0, idx) and
    R = [idx, C).

    With tie-breaking, x ∈ [0, m_eq] is chosen so |L| is closest to m/2;
    without, every duplicate of the splitter goes right (x = 0).  Bucket 0
    of the partition kernel's inclusive pass (nb = 2, one splitter per PE)
    holds the elements < s, of its strict pass those ≤ s; the histogram
    counts valid elements only."""
    e_key, e_tie = planes(lift(shard.keys))
    s_key, s_tie = planes(splitter_lifted[:, None])
    count = shard.count.contiguous()

    def n_below(inclusive):
        _, _, h = partition_buckets(e_key, e_tie, s_key, s_tie, n_buckets=2,
                                    count=count, inclusive=inclusive,
                                    want_pos=False, want_bucket=False)
        return h[:, 0].to(torch.int64)

    n_less = n_below(True)
    if not tie_break:
        return n_less
    n_leq = n_below(False)
    x = torch.minimum(torch.clamp(count // 2 - n_less, min=0),
                      n_leq - n_less)
    return n_less + x


def rquick(shard: SortShard, p: int, *, seed: int = 0x5EED,
           window_k: int = 16, robust: bool = True,
           shuffle: Optional[bool] = None, tie_break: Optional[bool] = None,
           capacity: Optional[int] = None,
           dims: Optional[Sequence[int]] = None) -> RQuickResult:
    """Sort over the (sub)cube spanned by ``dims`` (default: all of the p
    PEs).  Output: ascending over PE order, each shard locally sorted;
    elements never cross the subcube boundary.  The shards grow to
    ``capacity`` (default twice the input's); overflow counts what they
    drop."""
    dims = list(dims) if dims is not None else list(range(p.bit_length() - 1))
    shuffle = robust if shuffle is None else shuffle
    tie_break = robust if tie_break is None else tie_break
    cap = capacity or 2 * shard.capacity
    dev = shard.keys.device

    shard, _ = resize(shard, cap)            # the reference drops silently
    overflow = torch.zeros(shard.keys.shape[0], dtype=torch.int64,
                           device=dev)
    if shuffle:
        with record_function("shuffle"):
            shard, ovf = hypercube_shuffle(shard, p, seed, dims=dims)
            overflow += ovf
    shard = local_sort(shard)

    me = comm.axis_index(p, dev)
    pos = torch.arange(cap, device=dev)[None, :]
    for it, j in enumerate(sorted(dims, reverse=True)):
        with record_function(f"iter{it}"):
            sub_dims = [t for t in dims if t <= j]
            w = butterfly_median_window(shard, p, sub_dims, window_k,
                                        seed=seed * 1000003 + it)
            s, w_empty = splitter_from_window(w, seed=seed * 1000003 + it)
            del w
            sub_count = butterfly_sum(shard.count, p, sub_dims,
                                      itemsize=4)   # the reference's int32
            is_empty = (sub_count == 0) | w_empty
            idx = _split_point(shard, s, tie_break)[:, None]
            # the lower PE sends R (its suffix), the upper PE L (its prefix)
            upper = (((me >> j) & 1) == 1)[:, None]
            send = torch.where(upper, pos < idx, pos >= idx)
            send &= ~is_empty[:, None]
            sent, kept = compact(shard, send), compact(shard, ~send)
            del shard, send
            shard, ovf = merge_shards(kept, exchange_shard(sent, p, j),
                                      capacity=cap)
            del sent, kept
            overflow += ovf
    return RQuickResult(shard, overflow)
