"""Single-level p-way sample sort over PE-batched shards (counterpart of
``repro/core/samplesort.py``; see there for the algorithm, paper §VII).

``robust=True`` (SSort) first shuffles the elements through one random
all-to-all; ``robust=False`` (NS-SSort) does not, and skewed or
duplicate-heavy inputs overflow its slots, as in the reference.
``oracle_splitters`` skips the sampling.  ``overlap=True`` streams the
shuffle and the route and merges the source blocks as they arrive
(``hypercube._alltoall_route(stream=True)``), bit for bit the barrier
path's result, overflow included (it is counted on the sender's side).

Samples and splitters are the reference's u64 words (a zero-extended u32
key or an 8-byte key, all-ones for an invalid sample) held sign-flipped in
int64.  Every PE all-gathers the same samples, so the port sorts them once
for all rows, and records the reference's ``all_gather`` into an open
``comm.counting`` scope.  The classify is the partition kernel with nb = p and no
rank: 4-byte keys classify as (word, tie 0), 8-byte keys as the (hi, lo)
planes of their word, as the reference's (hi, lo) u32 planes.  The
shuffle, the splitter pick and classify, and the route run under
``torch.profiler`` scopes ``shuffle``, ``splitters`` and ``route``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from . import comm, prng
from .hypercube import _alltoall_route, alltoall_shuffle
from .median import LO, planes
from .rams import quantile_splitters
from .types import SortShard, local_sort, resize
from repro_torch.kernels.partition import partition_buckets

_INVALID = (1 << 63) - 1           # the flip of the all-ones u64 sample


class SSortResult(NamedTuple):
    shard: SortShard
    overflow: torch.Tensor         # (p,) int64


def _splitter_planes(splitters: torch.Tensor):
    """Flipped u64 splitters → the partition kernel's (key, tie) int32
    planes, against elements held as (port word, tie 0).  A zero-extended
    u32 element u is ≥ splitter w iff w < 2^32 and u ≥ w, so w < 2^32 maps
    to (its port word, 0) and every larger w to (INT32_MAX, 0xFFFFFFFF),
    above every element.  The map keeps the splitters' order."""
    w = splitters ^ LO                             # the u64, if below 2^63
    small = (w >= 0) & (w < (1 << 32))
    key = torch.where(small, w - (1 << 31), (1 << 31) - 1).to(torch.int32)
    tie = torch.where(small, 0, -1).to(torch.int32)
    return key.contiguous(), tie.contiguous()


def _destinations(shard: SortShard, splitters: torch.Tensor) -> torch.Tensor:
    """Every element's destination PE, #{splitters ≤ key}, and p for the
    slots past the count: the partition kernel's classify with nb = p
    (``splitters`` (p, p − 1), one row per PE) and no rank."""
    if shard.keys.dtype == torch.int64:
        e_key, e_tie = planes(shard.keys)
        s_key, s_tie = planes(splitters)
    else:
        e_key, e_tie = shard.keys, torch.zeros_like(shard.keys)
        s_key, s_tie = _splitter_planes(splitters)
    dest, _, _ = partition_buckets(
        e_key, e_tie, s_key, s_tie, n_buckets=splitters.shape[1] + 1,
        count=shard.count.contiguous(), want_pos=False, want_hist=False)
    return dest.to(torch.int64)


def samplesort(shard: SortShard, p: int, *, seed: int = 0x550,
               robust: bool = True, sample_factor: int = 16,
               slot_factor: float = 2.0,
               oracle_splitters: Optional[Sequence[int]] = None,
               overlap: bool = False) -> SSortResult:
    """Sort the p-PE shard; ``oracle_splitters`` are p − 1 nondecreasing
    u64 words (a zero-extended u32 key each, or an 8-byte key's word)."""
    cap = shard.capacity
    mean = max(1.0, cap / p)
    slot_cap = int(math.ceil(slot_factor * mean + 6 * math.sqrt(mean) + 6))
    overflow = torch.zeros_like(shard.count)

    with record_function("shuffle"):
        if robust:
            shard, ovf = alltoall_shuffle(shard, p, seed, slot_cap=slot_cap,
                                          stream=overlap)
            overflow = overflow + ovf
            if not overlap:                 # streamed arrives sorted
                shard = local_sort(shard)
            # the shuffle's p·slot_cap buffer shrinks to 2× the working
            # capacity
            shard, ovf = resize(shard, min(shard.capacity, 2 * cap))
            overflow = overflow + ovf
        else:
            shard = local_sort(shard)
    with record_function("splitters"):
        splitters = _splitters(shard, p, seed, sample_factor,
                               oracle_splitters)
        dest = _destinations(shard, splitters.expand(p, p - 1))
    with record_function("route"):
        out, ovf = _alltoall_route(shard, dest, p, slot_cap, stream=overlap)
        del dest, shard
        overflow = overflow + ovf
        if not overlap:                     # streamed arrives sorted
            out = local_sort(out)
        out, ovf = resize(out, cap)
    return SSortResult(out, overflow + ovf)


def _splitters(shard: SortShard, p: int, seed: int, sample_factor: int,
               oracle_splitters) -> torch.Tensor:
    """The p − 1 splitters, (1, p − 1) flipped u64 words: the oracle's, or
    the quantiles of every PE's ``sample_factor``·log p random samples."""
    dev = shard.keys.device
    if oracle_splitters is not None:
        w = np.asarray(oracle_splitters, dtype=np.uint64)
        if w.shape != (p - 1,):
            raise ValueError(f"oracle_splitters must hold p - 1 = {p - 1} "
                             f"words, got shape {w.shape}")
        return torch.from_numpy(
            (w ^ np.uint64(1 << 63)).view(np.int64)).to(dev)[None, :]
    s_per = max(1, sample_factor * max(1, int(math.log2(max(p, 2)))))
    key = prng.fold_in(prng.PRNGKey(seed, dev), comm.axis_index(p, dev))
    pos = prng.randint(key, s_per, 0, torch.clamp(shard.count, min=1))
    samp = torch.gather(shard.keys, 1, pos)
    if samp.dtype == torch.int32:                  # zero-extended to u64
        samp = samp.to(torch.int64) + ((1 << 31) + LO)
    samp = torch.where(pos < shard.count[:, None], samp, _INVALID)
    comm.note("all_gather", samp)
    return quantile_splitters(torch.sort(samp.reshape(1, -1))[0], p)
