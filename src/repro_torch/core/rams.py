"""RAMS — robust multi-level sample sort over PE-batched shards
(counterpart of ``repro/core/rams.py``; see there for the algorithm).

Per level, within subcubes of 2^h PEs split into k = 2^b groups: sample
with tie-break composites, all-gather and sort the samples in the subcube,
pick nb − 1 splitters, classify + rank every element (the partition
kernel), prefix-sum the bucket histograms over the subcube, map each
element to a target PE inside its group, and exchange through one slotted
all-to-all.  ``overlap=True`` streams every slotted exchange (the
shuffle and each level) and merges the source blocks as they arrive
(``hypercube._alltoall_route(stream=True)``), bit for bit the barrier
path's result; the sort after each exchange is then already done.

Each phase runs under a ``torch.profiler.record_function`` scope and the
reference's ``comm.tagged`` scope of the same name (``shuffle``,
``level0``, ``level1``, …), so a profiler trace attributes time and a
collective trace launches and bytes per phase; outside a profiler and a
``comm.counting`` scope they cost microseconds.

Composites are the sign-flipped int64 form of the reference's u64
``key << 32 | tag``: ``int64(key_int32) << 32 | tag``, with the invalid
composite 0x7FFF…F (the flip of all-ones).  Accumulators are int64, as in
the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
from torch.profiler import record_function

from . import comm
from .hypercube import (_alltoall_route, alltoall_shuffle, subcube_groups,
                        subcube_prefix_sum)
from .types import SortShard, local_sort, resize
from . import prng
from repro_torch.kernels.partition import partition_buckets

_PE_BITS = 12
_POS_BITS = 20
_M32 = 0xFFFFFFFF
_INVALID = (1 << 63) - 1           # flip of the reference's all-ones word


class RAMSResult(NamedTuple):
    shard: SortShard
    overflow: torch.Tensor         # (p,) int64


def default_levels(p: int, levels: Optional[int] = None) -> Sequence[int]:
    """Split log2(p) into ``levels`` groups of bits, high bits first."""
    d = p.bit_length() - 1
    if levels is None:
        levels = 1 if d <= 4 else (2 if d <= 10 else 3)
    levels = max(1, min(levels, d)) if d else 1
    base, rem = divmod(d, levels)
    return [base + (1 if i < rem else 0) for i in range(levels)]


def nested_level_bits(p_outer: int, p_inner: int,
                      levels: Optional[int] = None) -> Sequence[int]:
    """The level schedule of a nested (outer × inner) mesh: the first
    level splits across the p_outer outer slices (its all_to_all is the
    only level exchange on the outer axis), every later one recurses inside
    an inner subcube; ``levels=1`` spans both axes with one level.

    >>> nested_level_bits(16, 64), nested_level_bits(4, 16, levels=1)
    ([4, 3, 3], [6])
    """
    d_o = p_outer.bit_length() - 1
    d_i = p_inner.bit_length() - 1
    if p_outer.bit_count() != 1 or p_inner.bit_count() != 1:
        raise ValueError(f"mesh ({p_outer}, {p_inner}) entries must be "
                         f"powers of two")
    if d_o == 0:
        return list(default_levels(p_inner, levels))
    if d_i == 0:
        return [d_o]
    if levels == 1:
        return [d_o + d_i]
    inner_levels = None if levels is None else max(1, levels - 1)
    return [d_o] + list(default_levels(p_inner, inner_levels))


def _mul32(x, c: int):
    """``x * c mod 2^32`` for uint32 words held in int64, exact: the
    constant is split into 16-bit halves so no product reaches 2^63."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((x * hi) & 0xFFFF) << 16) + x * lo) & _M32


def _mix32(x):
    """Bijective 32-bit mix (murmur3 finalizer) of uint32 words in int64."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def as_int32_bits(x):
    """int64 tensor of uint32 words -> int32 tensor with the same bits."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def _tag(pe, pos):
    """The 32-bit tie-break tag of (pe, pos) as int64."""
    return _mix32(((pe << _POS_BITS) | pos) & _M32)


def _composite(keys, pe, pos, valid):
    c = (keys.to(torch.int64) << (_PE_BITS + _POS_BITS)) | _tag(pe, pos)
    return torch.where(valid, c, _INVALID)


def quantile_splitters(sorted_samples, nb: int, invalid=_INVALID):
    """Per row, ``nb - 1`` evenly spaced order statistics of the valid
    prefix of ascending (rows, S) composites: rank ``i * n_valid // nb``."""
    n_valid = (sorted_samples != invalid).sum(dim=1, keepdim=True)
    q = torch.arange(1, nb, device=sorted_samples.device)[None, :] * n_valid
    q = torch.clamp(q // nb, 0, sorted_samples.shape[1] - 1)
    return torch.gather(sorted_samples, 1, q)


def _slot_cap(cap: int, p_sub: int, slot_factor: float) -> int:
    mean = max(1.0, cap / p_sub)
    return int(math.ceil(slot_factor * mean + 6 * math.sqrt(mean) + 6))


def rams(shard: SortShard, p: int, *, seed: int = 0xA35,
         levels: Optional[int] = None,
         level_bits: Optional[Sequence[int]] = None, oversample: int = 4,
         tie_break: bool = True, shuffle: bool = True,
         slot_factor: float = 2.0, overlap: bool = False) -> RAMSResult:
    """Sort the p-PE shard.  Requires int32 internal words (4-byte keys):
    8-byte keys raise the reference's error."""
    if shard.keys.dtype != torch.int32:
        raise ValueError("rams requires uint32 keys (use psort's transform)")
    d = p.bit_length() - 1
    if p.bit_count() != 1 or shard.capacity >= (1 << _POS_BITS):
        raise ValueError(f"rams needs a power-of-two p and capacity < "
                         f"2^{_POS_BITS}; got p={p}, C={shard.capacity}")
    if level_bits is not None:
        bits = [int(b) for b in level_bits]
        if sum(bits) != d or any(b < 1 for b in bits):
            raise ValueError(f"level_bits {bits} must be >=1 each and sum "
                             f"to log2(p)={d}")
    else:
        bits = default_levels(p, levels)
    cap = shard.capacity
    overflow = torch.zeros_like(shard.count)

    with record_function("shuffle"), comm.tagged("shuffle"):
        if shuffle:
            shard, ovf = alltoall_shuffle(
                shard, p, seed, slot_cap=_slot_cap(cap, p, slot_factor),
                stream=overlap)
            overflow = overflow + ovf
        if not (shuffle and overlap):           # streamed arrives sorted
            shard = local_sort(shard)
        # the shuffle's p·slot_cap buffer shrinks to 2× the working
        # capacity, the slack the levels' slot caps are scaled from
        shard, ovf = resize(shard, min(shard.capacity, 2 * cap))
        overflow = overflow + ovf

    h = d
    for lvl, b in enumerate(bits):
        with record_function(f"level{lvl}"), comm.tagged(f"level{lvl}"):
            shard, ovf = _rams_level(shard, p, h, b,
                                     seed=seed + 7919 * (lvl + 1),
                                     oversample=oversample,
                                     tie_break=tie_break,
                                     slot_factor=slot_factor,
                                     overlap=overlap)
        overflow = overflow + ovf
        h -= b
    return RAMSResult(shard, overflow)


def _rams_level(shard: SortShard, p: int, h: int, b: int, *, seed: int,
                oversample: int, tie_break: bool, slot_factor: float,
                overlap: bool = False):
    """One k-way splitting level within the 2^h-subcubes."""
    k = 1 << b
    p_sub = 1 << h
    p_g = p_sub >> b                       # PEs per target group
    nb = max(k, oversample * k)
    cap = shard.capacity
    dev = shard.keys.device
    me = comm.axis_index(p, dev)
    sub_rel = me & (p_sub - 1)             # my index within the subcube
    groups = subcube_groups(p, h)

    # --- 1. local samples with tie-break composites ------------------------
    s_per = max(1, -(-(2 * nb * max(2, int(math.log2(p_sub + 1)))) // p_sub))
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(seed, dev), me), 1)
    pos = prng.randint(key, s_per, 0, torch.clamp(shard.count, min=1))
    sample_keys = torch.gather(shard.keys, 1, pos)
    valid = (shard.count > 0)[:, None] & (pos < shard.count[:, None])
    samp = _composite(sample_keys, sub_rel[:, None], pos, valid)
    if not tie_break:
        low = (1 << (_PE_BITS + _POS_BITS)) - 1
        samp = torch.where(samp == _INVALID, samp, samp & ~low)

    # --- 2. gather + sort samples within subcube ---------------------------
    all_samp = comm.all_gather(samp, groups, tiled=True)
    all_samp, _ = torch.sort(all_samp, dim=1)

    # --- 3. select splitters, classify -------------------------------------
    splitters = quantile_splitters(all_samp, nb)                # (p, nb-1)
    if tie_break:
        elem_pos = torch.arange(cap, device=dev)[None, :]
        e_ties = as_int32_bits(_tag(sub_rel[:, None], elem_pos))
    else:
        e_ties = torch.zeros_like(shard.keys)
    s_keys = (splitters >> 32).to(torch.int32)
    s_ties = as_int32_bits(splitters & _M32)
    bucket, q_in_bucket, hist = partition_buckets(
        shard.keys, e_ties, s_keys.contiguous(), s_ties.contiguous(),
        n_buckets=nb, count=shard.count)
    del e_ties

    # --- 4. histogram prefix over the subcube, greedy group assignment -----
    hist = hist.to(torch.int64)                                 # (p, nb)
    my_prefix, totals = subcube_prefix_sum(hist, p, list(range(h)))
    total = totals.sum(dim=1, keepdim=True)
    cum = torch.cumsum(totals, dim=1)
    cum_before = cum - totals
    mid = cum_before + totals // 2
    g_of_bucket = torch.clamp((mid * k) // torch.clamp(total, min=1), 0, k - 1)
    group_total = torch.zeros((totals.shape[0], k), dtype=torch.int64,
                              device=dev)
    group_total.scatter_add_(1, g_of_bucket, totals)
    cum_grp = torch.cumsum(group_total, dim=1) - group_total

    # --- 5. per-element target PE (perfect balance within groups) ----------
    bsafe = torch.clamp(bucket, 0, nb - 1).to(torch.int64)
    del bucket
    g_e = torch.gather(g_of_bucket, 1, bsafe)
    pos_in_group = (torch.gather(cum_before, 1, bsafe)
                    - torch.gather(cum_grp, 1, g_e)
                    + torch.gather(my_prefix, 1, bsafe)
                    + q_in_bucket.to(torch.int64))
    del bsafe, q_in_bucket
    gt = torch.clamp(torch.gather(group_total, 1, g_e), min=1)
    dest = g_e * p_g + (pos_in_group * p_g) // gt
    del g_e, pos_in_group, gt
    dest = torch.where(shard.valid_mask(), dest, p_sub)

    # --- 6. slotted all-to-all within the subcube --------------------------
    out, ovf = _alltoall_route(shard, dest, p_sub,
                               _slot_cap(cap, p_sub, slot_factor),
                               groups=groups, stream=overlap)
    del dest, shard
    if not overlap:                         # streamed arrives sorted
        out = local_sort(out)
    out, ovf2 = resize(out, cap)
    return out, ovf + ovf2
