"""Plain PyTorch versions of the partition kernels, over (rows, C) shards
with per-row splitters.

``partition_ref`` keeps the contract of the reference's ``partition_ref``
(``repro/kernels/partition/ref.py``), batched: keys (rows, C) are the
port's sign-flipped int32 words, ties (rows, C) int32 planes holding
uint32 tie-break tags, s_keys/s_ties (rows, nb−1) the splitter planes
(nondecreasing in (key, unsigned tie) order), count (rows,).  An element
and a splitter compare as the int64 ``key << 32 | tie`` — the sign-flipped
form of the reference's u64 composite.

``classify_ref`` and ``rank_ref`` are the functions of the two CUDA
launches, which ``chip_smoke.py`` holds the kernels against."""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _composite(keys, ties):
    return (keys.to(torch.int64) << 32) | (ties.to(torch.int64) & _M32)


def _bucket(keys, ties, s_keys, s_ties, n_buckets, count, inclusive):
    elem = _composite(keys, ties)
    spl = _composite(s_keys, s_ties).contiguous()
    bucket = torch.searchsorted(spl, elem, right=inclusive).to(torch.int32)
    idx = torch.arange(keys.shape[1], device=keys.device)
    valid = idx[None, :] < count[:, None]
    return torch.where(valid, bucket, n_buckets)


def _stable_rank(group):
    """Rank of each element among the earlier elements of its row that
    share its group id (ids >= 0), plus the row's sorted ids and order."""
    sg, order = torch.sort(group, dim=1, stable=True)
    first = torch.searchsorted(sg, sg)
    rank = torch.arange(group.shape[1], device=group.device)[None, :] - first
    return torch.empty_like(rank).scatter_(1, order, rank), sg


def partition_ref(keys, ties, s_keys, s_ties, *, n_buckets: int, count,
                  inclusive: bool = True, want_pos: bool = True):
    """Classify + rank + histogram.  Returns (bucket (rows, C) int32 in
    [0, nb], pos (rows, C) int32 stable rank inside the bucket or None,
    hist (rows, nb) int32 with ``hist.sum(1) == count``)."""
    bucket = _bucket(keys, ties, s_keys, s_ties, n_buckets, count, inclusive)
    nbt = n_buckets + 1
    hist = torch.zeros((keys.shape[0], nbt), dtype=torch.int64,
                       device=keys.device)
    hist.scatter_add_(1, bucket.to(torch.int64), torch.ones_like(
        bucket, dtype=torch.int64))
    hist = hist[:, :n_buckets].to(torch.int32)
    if not want_pos:
        return bucket, None, hist
    rank, _ = _stable_rank(bucket.to(torch.int64))
    return bucket, rank.to(torch.int32), hist


def classify_ref(keys, ties, s_keys, s_ties, count, *, n_buckets: int,
                 tile: int, inclusive: bool = True):
    """The classify launch: (bucket (rows, C) int32, tile_hist
    (rows, tiles, nb+1) int32) for tiles of ``tile`` elements."""
    bucket = _bucket(keys, ties, s_keys, s_ties, n_buckets, count, inclusive)
    rows, C = keys.shape
    tiles = -(-C // tile)
    nbt = n_buckets + 1
    tid = torch.arange(C, device=keys.device) // tile
    flat = tid[None, :] * nbt + bucket.to(torch.int64)
    th = torch.zeros((rows, tiles * nbt), dtype=torch.int64,
                     device=keys.device)
    th.scatter_add_(1, flat, torch.ones_like(flat))
    return bucket, th.reshape(rows, tiles, nbt).to(torch.int32)


def rank_ref(bucket, tile_off, *, n_buckets: int, tile: int):
    """The rank launch: ``tile_off[row, tile, bucket]`` plus the element's
    stable rank among the same-bucket elements of its tile."""
    rows, C = bucket.shape
    nbt = n_buckets + 1
    tid = (torch.arange(C, device=bucket.device) // tile)[None, :]
    group = tid * nbt + bucket.to(torch.int64)
    rank, _ = _stable_rank(group)
    off = torch.gather(tile_off.reshape(rows, -1).to(torch.int64), 1, group)
    return (off + rank).to(torch.int32)
