"""Plain PyTorch version of the k-way classifier kernel.

Keys (C,) are the port's sign-flipped int32 words, ties (C,) int32 planes
holding uint32 bits; an element and a splitter compare as the int64
``key << 32 | tie``, the sign-flipped form of the reference's u64
composite (``repro/kernels/kway/ref.py``).  The splitters need not be in
order: the reference's own tests pass sorted keys with unordered ties.
``bucket[i]`` counts the splitters at or below element i; a count does not
depend on the order it is taken in, so it is taken as a search of the
splitters once they are sorted."""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _composite(keys, ties):
    return (keys.to(torch.int64) << 32) | (ties.to(torch.int64) & _M32)


def kway_classify_ref(keys, ties, s_keys, s_ties, *, n_buckets: int):
    """(bucket (C,) int32 = #splitters <= element, hist (n_buckets,) int32
    of the buckets below n_buckets)."""
    spl = torch.sort(_composite(s_keys, s_ties))[0]
    bucket = torch.searchsorted(spl, _composite(keys, ties), right=True)
    hist = torch.bincount(bucket, minlength=n_buckets)[:n_buckets]
    return bucket.to(torch.int32), hist.to(torch.int32)
