"""Key representation and PE-batched shards (counterpart of
``repro/core/types.py``).

The reference maps every key dtype to an unsigned word and compares
unsigned.  Torch lacks ``<``, ``>>``, ``searchsorted``, ``max`` and
``scatter`` for uint32/uint64 on some devices, so the port holds the
reference's unsigned word ``u`` *sign-flipped*: ``s = u ^ 0x80…0`` viewed
as int32/int64.  Signed order on ``s`` equals unsigned order on ``u``; the
pad word 0xFFFFFFFF becomes 0x7FFFFFFF, and an int32 input is its own
internal word (flipped twice).

A shard holds all p PEs at once: ``keys`` (p, C), ``vals`` {name: (p, C)},
``count`` (p,) int64.  Every function here is a plain function over those
tensors; ``keys[i, count[i]:]`` is padding.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.policy import (LocalKernelPolicy,  # noqa: F401
                                        local_kernels, set_local_kernels)

_FLIP = {torch.int32: -(1 << 31), torch.int64: -(1 << 63)}
_PAD = {torch.int32: (1 << 31) - 1, torch.int64: (1 << 63) - 1}
_INTERNAL = {torch.int32: torch.int32, torch.uint32: torch.int32,
             torch.float32: torch.int32, torch.int64: torch.int64,
             torch.uint64: torch.int64, torch.float64: torch.int64}


def key_to_int(x: torch.Tensor) -> torch.Tensor:
    """Map f32/f64/i32/i64/u32/u64 keys to the sign-flipped internal word
    (int32 for 4-byte keys, int64 for 8-byte ones), order-preserving."""
    dt = x.dtype
    if dt not in _INTERNAL:
        raise TypeError(f"unsupported key dtype {dt}")
    it = _INTERNAL[dt]
    b = x.view(it)
    if dt in (torch.int32, torch.int64):
        return b.clone()
    if dt in (torch.uint32, torch.uint64):
        return b ^ _FLIP[it]
    # floats: negative values flip every bit of the unsigned word, others
    # only the sign bit; after the sign flip that is "negative: flip the
    # magnitude bits, non-negative: unchanged"
    return torch.where(b < 0, b ^ _PAD[it], b)


def int_to_key(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`key_to_int`."""
    if dtype not in _INTERNAL or _INTERNAL[dtype] != s.dtype:
        raise TypeError(f"cannot map {s.dtype} words to {dtype}")
    if dtype in (torch.int32, torch.int64):
        return s.clone()
    if dtype in (torch.uint32, torch.uint64):
        return (s ^ _FLIP[s.dtype]).view(dtype)
    return torch.where(s < 0, s ^ _PAD[s.dtype], s).view(dtype)


def resolve_device(device) -> torch.device:
    """``device``, or CUDA when it is None; never the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("psort runs on CUDA by default and no CUDA "
                               "device is available; pass device='cpu' to "
                               "run the plain versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


def pad_value(dtype: torch.dtype) -> int:
    """The internal pad word: the flip of the reference's all-ones word."""
    return _PAD[dtype]


@dataclasses.dataclass(frozen=True)
class SortShard:
    """All PEs' fixed-capacity fragments.  Rows of ``keys`` are sorted
    ascending up to ``count`` and padded after it."""

    keys: torch.Tensor                  # (p, C) int32 / int64
    vals: Dict[str, torch.Tensor]       # each (p, C)
    count: torch.Tensor                 # (p,) int64

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    @property
    def pad(self) -> int:
        return pad_value(self.keys.dtype)

    def valid_mask(self) -> torch.Tensor:
        idx = torch.arange(self.capacity, device=self.keys.device)
        return idx[None, :] < self.count[:, None]

    def replace(self, **kw) -> "SortShard":
        return dataclasses.replace(self, **kw)


def make_shard(keys: torch.Tensor, count=None, capacity: Optional[int] = None,
               vals: Optional[Dict[str, torch.Tensor]] = None) -> SortShard:
    """Build a locally sorted shard from raw (p, n) keys of any supported
    dtype."""
    s = key_to_int(keys)
    p, n = s.shape
    cap = capacity or n
    dev = s.device
    if count is None:
        count = torch.full((p,), n, dtype=torch.int64, device=dev)
    count = torch.as_tensor(count, dtype=torch.int64, device=dev)
    pad = pad_value(s.dtype)
    vals = dict(vals or {})
    if cap != n:
        s = torch.cat([s, s.new_full((p, cap - n), pad)], dim=1)
        vals = {k: torch.cat([v, v.new_zeros((p, cap - n))], dim=1)
                for k, v in vals.items()}
    idx = torch.arange(cap, device=dev)
    s = torch.where(idx[None, :] < count[:, None], s, pad)
    return local_sort(SortShard(keys=s, vals=vals, count=count))


def local_sort(shard: SortShard, max_count: Optional[int] = None
               ) -> SortShard:
    """Sort each PE's valid elements ascending, stable w.r.t. input order.

    Pads are written over the tail first, so a valid key equal to the pad
    word still precedes every pad (the stable order keeps it in front).
    The valid elements are a prefix, so a stable sort leaves the pad tail
    exactly where it is, payload included.  4-byte keys with at most one
    4-byte payload go through the Hopper tile-sort and run-merge kernels on
    the card (their plain stable sort on the CPU), which sort only each
    row's prefix [0, count); other shards take torch's stable sort, as the
    reference takes its stable argsort where no kernel lowers.  A caller
    that holds a bound on ``max(count)`` on the host passes it as
    ``max_count`` to spare the kernels' read back of the counts."""
    keys = torch.where(shard.valid_mask(), shard.keys, shard.pad)
    if keys.dtype == torch.int32 and len(shard.vals) <= 1 and all(
            v.dtype == torch.int32 for v in shard.vals.values()):
        from repro_torch.kernels.bitonic import local_sort_fast
        if not shard.vals:
            ks, _ = local_sort_fast(keys, count=shard.count.contiguous(),
                                    max_count=max_count)
            return shard.replace(keys=ks)
        (name, v), = shard.vals.items()
        ks, vs = local_sort_fast(keys, v.contiguous(),
                                 shard.count.contiguous(),
                                 max_count=max_count)
        return shard.replace(keys=ks, vals={name: vs})
    ks, order = torch.sort(keys, dim=1, stable=True)
    return shard.replace(keys=ks, vals={k: torch.gather(v, 1, order)
                                        for k, v in shard.vals.items()})


def resize(shard: SortShard, capacity: int):
    """Grow/shrink the buffers (sorted, padded).  Returns (shard, overflow)
    with overflow (p,) int64."""
    zero = torch.zeros_like(shard.count)
    if capacity == shard.capacity:
        return shard, zero
    if capacity > shard.capacity:
        extra = capacity - shard.capacity
        p = shard.keys.shape[0]
        keys = torch.cat([shard.keys, shard.keys.new_full((p, extra),
                                                          shard.pad)], dim=1)
        vals = {k: torch.cat([v, v.new_zeros((p, extra))], dim=1)
                for k, v in shard.vals.items()}
        return SortShard(keys, vals, shard.count), zero
    keys = shard.keys[:, :capacity].contiguous()
    vals = {k: v[:, :capacity].contiguous() for k, v in shard.vals.items()}
    overflow = torch.clamp(shard.count - capacity, min=0)
    return SortShard(keys, vals, torch.clamp(shard.count, max=capacity)), \
        overflow


def compact(shard: SortShard, keep_mask: torch.Tensor) -> SortShard:
    """Keep only elements where ``keep_mask`` (and valid); kept elements
    move to the front in order, the rest follow in order (the reference's
    stable argsort of the keep flag, done as one scatter)."""
    keep = keep_mask & shard.valid_mask()
    keys = torch.where(keep, shard.keys, shard.pad)
    kept = torch.cumsum(keep, dim=1)                 # kept up to and incl.
    n_keep = kept[:, -1:]
    idx = torch.arange(shard.capacity, device=keys.device)[None, :]
    dst = torch.where(keep, kept - 1, n_keep + idx - kept)
    del kept
    out_k = torch.empty_like(keys).scatter_(1, dst, keys)
    del keys
    vals = {k: torch.empty_like(v).scatter_(1, dst, v)
            for k, v in shard.vals.items()}
    return SortShard(out_k, vals, n_keep[:, 0].clone())


def _count_before(keys, count, query, or_equal):
    """Per row, #{valid keys < query} (≤ where ``or_equal``, a bool or a
    (p, 1) bool tensor) for sorted padded rows ``keys``: one
    ``searchsorted`` clamped to ``count``, so a valid key equal to the pad
    word is told from the pads by the count, not by its value.  With a
    tensor, ``x ≤ q`` is searched as ``x < q + 1`` below the pad word, and
    at it every valid key counts; nothing overflows."""
    if isinstance(or_equal, bool):
        n = torch.searchsorted(keys, query, right=or_equal)
    else:
        top = query == pad_value(keys.dtype)
        n = torch.searchsorted(keys, query + (or_equal & ~top))
        n = torch.where(or_equal & top, keys.shape[1], n)
    return torch.minimum(n, count[:, None])


def _merge_positions(a: SortShard, b: SortShard, tie_a_first):
    """Each element's place in the merge of ``merge_shards``: its own index
    plus a count in the other shard.  4-byte words search one int64
    composite ``key << 2 | tie rank``; 8-byte words leave no room for the
    rank, so they search the keys themselves, clamped to the counts, with
    ``<`` or ``≤`` as the tie rank says (:func:`_count_before`), and the
    pads go after every valid element, a's first."""
    dev = a.keys.device
    ia = torch.arange(a.capacity, device=dev)
    ib = torch.arange(b.capacity, device=dev)
    per_pe = isinstance(tie_a_first, torch.Tensor)
    first = tie_a_first.to(dev).reshape(-1, 1) if per_pe \
        else bool(tie_a_first)                   # a host bool: no copy
    valid_a, valid_b = a.valid_mask(), b.valid_mask()
    if a.keys.dtype == torch.int32:
        rank_a, rank_b = (torch.where(first, 0, 1), torch.where(first, 1, 0)) \
            if per_pe else ((0, 1) if first else (1, 0))

        def composite(sh, valid, rank):
            key = torch.where(valid, sh.keys, sh.pad).to(torch.int64)
            return (key << 2) | torch.where(valid, rank, 2)

        ca, cb = composite(a, valid_a, rank_a), composite(b, valid_b, rank_b)
        return (torch.searchsorted(cb, ca).add_(ia),
                torch.searchsorted(ca, cb, right=True).add_(ib))
    ka = torch.where(valid_a, a.keys, a.pad)
    kb = torch.where(valid_b, b.keys, b.pad)
    b_first = ~first if per_pe else not first
    return (torch.where(valid_a, ia + _count_before(kb, b.count, ka, b_first),
                        ia + b.count[:, None]),
            torch.where(valid_b, ib + _count_before(ka, a.count, kb, first),
                        ib + a.capacity))


def merge_shards(a: SortShard, b: SortShard, capacity: Optional[int] = None,
                 tie_a_first=True):
    """Merge two sorted padded shards into one of ``capacity`` per PE.

    Returns (merged, overflow (p,)): the elements past the capacity are
    dropped and counted.  The order is the reference's lexsort of the
    concatenation by (key, tie rank) with tie ranks valid a (0) < valid b
    (1) < padding (2), a and b swapped where ``tie_a_first`` (a bool or a
    (p,) bool tensor, one per PE) is false; so a valid key equal to the pad
    word stays before every pad.  Both inputs are sorted in that order
    (valid prefix ascending, pad words after it), so each element's place
    is its own index plus a count in the other shard: a[i] goes to ``i +
    #{b before a[i]}`` and b[j] to ``j + #{a before b[j]}``, one
    ``searchsorted`` each (:func:`_merge_positions`), for keys of either
    width."""
    cap = capacity or max(a.capacity, b.capacity)
    dev = a.keys.device
    pos_a, pos_b = _merge_positions(a, b, tie_a_first)
    p, width = a.keys.shape[0], a.capacity + b.capacity

    def merged(va, vb):
        out = va.new_empty((p, width))
        out.scatter_(1, pos_a, va).scatter_(1, pos_b, vb)
        if width >= cap:
            return out[:, :cap].contiguous()
        return torch.cat([out, out.new_zeros((p, cap - width))], dim=1)

    keys = merged(a.keys, b.keys)
    vals = {k: merged(a.vals[k], b.vals[k]) for k in a.vals}
    total = a.count + b.count
    count = torch.clamp(total, max=cap)
    idx = torch.arange(cap, device=dev)
    keys = torch.where(idx[None, :] < count[:, None], keys, a.pad)
    return SortShard(keys, vals, count), torch.clamp(total - cap, min=0)


def merge_sorted_shards(a: SortShard, b: SortShard,
                        capacity: Optional[int] = None):
    """The reference's positional merge of two ascending shards with
    a-before-b ties: valid a < valid b < pads, so a valid key equal to the
    pad word stays before every pad.  That is :func:`merge_shards` with
    ``tie_a_first=True``, whose positions are computed the same way (two
    ``searchsorted`` and a scatter); equal to the reference on keys,
    counts, overflow and the vals in ``[0, count)``."""
    return merge_shards(a, b, capacity, tie_a_first=True)


# ---------------------------------------------------------------------------
# State carried across from the reference: numpy u32 planes <-> port shard
# ---------------------------------------------------------------------------


def shard_from_numpy(keys_u: np.ndarray, vals: Dict[str, np.ndarray],
                     count: np.ndarray, device=None) -> SortShard:
    """A port shard from a reference ``SortShard`` batched over PEs, given
    as numpy arrays: (p, C) uint32 keys (uint64 for 8-byte keys),
    {name: (p, C) uint32} payloads and (p,) counts."""
    keys_u = np.asarray(keys_u)
    wide = keys_u.dtype == np.uint64
    ku = torch.from_numpy(np.array(keys_u, np.uint64 if wide
                                   else np.uint32))              # a copy
    keys = key_to_int(ku).to(device)
    tv = {k: torch.from_numpy(np.array(v, np.uint32).view(np.int32)).to(
        device) for k, v in vals.items()}
    cnt = torch.as_tensor(np.asarray(count, np.int64), device=device)
    return SortShard(keys, tv, cnt)


def shard_to_numpy(shard: SortShard):
    """Inverse of :func:`shard_from_numpy`: (keys u32 or u64, {name: u32},
    count int32) numpy arrays in the reference's layout."""
    wide = shard.keys.dtype == torch.int64
    signed, unsigned = (torch.int64, torch.uint64) if wide \
        else (torch.int32, torch.uint32)
    keys = int_to_key(shard.keys, unsigned).view(signed).cpu()
    keys = keys.numpy().view(np.uint64 if wide else np.uint32)
    vals = {k: v.cpu().numpy().view(np.uint32)
            for k, v in shard.vals.items()}
    return keys, vals, shard.count.cpu().numpy().astype(np.int32)
