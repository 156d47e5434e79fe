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


def local_sort(shard: SortShard) -> SortShard:
    """Sort each PE's valid elements ascending, stable w.r.t. input order.

    Pads are written over the tail first, so a valid key equal to the pad
    word still precedes every pad (the stable order keeps it in front).
    4-byte keys with at most one 4-byte payload go through the Hopper
    tile-sort and run-merge kernels on the card (their plain stable sort on
    the CPU); other shards take torch's stable sort, as the reference takes
    its stable argsort where no kernel lowers."""
    keys = torch.where(shard.valid_mask(), shard.keys, shard.pad)
    if keys.dtype == torch.int32 and len(shard.vals) <= 1 and all(
            v.dtype == torch.int32 for v in shard.vals.values()):
        from repro_torch.kernels.bitonic import local_sort_fast
        if not shard.vals:
            ks, _ = local_sort_fast(keys)
            return shard.replace(keys=ks)
        (name, v), = shard.vals.items()
        ks, vs = local_sort_fast(keys, v)
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


# ---------------------------------------------------------------------------
# State carried across from the reference: numpy u32 planes <-> port shard
# ---------------------------------------------------------------------------


def shard_from_numpy(keys_u32: np.ndarray, vals: Dict[str, np.ndarray],
                     count: np.ndarray, device=None) -> SortShard:
    """A port shard from a reference ``SortShard`` batched over PEs, given
    as numpy arrays: (p, C) uint32 keys, {name: (p, C) uint32} payloads and
    (p,) counts."""
    ku = torch.from_numpy(np.array(keys_u32, np.uint32))       # a copy
    keys = key_to_int(ku).to(device)
    tv = {k: torch.from_numpy(np.array(v, np.uint32).view(np.int32)).to(
        device) for k, v in vals.items()}
    cnt = torch.as_tensor(np.asarray(count, np.int64), device=device)
    return SortShard(keys, tv, cnt)


def shard_to_numpy(shard: SortShard):
    """Inverse of :func:`shard_from_numpy`: (keys u32, {name: u32}, count
    int32) numpy arrays in the reference's layout."""
    keys = int_to_key(shard.keys, torch.uint32).view(torch.int32).cpu()
    keys = keys.numpy().view(np.uint32)
    vals = {k: v.cpu().numpy().view(np.uint32)
            for k, v in shard.vals.items()}
    return keys, vals, shard.count.cpu().numpy().astype(np.int32)
