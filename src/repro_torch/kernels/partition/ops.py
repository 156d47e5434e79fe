"""Wrapper of the partition kernels (counterpart of
``repro/kernels/partition/ops.py``).

``partition_buckets`` is what the algorithms call over the whole PE
batch, with per-row splitters (rows, nb−1) and per-row counts: RAMS once
per level for buckets, ranks and histogram, SSort for buckets only, RQuick
for the histogram only.  On a CUDA tensor it launches the classify variant
that writes just those outputs (``WANTS``) and, for the ranks, threads the
per-tile histograms into per-tile offsets with one ``torch.cumsum`` over
the tile axis and launches the rank kernel (csrc/partition.cu); otherwise
it raises.  On a CPU tensor it runs the plain version (ref.py).
``LAUNCHES`` counts the launches of each kernel, and those of each
classify variant under ``partition_classify:<variant>``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

PTILE = 1024                 # must equal PTILE in csrc/partition.cu
MAX_BUCKETS = 2048           # the kernels' shared memory stays under 48 KB
# the classify variants, by the outputs they write (the C mode is the index)
WANTS = ("rank", "bucket_hist", "bucket", "hist")
LAUNCHES = {"partition_classify": 0, "partition_rank": 0,
            **{f"partition_classify:{w}": 0 for w in WANTS}}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_C = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("partition")
    lib.partition_classify.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _C, _C, _C, _P]
    lib.partition_classify.restype = _C
    lib.partition_rank.argtypes = [_P, _P, _P, _I, _I, _C, _P]
    lib.partition_rank.restype = _C
    lib.partition_tile_size.restype = _C
    if lib.partition_tile_size() != PTILE:
        raise RuntimeError("csrc/partition.cu PTILE differs from ops.PTILE")
    return lib


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(keys, ties, s_keys, s_ties, count, n_buckets):
    if keys.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, not "
                         f"{keys.device}")
    rows, C = keys.shape
    for name, t, shape, dt in (("keys", keys, (rows, C), torch.int32),
                               ("ties", ties, (rows, C), torch.int32),
                               ("s_keys", s_keys, (rows, n_buckets - 1),
                                torch.int32),
                               ("s_ties", s_ties, (rows, n_buckets - 1),
                                torch.int32),
                               ("count", count, (rows,), torch.int64)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise TypeError(f"{name} must be {shape} {dt}, got "
                            f"{tuple(t.shape)} {t.dtype}")
        if t.device != keys.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, on the keys' "
                             f"device")
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"n_buckets must be in [1, {MAX_BUCKETS}]")


def classify(keys, ties, s_keys, s_ties, count, *, n_buckets: int,
             inclusive: bool = True, want: str = "rank"):
    """The classify launch of variant ``want``: "rank" gives (bucket
    (rows, C), tile_hist (rows, tiles, nb+1)), the rank's input;
    "bucket_hist" (bucket, hist (rows, nb)); "bucket" (bucket,); "hist"
    (hist,).  All int32; ``hist`` counts valid elements only."""
    if want not in WANTS:
        raise ValueError(f"want must be one of {WANTS}, got {want!r}")
    if keys.device.type == "cpu":
        return ref.classify_ref(keys, ties, s_keys, s_ties, count,
                                n_buckets=n_buckets, tile=PTILE,
                                inclusive=inclusive, want=want)
    _check(keys, ties, s_keys, s_ties, count, n_buckets)
    rows, C = keys.shape
    dev = keys.device
    bucket = None if want == "hist" else torch.empty_like(keys)
    if want == "rank":
        hist = torch.empty((rows, -(-C // PTILE), n_buckets + 1),
                           dtype=torch.int32, device=dev)
    elif want == "bucket":
        hist = None
    else:                                 # one atomicAdd per block into it
        hist = torch.zeros((rows, n_buckets), dtype=torch.int32, device=dev)
    err = _lib().partition_classify(
        keys.data_ptr(), ties.data_ptr(), s_keys.data_ptr(),
        s_ties.data_ptr(), count.data_ptr(),
        0 if bucket is None else bucket.data_ptr(),
        0 if hist is None else hist.data_ptr(), rows, C, n_buckets,
        int(inclusive), WANTS.index(want), _stream())
    _build.check(err, "partition_classify")
    LAUNCHES["partition_classify"] += 1
    LAUNCHES[f"partition_classify:{want}"] += 1
    return tuple(t for t in (bucket, hist) if t is not None)


def rank(bucket, tile_off, *, n_buckets: int):
    """The rank launch: stable in-bucket position of every element, from
    the per-tile bucket offsets ``tile_off`` (rows, tiles, nb+1) int32."""
    if bucket.device.type == "cpu":
        return ref.rank_ref(bucket, tile_off, n_buckets=n_buckets, tile=PTILE)
    rows, C = bucket.shape
    tiles = -(-C // PTILE)
    if bucket.device.type != "cuda" or bucket.dtype != torch.int32 \
            or not bucket.is_contiguous():
        raise TypeError("bucket must be a contiguous CUDA int32 tensor")
    if tuple(tile_off.shape) != (rows, tiles, n_buckets + 1) \
            or tile_off.dtype != torch.int32 or not tile_off.is_contiguous() \
            or tile_off.device != bucket.device:
        raise TypeError(f"tile_off must be contiguous ({rows}, {tiles}, "
                        f"{n_buckets + 1}) int32 on the bucket's device")
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"n_buckets must be in [1, {MAX_BUCKETS}]")
    pos = torch.empty_like(bucket)
    err = _lib().partition_rank(bucket.data_ptr(), tile_off.data_ptr(),
                                pos.data_ptr(), rows, C, n_buckets,
                                _stream())
    _build.check(err, "partition_rank")
    LAUNCHES["partition_rank"] += 1
    return pos


def partition_buckets(keys, ties, s_keys, s_ties, *, n_buckets: int, count,
                      inclusive: bool = True, want_pos: bool = True,
                      want_bucket: bool = True, want_hist: bool = True):
    """Fused classify + rank + histogram over PE-batched shards; same
    contract as :func:`ref.partition_ref`.  Without ``want_pos`` one
    classify launch writes only the outputs whose ``want_`` flag is set."""
    if keys.device.type == "cpu":
        return ref.partition_ref(keys, ties, s_keys, s_ties,
                                 n_buckets=n_buckets, count=count,
                                 inclusive=inclusive, want_pos=want_pos,
                                 want_bucket=want_bucket,
                                 want_hist=want_hist)
    kw = dict(n_buckets=n_buckets, inclusive=inclusive)
    if not want_pos:
        if not (want_bucket or want_hist):
            raise ValueError("partition_buckets asked for no output")
        want = ("bucket_hist" if want_hist else "bucket") if want_bucket \
            else "hist"
        out = classify(keys, ties, s_keys, s_ties, count, want=want, **kw)
        return (out[0] if want_bucket else None, None,
                out[-1] if want_hist else None)
    bucket, tile_hist = classify(keys, ties, s_keys, s_ties, count, **kw)
    csum = torch.cumsum(tile_hist, dim=1, dtype=torch.int32)
    hist = csum[:, -1, :n_buckets].clone()
    tile_off = csum.sub_(tile_hist)
    del tile_hist
    return bucket, rank(bucket, tile_off, n_buckets=n_buckets), hist
