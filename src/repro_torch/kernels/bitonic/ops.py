"""Wrappers of the local-sort kernels (counterpart of
``repro/kernels/bitonic/ops.py``).

``local_sort_fast(keys, vals, count)`` sorts the first ``count[r]`` keys
of every row r of a (rows, C) int32 key tensor stably, carrying an
optional int32 payload; the rest of each row passes through unchanged
(``count=None``: every row is full).  :func:`schedule` lays out the
launches: one tile sort of :data:`TILE`-key tiles, then one run merge per
doubling of the sorted runs until one run spans the longest row's valid
prefix, ping-ponging between two buffers; the tile-sort launch copies each
row's tail once, into the buffer the last merge ends in.

On a CUDA tensor each wrapper launches its kernel (csrc/bitonic.cu) or
raises; on a CPU tensor it runs the plain version (ref.py).  ``LAUNCHES``
counts the kernel launches of each wrapper.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

TILE = 8192                  # must equal TILE in csrc/bitonic.cu
LAUNCHES = {"tile_sort": 0, "run_merge": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int64


@functools.cache
def _lib():
    lib = _build.load("bitonic")
    lib.tile_sort.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P]
    lib.tile_sort.restype = ctypes.c_int
    lib.run_merge.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.run_merge.restype = ctypes.c_int
    lib.tile_size.restype = ctypes.c_int
    if lib.tile_size() != TILE:
        raise RuntimeError("csrc/bitonic.cu TILE differs from ops.TILE")
    return lib


def _check_args(keys, vals, count):
    if keys.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, not "
                         f"{keys.device}")
    if keys.dim() != 2 or keys.dtype != torch.int32:
        raise TypeError(f"keys must be (rows, C) int32, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if vals is not None:
        if vals.shape != keys.shape or vals.dtype != torch.int32:
            raise TypeError("vals must be an int32 tensor shaped like keys")
        if vals.device != keys.device or not vals.is_contiguous():
            raise ValueError("vals must be contiguous, on the keys' device")
    if count is not None:
        if count.shape != keys.shape[:1] or count.dtype != torch.int64:
            raise TypeError("count must be a (rows,) int64 tensor")
        if count.device != keys.device or not count.is_contiguous():
            raise ValueError("count must be contiguous, on the keys' device")


def _max_count(count, C: int) -> int:
    """The longest valid prefix of any row.  With a count this reads it
    back to the host: one synchronisation per call, which fixes the grid
    and the number of merge passes."""
    if count is None or count.numel() == 0:
        return C if count is None else 0
    lo, hi = torch.stack(torch.aminmax(count)).tolist()
    if lo < 0 or hi > C:
        raise ValueError(f"count must lie in [0, {C}], got [{lo}, {hi}]")
    return hi


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def launch_tile_sort(keys, vals, count, out_keys, out_vals, tail_keys,
                     tail_vals):
    """One tile_sort launch: the tiles of each row's valid prefix sorted
    into ``out_*``, the row's tail copied into ``tail_*``."""
    err = _lib().tile_sort(_ptr(keys), _ptr(vals), _ptr(out_keys),
                           _ptr(out_vals), _ptr(tail_keys), _ptr(tail_vals),
                           _ptr(count), keys.shape[0], keys.shape[1],
                           _stream())
    _build.check(err, "tile_sort")
    LAUNCHES["tile_sort"] += 1


def launch_run_merge(keys, vals, count, width, cmax, out_keys, out_vals):
    """One run_merge launch: runs of ``width`` merged pairwise inside each
    row's valid prefix; nothing past it is written."""
    err = _lib().run_merge(_ptr(keys), _ptr(vals), _ptr(out_keys),
                           _ptr(out_vals), _ptr(count), keys.shape[0],
                           keys.shape[1], cmax, width, _stream())
    _build.check(err, "run_merge")
    LAUNCHES["run_merge"] += 1


def merge_passes(cmax: int, tile: int = TILE) -> int:
    """Merge passes after the tile sort until one run covers ``cmax``."""
    passes, w = 0, tile
    while w < cmax:
        passes, w = passes + 1, 2 * w
    return passes


def schedule(keys, vals, count, cmax: int, tile_sort, run_merge,
             tile: int = TILE):
    """The local sort as launches of ``tile_sort`` and ``run_merge`` (the
    signatures of :func:`launch_tile_sort` and :func:`launch_run_merge`).
    Returns the buffers (keys, vals-or-None) the last launch wrote."""
    passes = merge_passes(cmax, tile)

    def buffers():
        return (torch.empty_like(keys),
                None if vals is None else torch.empty_like(vals))
    bufs = [buffers() for _ in range(1 if passes == 0 else 2)]
    final = bufs[passes % 2]
    tile_sort(keys, vals, count, *bufs[0], *final)
    w = tile
    for i in range(passes):
        run_merge(*bufs[i % 2], count, w, cmax, *bufs[(i + 1) % 2])
        w *= 2
    return final


def sort_tiles(keys, vals=None, count=None):
    """Stable sort of every TILE-key tile of each row's valid prefix."""
    if keys.device.type == "cpu":
        return ref.sort_tiles_ref(keys, vals, TILE, count)
    _check_args(keys, vals, count)
    ok = torch.empty_like(keys)
    ov = None if vals is None else torch.empty_like(vals)
    launch_tile_sort(keys, vals, count, ok, ov, ok, ov)
    return ok, ov


def merge_runs(keys, vals=None, width: int = TILE, count=None):
    """Merge adjacent sorted runs of ``width`` into runs of 2·width inside
    each row's valid prefix; on the card ``width`` is a multiple of
    TILE."""
    if keys.device.type == "cpu":
        return ref.merge_runs_ref(keys, vals, width, count)
    _check_args(keys, vals, count)
    if width <= 0 or width % TILE:
        raise ValueError(f"width must be a positive multiple of {TILE}")
    cmax = _max_count(count, keys.shape[1])
    # the merge writes only inside the counts: the tails start as copies
    new = torch.empty_like if count is None else torch.clone
    ok = new(keys)
    ov = None if vals is None else new(vals)
    launch_run_merge(keys, vals, count, width, cmax, ok, ov)
    return ok, ov


def local_sort_fast(keys, vals=None, count=None, *, max_count=None):
    """Stable sort of every row's valid prefix; returns (keys,
    vals-or-None).  A caller that holds ``max(count)`` on the host passes
    it as ``max_count``, which saves the read back."""
    if keys.device.type == "cpu":
        return ref.sort_ref(keys, vals, count)
    _check_args(keys, vals, count)
    cmax = (_max_count(count, keys.shape[1]) if max_count is None
            else int(max_count))
    return schedule(keys, vals, count, cmax, launch_tile_sort,
                    launch_run_merge)
