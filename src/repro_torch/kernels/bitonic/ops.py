"""Wrappers of the local-sort kernels (counterpart of
``repro/kernels/bitonic/ops.py``).

``local_sort_fast(keys, vals)`` sorts every row of a (rows, C) int32 key
tensor stably, carrying an optional int32 payload: one tile-sort launch
sorts tiles of :data:`TILE` elements, then ⌈log2(C / TILE)⌉ run-merge
launches double the sorted runs until one run spans the row — the shape
of the reference's ``_sort_pow2``, without padding to a power of two.

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

TILE = 4096                  # must equal TILE in csrc/bitonic.cu
LAUNCHES = {"tile_sort": 0, "run_merge": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int64


@functools.cache
def _lib():
    lib = _build.load("bitonic")
    lib.tile_sort.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    lib.tile_sort.restype = ctypes.c_int
    lib.run_merge.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.run_merge.restype = ctypes.c_int
    lib.tile_size.restype = ctypes.c_int
    if lib.tile_size() != TILE:
        raise RuntimeError("csrc/bitonic.cu TILE differs from ops.TILE")
    return lib


def _check_args(keys, vals):
    if keys.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, not "
                         f"{keys.device}")
    if keys.dim() != 2 or keys.dtype != torch.int32:
        raise TypeError(f"keys must be (rows, C) int32, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if keys.shape[0] > 65535:
        raise ValueError("at most 65535 rows per launch")
    if vals is not None:
        if vals.shape != keys.shape or vals.dtype != torch.int32:
            raise TypeError("vals must be an int32 tensor shaped like keys")
        if vals.device != keys.device or not vals.is_contiguous():
            raise ValueError("vals must be contiguous, on the keys' device")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def sort_tiles(keys, vals=None):
    """Stable sort of every TILE-element tile of every row."""
    if keys.device.type == "cpu":
        return ref.sort_tiles_ref(keys, vals, TILE)
    _check_args(keys, vals)
    ok = torch.empty_like(keys)
    ov = None if vals is None else torch.empty_like(vals)
    lib = _lib()
    err = lib.tile_sort(_ptr(keys), _ptr(vals), _ptr(ok), _ptr(ov),
                        keys.shape[0], keys.shape[1], _stream())
    _build.check(err, "tile_sort")
    LAUNCHES["tile_sort"] += 1
    return ok, ov


def merge_runs(keys, vals=None, width: int = TILE):
    """Merge adjacent sorted runs of ``width`` into runs of 2·width."""
    if keys.device.type == "cpu":
        return ref.merge_runs_ref(keys, vals, width)
    _check_args(keys, vals)
    ok = torch.empty_like(keys)
    ov = None if vals is None else torch.empty_like(vals)
    lib = _lib()
    err = lib.run_merge(_ptr(keys), _ptr(vals), _ptr(ok), _ptr(ov),
                        keys.shape[0], keys.shape[1], width, _stream())
    _build.check(err, "run_merge")
    LAUNCHES["run_merge"] += 1
    return ok, ov


def local_sort_fast(keys, vals=None):
    """Stable sort of every row; returns (keys, vals-or-None)."""
    if keys.device.type == "cpu":
        return ref.sort_ref(keys, vals)
    ks, vs = sort_tiles(keys, vals)
    w = TILE
    while w < keys.shape[1]:
        ks, vs = merge_runs(ks, vs, w)
        w *= 2
    return ks, vs
