"""Plain PyTorch versions of the local-sort kernels, over (rows, C).

They are what the wrappers run on a CPU tensor and what ``chip_smoke.py``
holds the CUDA kernels against on the card.  All three are stable: equal
keys keep their input order, which is the reference's kernel-off
``local_sort`` (a stable argsort)."""
from __future__ import annotations

import torch


def _take(vals, order):
    return None if vals is None else torch.gather(vals, 1, order)


def sort_ref(keys, vals=None):
    """Stable ascending sort of every row, payload carried along."""
    ks, order = torch.sort(keys, dim=1, stable=True)
    return ks, _take(vals, order)


def _segment_sort(keys, vals, width: int):
    """Stable sort of each width-segment of every row (ragged tail too)."""
    rows, C = keys.shape
    segs = -(-C // width)
    extra = segs * width - C
    if extra:              # the pad sorts last, after any real equal key
        keys = torch.cat([keys, keys.new_full((rows, extra),
                                              torch.iinfo(keys.dtype).max)], 1)
        if vals is not None:
            vals = torch.cat([vals, vals.new_zeros((rows, extra))], 1)
    ks, vs = sort_ref(keys.reshape(rows * segs, width),
                      None if vals is None else vals.reshape(rows * segs,
                                                             width))
    ks = ks.reshape(rows, -1)[:, :C]
    vs = None if vs is None else vs.reshape(rows, -1)[:, :C]
    return ks, vs


def sort_tiles_ref(keys, vals=None, tile: int = 4096):
    """The tile-sort kernel's function: each tile of ``tile`` elements of
    every row sorted on its own (stable)."""
    return _segment_sort(keys, vals, tile)


def merge_runs_ref(keys, vals=None, width: int = 4096):
    """The run-merge kernel's function: adjacent sorted runs of ``width``
    merged pairwise into runs of 2·width, ties from the left run first.  A
    stable sort of each 2·width segment computes exactly that."""
    return _segment_sort(keys, vals, 2 * width)
