"""Plain PyTorch versions of the local-sort kernels, over (rows, C).

They are what the wrappers run on a CPU tensor and what ``chip_smoke.py``
holds the CUDA kernels against on the card.  All three are stable: equal
keys keep their input order, which is the reference's kernel-off
``local_sort`` (a stable argsort).  Each takes an optional (rows,) int64
``count``: only the first ``count[r]`` keys of row r are sorted, and the
rest of the row stays where it is (``None``: every row is full)."""
from __future__ import annotations

import torch


def _take(vals, order):
    return None if vals is None else torch.gather(vals, 1, order)


def _masked(keys, count):
    """``keys`` with every position at or past ``count`` set to the largest
    key.  A stable sort leaves those positions where they are, behind any
    real key equal to it, so it sorts the valid prefix alone."""
    if count is None:
        return keys
    idx = torch.arange(keys.shape[1], device=keys.device)
    return torch.where(idx[None, :] < count[:, None], keys,
                       torch.iinfo(keys.dtype).max)


def sort_ref(keys, vals=None, count=None):
    """Stable ascending sort of every row's valid prefix, payload carried
    along."""
    if count is None:
        ks, order = torch.sort(keys, dim=1, stable=True)
        return ks, _take(vals, order)
    order = torch.sort(_masked(keys, count), dim=1, stable=True)[1]
    return torch.gather(keys, 1, order), _take(vals, order)


def _segment_sort(keys, vals, width: int, count=None):
    """Stable sort of each width-segment of every row's valid prefix (the
    ragged last segment too)."""
    rows, C = keys.shape
    if C <= width:         # one segment: no padding to the width
        return sort_ref(keys, vals, count)
    segs = -(-C // width)
    order_keys = _masked(keys, count)
    extra = segs * width - C
    if extra:              # the pad sorts last, after any real equal key
        order_keys = torch.cat([order_keys, order_keys.new_full(
            (rows, extra), torch.iinfo(keys.dtype).max)], 1)
    order = torch.sort(order_keys.reshape(rows, segs, width), dim=2,
                       stable=True)[1]
    order += torch.arange(0, segs * width, width,
                          device=keys.device)[None, :, None]
    order = order.reshape(rows, -1)[:, :C]
    return torch.gather(keys, 1, order), _take(vals, order)


def sort_tiles_ref(keys, vals, tile: int, count=None):
    """The tile-sort kernel's function: each tile of ``tile`` keys of every
    row's valid prefix sorted on its own (stable)."""
    return _segment_sort(keys, vals, tile, count)


def merge_runs_ref(keys, vals, width: int, count=None):
    """The run-merge kernel's function: adjacent sorted runs of ``width``
    in every row's valid prefix merged pairwise into runs of 2·width, ties
    from the left run first.  A stable sort of each 2·width segment
    computes exactly that."""
    return _segment_sort(keys, vals, 2 * width, count)
