"""Stable local sort of PE-batched shards: Hopper tile-sort and run-merge
kernels (csrc/bitonic.cu), their plain versions (ref.py) and the wrapper
``local_sort_fast`` (ops.py)."""
from .ops import LAUNCHES, TILE, local_sort_fast, merge_runs, sort_tiles  # noqa: F401
