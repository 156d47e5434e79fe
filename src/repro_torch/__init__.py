"""repro_torch — the PyTorch + CUDA port of the robust massively parallel
sorting library (``repro``), for one NVIDIA Hopper GPU.

It imports torch and numpy only: never jax, never ``repro``.  The JAX
package is the reference every part of the port is held against."""
from .core import (ExternalPolicy, ResidentData, SortConfig,  # noqa: F401
                   percentile, psort, range_query, rank_of_key, select_rank,
                   shard_data, top_k, trace_collectives, trace_query)
