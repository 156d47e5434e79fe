"""repro_torch — the PyTorch + CUDA port of the robust massively parallel
sorting library (``repro``), for one NVIDIA Hopper GPU.

It imports torch and numpy only: never jax, never ``repro``.  The JAX
package is the reference every part of the port is held against."""
from .core import (ExternalPolicy, SortConfig, psort,  # noqa: F401
                   trace_collectives)
