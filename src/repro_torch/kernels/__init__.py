"""Hand-written Hopper kernels of the port and their plain versions.

``bitonic`` (tile sort + run merge) and ``partition`` (classify + rank)
replace the Pallas TPU kernels of ``repro.kernels`` on the RAMS path,
``kway`` (the k-way classifier) on the external lane.  Nothing is compiled
at import: each wrapper builds its CUDA source with ``nvcc`` on first use
(``_build.py``).  ``policy`` says which kernel families the algorithms
launch (the reference's ``REPRO_LOCAL_KERNELS`` switch)."""
from .policy import (LocalKernelPolicy, local_kernels,  # noqa: F401
                     set_local_kernels)


def _counters():
    from .bitonic import LAUNCHES as b
    from .kway import LAUNCHES as k
    from .partition import LAUNCHES as p
    return b, p, k


def launch_counts() -> dict:
    """Launches of every kernel so far, by kernel name."""
    return {name: n for d in _counters() for name, n in d.items()}


def reset_launch_counts() -> None:
    for d in _counters():
        for k in d:
            d[k] = 0
