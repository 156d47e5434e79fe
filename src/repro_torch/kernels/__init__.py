"""Hand-written Hopper kernels of the port and their plain versions.

``bitonic`` (tile sort + run merge) and ``partition`` (classify + rank)
replace the Pallas TPU kernels of ``repro.kernels`` on the RAMS path.
Nothing is compiled at import: each wrapper builds its CUDA source with
``nvcc`` on first use (``_build.py``)."""


def launch_counts() -> dict:
    """Launches of every kernel so far, by kernel name."""
    from .bitonic import LAUNCHES as b
    from .partition import LAUNCHES as p
    return {**b, **p}


def reset_launch_counts() -> None:
    from .bitonic import LAUNCHES as b
    from .partition import LAUNCHES as p
    for d in (b, p):
        for k in d:
            d[k] = 0
