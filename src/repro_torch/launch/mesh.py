"""Production meshes (counterpart of ``repro/launch/mesh.py``).
Functions, not module constants: importing this module touches no
process group.

Single pod: (data 16, model 16), 256 ranks.  Multi-pod: (pod 2, data 16,
model 16), 512 ranks; only the batch's and the gradients' reductions
cross ``pod``.  ``make_mesh_shape`` builds any other shape (a restore
onto another topology, ``serve --mesh``, ``train --mesh``).

Each builder returns the ``DeviceMesh`` of the first ranks of the
default process group, row-major (``dist.sharding.make_mesh``); with
fewer ranks than the mesh holds it raises ``RuntimeError``, as the
reference's does with fewer devices.  Given ``rank``,
``make_production_mesh`` returns that rank's ``dist.sharding.MeshLayout``
of the same shape instead: the axes, their sizes and the rank's
coordinate, with no process group, which is what the dry-run
(``launch/dryrun.py``) reckons a rank's step on.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.dist.sharding import MeshLayout, make_mesh, world_ranks


def _mesh(shape: Sequence[int], axes: Sequence[str]):
    shape, axes = tuple(int(v) for v in shape), tuple(axes)
    n = int(np.prod(shape))
    if world_ranks() < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, found {world_ranks()}; start "
            f"{n} processes (torchrun --nproc-per-node)")
    return make_mesh(np.arange(n).reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         rank: Optional[int] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if rank is None:
        return _mesh(shape, axes)
    if not 0 <= rank < int(np.prod(shape)):
        raise ValueError(f"rank {rank} is not in a mesh {shape}")
    return MeshLayout.of_rank(axes, shape, rank)


def make_mesh_shape(shape: Sequence[int], axes: Sequence[str]):
    """Elastic mesh builder (checkpoint restore onto a different
    topology)."""
    return _mesh(shape, axes)


def make_sort_mesh(p: Optional[int] = None, axis: str = "sort"):
    """1-D mesh for the standalone sorting workloads: ``p`` ranks (default:
    every rank of the group) on ``axis``."""
    p = p or world_ranks()
    return _mesh((p,), (axis,))
