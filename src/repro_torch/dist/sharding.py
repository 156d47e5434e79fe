"""The device meshes of the distributed backend (counterpart of
``sort_mesh`` in ``repro/dist/sharding.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group: each rank is one PE (one device in the
reference).  Building one creates the process groups of its dimensions,
a collective over the whole default group, so every rank calls
:func:`sort_mesh` with the same arguments, ranks the mesh leaves out
included.  Meshes are cached per layout, so repeated calls (``psort``'s
default meshes among them) reuse their groups.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

_MESHES: Dict[tuple, object] = {}


def world_ranks() -> int:
    """The ranks of the default process group; 0 where none is
    initialised."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return 0
    return tdist.get_world_size()


def mesh_sizes(mesh) -> Dict[str, int]:
    """A mesh's axis sizes by name, in order (the reference's
    ``Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def make_mesh(layout: np.ndarray, names: Tuple[str, ...]):
    """The ``DeviceMesh`` of the global ranks ``layout`` with axis
    ``names``, made once per (default group, layout, names); its device
    type follows the default group's backend (``cuda`` for NCCL)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not world_ranks():
        raise RuntimeError("a device mesh needs an initialised "
                           "torch.distributed process group")
    default = tdist.distributed_c10d._get_default_group()
    layout = np.asarray(layout, np.int64)
    key = (id(default), layout.shape, tuple(layout.reshape(-1).tolist()),
           tuple(names))
    if key not in _MESHES:
        device_type = "cuda" if tdist.get_backend() == "nccl" else "cpu"
        _MESHES[key] = DeviceMesh(device_type, torch.from_numpy(layout),
                                  mesh_dim_names=tuple(names))
    return _MESHES[key]


def sort_mesh(p: Optional[int] = None, d: int = 1, *, axis: str = "sort",
              data_axis: str = "data",
              shape: Optional[Tuple[int, int]] = None,
              mesh_axes: Tuple[str, str] = ("inter", "intra"),
              devices=None, exclude: Tuple[int, ...] = ()):
    """A device mesh for ``psort``: flat (d, p) or hierarchical nested.

    Flat form (default): a (d, p) mesh with axes (``data_axis``, ``axis``)
    — row r of a (d, n) key batch lives on the r-th data-axis slice and is
    sorted by the p ranks of its sort-axis subgroup.  ``p`` defaults to
    ``len(devices) // d``.

    Hierarchical form — ``shape=(p_outer, p_inner)`` builds the nested
    (``data_axis``?, *inter*, *intra*) mesh that hierarchy-aware ``psort``
    sorts over; the data axis leads only when ``d > 1``.  Flat PE index =
    ``outer · p_inner + inner``.

    ``devices`` are global ranks of the default process group (default:
    all of them, in order).  ``exclude`` drops ranks by their *position*
    in that list before the mesh is laid out — the elastic rescale path
    (``repro_torch.runtime.elastic.plan_sort_rescale``): the survivors
    renumber contiguously into the reduced mesh (pass the plan's
    ``p_new``/``mesh_shape`` as ``p``/``shape``).  The excluded ranks call
    this too: making the mesh is collective."""
    devs = list(devices) if devices is not None else list(
        range(world_ranks()))
    if exclude:
        bad = {int(i) for i in exclude}
        out_of_range = bad - set(range(len(devs)))
        if out_of_range:
            raise ValueError(f"exclude={sorted(bad)} names device positions "
                             f"outside 0..{len(devs) - 1}")
        devs = [dv for i, dv in enumerate(devs) if i not in bad]
    if d < 1:
        raise ValueError(f"d={d} must be >= 1")
    if shape is not None:
        if p is not None and p != int(np.prod(shape)):
            raise ValueError(f"p={p} inconsistent with shape={tuple(shape)}")
        p_o, p_i = (int(v) for v in shape)
        if p_o < 1 or p_i < 1 or d * p_o * p_i > len(devs):
            raise ValueError(f"requested mesh ({d}, {p_o}, {p_i}) needs "
                             f"{d * p_o * p_i} devices; have {len(devs)}")
        dims = (d, p_o, p_i) if d > 1 else (p_o, p_i)
        names = ((data_axis,) if d > 1 else ()) + tuple(mesh_axes)
        return make_mesh(np.array(devs[:d * p_o * p_i]).reshape(dims), names)
    p = p if p is not None else len(devs) // d
    if p < 1 or d * p > len(devs):
        raise ValueError(f"requested mesh ({d}, {p}) needs {d * p} devices; "
                         f"have {len(devs)}")
    return make_mesh(np.array(devs[:d * p]).reshape(d, p), (data_axis, axis))
