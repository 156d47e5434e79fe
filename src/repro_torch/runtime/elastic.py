"""Elastic rescale of a sorting mesh after PE failures (the sort half of
the reference's ``repro/runtime/elastic.py``, which is plain Python).

:func:`plan_sort_rescale` gives the reduced topology a ``psort`` fault lane
re-runs at: survivors rounded down to a power of two (the hypercube
layout every algorithm assumes), and on a nested mesh the inner axis kept
while it fits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SortRescalePlan:
    """Topology change for a sorting mesh after PE failures.

    ``p_new`` is the largest power of two ≤ the survivor count — the
    hypercube layout every sorting algorithm assumes (a p = 1024 sort that
    loses one PE restarts at p = 512, where ``select_algorithm`` may pick
    a different regime).  ``mesh_shape`` is the re-derived (outer, inner)
    nested factorization when the old mesh was hierarchical: the inner
    (intra-host) extent is preserved while it still fits, the outer axis
    absorbs the shrink; the axis names are unchanged.
    """

    p_old: int
    failed: Tuple[int, ...]
    p_new: int
    mesh_shape: Optional[Tuple[int, int]]
    notes: Tuple[str, ...]

    @property
    def survivors(self) -> int:
        return self.p_old - len(self.failed)


def plan_sort_rescale(p_old: int, failed,
                      mesh_shape: Optional[Tuple[int, int]] = None
                      ) -> SortRescalePlan:
    """Plan the sort-mesh topology after excluding ``failed`` PE ranks.

    Given the old axis extent (or nested ``mesh_shape``) and the flat
    ranks of the dead/straggling PEs, derive the reduced power-of-two
    extent the sort re-runs at.  Raises ``ValueError`` when no usable
    topology survives.
    """
    failed = tuple(sorted({int(f) for f in failed if 0 <= int(f) < p_old}))
    alive = p_old - len(failed)
    if alive < 1:
        raise ValueError(f"no surviving PEs (p={p_old}, failed={failed})")
    p_new = 1 << (alive.bit_length() - 1)          # largest pow2 ≤ alive
    notes = []
    if p_new != alive:
        notes.append(f"{alive} survivors rounded down to p={p_new} "
                     f"(hypercube layout)")
    new_shape = None
    if mesh_shape is not None:
        p_o, p_i = (int(v) for v in mesh_shape)
        p_i_new = min(p_i, p_new)
        p_o_new = p_new // p_i_new
        new_shape = (p_o_new, p_i_new)
        if new_shape != (p_o, p_i):
            notes.append(f"nested mesh {(p_o, p_i)} → {new_shape} "
                         f"(inner axis preserved while it fits)")
    return SortRescalePlan(int(p_old), failed, int(p_new), new_shape,
                           tuple(notes))
