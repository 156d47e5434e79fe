"""Elastic scaling (counterpart of ``repro/runtime/elastic.py``): plan a
topology change at restart time, for training and for sorting.

:func:`plan_rescale` chooses the (pod, data, model) factorization of a new
chip count for training (plain Python, the reference's copy), and
:func:`rescale_state` restores the latest checkpoint onto the new
topology: one device, or a mesh, where it re-derives the shardings with
``make_shardings`` and every rank keeps its slices of the whole leaves.

:func:`plan_sort_rescale` gives the reduced topology a ``psort`` fault lane
re-runs at: survivors rounded down to a power of two (the hypercube
layout every algorithm assumes), and on a nested mesh the inner axis kept
while it fits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_shape: Dict[str, int]
    new_shape: Dict[str, int]
    grad_accum: int                 # steps to accumulate if batch ∤ data
    notes: Tuple[str, ...]

    @property
    def n_chips(self) -> int:
        return int(np.prod(list(self.new_shape.values())))


def plan_rescale(old_shape: Dict[str, int], n_chips: int, cfg,
                 global_batch: int) -> RescalePlan:
    """Choose a (pod, data, model) factorization of ``n_chips``.

    Keeps the model extent as close to the old one as the architecture's
    shardable dims allow, puts the rest in (pod ×) data.
    """
    notes = []
    model_old = old_shape.get("model", 1)
    # largest model extent ≤ old that divides n_chips and the arch dims
    divisors = [m for m in range(min(model_old, n_chips), 0, -1)
                if n_chips % m == 0 and _model_divides(cfg, m)]
    model = divisors[0] if divisors else 1
    if model != model_old:
        notes.append(f"model axis {model_old}→{model} "
                     f"(arch dims / chip count)")
    rest = n_chips // model
    pod = old_shape.get("pod", 1)
    if rest % pod != 0:
        pod = 1
        notes.append("pod axis collapsed to 1")
    data = rest // pod
    accum = 1
    unit = pod * data
    if global_batch % unit != 0:
        # smallest accum with global_batch % (unit·accum) == 0; when the
        # data extent itself does not divide the batch no such accum
        # exists, so pad the batch up to the next multiple of unit
        # (per-chip microbatch of 1, effective batch unit·accum).
        accum = next((a for a in range(1, max(1, global_batch // unit) + 1)
                      if global_batch % (unit * a) == 0), None)
        if accum is None:
            accum = -(-global_batch // unit)       # ceil: pad, never shrink
            notes.append(f"grad accumulation ×{accum} (batch {global_batch} "
                         f"∤ data extent {unit}; padded to {unit * accum})")
        else:
            notes.append(f"grad accumulation ×{accum} (batch {global_batch} "
                         f"∤ data extent {unit})")
    new = {"data": data, "model": model}
    if pod > 1:
        new = {"pod": pod, **new}
    return RescalePlan(dict(old_shape), new, accum, tuple(notes))


def _model_divides(cfg, m: int) -> bool:
    dims = [cfg.d_ff, cfg.n_heads * cfg.head_dim]
    if cfg.n_experts:
        dims.append(cfg.n_experts * cfg.d_ff)
    return all(d % m == 0 for d in dims if d)


def rescale_state(state, state_like, cfg, new_mesh, ckpt_manager,
                  step: Optional[int] = None):
    """Restore ``state_like``-shaped state from the checkpoint onto
    ``new_mesh`` with re-derived shardings (the elastic restart path):
    ``state_like`` holds this rank's slices on ``new_mesh`` (or, None,
    the whole state on one device), restored in place.  ``state`` (the
    state of the old topology) is not read, as in the reference."""
    from repro_torch.launch.steps import state_shardings
    return ckpt_manager.restore(state_like, step=step,
                                shardings=state_shardings(cfg, new_mesh))


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
