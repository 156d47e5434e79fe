"""Collectives over the leading PE dimension (counterpart of the one-shot
paths of ``SimCollectives``, ``repro/core/comm.py``).

Every value is a tensor whose dimension 0 indexes the p PEs.  A collective
is a gather along that dimension through static tables: ``_group_tables``
turns ``axis_index_groups`` into ``members[i]`` (the PEs of i's group, in
group order) and ``rank[i]`` (i's position in it), exactly as the reference
does.  Integer results are bit-identical to the reference; the chunked
ring and the counting/trace decorators are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _group_tables(axis_index_groups, p: int):
    """(members (p, g), rank (p,)) for equal-sized groups partitioning the
    axis; one group in axis order when ``axis_index_groups`` is None."""
    if axis_index_groups is None:
        axis_index_groups = [list(range(p))]
    groups = [list(g) for g in axis_index_groups]
    size = len(groups[0])
    if any(len(g) != size for g in groups):
        raise ValueError("groups must be equal-sized")
    if sorted(pe for g in groups for pe in g) != list(range(p)):
        raise ValueError("groups must partition the axis")
    members = np.zeros((p, size), np.int64)
    rank = np.zeros((p,), np.int64)
    for g in groups:
        for r, pe in enumerate(g):
            members[pe] = g
            rank[pe] = r
    return members, rank


def _tables(x: torch.Tensor, axis_index_groups):
    members, rank = _group_tables(axis_index_groups, x.shape[0])
    return (torch.as_tensor(members, device=x.device),
            torch.as_tensor(rank, device=x.device))


def axis_index(p: int, device=None) -> torch.Tensor:
    """Every PE's own index: (p,) int64."""
    return torch.arange(p, device=device)


def ppermute(x: torch.Tensor, perm: Sequence) -> torch.Tensor:
    """``out[dst] = x[src]`` for each (src, dst) pair; PEs that receive
    nothing get zeros (the ``jax.lax.ppermute`` contract)."""
    out = torch.zeros_like(x)
    src = torch.as_tensor([s for s, _ in perm], device=x.device)
    dst = torch.as_tensor([d for _, d in perm], device=x.device)
    out[dst] = x[src]
    return out


def psum(x: torch.Tensor, axis_index_groups=None) -> torch.Tensor:
    """Sum over each PE's group, dtype preserved."""
    members, _ = _tables(x, axis_index_groups)
    return x[members].sum(dim=1, dtype=x.dtype)


def all_gather(x: torch.Tensor, axis_index_groups=None,
               tiled: bool = False) -> torch.Tensor:
    """``out[i]`` = the values of i's group members in group order:
    (p, g, ...) or, tiled, (p, g·n, ...)."""
    members, _ = _tables(x, axis_index_groups)
    out = x[members]
    return out.reshape((x.shape[0], -1) + tuple(x.shape[2:])) if tiled \
        else out


def all_to_all(x: torch.Tensor, axis_index_groups=None) -> torch.Tensor:
    """Tiled all_to_all with split/concat axis 0 of each PE's value.

    ``x`` is (p, g·blk, ...): PE i's block j goes to its group member j;
    ``out[i]`` concatenates, in group order, the block each member
    addressed to i (the block at i's rank) — the block order of the
    reference (``comm.py:884-889``)."""
    members, rank = _tables(x, axis_index_groups)
    p, g = members.shape
    if x.shape[1] % g:
        raise ValueError(f"dimension 1 ({x.shape[1]}) must split into "
                         f"{g} blocks")
    blocks = x.reshape((p, g, x.shape[1] // g) + tuple(x.shape[2:]))
    out = blocks[members, rank[:, None]]
    return out.reshape(x.shape)
