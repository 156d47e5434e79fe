"""Collectives over the leading PE dimension (counterpart of the one-shot
paths of ``SimCollectives``, ``repro/core/comm.py``), and the collective
trace (its ``CommEvent``, ``CommTrace``, ``tagged`` and ``counting``).

Every value is a tensor whose dimension 0 indexes the p PEs.  A collective
is a gather along that dimension through static tables: ``_group_tables``
turns ``axis_index_groups`` into ``members[i]`` (the PEs of i's group, in
group order) and ``rank[i]`` (i's position in it), exactly as the reference
does.  Integer results are bit-identical to the reference.
:func:`alltoall_stream` is the reference's streamed all_to_all, a ring
over the PE dimension that hands each arriving source block to a fold.

The trace.  The reference counts collectives at trace time, one event per
call site execution with the per-PE bytes of each pytree leaf read off its
static shape (``CountingCollectives``).  The port has no backend object:
while a :func:`counting` scope is open, :func:`ppermute`, :func:`psum`,
:func:`all_gather`, :func:`all_to_all` and :func:`alltoall_stream` (one
``all_to_all`` event per delivered block, tagged ``ovl:<phase>``, as the
reference's counting decorator records it) record into its trace, and so
does :func:`record`, which the algorithms call where they compute a
reference collective without one of those (the hypercube exchange is a
reshape and flip, the sample gather of SSort a reshape).  Each event
carries the reference's bytes: the port's count is int64 where the
reference's is int32, so a call site passes ``itemsize``.  Bytes come from
shapes only, so recording adds no device-to-host sync; outside a scope
nothing is recorded.  Tags come from the reference's :func:`tagged`
scopes only; the axis is the reference's ``"sort"``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

AXIS = "sort"                        # the reference's sort axis name


@dataclasses.dataclass(frozen=True)
class CommEvent:
    """One collective launch as seen at the call site (per PE): the
    reference's ``CommEvent``.  ``primitive`` is one of the four
    collectives, or the external lane's ``ext:h2d``/``ext:d2h`` copies."""
    primitive: str                    # ppermute | psum | all_gather | all_to_all
    bytes: int                        # payload bytes moved per PE (input side)
    group_size: Optional[int] = None  # participants; None = the full axis
    axis: Optional[str] = None        # mesh axis the launch targeted
    tag: Optional[str] = None         # algorithm phase (see :func:`tagged`)
    pe: Optional[int] = None          # target PE of an injected event


class CommTrace:
    """Every collective launched in a :func:`counting` scope, in order,
    with the reference's aggregates (``repro/core/comm.py``): one event per
    call site execution, so an unrolled loop gives one event per
    iteration, the launch count the cost model's α terms charge."""

    PRIMITIVES = ("ppermute", "psum", "all_gather", "all_to_all")
    IO_PRIMITIVES = ("ext:h2d", "ext:d2h")

    def __init__(self):
        self.events: List[CommEvent] = []

    def add(self, primitive: str, nbytes: int,
            group_size: Optional[int] = None, axis: Optional[str] = None,
            tag: Optional[str] = None, pe: Optional[int] = None):
        self.events.append(CommEvent(primitive, int(nbytes), group_size,
                                     axis, tag, pe))

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.primitive] = out.get(e.primitive, 0) + 1
        return out

    def payload_bytes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.primitive] = out.get(e.primitive, 0) + e.bytes
        return out

    def injected(self) -> List[CommEvent]:
        """Events that are not collectives (the lane's copies), kept out
        of every launch and wire-byte aggregate."""
        return [e for e in self.events if e.primitive not in self.PRIMITIVES]

    @property
    def launches(self) -> int:
        return sum(1 for e in self.events if e.primitive in self.PRIMITIVES)

    @property
    def p2p_launches(self) -> int:
        """Point-to-point steps (collective-permutes): the α term."""
        return sum(1 for e in self.events if e.primitive == "ppermute")

    @property
    def fused_launches(self) -> int:
        """Fused collectives: the α_c term."""
        return self.launches - self.p2p_launches

    def fused_hops(self, p: int) -> float:
        """Σ over fused launches of (group size)^⅓, the α_hop term."""
        return float(sum((e.group_size or p) ** (1.0 / 3.0)
                         for e in self.events
                         if e.primitive in self.PRIMITIVES
                         and e.primitive != "ppermute"))

    def wire_bytes(self) -> int:
        return sum(e.bytes for e in self.events
                   if e.primitive in self.PRIMITIVES)

    def io_bytes(self) -> int:
        """Host↔device volume of the external lane (``ext:h2d`` and
        ``ext:d2h`` events), the ``io_beta`` term's aggregate."""
        return sum(e.bytes for e in self.events
                   if e.primitive in self.IO_PRIMITIVES)

    def filter(self, primitive: Optional[str] = None,
               axis: Optional[str] = None,
               tag: Optional[str] = None) -> "CommTrace":
        """Sub-trace of the events matching every given criterion (None is
        ignored; ``axis=""``/``tag=""`` select events with it unset)."""
        sub = CommTrace()
        sub.events = [e for e in self.events
                      if (primitive is None or e.primitive == primitive)
                      and (axis is None or (e.axis or "") == axis)
                      and (tag is None or (e.tag or "") == tag)]
        return sub

    def axes(self) -> List[str]:
        return sorted({e.axis or "" for e in self.events})

    def tags(self) -> List[str]:
        return sorted({e.tag or "" for e in self.events})

    def by_axis(self) -> Dict[str, dict]:
        return {a: self.filter(axis=a).summary() for a in self.axes()}

    def by_tag(self) -> Dict[str, dict]:
        """Per-phase totals; the tags partition the events, so these sum
        back to :meth:`summary`."""
        return {t: self.filter(tag=t).summary() for t in self.tags()}

    def summary(self, p: Optional[int] = None) -> dict:
        s = {
            "launches": self.launches,
            "p2p_launches": self.p2p_launches,
            "fused_launches": self.fused_launches,
            "counts": self.counts(),
            "bytes": self.payload_bytes(),
            "wire_bytes": self.wire_bytes(),
        }
        if p is not None:
            s["fused_hops"] = self.fused_hops(p)
        return s


# the phase tag, and the traces of the open counting() scopes (innermost
# last: a nested scope records into the outer ones too, as the reference's
# CountingCollectives wrapping another does)
_TAG: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "repro_torch_comm_tag", default=None)
_TRACES: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_comm_traces", default=())


@contextlib.contextmanager
def tagged(tag: Optional[str]):
    """Label every collective recorded in this scope with a phase tag."""
    token = _TAG.set(tag)
    try:
        yield
    finally:
        _TAG.reset(token)


def current_tag() -> Optional[str]:
    return _TAG.get()


@contextlib.contextmanager
def counting():
    """Record every collective of the port run in this scope; yields the
    :class:`CommTrace` being filled."""
    trace = CommTrace()
    token = _TRACES.set(_TRACES.get() + (trace,))
    try:
        yield trace
    finally:
        _TRACES.reset(token)


def record(primitive: str, nbytes: int,
           group_size: Optional[int] = None) -> None:
    """One collective of the reference, ``nbytes`` per PE, into the open
    traces (nothing outside a :func:`counting` scope)."""
    for trace in _TRACES.get():
        trace.add(primitive, nbytes, group_size, axis=AXIS, tag=_TAG.get())


def note(primitive: str, x: torch.Tensor, itemsize: Optional[int] = None,
         axis_index_groups=None) -> None:
    """:func:`record` of a collective on the (p, ...) tensor ``x``, its
    bytes read off the shape only when a scope is open."""
    if _TRACES.get():
        record(primitive, pe_bytes(x, itemsize),
               _group_size(axis_index_groups))


def io_recorder(tag: str):
    """The external lane's ``io(direction, nbytes)`` callback recording
    ``ext:h2d``/``ext:d2h`` events under ``tag`` (the reference's
    ``_io_recorder``), or None when no scope is open."""
    traces = _TRACES.get()
    if not traces:
        return None

    def io(direction: str, nbytes: int) -> None:
        for trace in traces:
            trace.add(direction, nbytes, 1, tag=tag)
    return io


def pe_bytes(x: torch.Tensor, itemsize: Optional[int] = None) -> int:
    """Per-PE bytes of a (p, ...) tensor, at ``itemsize`` bytes an element
    where the reference's dtype differs from the port's."""
    per = x.numel() // x.shape[0] if x.shape[0] else 0
    return per * (itemsize or x.element_size())


def _group_size(axis_index_groups) -> Optional[int]:
    return None if axis_index_groups is None \
        else len(list(axis_index_groups)[0])


def _group_tables(axis_index_groups, p: int):
    """(members (p, g), rank (p,)) for equal-sized groups partitioning the
    axis; one group in axis order when ``axis_index_groups`` is None."""
    if axis_index_groups is None:
        axis_index_groups = [range(p)]
    groups = [list(g) for g in axis_index_groups]
    size = len(groups[0])
    if any(len(g) != size for g in groups):
        raise ValueError("groups must be equal-sized")
    table = np.asarray(groups, np.int64)                 # (G, size)
    flat = table.reshape(-1)
    if flat.size != p or not np.array_equal(np.sort(flat), np.arange(p)):
        raise ValueError("groups must partition the axis")
    members = np.empty((p, size), np.int64)
    rank = np.empty((p,), np.int64)
    members[flat] = np.repeat(table, size, axis=0)
    rank[flat] = np.tile(np.arange(size), len(groups))
    return members, rank


def _tables(x: torch.Tensor, axis_index_groups):
    """``_group_tables`` on ``x``'s device; the whole axis (None) as views
    of one ``arange``, so that no (p, p) table is built."""
    p = x.shape[0]
    if axis_index_groups is None:
        idx = torch.arange(p, device=x.device)
        return idx.expand(p, p), idx
    members, rank = _group_tables(axis_index_groups, p)
    return (torch.as_tensor(members, device=x.device),
            torch.as_tensor(rank, device=x.device))


def axis_index(p: int, device=None) -> torch.Tensor:
    """Every PE's own index: (p,) int64."""
    return torch.arange(p, device=device)


def ppermute(x: torch.Tensor, perm: Sequence) -> torch.Tensor:
    """``out[dst] = x[src]`` for each (src, dst) pair; PEs that receive
    nothing get zeros (the ``jax.lax.ppermute`` contract)."""
    note("ppermute", x)
    out = torch.zeros_like(x)
    src = torch.as_tensor([s for s, _ in perm], device=x.device)
    dst = torch.as_tensor([d for _, d in perm], device=x.device)
    out[dst] = x[src]
    return out


def psum(x: torch.Tensor, axis_index_groups=None) -> torch.Tensor:
    """Sum over each PE's group, dtype preserved."""
    note("psum", x, axis_index_groups=axis_index_groups)
    members, _ = _tables(x, axis_index_groups)
    return x[members].sum(dim=1, dtype=x.dtype)


def all_gather(x: torch.Tensor, axis_index_groups=None,
               tiled: bool = False) -> torch.Tensor:
    """``out[i]`` = the values of i's group members in group order:
    (p, g, ...) or, tiled, (p, g·n, ...)."""
    note("all_gather", x, axis_index_groups=axis_index_groups)
    members, _ = _tables(x, axis_index_groups)
    out = x[members]
    return out.reshape((x.shape[0], -1) + tuple(x.shape[2:])) if tiled \
        else out


def all_to_all(x: torch.Tensor, axis_index_groups=None,
               itemsize: Optional[int] = None) -> torch.Tensor:
    """Tiled all_to_all with split/concat axis 0 of each PE's value.

    ``x`` is (p, g·blk, ...): PE i's block j goes to its group member j;
    ``out[i]`` concatenates, in group order, the block each member
    addressed to i (the block at i's rank) — the block order of the
    reference (``comm.py:884-889``).  ``itemsize`` is the bytes of an
    element in the reference, where its dtype is narrower than the
    port's (the trace records those)."""
    note("all_to_all", x, itemsize, axis_index_groups)
    members, rank = _tables(x, axis_index_groups)
    p, g = members.shape
    if x.shape[1] % g:
        raise ValueError(f"dimension 1 ({x.shape[1]}) must split into "
                         f"{g} blocks")
    blocks = x.reshape((p, g, x.shape[1] // g) + tuple(x.shape[2:]))
    out = blocks[members, rank[:, None]]
    return out.reshape(x.shape)


def alltoall_stream(leaves: Sequence[torch.Tensor], fold, init, gsize: int,
                    axis_index_groups=None):
    """All_to_all delivered one source block at a time: the reference's
    ``alltoall_stream`` as its ring (``_stream_ring``).

    Every leaf is (P, gsize·blk, ...), laid out as the input of
    :func:`all_to_all`.  At step t every PE i takes the block addressed to
    it by group member (rank(i) + t) mod gsize and calls ``fold(acc,
    chunks, src)``: ``chunks`` holds one (P, blk, ...) tensor per leaf and
    ``src`` (P,) is each PE's source group rank.  Returns the final
    ``acc``.  Delivery starts at a PE's own rank and wraps, the
    reference's order, so a fold that stages blocks by source is
    insensitive to it.

    On CUDA the gather of step t + 1 runs on a side stream while the fold
    of step t runs on the current one, ordered by events.  Recorded as
    gsize ``all_to_all`` events of 1/gsize of the leaves' per-PE bytes
    each, tagged ``ovl:<tag>``: together the barrier exchange's bytes."""
    x0 = leaves[0]
    P, dev = x0.shape[0], x0.device
    if any(v.shape[1] % gsize for v in leaves):
        raise ValueError(f"dimension 1 must split into {gsize} blocks")
    traces = _TRACES.get()
    if traces:
        per_chunk = sum(pe_bytes(v) for v in leaves) // max(gsize, 1)
        tag = f"ovl:{_TAG.get() or ''}"
        for trace in traces:
            for _ in range(gsize):
                trace.add("all_to_all", per_chunk,
                          _group_size(axis_index_groups), axis=AXIS, tag=tag)
    members, rank = _tables(x0, axis_index_groups)
    if members.shape[1] != gsize:
        raise ValueError(f"groups of {members.shape[1]} PEs, not {gsize}")
    blocks = [v.reshape((P, gsize, v.shape[1] // gsize) + tuple(v.shape[2:]))
              for v in leaves]

    def gather(t):
        src = (rank + t) % gsize
        pe = torch.gather(members, 1, src[:, None])[:, 0]
        return [b[pe, rank] for b in blocks], src

    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    if side is None:
        acc = init
        for t in range(gsize):
            chunks, src = gather(t)
            acc = fold(acc, chunks, src)
        return acc
    main = torch.cuda.current_stream(dev)
    side.wait_stream(main)                  # the leaves are written

    def prefetch(t):
        with torch.cuda.stream(side):
            out = gather(t)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    nxt = prefetch(0)
    acc = init
    for t in range(gsize):
        (chunks, src), ready = nxt
        main.wait_event(ready)
        for c in chunks + [src]:
            c.record_stream(main)
        if t + 1 < gsize:
            nxt = prefetch(t + 1)           # in flight while step t folds
        acc = fold(acc, chunks, src)
    return acc
