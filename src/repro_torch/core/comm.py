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

Two scopes change the layout.  :func:`batched` ``(d)`` makes dimension 0
hold d independent sorts of p PEs each, PE i of sort r at row ``r·p + i``
(the reference's ``sim_map(mesh=(d, p))``): every collective runs within
each sort's rows and :func:`axis_index` gives i.  :func:`nested` views the
sort axis as an (outer × inner) pair of real axes (the reference's
``NestedCollectives``): every collective on the sort axis runs as the
reference's view runs it, stage by stage over the real axes, and the trace
records those stages with their real axes.

The distributed backend.  Inside :func:`distributed` (the reference's
``LaxCollectives`` under ``shard_map``) a rank of ``torch.distributed`` is
one PE: dimension 0 holds its own row, and each collective runs on the
process group of the mesh axis it names (under :func:`nested` the mesh's
two real axes).  ``psum`` on integers is an ``all_reduce``, on floats and
bools a gather summed in group order (the emulated PEs' bits);
``all_gather`` and ``all_to_all`` are ``all_gather_single`` and
``all_to_all_single`` over the whole axis, and a grouped variant, a
``ppermute``, the hypercube exchange (:func:`swap`) and each step of the
streamed ring are one ``all_to_all_single`` with zero splits to every rank
outside the group.  No process group is created past the mesh's own, so
ranks a mesh leaves out never take part after its making.  The few reads
across PEs that are not collectives of the reference (the samples SSort
pools, the merge-pass bound of the streamed exchange, the reassembled
result) go through unrecorded helpers (:func:`sort_rows`,
:func:`agree_max`, :func:`gather_ranks`, :func:`gather_pes`).  A float
``psum`` or ``all_to_all`` of a tensor that takes gradients is recorded
by autograd (:func:`collective`): its backward is its transpose, a
``psum`` of the gradient (the reference's ``psum`` transposes so) and an
``all_to_all`` back along the same blocks.

The trace.  The reference counts collectives at trace time, one event per
call site execution with the per-PE bytes of each pytree leaf read off its
static shape (``CountingCollectives``).  The port has no backend object:
while a :func:`counting` scope is open, :func:`ppermute`, :func:`psum`,
:func:`all_gather`, :func:`all_to_all` and :func:`alltoall_stream` (one
``all_to_all`` event per delivered block, tagged ``ovl:<phase>``, as the
reference's counting decorator records it) record into its trace, and so
does :func:`record`, which the algorithms call where they compute a
reference collective without one of those (on emulated PEs the hypercube
exchange is a reshape and flip, the sample gather of SSort a reshape).
Each event carries the reference's bytes: the port's count is int64 where
the reference's is int32, so a call site passes ``itemsize``.  Bytes come from
shapes only, so recording adds no device-to-host sync; outside a scope
nothing is recorded.  Tags come from the reference's :func:`tagged`
scopes only; the axis is the reference's ``"sort"``, or under
:func:`nested` the real axis of each stage.

Faults.  The reference injects faults with a decorator backend
(``FaultyCollectives``) that sees every launch its wrapped backend
receives.  Here a :func:`faulty` scope installs a
:class:`FaultyCollectives` state, and every launch of a reference
collective asks it first, whether or not a :func:`counting` scope is open:
each recorded event (:func:`record`: the four collectives, every stage of a
nested one, the exchanges the algorithms compute without them) and each
:func:`alltoall_stream` (one launch, however many chunk events it
records).  The check runs before the launch's own event is recorded, as
the reference's faulty decorator sits outside its counting one, so a
killed launch leaves its ``fault:kill`` event and not its own.  The
external lane's ``ext:h2d``/``ext:d2h`` copies are never injection points.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as tdist

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


@contextlib.contextmanager
def recording(trace: CommTrace):
    """Record into ``trace`` alone in this scope, not into the open
    :func:`counting` scopes: the fault lane's counter over the plain
    backend, which the reference builds afresh and does not nest in the
    ambient one."""
    token = _TRACES.set((trace,))
    try:
        yield trace
    finally:
        _TRACES.reset(token)


# ---------------------------------------------------------------------------
# Fault injection: PEFailure, the fault plan and the faulty scope
# ---------------------------------------------------------------------------


class PEFailure(RuntimeError):
    """A (simulated) PE died mid-collective.

    Raised by :class:`FaultyCollectives` when a planned kill fires, at the
    launch that observes it, before that launch runs: the attempt stops
    there, as a dead participant aborts a collective for its whole group.
    Carries the identity the rescale path needs
    (``repro_torch.runtime.elastic.plan_sort_rescale``): the flat PE rank,
    the phase tag, and the primitive/axis of the launch that observed the
    failure.  ``psort``'s fault lane also raises it with
    ``phase="straggler"`` to route a watchdog-flagged PE down the same
    exclude-and-rescale path.
    """

    def __init__(self, pe: int, phase: Optional[str] = None,
                 primitive: Optional[str] = None, axis: Optional[str] = None):
        self.pe = int(pe)
        self.phase = phase
        self.primitive = primitive
        self.axis = axis
        super().__init__(
            f"PE {self.pe} failed during {primitive or 'collective'} "
            f"(axis={axis!r}, phase={phase!r})")


@dataclasses.dataclass(frozen=True)
class PEFault:
    """One planned fault: kill or delay PE ``pe``.

    ``tag`` names the phase (:func:`tagged`) whose collectives trigger the
    fault; ``None`` matches any phase, so the fault fires at the first
    collective of the run.  ``after`` skips that many matching launches
    first — the fault fires on the (``after`` + 1)-th.  ``factor`` is the
    simulated step-time stretch of a ``delay`` fault, the straggler signal
    ``repro_torch.runtime.failures.flag_stragglers`` thresholds against
    ``k_mad`` deviations.

    PE indices are flat ranks in the topology of the attempt the fault
    fires in; after a rescale the fault lane drops plans whose ``pe`` fell off
    the shrunken mesh.
    """

    kind: str                       # "kill" | "delay"
    pe: int
    tag: Optional[str] = None       # phase tag to fire at; None = any
    after: int = 0                  # matching launches to let pass first
    factor: float = 4.0             # step-time stretch of a delay

    def __post_init__(self):
        if self.kind not in ("kill", "delay"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


def kill_pe(pe: int, tag: Optional[str] = None, after: int = 0) -> PEFault:
    """A fault that kills PE ``pe`` at phase ``tag``."""
    return PEFault("kill", int(pe), tag, int(after))


def delay_pe(pe: int, factor: float = 4.0, tag: Optional[str] = None,
             after: int = 0) -> PEFault:
    """A fault that stretches PE ``pe``'s simulated step time ×``factor``."""
    return PEFault("delay", int(pe), tag, int(after), float(factor))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic set of :class:`PEFault` to execute during one run."""

    faults: Tuple[PEFault, ...] = ()

    def __bool__(self) -> bool:
        return bool(self.faults)

    def surviving(self, pe: int, p_new: int) -> "FaultPlan":
        """The plan after PE ``pe`` was excluded and the topology shrank
        to ``p_new``: drop its faults and any targeting off-mesh ranks."""
        return FaultPlan(tuple(f for f in self.faults
                               if f.pe != pe and f.pe < p_new))


class FaultyCollectives:
    """The state of one :func:`faulty` scope, executing a ``FaultPlan``
    (the reference's decorator backend of that name, without a backend to
    wrap).

    Every launch of a reference collective in the scope calls
    :meth:`_inject` first.  A matching *kill* records a ``fault:kill``
    event and raises :class:`PEFailure`; a matching *delay* records
    ``fault:delay`` and keeps the largest stretch factor per PE in
    :attr:`fired_delays` (read by ``psort``'s fault lane to make the
    per-PE step times of the watchdog lane).  Injected events go to
    ``trace``: by default the innermost open :func:`counting` trace, so
    one :class:`CommTrace` interleaves them with the regular launches.
    """

    def __init__(self, plan, trace: Optional[CommTrace] = None):
        self.plan = plan if isinstance(plan, FaultPlan) \
            else FaultPlan(tuple(plan))
        if trace is None:
            traces = _TRACES.get()
            trace = traces[-1] if traces else CommTrace()
        self.trace = trace
        self.fired_delays: Dict[int, float] = {}
        self._launches: Dict[PEFault, int] = {}
        self._done: Set[PEFault] = set()

    def _inject(self, primitive: str, axis_name) -> None:
        tag = _TAG.get()
        pending = [f for f in self.plan.faults if f not in self._done
                   and (f.tag is None or f.tag == tag)]
        # kills outrank delays within one launch: the PE dies before its
        # slowdown could be observed
        for f in sorted(pending, key=lambda f: f.kind != "kill"):
            seen = self._launches.get(f, 0) + 1
            self._launches[f] = seen
            if seen <= f.after:
                continue
            self._done.add(f)
            if f.kind == "kill":
                self.trace.add("fault:kill", 0, axis=str(axis_name),
                               tag=tag, pe=f.pe)
                raise PEFailure(f.pe, phase=tag, primitive=primitive,
                                axis=str(axis_name))
            self.trace.add("fault:delay", 0, axis=str(axis_name),
                           tag=tag, pe=f.pe)
            self.fired_delays[f.pe] = max(self.fired_delays.get(f.pe, 1.0),
                                          f.factor)


_FAULTY: contextvars.ContextVar[Optional[FaultyCollectives]] = \
    contextvars.ContextVar("repro_torch_comm_faulty", default=None)


@contextlib.contextmanager
def faulty(plan, trace: Optional[CommTrace] = None):
    """Execute ``plan`` (a :class:`FaultPlan`, or faults) at every launch
    of a reference collective in this scope, counted or not; yields the
    :class:`FaultyCollectives` so the caller can read its
    :attr:`~FaultyCollectives.fired_delays`.  Injected events go to
    ``trace`` (default: the innermost open :func:`counting` trace, else
    a trace of their own)."""
    fc = FaultyCollectives(plan, trace)
    token = _FAULTY.set(fc)
    try:
        yield fc
    finally:
        _FAULTY.reset(token)


def _inject(primitive: str, axis) -> None:
    """The open :func:`faulty` scope's check of one launch, if any."""
    fc = _FAULTY.get()
    if fc is not None:
        fc._inject(primitive, axis)


@contextlib.contextmanager
def _unobserved():
    """Neither record nor inject: the launches inside are parts of one
    that was recorded and checked as a whole."""
    traces, fault = _TRACES.set(()), _FAULTY.set(None)
    try:
        yield
    finally:
        _FAULTY.reset(fault)
        _TRACES.reset(traces)


# ---------------------------------------------------------------------------
# The layout of the PE dimension: a batch of d independent sorts, and the
# nested (outer × inner) view of the sort axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NestedAxes:
    """One virtual flat axis of p = p_o·p_i PEs over an (outer, inner) pair
    of real axes, PE ``o·p_i + i`` (the reference's ``NestedCollectives``,
    ``repro/core/comm.py``): a collective on the virtual axis runs as
    collectives on the real axes, element for element equal to the flat
    one, and the trace records those, each with its real axis."""
    outer: str
    p_o: int
    inner: str
    p_i: int

    @property
    def p(self) -> int:
        return self.p_o * self.p_i

    def bit_axis(self, j: int) -> str:
        """The real axis the hypercube partner ``f ^ 2^j`` differs on."""
        return self.inner if (1 << j) < self.p_i else self.outer

    def factor_perm(self, perm):
        """A flat permutation as (real axis, permutation on that axis); it
        must move every inner slice alike (or every outer slice alike)."""
        po, pi = self.p_o, self.p_i
        pairs = [(int(s), int(d)) for s, d in perm]
        srcs = sorted(s for s, _ in pairs)
        dsts = sorted(d for _, d in pairs)
        if srcs == dsts == list(range(self.p)):
            if all(s // pi == d // pi for s, d in pairs):
                maps = [{} for _ in range(po)]
                for s, d in pairs:
                    maps[s // pi][s % pi] = d % pi
                if all(m == maps[0] for m in maps):
                    return self.inner, sorted(maps[0].items())
            if all(s % pi == d % pi for s, d in pairs):
                maps = [{} for _ in range(pi)]
                for s, d in pairs:
                    maps[s % pi][s // pi] = d // pi
                if all(m == maps[0] for m in maps):
                    return self.outer, sorted(maps[0].items())
        raise NotImplementedError(
            f"virtual-axis ppermute does not factor through one of the "
            f"nested axes {self.axes}: {perm}")

    def classify_groups(self, axis_index_groups):
        """(mode, groups): ``"inner"`` (groups inside one inner slice, the
        same pattern in every slice: the inner axis alone) or ``"outer"``
        (groups that are unions of whole outer slices: an inner stage over
        the whole inner axis, then the outer axis); ``groups`` are along
        that real axis, None for all of it."""
        po, pi = self.p_o, self.p_i
        if axis_index_groups is None:
            return "outer", None
        groups = [[int(v) for v in g] for g in axis_index_groups]
        if len(groups) == 1 and groups[0] == list(range(self.p)):
            return "outer", None
        gsize = len(groups[0])
        if gsize <= pi and all(pe // pi == g[0] // pi
                               for g in groups for pe in g):
            per_slice = [[] for _ in range(po)]
            for g in groups:
                per_slice[g[0] // pi].append(tuple(pe % pi for pe in g))
            pattern = sorted(per_slice[0])
            if all(sorted(s) == pattern for s in per_slice):
                inner = [list(g) for g in pattern]
                if len(inner) == 1 and inner[0] == list(range(pi)):
                    return "inner", None
                return "inner", inner
        if gsize % pi == 0:
            outer = []
            for g in groups:
                outs = sorted({pe // pi for pe in g})
                if g != [o * pi + i for o in outs for i in range(pi)]:
                    break
                outer.append(outs)
            else:
                if len(outer) == 1 and outer[0] == list(range(po)):
                    return "outer", None
                return "outer", outer
        raise NotImplementedError(
            f"axis_index_groups do not align with the nested axes "
            f"{self.axes}: {axis_index_groups}")

    @property
    def axes(self):
        return ((self.outer, self.p_o), (self.inner, self.p_i))

    def flat_groups(self, axis: str, groups):
        """Groups along the real ``axis`` (None: all of it) as groups of
        flat PEs, one set for every slice of the other axis."""
        po, pi = self.p_o, self.p_i
        if axis == self.inner:
            return [[o * pi + i for i in g] for o in range(po)
                    for g in (groups or [list(range(pi))])]
        if axis == self.outer:
            return [[o * pi + i for o in g] for i in range(pi)
                    for g in (groups or [list(range(po))])]
        raise ValueError(f"no axis {axis!r} in the nested axes {self.axes}")

    def flat_perm(self, axis: str, perm):
        """A permutation of the real ``axis`` as one of the flat PEs."""
        po, pi = self.p_o, self.p_i
        if axis == self.inner:
            return [(o * pi + s, o * pi + d) for o in range(po)
                    for s, d in perm]
        if axis == self.outer:
            return [(s * pi + i, d * pi + i) for i in range(pi)
                    for s, d in perm]
        raise ValueError(f"no axis {axis!r} in the nested axes {self.axes}")


@dataclasses.dataclass(frozen=True)
class _View:
    d: int = 1                              # independent sorts (rows of p)
    nest: Optional[NestedAxes] = None       # the sort axis's nested view
    dist: Optional["Distributed"] = None    # one PE per rank (distributed)


_VIEW: contextvars.ContextVar[_View] = contextvars.ContextVar(
    "repro_torch_comm_view", default=_View())


@contextlib.contextmanager
def batched(d: int):
    """Lay the PE dimension out as d independent sorts: PE i of sort r is
    row ``r·p + i``.  Every collective then runs within each sort's p rows
    (the reference's ``sim_map(mesh=(d, p))``), and :func:`axis_index`
    gives i, so each sort draws what it draws alone."""
    if d < 1:
        raise ValueError(f"d={d} must be at least 1")
    token = _VIEW.set(dataclasses.replace(_VIEW.get(), d=int(d)))
    try:
        yield
    finally:
        _VIEW.reset(token)


@contextlib.contextmanager
def nested(virtual_axis: str, axes):
    """View the sort axis (``virtual_axis``, the reference's ``"sort"``)
    as the ``axes = ((outer, p_o), (inner, p_i))`` pair: in this scope every
    collective on it runs as the reference's ``NestedCollectives`` runs
    it, stage by stage on the real axes, and records those stages."""
    if virtual_axis != AXIS:
        raise ValueError(f"the port's collectives run on the axis "
                         f"{AXIS!r}, not {virtual_axis!r}")
    axes = tuple((str(n), int(s)) for n, s in axes)
    if len(axes) != 2:
        raise NotImplementedError(
            f"NestedCollectives supports exactly 2 nested axes; got {axes}")
    (outer, p_o), (inner, p_i) = axes
    view = NestedAxes(outer, p_o, inner, p_i)
    token = _VIEW.set(dataclasses.replace(_VIEW.get(), nest=view))
    try:
        yield view
    finally:
        _VIEW.reset(token)


def bit_axis(j: int) -> str:
    """The axis a hypercube exchange along bit j targets: the sort axis,
    or under :func:`nested` the real axis bit j belongs to."""
    nest = _VIEW.get().nest
    return AXIS if nest is None else nest.bit_axis(j)


def _virtual(axis: Optional[str]) -> Optional[NestedAxes]:
    """The nested view when ``axis`` means the (virtual) sort axis."""
    return _VIEW.get().nest if axis in (None, AXIS) else None


def _real(axis: str) -> NestedAxes:
    """The nested view that holds the real ``axis``."""
    nest = _VIEW.get().nest
    if nest is None:
        raise ValueError(f"no axis {axis!r} outside a nested scope")
    return nest


def _flat_groups(axis_index_groups, axis: Optional[str]):
    if axis in (None, AXIS):
        return axis_index_groups
    return _real(axis).flat_groups(axis, axis_index_groups)


def _split(x: torch.Tensor):
    """(d, p) of ``x``'s leading dimension."""
    d = _VIEW.get().d
    if x.shape[0] % d:
        raise ValueError(f"{x.shape[0]} rows do not split into {d} sorts")
    return d, x.shape[0] // d


# ---------------------------------------------------------------------------
# The distributed backend: one PE per rank of a torch.distributed group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Axis:
    """One mesh axis as this rank sees it: the process group of its slice,
    the global ranks along it in axis order, and this rank's position."""
    group: object
    ranks: Tuple[int, ...]
    index: int
    slot: Tuple[int, ...]        # group rank of each axis position
    name: str = AXIS             # the mesh axis, as the wire counts name it

    @classmethod
    def of(cls, group, ranks, index, name: str = AXIS) -> "_Axis":
        ranks = tuple(int(r) for r in ranks)
        if group is None:        # the dry transport: no process group
            return cls(None, ranks, int(index), tuple(range(len(ranks))),
                       name)
        slot = tuple(tdist.get_group_rank(group, r) for r in ranks)
        return cls(group, ranks, int(index), slot, name)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def members(self, axis_index_groups) -> List[int]:
        """The axis positions of this rank's group, in group order."""
        if axis_index_groups is None:
            return list(range(self.size))
        for g in axis_index_groups:
            g = [int(v) for v in g]
            if self.index in g:
                return g
        raise ValueError(f"axis position {self.index} is in no group of "
                         f"{axis_index_groups}")


@dataclasses.dataclass(frozen=True)
class Distributed:
    """The ``torch.distributed`` layout of a :func:`distributed` scope: the
    sort axis (None where a :func:`nested` view makes it virtual) and every
    named axis of the mesh."""
    sort: Optional[_Axis]
    dims: Dict[str, _Axis]

    @classmethod
    def of(cls, mesh_or_group, axis: str = AXIS) -> "Distributed":
        """From a ``DeviceMesh`` (its ``axis`` dimension is the sort axis,
        when it has one) or a ``ProcessGroup`` (the sort axis itself, in
        group-rank order).  Under :func:`dry` a mesh without process
        groups (``dist.sharding.MeshLayout``) stands for one: its rank's
        axes carry nothing."""
        dry_layout = _DRY[0] and not hasattr(mesh_or_group, "get_group")
        if not dry_layout and (not tdist.is_available()
                               or not tdist.is_initialized()):
            raise RuntimeError("the distributed backend needs an initialised "
                               "torch.distributed process group")
        if not hasattr(mesh_or_group, "mesh_dim_names"):
            group = mesh_or_group
            ranks = tdist.get_process_group_ranks(group)
            return cls(_Axis.of(group, ranks, tdist.get_rank(group), axis),
                       {})
        mesh = mesh_or_group
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"this rank is not in the mesh "
                             f"{mesh.mesh.tolist()}")
        dims = {}
        for k, name in enumerate(mesh.mesh_dim_names):
            at = list(coord)
            at[k] = slice(None)
            dims[name] = _Axis.of(None if dry_layout else mesh.get_group(name),
                                  mesh.mesh[tuple(at)].tolist(), coord[k],
                                  name)
        return cls(dims.get(axis), dims)

    def axis(self, name: Optional[str]) -> _Axis:
        if name in (None, AXIS):
            if self.sort is None:
                raise ValueError("the sort axis is not a mesh axis: open a "
                                 "nested view of it")
            return self.sort
        if name not in self.dims:
            raise ValueError(f"no axis {name!r} in the mesh "
                             f"{sorted(self.dims)}")
        return self.dims[name]


@contextlib.contextmanager
def distributed(mesh_or_group, axis: str = AXIS):
    """Run every collective on ``torch.distributed``: this rank is one PE,
    its tensors hold its own row (dimension 0 of size 1), and each
    collective runs on the process group of the axis it names, the sort
    axis being ``mesh_or_group``'s ``axis`` dimension (or the group).  A
    :func:`nested` view inside it runs on the mesh's two real axes.  The
    trace records what the emulated PEs record, event for event; the
    transport's own launches are never recorded."""
    view = dataclasses.replace(_VIEW.get(),
                               dist=Distributed.of(mesh_or_group, axis))
    token = _VIEW.set(view)
    try:
        yield view.dist
    finally:
        _VIEW.reset(token)


def _dist() -> Optional[Distributed]:
    return _VIEW.get().dist


class _Collective(torch.autograd.Function):
    """``fwd`` of tensors, linear in them, whose transpose is ``bwd``."""

    @staticmethod
    def forward(ctx, fwd, bwd, *xs):
        ctx.bwd = bwd
        return tuple(fwd(xs))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(ctx.bwd(tuple(g.contiguous()
                                                  for g in gs)))


def collective(fwd, bwd, *xs) -> tuple:
    """``fwd(xs)``, a tuple of tensors computed from the tuple ``xs`` by a
    collective linear in them; where autograd records any of ``xs``, the
    call is recorded with ``bwd`` (gradients of the outputs → gradients
    of ``xs``, run on every rank in the same order) as its backward."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return _Collective.apply(fwd, bwd, *xs)
    return tuple(fwd(xs))


def _one_row(x: torch.Tensor) -> None:
    if x.shape[0] != 1:
        raise ValueError(f"a rank holds one PE's row, not {x.shape[0]}")


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous 1-D tensor the transport takes (bool as
    uint8: NCCL takes no bool)."""
    x = x.contiguous()
    return (x.view(torch.uint8) if x.dtype == torch.bool else x).reshape(-1)


def _unwire(y: torch.Tensor, dtype) -> torch.Tensor:
    return y.view(torch.bool) if dtype == torch.bool else y


# ---------------------------------------------------------------------------
# The transport's seam: what it carries, counted, and the dry transport
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Wire:
    """What the transport of this process carried while counted.

    ``sent``/``received``: this rank's bytes to and from the other ranks
    (an all-gather of b bytes a rank over n ranks sends and receives
    b·(n − 1), an all-to-all of b bytes over g ranks b·(g − 1)/g, an
    all-reduce 2·b·(n − 1)/n).  ``wire``: per kind the bytes by the
    reference's conventions (``repro/launch/hlo_cost.py``): an all-gather
    its result, an all-reduce twice its operand, the others the larger of
    operand and result; ``counts`` one per collective, ``by_axis`` the
    wire bytes per mesh axis, ``moved`` operand plus result bytes of each
    collective.  A collective the port builds from others (an all-reduce
    as a reduce-scatter and an all-gather) counts as one of its own kind
    (:func:`carried_as`); its parts add only to ``sent``/``received``."""
    sent: int = 0
    received: int = 0
    moved: int = 0
    wire: Dict[str, int] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    by_axis: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, axis: str, operand: int, result: int) -> None:
        wire = result if kind == "all-gather" else (
            2 * operand if kind == "all-reduce" else max(operand, result))
        self.wire[kind] = self.wire.get(kind, 0) + wire
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.by_axis[axis] = self.by_axis.get(axis, 0) + wire
        self.moved += operand + result


# the open counters and the dry transport's depth: process-wide, because
# autograd runs a collective's backward on its device's thread
_WIRES: List[Wire] = []
_WIRES_LOCK = threading.Lock()
_DRY = [0]
_SEAM = threading.local()


@contextlib.contextmanager
def count_wire():
    """Count what the transport carries in this scope (every thread of the
    process): yields the :class:`Wire`."""
    w = Wire()
    with _WIRES_LOCK:
        _WIRES.append(w)
    try:
        yield w
    finally:
        with _WIRES_LOCK:
            _WIRES.remove(w)


@contextlib.contextmanager
def dry():
    """The dry transport: every collective of a :func:`distributed` scope
    moves nothing and returns a meta tensor of the shape and dtype it
    would return, counted as if it had run; a ``dist.sharding.MeshLayout``
    stands for a mesh.  What a rank's step would send is reckoned without
    a process group or a device.  It carries meta stand-ins only: a
    collective on a tensor of any other device raises while it is open
    (the scope is process-wide)."""
    _DRY[0] += 1
    try:
        yield
    finally:
        _DRY[0] -= 1


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@contextlib.contextmanager
def carried_as(kind: str, axis: str, operand: int, result: int):
    """The collectives in this scope are parts of one ``kind`` collective
    over mesh ``axis`` of ``operand`` and ``result`` bytes a rank: it is
    counted once, as that kind, and its parts add only their bytes sent
    and received."""
    outer = getattr(_SEAM, "kind", None)
    if outer is None:
        with _WIRES_LOCK:
            for w in _WIRES:
                w.add(kind, axis, operand, result)
    _SEAM.kind = outer or kind
    try:
        yield
    finally:
        _SEAM.kind = outer


@contextlib.contextmanager
def _carry(kind: str, ax: _Axis, x: torch.Tensor, operand: int, result: int,
           sent: int, received: int):
    """One launch of the transport on ``ax`` with operand ``x``: counted,
    with the bytes this rank sends and receives, unless it is part of a
    launch already counted; yields whether the transport is dry (then
    ``x`` must be a meta stand-in)."""
    if _DRY[0] and x.device.type != "meta":
        raise RuntimeError(
            f"a {kind} on a {x.device.type} tensor inside comm.dry(): the "
            "dry transport carries meta stand-ins only")
    depth = getattr(_SEAM, "depth", 0)
    if depth == 0:
        with carried_as(kind, ax.name, operand, result), _WIRES_LOCK:
            for w in _WIRES:
                w.sent += sent
                w.received += received
    _SEAM.depth = depth + 1
    try:
        yield bool(_DRY[0])
    finally:
        _SEAM.depth = depth


_gather_single = getattr(tdist, "all_gather_single", None) or getattr(
    tdist, "all_gather_into_tensor", None)


def _d_gather(ax: _Axis, members: Sequence[int], x: torch.Tensor
              ) -> torch.Tensor:
    """The values of ``members`` (axis positions, this rank among them),
    stacked in their order: ``(len(members),) + x.shape``."""
    n, b = len(members), _nbytes(x)
    with _carry("all-gather", ax, x, b, n * b, b * (n - 1),
                b * (n - 1)) as is_dry:
        if is_dry:
            return x.new_empty((n,) + tuple(x.shape))
        return _d_gather_now(ax, members, x)


def _d_gather_now(ax: _Axis, members: Sequence[int], x: torch.Tensor
                  ) -> torch.Tensor:
    if list(members) == list(range(ax.size)):
        src = _wire(x)
        out = src.new_empty(ax.size * src.numel())
        _gather_single(out, src, group=ax.group)
        out = out.view(ax.size, src.numel())[list(ax.slot)]
        return _unwire(out, x.dtype).reshape((ax.size,) + tuple(x.shape))
    return _d_alltoall(ax, members, x.expand((len(members),) + tuple(
        x.shape)))


def _d_alltoall(ax: _Axis, members: Sequence[int], blocks: torch.Tensor
                ) -> torch.Tensor:
    """Block j of ``blocks`` to member j; returns the blocks the members
    sent here, in member order."""
    g, b = len(members), _nbytes(blocks)
    moved = b * (g - 1) // g
    with _carry("all-to-all", ax, blocks, b, b, moved, moved) as is_dry:
        if is_dry:
            return blocks.new_empty(blocks.shape)
        return _d_alltoall_now(ax, members, blocks)


def _d_alltoall_now(ax: _Axis, members: Sequence[int], blocks: torch.Tensor
                    ) -> torch.Tensor:
    members = list(members)
    g = len(members)
    src = _wire(blocks).view(g, blocks.numel() // g)
    m = src.shape[1]
    if members == list(range(ax.size)):
        inv = [0] * g
        for k, s in enumerate(ax.slot):
            inv[s] = k
        out = torch.empty_like(src)
        tdist.all_to_all_single(out, src[inv].contiguous(), group=ax.group)
        out = out[list(ax.slot)]
    else:
        got = _d_exchange(ax, dict(zip(members, src)),
                          {k: m for k in members}, src)
        out = torch.stack([got[k] for k in members])
    return _unwire(out, blocks.dtype).reshape(blocks.shape)


def _d_exchange(ax: _Axis, sends: Dict[int, torch.Tensor],
                recv: Dict[int, int], like: torch.Tensor
                ) -> Dict[int, torch.Tensor]:
    """Point-to-point through one ``all_to_all_single`` of the axis's
    group with zero splits to every other rank: ``sends`` maps an axis
    position to the 1-D wire tensor it gets, ``recv`` a position to the
    number of elements it sends here; ``like`` gives their dtype and
    device.  Returns what arrived, by position."""
    item = like.element_size()
    out_b = sum(v.numel() for k, v in sends.items() if k != ax.index) * item
    in_b = sum(n for k, n in recv.items() if k != ax.index) * item
    with _carry("collective-permute", ax, like, out_b, in_b, out_b,
                in_b) as is_dry:
        if is_dry:
            return {k: like.new_empty(int(n)) for k, n in recv.items()}
        return _d_exchange_now(ax, sends, recv, like)


def _d_exchange_now(ax: _Axis, sends: Dict[int, torch.Tensor],
                    recv: Dict[int, int], like: torch.Tensor
                    ) -> Dict[int, torch.Tensor]:
    size_in, size_out = [0] * ax.size, [0] * ax.size
    for k, v in sends.items():
        size_in[ax.slot[k]] = v.numel()
    for k, n in recv.items():
        size_out[ax.slot[k]] = int(n)
    order = sorted(sends, key=lambda k: ax.slot[k])
    inp = torch.cat([sends[k] for k in order]) if order else like.new_empty(0)
    out = like.new_empty(sum(size_out))
    tdist.all_to_all_single(out, inp, size_out, size_in, group=ax.group)
    parts = torch.split(out, size_out)
    return {k: parts[ax.slot[k]] for k in recv}


def _d_permute(ax: _Axis, x: torch.Tensor, dst: Optional[int],
               src: Optional[int]) -> torch.Tensor:
    """Send ``x`` to axis position ``dst`` and take the value ``src``
    sends here (None: nothing), zeros where nothing arrives."""
    w = _wire(x)
    got = _d_exchange(ax, {} if dst is None else {dst: w},
                      {} if src is None else {src: w.numel()}, w)
    if src is None:
        return torch.zeros_like(x)
    return _unwire(got[src], x.dtype).view(x.shape)


def _d_real(j: int):
    """(axis, position of this rank's partner) of the hypercube exchange
    along bit j: on the sort axis, or on the real axis of bit j."""
    dist_, nest = _dist(), _VIEW.get().nest
    if nest is None:
        ax = dist_.axis(AXIS)
        return ax, ax.index ^ (1 << j)
    name = nest.bit_axis(j)
    ax = dist_.axis(name)
    bit = j if name == nest.inner else j - (nest.p_i.bit_length() - 1)
    return ax, ax.index ^ (1 << bit)


def swap(x: torch.Tensor, j: int) -> torch.Tensor:
    """Every PE receives the value of its hypercube partner ``i ^ 2^j``
    (unrecorded: the caller records the reference's exchange).  Emulated
    PEs swap the halves of every 2^(j+1) block of rows, inside each sort
    of a batch; a rank exchanges with its partner's rank."""
    if _dist() is None:
        rest = tuple(x.shape[1:])
        return x.reshape((x.shape[0] >> (j + 1), 2, 1 << j) + rest).flip(
            1).reshape(x.shape)
    _one_row(x)
    ax, partner = _d_real(j)
    return _d_permute(ax, x, partner, partner)


def sorts(rows: int, p: int) -> int:
    """How many sorts the ``rows`` PEs held here belong to: rows / p
    emulated, one on a rank."""
    return 1 if _dist() is not None else rows // p


def sort_rows(x: torch.Tensor, p: int) -> torch.Tensor:
    """Each sort's PE values concatenated in PE order, one row per sort
    held here: (sorts, p·m) of the (P, m) values (unrecorded: the caller
    records the reference's gather)."""
    if _dist() is None:
        return x.reshape(-1, p * x.shape[1])
    with _unobserved():
        return all_gather(x, tiled=True)


def _sort_axes(names: Sequence[str]) -> List[str]:
    """The real axes behind ``names``: the sort axis is its inner, then
    its outer axis under :func:`nested`."""
    nest = _VIEW.get().nest
    out = []
    for name in names:
        if name in (None, AXIS) and nest is not None:
            out += [nest.inner, nest.outer]
        else:
            out.append(name)
    return out


def gather_ranks(t: torch.Tensor, axes: Sequence[str] = (AXIS,)
                 ) -> torch.Tensor:
    """The 1-D ``t`` of every rank across ``axes`` (the sort axis, then
    e.g. the data axis), concatenated with the first axis varying fastest:
    PE order, then row order.  Lengths may differ between ranks; each rank
    broadcasts its part in turn.  Unrecorded: the reassembly of a result,
    which the reference's global arrays hold without a collective."""
    dist_ = _dist()
    for name in _sort_axes(axes):
        ax = dist_.axis(name)
        n = torch.tensor([t.numel()], dtype=torch.int64, device=t.device)
        sizes = _d_gather(ax, list(range(ax.size)), n).reshape(-1).tolist()
        parts = []
        for k, size in enumerate(sizes):
            buf = _wire(t) if k == ax.index else t.new_empty(
                (size,), dtype=torch.uint8 if t.dtype == torch.bool
                else t.dtype)
            tdist.broadcast(buf, src=ax.ranks[k], group=ax.group)
            parts.append(_unwire(buf, t.dtype))
        t = torch.cat(parts)
    return t


def gather_pes(x: torch.Tensor) -> torch.Tensor:
    """(p, ...) of every PE's (1, ...) value on the sort axis, in PE
    order, unrecorded (emulated PEs hold them all already)."""
    if _dist() is None:
        return x
    with _unobserved():
        return all_gather(x)[0]


def agree_max(x: torch.Tensor) -> int:
    """The largest value of ``x`` over every PE of the sort, on the host
    (unrecorded: an agreement the emulated PEs read off their rows)."""
    dist_ = _dist()
    local = x.max() if x.numel() else x.new_zeros(())
    if dist_ is None:
        return int(local)
    m = local.reshape(1).to(torch.int64)
    for name in _sort_axes([AXIS]):
        tdist.all_reduce(m, op=tdist.ReduceOp.MAX,
                         group=dist_.axis(name).group)
    return int(m)


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


def record(primitive: str, nbytes: int,
           group_size: Optional[int] = None, axis: str = AXIS) -> None:
    """One launch of a reference collective, ``nbytes`` per PE: checked
    by the open :func:`faulty` scope, then recorded into the open traces
    (nothing outside both scopes)."""
    _inject(primitive, axis)
    for trace in _TRACES.get():
        trace.add(primitive, nbytes, group_size, axis=axis, tag=_TAG.get())


def _stages(primitive: str, nbytes: int, axis_index_groups, axis):
    """The events of one collective: itself, or under :func:`nested` on
    the sort axis the stages the reference's view runs (all_to_all: the
    outer axis first; psum and all_gather: the inner axis first, whose
    gather multiplies the outer stage's bytes by p_i)."""
    nest = _virtual(axis)
    if nest is None:
        return [(primitive, nbytes, _group_size(axis_index_groups),
                 axis or AXIS)]
    if primitive == "ppermute":
        raise ValueError("a ppermute under a nested view names the real "
                         "axis it permutes (comm.bit_axis)")
    mode, g = nest.classify_groups(axis_index_groups)
    if mode == "inner":
        return [(primitive, nbytes, _group_size(g), nest.inner)]
    inner = (primitive, nbytes, None, nest.inner)
    if primitive == "all_to_all":
        return [(primitive, nbytes, _group_size(g), nest.outer), inner]
    outer_bytes = nbytes * nest.p_i if primitive == "all_gather" else nbytes
    return [inner, (primitive, outer_bytes, _group_size(g), nest.outer)]


def note(primitive: str, x: torch.Tensor, itemsize: Optional[int] = None,
         axis_index_groups=None, axis: Optional[str] = None) -> None:
    """:func:`record` of a collective on the (P, ...) tensor ``x`` (on the
    sort axis, or the real ``axis``), its bytes read off the shape only
    when a :func:`counting` or :func:`faulty` scope is open; under
    :func:`nested` the stages of the view."""
    if _TRACES.get() or _FAULTY.get() is not None:
        nbytes = pe_bytes(x, itemsize)
        for ev in _stages(primitive, nbytes, axis_index_groups, axis):
            record(*ev)


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
    """Per-PE bytes of a (P, ...) tensor, at ``itemsize`` bytes an element
    where the reference's dtype differs from the port's."""
    per = x.numel() // x.shape[0] if x.shape[0] else 0
    return per * (itemsize or x.element_size())


def _group_size(axis_index_groups) -> Optional[int]:
    return None if axis_index_groups is None \
        else len(list(axis_index_groups)[0])


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


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


def _tables(p: int, axis_index_groups, device):
    """``_group_tables`` on ``device``; the whole axis (None) as views of
    one ``arange``, so that no (p, p) table is built."""
    if axis_index_groups is None:
        idx = torch.arange(p, device=device)
        return idx.expand(p, p), idx
    members, rank = _group_tables(axis_index_groups, p)
    return (torch.as_tensor(members, device=device),
            torch.as_tensor(rank, device=device))


def axis_index(p: int, device=None) -> torch.Tensor:
    """Every PE's own index within its sort: (d·p,) int64, or on a rank
    (1,), its position on the sort axis (under :func:`nested` ``o·p_i +
    i`` of its real positions)."""
    view = _VIEW.get()
    if view.dist is None:
        return torch.arange(p, device=device).repeat(view.d)
    if view.nest is None:
        ax = view.dist.axis(AXIS)
        size, me = ax.size, ax.index
    else:
        size = view.nest.p
        me = (view.dist.axis(view.nest.outer).index * view.nest.p_i
              + view.dist.axis(view.nest.inner).index)
    if size != p:
        raise ValueError(f"the sort axis has {size} ranks, not p = {p}")
    return torch.full((1,), me, dtype=torch.int64, device=device)


def ppermute(x: torch.Tensor, perm: Sequence,
             axis: Optional[str] = None) -> torch.Tensor:
    """``out[dst] = x[src]`` for each (src, dst) pair of the sort axis (or
    of the real ``axis`` of a nested view) in every sort; PEs that
    receive nothing get zeros (the ``jax.lax.ppermute`` contract).  On the
    nested sort axis the permutation must factor through one real axis."""
    nest = _virtual(axis)
    if nest is not None:
        axis, perm = nest.factor_perm(perm)
    note("ppermute", x, axis=axis or AXIS)
    if _dist() is not None:
        _one_row(x)
        ax = _dist().axis(axis)
        dst = [int(t) for s, t in perm if int(s) == ax.index]
        src = [int(s) for s, t in perm if int(t) == ax.index]
        return _d_permute(ax, x, dst[0] if dst else None,
                          src[0] if src else None)
    if axis not in (None, AXIS):
        perm = _real(axis).flat_perm(axis, perm)
    d, p = _split(x)
    out = torch.zeros_like(x)
    src = torch.as_tensor([s for s, _ in perm], device=x.device)
    dst = torch.as_tensor([t for _, t in perm], device=x.device)
    rest = tuple(x.shape[1:])
    out.view((d, p) + rest)[:, dst] = x.reshape((d, p) + rest)[:, src]
    return out


def psum(x: torch.Tensor, axis_index_groups=None,
         axis: Optional[str] = None) -> torch.Tensor:
    """Sum over each PE's group, dtype preserved; nested: the inner axis,
    then the outer."""
    nest = _virtual(axis)
    if nest is not None:
        mode, g = nest.classify_groups(axis_index_groups)
        if mode == "inner":
            return psum(x, g, axis=nest.inner)
        return psum(psum(x, axis=nest.inner), g, axis=nest.outer)
    note("psum", x, axis_index_groups=axis_index_groups, axis=axis)
    if _dist() is not None:
        _one_row(x)
        ax = _dist().axis(axis)
        b = _nbytes(x)
        if axis_index_groups is None and not (x.dtype.is_floating_point
                                              or x.dtype == torch.bool):
            out = x.clone()
            moved = 2 * b * (ax.size - 1) // ax.size
            with _carry("all-reduce", ax, out, b, b, moved,
                        moved) as is_dry:
                if not is_dry:
                    tdist.all_reduce(out, group=ax.group)
            return out
        members = ax.members(axis_index_groups)

        def total(xs):
            # floats and bools: the group's values summed in group order,
            # the emulated PEs' sum bit for bit
            with carried_as("all-reduce", ax.name, b, b):
                g = _d_gather(ax, members, xs[0])
            return (g.reshape((1, 1) + tuple(g.shape[:1]) + tuple(
                x.shape[1:])).sum(dim=2, dtype=x.dtype).reshape(x.shape),)
        return collective(total, total, x)[0]
    d, p = _split(x)
    groups = _flat_groups(axis_index_groups, axis)
    rest = tuple(x.shape[1:])
    if groups is None and not (x.dtype.is_floating_point
                               or x.dtype == torch.bool):
        # the whole axis on integers: one sum per sort, in any order the
        # same bits, with no (p, p) gather
        return x.reshape((d, p) + rest).sum(
            dim=1, keepdim=True, dtype=x.dtype).expand(
            (d, p) + rest).reshape(x.shape).contiguous()
    members, _ = _tables(p, groups, x.device)
    return x.reshape((d, p) + rest)[:, members].sum(
        dim=2, dtype=x.dtype).reshape(x.shape)


def all_gather(x: torch.Tensor, axis_index_groups=None, tiled: bool = False,
               axis: Optional[str] = None) -> torch.Tensor:
    """``out[i]`` = the values of i's group members in group order:
    (P, g, ...) or, tiled, (P, g·n, ...); nested: a gather over the whole
    inner axis, then one of those over the outer axis's groups."""
    P, rest = x.shape[0], tuple(x.shape[1:])
    nest = _virtual(axis)
    if nest is not None:
        mode, g = nest.classify_groups(axis_index_groups)
        if mode == "inner":
            return all_gather(x, g, tiled, axis=nest.inner)
        gi = all_gather(x, axis=nest.inner)             # (P, p_i, ...)
        out = all_gather(gi, g, axis=nest.outer)        # (P, g_o, p_i, ...)
        out = out.reshape((P, -1) + rest)               # flat group order
    else:
        note("all_gather", x, axis_index_groups=axis_index_groups,
             axis=axis)
        if _dist() is not None:
            _one_row(x)
            ax = _dist().axis(axis)
            out = _d_gather(ax, ax.members(axis_index_groups), x)
            return out.reshape((P, -1) + rest[1:] if tiled
                               else (P, out.shape[0]) + rest)
        d, p = _split(x)
        members, _ = _tables(p, _flat_groups(axis_index_groups, axis),
                             x.device)
        out = x.reshape((d, p) + rest)[:, members].reshape(
            (P, members.shape[1]) + rest)
    return out.reshape((P, -1) + rest[1:]) if tiled else out


def all_to_all(x: torch.Tensor, axis_index_groups=None,
               itemsize: Optional[int] = None,
               axis: Optional[str] = None) -> torch.Tensor:
    """Tiled all_to_all with split/concat axis 0 of each PE's value.

    ``x`` is (P, g·blk, ...): PE i's block j goes to its group member j;
    ``out[i]`` concatenates, in group order, the block each member
    addressed to i (the block at i's rank) — the block order of the
    reference (``comm.py:884-889``).  ``itemsize`` is the bytes of an
    element in the reference, where its dtype is narrower than the
    port's (the trace records those).  Nested: an all_to_all over the
    outer axis's groups (chunk o of a PE's blocks goes to outer slice o),
    then one over the whole inner axis, as the reference's view runs it."""
    P, rest = x.shape[0], tuple(x.shape[2:])
    nest = _virtual(axis)
    if nest is not None:
        mode, g = nest.classify_groups(axis_index_groups)
        if mode == "inner":
            return all_to_all(x, g, itemsize, axis=nest.inner)
        pi = nest.p_i
        g_out = nest.p_o if g is None else len(g[0])
        if x.shape[1] % (g_out * pi):
            raise ValueError(f"dimension 1 ({x.shape[1]}) must split into "
                             f"{g_out * pi} blocks")
        blk = x.shape[1] // (g_out * pi)
        y = all_to_all(x, g, itemsize, axis=nest.outer)
        y = y.reshape((P, g_out, pi, blk) + rest).transpose(1, 2).reshape(
            (P, pi * g_out * blk) + rest)
        z = all_to_all(y, None, itemsize, axis=nest.inner)
        return z.reshape((P, pi, g_out, blk) + rest).transpose(1, 2).reshape(
            x.shape)
    note("all_to_all", x, itemsize, axis_index_groups, axis)
    if _dist() is not None:
        _one_row(x)
        ax = _dist().axis(axis)
        members = ax.members(axis_index_groups)
        if x.shape[1] % len(members):
            raise ValueError(f"dimension 1 ({x.shape[1]}) must split into "
                             f"{len(members)} blocks")

        def exchange(xs):        # its own transpose: the blocks go back
            return (_d_alltoall(ax, members, xs[0].reshape(
                (len(members), -1) + rest)).reshape(x.shape),)
        return collective(exchange, exchange, x)[0]
    d, p = _split(x)
    members, rank = _tables(p, _flat_groups(axis_index_groups, axis),
                            x.device)
    g = members.shape[1]
    if x.shape[1] % g:
        raise ValueError(f"dimension 1 ({x.shape[1]}) must split into "
                         f"{g} blocks")
    blocks = x.reshape((d, p, g, x.shape[1] // g) + rest)
    return blocks[:, members, rank[:, None]].reshape(x.shape)


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
    each, tagged ``ovl:<tag>``: together the barrier exchange's bytes.

    Under :func:`nested` it is the reference's fallback, as its view has
    no streamed path: one :func:`all_to_all` of the leaves, then the blocks
    folded in ascending source order.  The view hands the leaves to the
    inner axis as one collective (one event of their bytes together) and
    decomposes them leaf by leaf otherwise.  A :func:`faulty` scope checks
    the stream once (on the flat axis), or each launch the view makes."""
    x0 = leaves[0]
    P, dev = x0.shape[0], x0.device
    if any(v.shape[1] % gsize for v in leaves):
        raise ValueError(f"dimension 1 must split into {gsize} blocks")
    nest = _VIEW.get().nest
    if nest is not None:
        mode, g = nest.classify_groups(axis_index_groups)
        scope = contextlib.nullcontext()
        if mode == "inner":
            record("all_to_all", sum(pe_bytes(v) for v in leaves),
                   _group_size(g), nest.inner)
            scope = _unobserved()           # recorded: the leaves as one
        with scope:
            recv = [all_to_all(v, axis_index_groups).reshape(
                (P, gsize, v.shape[1] // gsize) + tuple(v.shape[2:]))
                for v in leaves]
        acc = init
        for s in range(gsize):
            acc = fold(acc, [r[:, s] for r in recv],
                       torch.full((P,), s, dtype=torch.int64, device=dev))
        return acc
    _inject("all_to_all", AXIS)             # one launch, one check
    traces = _TRACES.get()
    if traces:
        per_chunk = sum(pe_bytes(v) for v in leaves) // max(gsize, 1)
        tag = f"ovl:{_TAG.get() or ''}"
        for trace in traces:
            for _ in range(gsize):
                trace.add("all_to_all", per_chunk,
                          _group_size(axis_index_groups), axis=AXIS, tag=tag)
    if _dist() is not None:
        return _d_stream(leaves, fold, init, gsize, axis_index_groups)
    d, p = _split(x0)
    members, rank = _tables(p, axis_index_groups, dev)
    if members.shape[1] != gsize:
        raise ValueError(f"groups of {members.shape[1]} PEs, not {gsize}")
    blocks = [v.reshape((d, p, gsize, v.shape[1] // gsize)
                        + tuple(v.shape[2:])) for v in leaves]

    def gather(t):
        src = (rank + t) % gsize
        pe = torch.gather(members, 1, src[:, None])[:, 0]
        return ([b[:, pe, rank].reshape((P,) + tuple(b.shape[3:]))
                 for b in blocks], src.repeat(d))

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


def _d_stream(leaves, fold, init, gsize: int, axis_index_groups):
    """:func:`alltoall_stream` on a rank: the reference's ring, one
    point-to-point step per source.  At step t this rank sends the block
    it addressed to group member (rank − t) mod gsize and folds the block
    member (rank + t) mod gsize addressed to it, the ring's delivery
    order; each block crosses once."""
    ax = _dist().axis(AXIS)
    for v in leaves:
        _one_row(v)
    members = ax.members(axis_index_groups)
    if len(members) != gsize:
        raise ValueError(f"groups of {len(members)} PEs, not {gsize}")
    r = members.index(ax.index)
    blocks = [_wire(v).view(gsize, v.numel() // gsize) for v in leaves]
    dev = leaves[0].device
    acc = init
    for t in range(gsize):
        to, frm = members[(r - t) % gsize], members[(r + t) % gsize]
        chunks = []
        for v, b in zip(leaves, blocks):
            got = _d_exchange(ax, {to: b[(r - t) % gsize]},
                              {frm: b.shape[1]}, b)[frm]
            chunks.append(_unwire(got, v.dtype).view(
                (1, v.shape[1] // gsize) + tuple(v.shape[2:])))
        acc = fold(acc, chunks, torch.full((1,), (r + t) % gsize,
                                           dtype=torch.int64, device=dev))
    return acc
