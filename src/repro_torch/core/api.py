"""Public API: ``psort`` on the sim and the distributed backends with
every algorithm of the reference, ``"auto"`` selection from a
:class:`CostModel`, the external lane, the streamed exchange
(``overlap=True``), batched (d, n) keys, nested (outer × inner) meshes and
``trace_collectives`` (counterpart of ``repro/core/api.py``).

The sim backend runs p PEs on one device; here every PE is a row of a
(p, C) tensor and the per-PE body of the reference (``_sort_body``) runs
once over all rows.  ``backend="shard_map"`` is the reference's production
backend on ``torch.distributed``: each rank of a mesh is one PE and runs
the same body on its one row, its collectives on the process groups of
the mesh's axes (``comm.distributed``), SPMD (:func:`_psort_distributed`).
The port's default stays ``"sim"``, where the reference's is
``"shard_map"``: one card is one device.  A batch of d sorts is d·p rows,
sort r's PE i at row ``r·p + i`` (``comm.batched``), and a nested mesh runs
the same body with every collective decomposed over the two real axes
(``comm.nested``).
``SortConfig(external=ExternalPolicy(budget))`` streams shards larger than
``budget`` through the device in runs (``external.py``), exactly when the
reference does.  ``SortConfig(fault_policy=FaultPolicy(...))`` runs the
sort under planned PE kills and stragglers, re-running it on the
surviving power-of-two topology after each (``_psort_faulty``).  The port
runs on ``cuda`` unless the caller passes ``device="cpu"``, where every
kernel wrapper takes its plain version; it never moves to the CPU on its
own.

The reference's legacy call styles work as there, each with one
``DeprecationWarning``: ``psort(keys, 8, ...)`` (a bare int is p),
``psort(keys, p=8, algorithm=..., ...)`` (keywords split into the
config's fields and ``algo_kw`` by :meth:`SortConfig.from_kwargs`) and
``trace_collectives(n, p, algorithm, capacity_factor)``; mixing them with
a ``SortConfig`` raises ``TypeError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import traceback
import warnings
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from . import comm, selection
from .bitonic import bitonic
from .external import (ExternalPolicy, _get_keys, _psort_external_once,
                       _put_keys)
from .gatherm import allgather_merge_sort, gather_merge
from .rams import as_int32_bits, nested_level_bits, rams
from .rfis import rfis
from .rquick import rquick
from .samplesort import samplesort
from .types import (int_to_key, key_to_int, make_shard, pad_value,
                    resolve_device)
from ..dist.sharding import make_mesh, mesh_sizes, sort_mesh, world_ranks
from ..runtime.elastic import plan_sort_rescale
from ..runtime.failures import flag_stragglers, run_with_restarts

BACKENDS = ("shard_map", "sim")
# the ported algorithms: each one's function and the keywords it takes
_RAMS_KW = ("seed", "levels", "level_bits", "oversample", "tie_break",
            "shuffle", "slot_factor", "overlap")
_RQUICK_KW = ("seed", "window_k", "robust", "shuffle", "tie_break",
              "capacity", "dims")
_SSORT_KW = ("seed", "robust", "sample_factor", "slot_factor",
             "oracle_splitters", "overlap")
_PORTED = {
    "rams": (rams, _RAMS_KW),
    "ntb-ams": (functools.partial(rams, tie_break=False), _RAMS_KW),
    "rquick": (rquick, _RQUICK_KW),
    "ntb-quick": (functools.partial(rquick, robust=False), _RQUICK_KW),
    "rfis": (rfis, ("capacity",)),
    "ssort": (samplesort, _SSORT_KW),
    "ns-ssort": (functools.partial(samplesort, robust=False), _SSORT_KW),
    "bitonic": (bitonic, ()),
    "gatherm": (gather_merge, ("dims",)),
    "allgatherm": (allgather_merge_sort, ("dims",)),
}
# their output lives on PE 0 (gatherm) or on every PE (allgatherm)
_CONCENTRATED = ("gatherm", "allgatherm")
# the algorithms with a slotted all_to_all, which overlap=True streams
_OVERLAP_ALGOS = ("rams", "ntb-ams", "ssort", "ns-ssort")


@dataclasses.dataclass(frozen=True, init=False)
class SortConfig:
    """The knobs of one sort, the reference's.

    ``p`` (PE count, a power of two), ``backend`` (``"sim"``, the default
    here: p PEs emulated as rows of one device; or ``"shard_map"``: one PE
    per rank of ``torch.distributed``, see :func:`psort`), ``algorithm``,
    ``capacity_factor`` (slack of the per-PE buffers), ``levels`` (RAMS
    and NTB-AMS level count, also taken with ``"auto"``; any other
    algorithm refuses it) and ``algo_kw`` (the algorithm's keywords, as a
    sorted tuple of pairs, lists made tuples).  The algorithms and their
    keywords:

    - ``"auto"`` (the default): the reference's ``select_algorithm`` over
      ``cost_model`` (a :class:`selection.CostModel`; None is the card's
      profile, ``selection.DEFAULT_MODEL``) picks ``gatherm``, ``rfis``,
      ``rquick`` or ``rams``, and ``"external"`` where n/p passes the
      ``external`` budget;
    - ``"rams"``, ``"ntb-ams"`` (RAMS without tie-breaking): ``seed``,
      ``levels``, ``level_bits``, ``oversample``, ``tie_break``,
      ``shuffle``, ``slot_factor``, ``overlap``;
    - ``"rquick"``, ``"ntb-quick"`` (no shuffle, no tie-breaking):
      ``seed``, ``window_k``, ``robust``, ``shuffle``, ``tie_break``,
      ``capacity``, ``dims``;
    - ``"rfis"``: ``capacity`` (of the output shards);
    - ``"ssort"``, ``"ns-ssort"`` (no random shuffle): ``seed``,
      ``robust``, ``sample_factor``, ``slot_factor``, ``oracle_splitters``
      (a tuple of p − 1 nondecreasing u64 words: a zero-extended u32 key
      each, or the unsigned word of an 8-byte key), ``overlap``;
    - ``"bitonic"``: none;
    - ``"gatherm"`` (everything to PE 0), ``"allgatherm"`` (everything to
      every PE): ``dims``.

    ``overlap=True`` streams the slotted exchanges of RAMS, NTB-AMS, SSort
    and NS-SSort and of the external lane's pass C, with the same result;
    the other algorithms run unchanged.  ``external`` (an
    :class:`ExternalPolicy`, or None) and ``algorithm="external"`` select
    the out-of-core lane.  ``mesh_shape=(p_o, p_i)`` runs the sort on a
    nested mesh of p = p_o·p_i PEs (``p`` may be left out), its real axes
    named by ``mesh_axes`` (outer, inner); ``data_axis`` names the axis of
    a batch of 2-D keys, as in the reference (the sim layout reads no
    name).  ``fault_policy`` (a ``repro_torch.runtime.FaultPolicy``, which
    psort writes its trace and attempts back to; it takes no part in
    equality) runs the fault lane (sim only, as in the reference).
    ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``, shard_map
    only; no part in equality) and ``axis`` (the name of its sort axis)
    lay the distributed backend out (``repro_torch.dist.sort_mesh``).
    :meth:`from_kwargs` builds a config from the flat keywords of the
    reference's legacy call style."""

    p: Optional[int] = None
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)
    axis: str = "sort"
    backend: str = "sim"
    algorithm: str = "auto"
    capacity_factor: float = 2.0
    levels: Optional[int] = None
    algo_kw: tuple = ()
    external: Optional[ExternalPolicy] = None
    cost_model: Optional[selection.CostModel] = None
    overlap: bool = False
    data_axis: str = "data"
    mesh_shape: Optional[tuple] = None
    mesh_axes: tuple = ("inter", "intra")
    fault_policy: Optional[object] = dataclasses.field(default=None,
                                                       compare=False)

    def __init__(self, p=None, mesh=None, axis="sort", backend="sim",
                 algorithm="auto", capacity_factor=2.0, levels=None,
                 algo_kw=(), external=None, cost_model=None, overlap=False,
                 data_axis="data", mesh_shape=None,
                 mesh_axes=("inter", "intra"), fault_policy=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected "
                             f"{BACKENDS}")
        if external is not None and not isinstance(external,
                                                   ExternalPolicy):
            raise TypeError(f"external must be an ExternalPolicy, got "
                            f"{type(external).__name__}")
        if cost_model is not None and not isinstance(cost_model,
                                                     selection.CostModel):
            raise TypeError(f"cost_model must be a CostModel, got "
                            f"{type(cost_model).__name__}")
        if overlap not in (True, False):
            raise TypeError(f"overlap must be True or False, got "
                            f"{overlap!r}")
        if algorithm not in _PORTED and algorithm not in ("auto",
                                                          "external"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if levels is not None and algorithm not in ("auto", "rams",
                                                    "ntb-ams"):
            raise ValueError(f"levels= applies to the multi-level AMS "
                             f"family (or 'auto'), not "
                             f"algorithm={algorithm!r}")
        kw = dict(algo_kw)
        known = _PORTED[algorithm][1] if algorithm in _PORTED else \
            {k for _, names in _PORTED.values() for k in names}
        unknown = set(kw) - set(known)
        if unknown:
            raise ValueError(f"unknown {algorithm.upper()} keywords "
                             f"{sorted(unknown)}")
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
        for name, value in (("p", p), ("mesh", mesh), ("axis", axis),
                            ("backend", backend),
                            ("algorithm", algorithm),
                            ("capacity_factor", capacity_factor),
                            ("levels", levels),
                            ("algo_kw", tuple(sorted(kw.items()))),
                            ("external", external),
                            ("cost_model", cost_model),
                            ("overlap", bool(overlap)),
                            ("data_axis", data_axis),
                            ("mesh_shape", None if mesh_shape is None
                             else tuple(int(v) for v in mesh_shape)),
                            ("mesh_axes", tuple(mesh_axes)),
                            ("fault_policy", fault_policy)):
            object.__setattr__(self, name, value)

    @classmethod
    def from_kwargs(cls, **kw) -> "SortConfig":
        """Split a flat legacy-style kwarg dict into config fields plus
        ``algo_kw`` (anything that is not a field)."""
        cfg = {k: kw.pop(k) for k in list(kw) if k in _CONFIG_FIELDS}
        return cls(algo_kw=kw, **cfg)

    def replace(self, **changes) -> "SortConfig":
        return dataclasses.replace(self, **changes)


# the reference's field names: what a legacy keyword call passes as a
# field rather than as an algorithm keyword
_CONFIG_FIELDS = frozenset(
    f.name for f in dataclasses.fields(SortConfig)) - {"algo_kw"}


def _coerce_config(config, legacy: dict, caller: str) -> SortConfig:
    """Resolve the (config | legacy kwargs) call styles to one SortConfig,
    as the reference does: exactly one ``DeprecationWarning`` per
    legacy-style call, and ``TypeError`` where the styles mix.  A bare int
    ``config`` is the old positional ``p``."""
    if isinstance(config, (int, np.integer)):      # legacy positional p
        legacy = {"p": int(config), **legacy}
        config = None
    if config is not None:
        if legacy:
            raise TypeError(
                f"{caller}() got both config= and legacy keyword arguments "
                f"{sorted(legacy)}; move them into the SortConfig")
        if not isinstance(config, SortConfig):
            raise TypeError(f"{caller}() config must be a SortConfig, got "
                            f"{type(config).__name__}")
        return config
    if not legacy:
        return SortConfig()
    warnings.warn(
        f"{caller}(keys, p=..., algorithm=..., ...) keyword style is "
        f"deprecated; pass {caller}(..., config=SortConfig(...)) instead "
        f"(field mapping: README 'Migrating to SortConfig')",
        DeprecationWarning, stacklevel=3)
    return SortConfig.from_kwargs(**legacy)


def _sort_body(keys2d, row_counts, p, capacity, out_capacity, algorithm,
               algo_kw):
    """The reference's per-PE body over all rows at once: p, or d·p in a
    ``comm.batched`` scope.

    Returns (keys (rows, ≤ out_capacity) int32 words, idx int32 rows
    holding uint32 indices, count (rows,), overflow (rows,)); what the
    output capacity cuts counts in the overflow."""
    per = keys2d.shape[1]
    dev = keys2d.device
    # the index payload proves permutation-ness (uint32 values); it
    # restarts in every sort of a batch, whose perm indexes its own row
    base = comm.axis_index(p, dev)[:, None] * per
    idx = as_int32_bits(base + torch.arange(per, device=dev)[None, :])
    with record_function("make_shard"):
        shard = make_shard(keys2d, count=row_counts, capacity=capacity,
                           vals={"idx": idx})
    del idx
    out, overflow = _PORTED[algorithm][0](shard, p, **algo_kw)
    overflow = overflow + torch.clamp(out.count - out_capacity, min=0)
    ok = torch.clamp(out.count, max=out_capacity)
    return (out.keys[:, :out_capacity], out.vals["idx"][:, :out_capacity],
            ok, overflow)


def psort(keys, config: Optional[SortConfig] = None, *,
          return_info: bool = False, device=None, **legacy):
    """Sort 1-D keys, or each row of 2-D (d, n) keys, (int32, uint32,
    float32, int64, uint64 or float64; numpy or torch) with
    ``config.algorithm`` (see :class:`SortConfig`) over p emulated PEs.
    8-byte keys sort with every algorithm but ``"rams"`` and
    ``"ntb-ams"``, which raise the reference's ``ValueError`` (their sample
    composite holds a 4-byte key beside its tag).

    Returns the sorted tensor on ``device`` in the keys' dtype and, with
    ``return_info``, a dict with ``algorithm``, ``backend``,
    ``mesh_shape``, ``counts`` (p,), ``overflow``, ``balance``, ``perm``
    (input index of every output element, int64), ``n`` and ``d`` — the
    reference's keys, equal to its values bit for bit.  Like the
    reference, an exchange slot that fills up drops elements and counts
    them in ``overflow``.  GatherM and AllGatherM concentrate the output
    (capacity p·⌈n/p⌉ per PE); the result of AllGatherM is PE 0's copy,
    but its ``perm`` concatenates every PE's, p·n entries, as the
    reference's does.

    2-D keys are d independent sorts, each within its own p PEs: row r of
    the result, of ``perm`` (d, n) and of ``counts`` (d, p) is bit for bit
    the 1-D sort of row r, and ``overflow`` is the sum over the rows.
    Where the rows drop different numbers of keys the result and ``perm``
    are lists of the d rows (the reference's ``np.stack`` of them raises
    there).  ``mesh_shape=(p_o, p_i)`` runs every collective over the two
    real axes of a nested mesh (``comm.nested``), with RAMS and NTB-AMS on
    the schedule ``rams.nested_level_bits(p_o, p_i, levels)``: bit for bit
    the flat sort with that schedule, on 1-D and 2-D keys.

    With an :class:`ExternalPolicy` (``config.external`` or the
    ``REPRO_EXTERNAL_BUDGET`` environment variable) the out-of-core lane
    runs on 1-D keys over the flat axis when ``algorithm="external"`` or
    n/p exceeds the budget, on every key dtype; its info adds the
    reference's ``external`` ({budget, runs, merge}) and the host-clock
    ``pass_seconds`` of passes A–D.

    ``algorithm="auto"`` (the default) sorts with the algorithm the
    reference's ``select_algorithm`` picks for (n, p) (and the mesh) from
    ``config.cost_model`` (the card's profile when None), which ``info``
    names; ``overlap=True`` streams the slotted exchanges, with the same
    result (on a nested mesh the exchanges run as barriers, as in the
    reference).

    With ``config.fault_policy`` the sort runs the reference's fault lane
    (:func:`_psort_faulty`): the policy's planned kills and stragglers
    exclude PEs, and the sort re-runs on the surviving power-of-two
    topology; ``info`` then adds ``fault`` ({p_final, failed, restarts,
    attempts}) and ``comm_trace``, and has no ``external`` or
    ``pass_seconds``, as the reference's.

    ``backend="shard_map"`` sorts on ``torch.distributed``, SPMD: every
    rank of ``config.mesh`` (a ``DeviceMesh``; by default the first p
    ranks of the default process group, ``sort_mesh(p, d)`` for 2-D keys
    and ``sort_mesh(shape=mesh_shape)`` on a nested mesh) calls psort with
    the same keys, sorts its own slice as one PE and returns the whole
    result, bit for bit the sim backend's.  Without a process group, or
    with fewer ranks than p, it raises the reference's ``default_mesh``
    error; ``external`` and ``fault_policy`` raise its ``ValueError``.

    The reference's legacy styles are taken (a bare int for p, or the
    config's fields and algorithm keywords as keywords), each with one
    ``DeprecationWarning``; ``device`` is the port's own keyword."""
    cfg = _coerce_config(config, legacy, "psort")
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(keys)) \
        if isinstance(keys, np.ndarray) else torch.as_tensor(keys)
    if x.dim() not in (1, 2):
        raise ValueError(f"keys must be 1-D (one sort) or 2-D (a batch of "
                         f"independent sorts); got shape {tuple(x.shape)}")
    batched = x.dim() == 2
    if cfg.backend == "shard_map":
        return _psort_distributed(x, cfg, batched, return_info, device)
    if cfg.mesh is not None:
        raise ValueError("backend='sim' runs meshless; drop the mesh arg")
    p, mesh_shape = _topology(cfg, "backend='sim' needs an explicit p")
    external = _resolve_external(cfg.external)
    if external is not None:
        if batched:
            raise ValueError("external= supports 1-D keys only (each run "
                             "pass is one global sort problem)")
        if mesh_shape is not None:
            raise ValueError("external= runs on one flat axis; drop "
                             "mesh_shape")
    elif cfg.algorithm == "external":
        raise ValueError("algorithm='external' needs external="
                         "ExternalPolicy(...) (or REPRO_EXTERNAL_BUDGET)")
    n = x.shape[-1]
    _check_dtype(x)
    if cfg.fault_policy is not None:
        return _psort_faulty(x, n, p, cfg, external, mesh_shape, batched,
                             return_info, dev)
    return _sort_routed(x, {}, _route(cfg, n, p, external, mesh_shape), n,
                        p, mesh_shape, cfg, external, batched, return_info,
                        dev)


def _check_dtype(x) -> None:
    if x.dtype not in _KEY_DTYPES:
        raise TypeError(f"unsupported key dtype {x.dtype}: psort sorts "
                        f"int32, uint32, float32, int64, uint64 or float64 "
                        f"keys")


def default_mesh(p: Optional[int] = None, axis: str = "sort"):
    """The 1-D mesh of the default process group's first p ranks (all of
    them when p is None), the reference's ``default_mesh`` with ranks for
    devices; without a process group there are none."""
    world = world_ranks()
    p = p or world
    if not world or p > world:
        raise ValueError(f"requested p={p} > available devices {world}"
                         f" (use backend='sim' for emulated PE counts)")
    return make_mesh(np.arange(p), (axis,))


def _mesh_of(cfg: SortConfig, batched: bool, d: int):
    """(mesh, p, mesh_shape) of a shard_map sort, with the reference's
    defaults and errors: the nested mesh ``sort_mesh(shape=...)``, for 2-D
    keys the (data, sort) mesh, else ``default_mesh``; p read off the
    mesh's sort axis."""
    mesh, axis, data_axis = cfg.mesh, cfg.axis, cfg.data_axis
    if cfg.mesh_shape is not None:
        p, mesh_shape = _topology(cfg, "")
        if mesh is None:
            mesh = sort_mesh(shape=mesh_shape, d=d if batched else 1,
                             data_axis=data_axis, mesh_axes=cfg.mesh_axes)
        want = dict(zip(cfg.mesh_axes, mesh_shape))
        if batched:
            want[data_axis] = d
        sizes = mesh_sizes(mesh)
        for a, sz in want.items():
            if sizes.get(a) != sz:
                raise ValueError(f"mesh axis {a!r} must have size {sz}; "
                                 f"mesh has {sizes}")
        return mesh, p, mesh_shape
    if batched:
        if mesh is None:
            mesh = sort_mesh(cfg.p, d=d, axis=axis, data_axis=data_axis)
        sizes = mesh_sizes(mesh)
        for a in (data_axis, axis):
            if a not in sizes:
                raise ValueError(f"2-D keys need a mesh with axes "
                                 f"({data_axis!r}, {axis!r}); mesh has "
                                 f"{tuple(sizes)}")
        if sizes[data_axis] != d:
            raise ValueError(f"keys.shape[0]={d} != mesh.shape"
                             f"[{data_axis!r}]={sizes[data_axis]}")
    else:
        mesh = mesh or default_mesh(cfg.p, axis)
    p = mesh_sizes(mesh)[axis]
    if p & (p - 1):
        raise ValueError(f"p={p} must be a power of two (hypercube layout)")
    return mesh, p, None


def _psort_distributed(x, cfg: SortConfig, batched, return_info, device):
    """``psort`` on the distributed backend (the reference's shard_map
    paths ``_psort_jit``, ``_psort2_jit`` and ``_psort_nested_jit``).

    SPMD: every rank of the mesh calls it with the same keys.  A rank is
    one PE: it takes its slice of its row (the row of its data-axis slice
    for 2-D keys), runs the per-PE body of the sim backend on that one row
    inside ``comm.distributed`` (and ``comm.nested`` on a nested mesh),
    and the sorted result is then reassembled on every rank, as the
    reference's global output array holds it."""
    d = x.shape[0] if batched else 1
    mesh, p, mesh_shape = _mesh_of(cfg, batched, d)
    _check_dtype(x)
    if cfg.external is not None:
        raise ValueError("external= requires backend='sim' (host-streamed "
                         "shards run on emulated PEs)")
    if cfg.algorithm == "external":
        raise ValueError("algorithm='external' needs external="
                         "ExternalPolicy(...) (or REPRO_EXTERNAL_BUDGET)")
    if cfg.fault_policy is not None:
        raise ValueError("fault_policy= requires backend='sim' (the "
                         "fault-injection lane runs on emulated PEs)")
    n = x.shape[-1]
    dev = resolve_device(device)
    algorithm = _route(cfg, n, p, None, mesh_shape)
    per, capacity, out_capacity = _capacities(cfg, algorithm, n, p)
    algo_kw = _algo_kw(cfg, algorithm, mesh_shape)
    with contextlib.ExitStack() as scopes:
        layout = scopes.enter_context(comm.distributed(mesh, cfg.axis))
        if mesh_shape is not None:
            scopes.enter_context(comm.nested(comm.AXIS, (
                (cfg.mesh_axes[0], mesh_shape[0]),
                (cfg.mesh_axes[1], mesh_shape[1]))))
        me = int(comm.axis_index(p)[0])
        r = layout.axis(cfg.data_axis).index if batched else 0
        lo, hi = min(per * me, n), min(per * (me + 1), n)
        s = key_to_int((x[r] if batched else x)[lo:hi].to(dev))
        row = torch.full((1, per), pad_value(s.dtype), dtype=s.dtype,
                         device=dev)
        row[0, :hi - lo] = s
        del s
        keys_out, idx_out, count, overflow = _sort_body(
            row, torch.tensor([hi - lo], device=dev), p, capacity,
            out_capacity, algorithm, algo_kw)
        del row
        with record_function("reassemble"):
            axes = (comm.AXIS, cfg.data_axis) if batched else (comm.AXIS,)
            c = int(count[0])
            counts = comm.gather_ranks(count, axes).reshape(d, p)
            overflow = int(comm.gather_ranks(overflow, axes).sum())
            # AllGatherM's result is PE 0's copy; every PE's perm counts
            mine = keys_out[0, :c if algorithm != "allgatherm" or me == 0
                            else 0]
            pes = 1 if algorithm == "allgatherm" else p
            result = _rows(int_to_key(comm.gather_ranks(mine, axes),
                                      x.dtype),
                           counts[:, :pes].sum(dim=1), batched)
            if not return_info:
                return result
            perm = _rows(comm.gather_ranks(idx_out[0, :c], axes).to(
                torch.int64) & 0xFFFFFFFF, counts.sum(dim=1), batched)
    return result, _info(algorithm, "shard_map", mesh_shape, counts,
                         overflow, perm, n, p, d, batched)


def _topology(cfg: SortConfig, missing_p: str):
    """(p, mesh_shape) of ``cfg`` with the reference's errors: the mesh's
    entries powers of two and p (optional with a mesh) their product."""
    p, mesh_shape = cfg.p, None
    if cfg.mesh_shape is not None:
        p_o, p_i = (int(v) for v in cfg.mesh_shape)
        if (p_o & (p_o - 1)) or (p_i & (p_i - 1)) or p_o < 1 or p_i < 1:
            raise ValueError(f"mesh_shape={cfg.mesh_shape} entries must be "
                             f"powers of two (hypercube layout)")
        if p is not None and p != p_o * p_i:
            raise ValueError(f"p={p} inconsistent with mesh_shape="
                             f"{tuple(cfg.mesh_shape)}")
        p, mesh_shape = p_o * p_i, (p_o, p_i)
    if p is None:
        raise ValueError(missing_p)
    p = int(p)
    if p < 1 or p & (p - 1):
        raise ValueError(f"p={p} must be a power of two (hypercube layout)")
    return p, mesh_shape


def _route(cfg: SortConfig, n: int, p: int, external,
           mesh_shape=None) -> str:
    """The algorithm a sort of n keys at p runs: ``cfg.algorithm``, or
    for ``"auto"`` the reference's choice from the cost model; and
    ``"external"`` wherever the lane takes the sort, that is with
    ``algorithm="external"`` or n/p past the lane's budget."""
    algorithm = cfg.algorithm
    if algorithm == "auto":
        algorithm = selection.select_algorithm(
            n, p, model=cfg.cost_model, levels=cfg.levels,
            mesh_shape=mesh_shape,
            budget=external.budget if external is not None else None)
    if external is not None and -(-max(n, 1) // p) > external.budget:
        return "external"
    return algorithm


def _sort_routed(x, words, algorithm, n, p, mesh_shape, cfg, external,
                 batched, return_info, dev):
    """One sort of the keys ``x`` at p with the ``algorithm`` that
    :func:`_route` gave: the external lane over the host words, or the
    in-core sort over the words on ``dev`` ((d, n), one row for 1-D
    keys).  ``words`` keeps the words that one call makes, for a later
    call on the same keys."""
    if algorithm == "external":
        if "host" not in words:
            words["host"] = _get_keys(key_to_int(x.cpu()))   # unsigned
        return _external_sort(words["host"], x.dtype, n, p, external,
                              return_info, dev, cfg.overlap)
    if "dev" not in words:
        s = key_to_int(x.to(dev))
        words["dev"] = s if batched else s[None]
    return _psort_incore(words["dev"], x.dtype, n, p, cfg, algorithm,
                         return_info, dev, batched, mesh_shape)


def _psort_incore(s, orig_dtype, n, p, cfg, algorithm, return_info, dev,
                  batched=False, mesh_shape=None):
    """The in-core sort of the port's words ``s`` ((d, n), on ``dev``)
    with ``algorithm``: the body over all d·p rows (over the nested axes
    of ``mesh_shape``), then the reference's reassembly into
    ``orig_dtype``, d rows where ``batched``, else one."""
    d = s.shape[0]
    per, capacity, out_capacity = _capacities(cfg, algorithm, n, p)
    algo_kw = _algo_kw(cfg, algorithm, mesh_shape)
    flat = torch.full((d, p * per), pad_value(s.dtype), dtype=s.dtype,
                      device=dev)
    flat[:, :n] = s
    del s
    row_counts = torch.clamp(n - per * torch.arange(p, device=dev), 0,
                             per).repeat(d)
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(comm.batched(d))
        if mesh_shape is not None:
            scopes.enter_context(comm.nested(comm.AXIS, (
                (cfg.mesh_axes[0], mesh_shape[0]),
                (cfg.mesh_axes[1], mesh_shape[1]))))
        keys_out, idx_out, counts_out, overflow = _sort_body(
            flat.reshape(d * p, per), row_counts, p, capacity, out_capacity,
            algorithm, algo_kw)
    del flat

    with record_function("reassemble"):
        width = keys_out.shape[1]
        take = (torch.arange(width, device=dev)[None, :]
                < counts_out[:, None]).reshape(d, p, width)
        counts = counts_out.reshape(d, p)
        pes = 1 if algorithm == "allgatherm" else p       # PE 0's copy
        result = _rows(int_to_key(
            keys_out.reshape(d, p, width)[:, :pes][take[:, :pes]],
            orig_dtype), counts[:, :pes].sum(dim=1), batched)
        if not return_info:
            return result
        perm = _rows(idx_out.reshape(d, p, width)[take].to(torch.int64)
                     & 0xFFFFFFFF, counts.sum(dim=1), batched)
    return result, _info(algorithm, "sim", mesh_shape, counts,
                         int(overflow.sum()), perm, n, p, d, batched)


def _capacities(cfg: SortConfig, algorithm: str, n: int, p: int):
    """(keys a PE, its shard's capacity, its output capacity): GatherM and
    AllGatherM concentrate the output, p·⌈n/p⌉ slots a PE."""
    per = -(-max(n, 1) // p)
    capacity = max(4, int(math.ceil(per * cfg.capacity_factor)))
    out_capacity = max(1, p * per) if algorithm in _CONCENTRATED \
        else capacity
    return per, capacity, out_capacity


def _algo_kw(cfg: SortConfig, algorithm: str, mesh_shape) -> dict:
    """The algorithm's keywords: ``algo_kw``, ``overlap`` where it
    streams, and RAMS's levels (the nested schedule on a nested mesh)."""
    algo_kw = dict(cfg.algo_kw)
    if cfg.overlap and algorithm in _OVERLAP_ALGOS:
        algo_kw.setdefault("overlap", True)
    if algorithm in ("rams", "ntb-ams"):
        if mesh_shape is not None:
            algo_kw.setdefault("level_bits", tuple(
                nested_level_bits(*mesh_shape, cfg.levels)))
        elif cfg.levels is not None:
            algo_kw.setdefault("levels", cfg.levels)
    return algo_kw


def _info(algorithm, backend, mesh_shape, counts, overflow, perm, n, p, d,
          batched) -> dict:
    """The reference's info dict; ``counts`` (d, p)."""
    return {
        "algorithm": algorithm,
        "backend": backend,
        "mesh_shape": mesh_shape,
        "counts": counts if batched else counts[0],
        "overflow": overflow,
        "balance": float(counts.max()) / max(1.0, n / p),
        "perm": perm,
        "n": n,
        "d": d,
    }


def _rows(values, lengths, batched):
    """The concatenated rows ``values`` as the result: 1-D for one sort, a
    (d, m) tensor for d rows of m, a list of the d rows where they differ
    in length."""
    if not batched:
        return values
    lengths = lengths.tolist()
    if len(set(lengths)) <= 1:
        return values.reshape(len(lengths), lengths[0] if lengths else 0)
    return list(torch.split(values, lengths))


_KEY_DTYPES = (torch.int32, torch.uint32, torch.float32, torch.int64,
               torch.uint64, torch.float64)


def trace_collectives(n: int, config: Optional[SortConfig] = None, *args,
                      d: int = 1, device=None, **legacy) -> comm.CommTrace:
    """The collectives one ``psort`` call launches, per PE, as the
    reference's ``trace_collectives`` counts them: the measured form of
    the paper's Table I and the feature vector a cost model is fitted
    from.

    The reference evaluates the body on shapes alone; the port runs it, on
    ``device`` (the card unless the caller passes ``"cpu"``), over n
    uint32 keys drawn from ``np.random.default_rng(0xE87)`` (d rows of
    them with ``d > 1``, the batched sort), inside a ``comm.counting``
    scope, and returns that scope's ``CommTrace``: the same events, the
    same ``summary(p)`` and the same ``by_tag()``.  The per-PE trace does
    not depend on d.  ``config.mesh_shape`` traces the nested mesh: every
    event carries the real axis it targeted (``mesh_axes``), so
    ``by_axis()`` splits the outer from the inner volume.
    ``config.external`` traces the external lane once on that input (1-D,
    flat), its ``ext:h2d``/``ext:d2h`` copies included.  ``"auto"`` traces
    the algorithm the cost model picks, and ``overlap=True`` the streamed
    exchanges, recorded as the reference records them (``ovl:<phase>``
    chunk events; on a nested mesh the barrier exchanges).
    ``backend="shard_map"`` runs the sort on the distributed backend
    (every rank calls it) and returns this rank's trace: each rank records
    what an emulated PE records.  The
    reference's legacy ``trace_collectives(n, p, algorithm,
    capacity_factor, ...)`` style works through the same shim as
    :func:`psort`'s."""
    if args:
        names = ("algorithm", "capacity_factor")
        if len(args) > len(names):
            raise TypeError(f"trace_collectives() takes at most "
                            f"{len(names)} legacy positional arguments "
                            f"after n/p ({names}); got {len(args)}")
        legacy.update(zip(names, args))
    cfg = _coerce_config(config, legacy, "trace_collectives")
    if cfg.external is not None and (d > 1 or cfg.mesh_shape is not None):
        raise ValueError("external tracing covers the 1-D flat axis only "
                         "(the external lane's contract)")
    rows = d if d > 1 else 1
    rng = np.random.default_rng(0xE87)
    u = rng.integers(0, 2 ** 32, size=(rows, max(n, 1)),
                     dtype=np.int64).astype(np.uint32)
    if cfg.backend == "shard_map":
        x = torch.from_numpy(np.ascontiguousarray(u[:, :n]))
        with comm.counting() as trace:
            _psort_distributed(x if rows > 1 else x[0], cfg, rows > 1, False,
                               device)
        return trace
    p, mesh_shape = _topology(cfg, "trace_collectives needs p or "
                                   "mesh_shape")
    dev = resolve_device(device)
    with comm.counting() as trace:
        if cfg.external is not None:
            _psort_external_once(u[0], n, p=p, policy=cfg.external,
                                 device=dev, overlap=cfg.overlap)
        else:
            if cfg.algorithm == "external":
                raise ValueError("algorithm='external' needs external="
                                 "ExternalPolicy(...)")
            x = torch.from_numpy(np.ascontiguousarray(u[:, :n]))
            _psort_incore(key_to_int(x.to(dev)), x.dtype, n, p, cfg,
                          _route(cfg, n, p, None, mesh_shape),
                          False, dev, rows > 1, mesh_shape)
    return trace


def _resolve_external(external) -> Optional[ExternalPolicy]:
    """Explicit policy wins; else ``REPRO_EXTERNAL_BUDGET``."""
    if external is not None:
        return external
    env = os.environ.get("REPRO_EXTERNAL_BUDGET")
    return ExternalPolicy(budget=int(env)) if env else None


def _external_sort(u, orig_dtype, n, p, policy, return_info, dev, overlap):
    """The external lane over the host words ``u``: the four passes from
    host memory (pass C streamed with ``overlap``), then the reference's
    reassembly of the output into ``orig_dtype``."""
    seconds = {}
    keys_out, idx_out, counts_out, overflow = _psort_external_once(
        u, n, p=p, policy=policy, device=dev, seconds=seconds,
        overlap=overlap)
    del u
    c = counts_out[0]
    with record_function("reassemble"):
        rows = np.concatenate([keys_out[0, pe, :c[pe]] for pe in range(p)])
        result = int_to_key(_put_keys(rows, dev), orig_dtype)
        if not return_info:
            return result
        perm = np.concatenate([idx_out[0, pe, :c[pe]] for pe in range(p)])
        perm = torch.from_numpy(perm.astype(np.int64)).to(dev)
    per = -(-max(n, 1) // p)
    info = {
        "algorithm": "external",
        "backend": "sim",
        "mesh_shape": None,
        "counts": torch.as_tensor(c, dtype=torch.int64, device=dev),
        "overflow": int(overflow.sum()),
        "balance": float(c.max()) / max(1.0, n / p),
        "perm": perm,
        "n": n,
        "d": 1,
        "external": {
            "budget": policy.budget,
            "runs": max(1, -(-per // policy.budget)),
            "merge": policy.merge,
        },
        "pass_seconds": seconds,
    }
    return result, info


def _psort_faulty(x, n, p, cfg, external, mesh_shape, batched, return_info,
                  dev):
    """The ``psort(..., fault_policy=...)`` loop (the reference's
    ``_psort_faulty``).

    Attempt loop, bounded by ``run_with_restarts``: run the sort under a
    fresh ``comm.faulty`` scope executing the policy's surviving plan, its
    launches recorded into the policy's merged trace alone.  On a
    ``PEFailure`` (a fired kill, or a watchdog-flagged straggler raised
    here) exclude the PE, plan the reduced topology
    (``plan_sort_rescale``), record a ``rescale`` event carrying the new
    extent, and retry.  Progress is shrinking p, so a rescale that fails
    to shrink trips the loop's no-progress give-up.

    Each attempt sorts the same input afresh at its p: ``"auto"`` chooses
    again, the external lane is entered once n/p passes its budget (a
    rescale can cross into it, never out of it), ``overlap`` applies to
    the algorithms it streams, batched rows sort at the new p and a nested
    mesh keeps its inner axis while it fits.  The straggler lane is
    simulated: per-PE times are ``base_step_time`` stretched by the fired
    delays, as a sim row has no time of its own.

    A killed attempt has done real work up to the kill (the reference
    kills at trace time, before any), and the exception's frames hold its
    tensors: the rescale drops them before the next attempt runs, so that
    attempt's peak is its own."""
    policy = cfg.fault_policy
    trace = policy.trace if policy.trace is not None else comm.CommTrace()
    policy.trace = trace
    log = policy.logger if policy.logger is not None else (lambda *a: None)
    plan0 = policy.plan if policy.plan is not None else comm.FaultPlan()
    if not isinstance(plan0, comm.FaultPlan):
        plan0 = comm.FaultPlan(tuple(plan0))
    state = {"p": p, "mesh_shape": mesh_shape, "plan": plan0, "failed": ()}
    policy.attempts.clear()
    words = {}                    # the input's words, each made once

    def attempt(_start):
        p_cur, ms = state["p"], state["mesh_shape"]
        algo = _route(cfg, n, p_cur, external, ms)
        rec = {"p": p_cur, "mesh_shape": ms, "algorithm": algo, "ok": False}
        policy.attempts.append(rec)
        with comm.recording(trace), comm.faulty(state["plan"], trace) as fc:
            out = _sort_routed(x, words, algo, n, p_cur, ms, cfg, external,
                               batched, return_info, dev)
        times = [policy.base_step_time * fc.fired_delays.get(pe, 1.0)
                 for pe in range(p_cur)]
        slow = flag_stragglers(times, k_mad=policy.k_mad,
                               warmup=policy.warmup)
        if slow:
            raise comm.PEFailure(slow[0], phase="straggler")
        rec["ok"] = True
        return out, p_cur

    def rescale(e, restarts):
        # the dead attempt's frames hold its tensors: let them go now
        traceback.clear_frames(e.__traceback__)
        e.__traceback__ = None
        p_cur, ms = state["p"], state["mesh_shape"]
        rplan = plan_sort_rescale(p_cur, (e.pe,), mesh_shape=ms)
        trace.add("rescale", 0, rplan.p_new, axis=comm.AXIS, tag=e.phase,
                  pe=e.pe)
        why = "straggling" if e.phase == "straggler" else "failed"
        log(f"[psort] PE {e.pe} {why} at p={p_cur}; "
            f"rescaling to p={rplan.p_new}")
        state["p"] = rplan.p_new
        state["mesh_shape"] = rplan.mesh_shape
        state["plan"] = state["plan"].surviving(e.pe, rplan.p_new)
        state["failed"] += (e.pe,)

    out, p_fin = run_with_restarts(
        attempt, max_restarts=policy.max_restarts,
        retry_on=(comm.PEFailure,), on_failure=rescale,
        progress_fn=lambda: -state["p"], logger=log)
    if not return_info:
        return out
    result, info = out
    for lane_only in ("external", "pass_seconds"):
        info.pop(lane_only, None)
    info["fault"] = {
        "p_final": p_fin,
        "failed": state["failed"],
        "restarts": len(policy.attempts) - 1,
        "attempts": list(policy.attempts),
    }
    info["comm_trace"] = trace
    return result, info
