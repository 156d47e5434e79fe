"""Public API: ``psort`` on the sim backend with every algorithm of the
reference, ``"auto"`` selection from a :class:`CostModel`, the external
lane, the streamed exchange (``overlap=True``) and ``trace_collectives``
(counterpart of ``repro/core/api.py``).

The sim backend runs p PEs on one device; here every PE is a row of a
(p, C) tensor and the per-PE body of the reference (``_sort_body``) runs
once over all rows.  ``SortConfig(external=ExternalPolicy(budget))``
streams shards larger than ``budget`` through the device in runs
(``external.py``), exactly when the reference does.  The port runs on
``cuda`` unless the caller passes ``device="cpu"``, where every kernel
wrapper takes its plain version; it never moves to the CPU on its own.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from . import comm, selection
from .bitonic import bitonic
from .external import (ExternalPolicy, _get_keys, _psort_external_once,
                       _put_keys)
from .gatherm import allgather_merge_sort, gather_merge
from .rams import as_int32_bits, rams
from .rfis import rfis
from .rquick import rquick
from .samplesort import samplesort
from .types import (int_to_key, key_to_int, make_shard, pad_value,
                    resolve_device)

# knobs of the reference's SortConfig that this port does not honour yet:
# the values it accepts (the reference's defaults) and the ROADMAP item
# (queue 1) that brings the others
_UNPORTED = {
    "mesh": ((None,), "item 7 (torch.distributed backend)"),
    "axis": (("sort",), "item 7 (torch.distributed backend)"),
    "data_axis": (("data",), "item 5 (batched keys and nested meshes)"),
    "mesh_shape": ((None,), "item 5 (batched keys and nested meshes)"),
    "mesh_axes": ((("inter", "intra"),),
                  "item 5 (batched keys and nested meshes)"),
    "fault_policy": ((None,), "item 8 (faults and elastic rescale)"),
}
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
    """The knobs of one sort that the port honours.

    ``p`` (PE count, a power of two), ``backend`` ("sim"), ``algorithm``,
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
    the out-of-core lane.  The reference's other knobs are taken at their
    default values (``mesh``, ``mesh_shape`` and ``fault_policy`` None,
    ``axis`` "sort", ``data_axis`` "data", ``mesh_axes`` ("inter",
    "intra") as a tuple or a list); any other value of one raises
    ``NotImplementedError`` naming the ROADMAP item that brings it."""

    p: Optional[int] = None
    backend: str = "sim"
    algorithm: str = "auto"
    capacity_factor: float = 2.0
    levels: Optional[int] = None
    algo_kw: tuple = ()
    external: Optional[ExternalPolicy] = None
    cost_model: Optional[selection.CostModel] = None
    overlap: bool = False

    def __init__(self, p=None, backend="sim", algorithm="auto",
                 capacity_factor=2.0, levels=None, algo_kw=(), external=None,
                 cost_model=None, overlap=False, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"SortConfig got an unexpected keyword "
                                f"{name!r}")
            accepted, item = _UNPORTED[name]
            if isinstance(value, list):
                value = tuple(value)
            if not any(value is a or (type(value) is type(a) and value == a)
                       for a in accepted):
                raise NotImplementedError(
                    f"SortConfig({name}=...) is not ported yet: ROADMAP "
                    f"queue 1 {item}")
        if backend != "sim":
            raise NotImplementedError(
                f"backend={backend!r} is not ported yet: ROADMAP queue 1 "
                f"{_UNPORTED['mesh'][1]}")
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
        for name, value in (("p", p), ("backend", backend),
                            ("algorithm", algorithm),
                            ("capacity_factor", capacity_factor),
                            ("levels", levels),
                            ("algo_kw", tuple(sorted(kw.items()))),
                            ("external", external),
                            ("cost_model", cost_model),
                            ("overlap", bool(overlap))):
            object.__setattr__(self, name, value)

    def replace(self, **changes) -> "SortConfig":
        return dataclasses.replace(self, **changes)


def _sort_body(keys2d, row_counts, p, capacity, out_capacity, algorithm,
               algo_kw):
    """The reference's per-PE body over all p rows at once.

    Returns (keys (p, ≤ out_capacity) int32 words, idx int32 rows holding
    uint32 indices, count (p,), overflow (p,)); what the output capacity
    cuts counts in the overflow."""
    per = keys2d.shape[1]
    dev = keys2d.device
    # global index payload proves permutation-ness (uint32 values)
    base = torch.arange(p, device=dev)[:, None] * per
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
          return_info: bool = False, device=None):
    """Sort 1-D keys (int32, uint32, float32, int64, uint64 or float64;
    numpy or torch) with ``config.algorithm`` (see :class:`SortConfig`)
    over p emulated PEs.  8-byte keys sort with every algorithm but
    ``"rams"`` and ``"ntb-ams"``, which raise the reference's ``ValueError``
    (their sample composite holds a 4-byte key beside its tag).

    Returns the sorted tensor on ``device`` in the keys' dtype and, with
    ``return_info``, a dict with ``counts`` (p,), ``overflow``,
    ``balance``, ``perm`` (input index of every output element, int64),
    ``n``, ``algorithm`` and ``backend`` — the reference's keys, equal to
    its values bit for bit.  Like the reference, an exchange slot that
    fills up drops elements and counts them in ``overflow``.  GatherM and
    AllGatherM concentrate the output (capacity p·⌈n/p⌉ per PE); the
    result of AllGatherM is PE 0's copy, but its ``perm`` concatenates
    every PE's, p·n entries, as the reference's does.

    With an :class:`ExternalPolicy` (``config.external`` or the
    ``REPRO_EXTERNAL_BUDGET`` environment variable) the out-of-core lane
    runs when ``algorithm="external"`` or n/p exceeds the budget, on every
    key dtype; its info adds the reference's ``mesh_shape``, ``d`` and
    ``external`` ({budget, runs, merge}) and the host-clock
    ``pass_seconds`` of passes A–D.

    ``algorithm="auto"`` (the default) sorts with the algorithm the
    reference's ``select_algorithm`` picks for (n, p) from
    ``config.cost_model`` (the card's profile when None), which ``info``
    names; ``overlap=True`` streams the slotted exchanges, with the same
    result."""
    cfg = config if config is not None else SortConfig()
    if cfg.p is None:
        raise ValueError("backend='sim' needs an explicit p")
    p = int(cfg.p)
    if p < 1 or p & (p - 1):
        raise ValueError(f"p={p} must be a power of two (hypercube layout)")
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(keys)) \
        if isinstance(keys, np.ndarray) else torch.as_tensor(keys)
    if x.dim() != 1:
        if x.dim() == 2:
            raise NotImplementedError(
                f"2-D (batched) keys are not ported yet: ROADMAP queue 1 "
                f"{_UNPORTED['data_axis'][1]}")
        raise ValueError(f"keys must be 1-D; got shape {tuple(x.shape)}")
    external = _resolve_external(cfg.external)
    if external is None and cfg.algorithm == "external":
        raise ValueError("algorithm='external' needs external="
                         "ExternalPolicy(...) (or REPRO_EXTERNAL_BUDGET)")
    n = x.shape[0]
    per = -(-max(n, 1) // p)                              # ceil(n/p)
    if x.dtype not in _KEY_DTYPES:
        raise ValueError(f"psort sorts int32, uint32, float32, int64, uint64 "
                         f"or float64 keys; got {x.dtype}")
    algorithm = _resolve_algorithm(cfg, n, p, external)
    if external is not None and (algorithm == "external"
                                 or per > external.budget):
        return _psort_external(x, n, p, external, return_info, dev,
                               cfg.overlap)
    orig_dtype = x.dtype
    s = key_to_int(x.to(dev))
    del x
    return _psort_incore(s, orig_dtype, n, p, cfg, algorithm, return_info,
                         dev)


def _resolve_algorithm(cfg: SortConfig, n: int, p: int, external) -> str:
    """``cfg.algorithm``, or for ``"auto"`` the reference's choice from
    the cost model (``"external"`` past the lane's budget)."""
    if cfg.algorithm != "auto":
        return cfg.algorithm
    return selection.select_algorithm(
        n, p, model=cfg.cost_model, levels=cfg.levels,
        budget=external.budget if external is not None else None)


def _psort_incore(s, orig_dtype, n, p, cfg, algorithm, return_info, dev):
    """The in-core sort of the port's words ``s`` (1-D, on ``dev``) with
    ``algorithm``: the body over all p rows, then the reference's
    reassembly into ``orig_dtype``."""
    per = -(-max(n, 1) // p)
    algo_kw = dict(cfg.algo_kw)
    if cfg.overlap and algorithm in _OVERLAP_ALGOS:
        algo_kw.setdefault("overlap", True)
    if cfg.levels is not None and algorithm in ("rams", "ntb-ams"):
        algo_kw.setdefault("levels", cfg.levels)

    capacity = max(4, int(math.ceil(per * cfg.capacity_factor)))
    flat = torch.full((p * per,), pad_value(s.dtype), dtype=s.dtype,
                      device=dev)
    flat[:n] = s
    del s
    row_counts = torch.clamp(n - per * torch.arange(p, device=dev), 0, per)
    out_capacity = max(1, p * per) if algorithm in _CONCENTRATED \
        else capacity
    keys_out, idx_out, counts_out, overflow = _sort_body(
        flat.reshape(p, per), row_counts, p, capacity, out_capacity,
        algorithm, algo_kw)
    del flat

    with record_function("reassemble"):
        take = torch.arange(keys_out.shape[1], device=dev)[None, :] \
            < counts_out[:, None]
        rows = 1 if algorithm == "allgatherm" else p      # PE 0's copy
        result = int_to_key(keys_out[:rows][take[:rows]], orig_dtype)
        if not return_info:
            return result
        perm = idx_out[take].to(torch.int64) & 0xFFFFFFFF
    info = {
        "algorithm": algorithm,
        "backend": "sim",
        "counts": counts_out,
        "overflow": int(overflow.sum()),
        "balance": float(counts_out.max()) / max(1.0, n / p),
        "perm": perm,
        "n": n,
    }
    return result, info


_KEY_DTYPES = (torch.int32, torch.uint32, torch.float32, torch.int64,
               torch.uint64, torch.float64)


def trace_collectives(n: int, config: Optional[SortConfig] = None, *,
                      d: int = 1, device=None) -> comm.CommTrace:
    """The collectives one ``psort`` call launches, per PE, as the
    reference's ``trace_collectives`` counts them: the measured form of
    the paper's Table I and the feature vector a cost model is fitted
    from.

    The reference evaluates the body on shapes alone; the port runs it, on
    ``device`` (the card unless the caller passes ``"cpu"``), over n
    uint32 keys drawn from ``np.random.default_rng(0xE87)``, inside a
    ``comm.counting`` scope, and returns that scope's ``CommTrace``: the
    same events, the same ``summary(p)`` and the same ``by_tag()``.
    ``config.external`` traces the external lane once on that input, its
    ``ext:h2d``/``ext:d2h`` copies included.  ``"auto"`` traces the
    algorithm the cost model picks, and ``overlap=True`` the streamed
    exchanges, recorded as the reference records them (``ovl:<phase>``
    chunk events).  ``d > 1`` raises
    ``NotImplementedError`` (ROADMAP queue 1, item 5), as ``SortConfig``
    does for the knobs not ported yet."""
    cfg = config if config is not None else SortConfig()
    if d != 1:
        raise NotImplementedError(
            f"trace_collectives(d={d}) is not ported yet: ROADMAP queue 1 "
            f"{_UNPORTED['data_axis'][1]}")
    p = cfg.p
    if p is None:
        raise ValueError("trace_collectives needs p")
    if p < 1 or p & (p - 1):
        raise ValueError(f"p={p} must be a power of two (hypercube layout)")
    dev = resolve_device(device)
    rng = np.random.default_rng(0xE87)
    u = rng.integers(0, 2 ** 32, size=max(n, 1), dtype=np.int64).astype(
        np.uint32)
    with comm.counting() as trace:
        if cfg.external is not None:
            _psort_external_once(u, n, p=p, policy=cfg.external, device=dev,
                                 overlap=cfg.overlap)
        else:
            if cfg.algorithm == "external":
                raise ValueError("algorithm='external' needs external="
                                 "ExternalPolicy(...)")
            x = torch.from_numpy(u[:n])
            _psort_incore(key_to_int(x.to(dev)), x.dtype, n, p, cfg,
                          _resolve_algorithm(cfg, n, p, None), False, dev)
    return trace


def _resolve_external(external) -> Optional[ExternalPolicy]:
    """Explicit policy wins; else ``REPRO_EXTERNAL_BUDGET``."""
    if external is not None:
        return external
    env = os.environ.get("REPRO_EXTERNAL_BUDGET")
    return ExternalPolicy(budget=int(env)) if env else None


def _psort_external(x, n, p, policy, return_info, dev, overlap):
    """The external lane: the four passes from host memory (pass C
    streamed with ``overlap``), then the reference's reassembly of the
    output."""
    orig_dtype = x.dtype
    u = _get_keys(key_to_int(x.cpu()))        # host words, unsigned
    del x
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
