"""Public API: ``psort`` on the sim backend with RAMS, RQuick/NTB-Quick
and the external lane (counterpart of ``repro/core/api.py``).

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

from .external import (ExternalPolicy, _get_keys, _psort_external_once,
                       _put_keys)
from .rams import as_int32_bits, rams
from .rquick import rquick
from .types import (int_to_key, key_to_int, make_shard, pad_value,
                    resolve_device)

# knobs of the reference's SortConfig that this port does not honour yet,
# with the ROADMAP item (queue 1) that brings each
_UNPORTED = {
    "mesh": "item 10 (torch.distributed backend)",
    "axis": "item 10 (torch.distributed backend)",
    "data_axis": "item 9 (batched keys and nested meshes)",
    "mesh_shape": "item 9 (batched keys and nested meshes)",
    "mesh_axes": "item 9 (batched keys and nested meshes)",
    "cost_model": "item 8 (selection)",
    "fault_policy": "item 13 (faults and elastic rescale)",
    "overlap": "item 11 (exchange/merge overlap)",
}
_ALGORITHMS = {
    "auto": "item 8 (selection)",
    "ntb-ams": "item 7 (the other algorithms)",
    "rfis": "item 7 (the other algorithms)",
    "bitonic": "item 7 (the other algorithms)",
    "ssort": "item 7 (the other algorithms)",
    "ns-ssort": "item 7 (the other algorithms)",
    "gatherm": "item 7 (the other algorithms)",
    "allgatherm": "item 7 (the other algorithms)",
}
# the ported algorithms: each one's function and the keywords it takes
_PORTED = {
    "rams": (rams, ("seed", "levels", "level_bits", "oversample",
                    "tie_break", "shuffle", "slot_factor")),
    "rquick": (rquick, ("seed", "window_k", "robust", "shuffle",
                        "tie_break", "capacity", "dims")),
}
_PORTED["ntb-quick"] = (functools.partial(rquick, robust=False),
                        _PORTED["rquick"][1])


@dataclasses.dataclass(frozen=True, init=False)
class SortConfig:
    """The knobs of one sort that this slice honours.

    ``p`` (PE count, a power of two), ``backend`` ("sim"), ``algorithm``
    ("rams", "rquick" or "ntb-quick"), ``capacity_factor`` (slack of the
    per-PE buffers), ``levels`` (RAMS level count) and ``algo_kw`` (the
    algorithm's keywords, as a sorted tuple of pairs: for RAMS ``seed``,
    ``level_bits``, ``oversample``, ``tie_break``, ``shuffle``,
    ``slot_factor``; for RQuick ``seed``, ``window_k``, ``robust``,
    ``shuffle``, ``tie_break``, ``capacity``, ``dims``); ``external``
    (an :class:`ExternalPolicy`, or None) and ``algorithm="external"``
    select the out-of-core lane.  Asking for a knob of the
    reference that is not ported raises ``NotImplementedError`` naming the
    ROADMAP item that brings it."""

    p: Optional[int] = None
    backend: str = "sim"
    algorithm: str = "rams"
    capacity_factor: float = 2.0
    levels: Optional[int] = None
    algo_kw: tuple = ()
    external: Optional[ExternalPolicy] = None

    def __init__(self, p=None, backend="sim", algorithm="rams",
                 capacity_factor=2.0, levels=None, algo_kw=(), external=None,
                 **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"SortConfig got an unexpected keyword "
                                f"{name!r}")
            if value not in (None, False):
                raise NotImplementedError(
                    f"SortConfig({name}=...) is not ported yet: ROADMAP "
                    f"queue 1 {_UNPORTED[name]}")
        if backend != "sim":
            raise NotImplementedError(
                f"backend={backend!r} is not ported yet: ROADMAP queue 1 "
                f"{_UNPORTED['mesh']}")
        if external is not None and not isinstance(external,
                                                   ExternalPolicy):
            raise TypeError(f"external must be an ExternalPolicy, got "
                            f"{type(external).__name__}")
        if algorithm not in _PORTED and algorithm != "external":
            if algorithm not in _ALGORITHMS:
                raise ValueError(f"unknown algorithm {algorithm!r}")
            raise NotImplementedError(
                f"algorithm={algorithm!r} is not ported yet: ROADMAP queue 1 "
                f"{_ALGORITHMS[algorithm]}")
        kw = dict(algo_kw)
        if kw.get("overlap"):
            raise NotImplementedError(
                f"overlap is not ported yet: ROADMAP queue 1 "
                f"{_UNPORTED['overlap']}")
        kw.pop("overlap", None)
        known = _PORTED.get(algorithm, _PORTED["rams"])[1]
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
                            ("external", external)):
            object.__setattr__(self, name, value)

    def replace(self, **changes) -> "SortConfig":
        return dataclasses.replace(self, **changes)


def _sort_body(keys2d, row_counts, p, capacity, algorithm, algo_kw):
    """The reference's per-PE body over all p rows at once.

    Returns (keys (p, ≤ capacity) int32 words, idx int32 rows holding uint32
    indices, count (p,), overflow (p,)); the output capacity of RAMS and
    RQuick is the input capacity (RQuick's shards grow to twice it inside),
    and what is cut counts in the overflow."""
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
    overflow = overflow + torch.clamp(out.count - capacity, min=0)
    ok = torch.clamp(out.count, max=capacity)
    return (out.keys[:, :capacity], out.vals["idx"][:, :capacity], ok,
            overflow)


def psort(keys, config: Optional[SortConfig] = None, *,
          return_info: bool = False, device=None):
    """Sort 1-D keys (int32, uint32 or float32; numpy or torch) with RAMS,
    RQuick or NTB-Quick (``config.algorithm``) over p emulated PEs.

    Returns the sorted tensor on ``device`` in the keys' dtype and, with
    ``return_info``, a dict with ``counts`` (p,), ``overflow``,
    ``balance``, ``perm`` (input index of every output element, int64),
    ``n``, ``algorithm`` and ``backend`` — the reference's keys, equal to
    its values bit for bit.  Like the reference, an exchange slot that
    fills up drops elements and counts them in ``overflow``.

    With an :class:`ExternalPolicy` (``config.external`` or the
    ``REPRO_EXTERNAL_BUDGET`` environment variable) the out-of-core lane
    runs when ``algorithm="external"`` or n/p exceeds the budget; it also
    takes 8-byte keys (int64, uint64, float64), and its info adds the
    reference's ``mesh_shape``, ``d`` and ``external`` ({budget, runs,
    merge}) and the host-clock ``pass_seconds`` of passes A–D."""
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
                "2-D (batched) keys are not ported yet: ROADMAP queue 1 "
                "item 9")
        raise ValueError(f"keys must be 1-D; got shape {tuple(x.shape)}")
    external = _resolve_external(cfg.external)
    if external is None and cfg.algorithm == "external":
        raise ValueError("algorithm='external' needs external="
                         "ExternalPolicy(...) (or REPRO_EXTERNAL_BUDGET)")
    n = x.shape[0]
    per = -(-max(n, 1) // p)                              # ceil(n/p)
    if external is not None and (cfg.algorithm == "external"
                                 or per > external.budget):
        if x.dtype not in _EXTERNAL_DTYPES:
            raise ValueError(f"the external lane sorts int32, uint32, "
                             f"float32, int64, uint64 or float64 keys; got "
                             f"{x.dtype}")
        return _psort_external(x, n, p, external, return_info, dev)
    if x.dtype not in (torch.int32, torch.uint32, torch.float32):
        raise ValueError(f"{cfg.algorithm} sorts 4-byte keys (int32, uint32, "
                         f"float32); got {x.dtype}")
    algo_kw = dict(cfg.algo_kw)
    if cfg.levels is not None and cfg.algorithm == "rams":
        algo_kw.setdefault("levels", cfg.levels)
    orig_dtype = x.dtype
    s = key_to_int(x.to(dev))
    del x

    capacity = max(4, int(math.ceil(per * cfg.capacity_factor)))
    flat = torch.full((p * per,), pad_value(s.dtype), dtype=s.dtype,
                      device=dev)
    flat[:n] = s
    del s
    row_counts = torch.clamp(n - per * torch.arange(p, device=dev), 0, per)
    keys_out, idx_out, counts_out, overflow = _sort_body(
        flat.reshape(p, per), row_counts, p, capacity, cfg.algorithm,
        algo_kw)
    del flat

    with record_function("reassemble"):
        take = torch.arange(keys_out.shape[1], device=dev)[None, :] \
            < counts_out[:, None]
        result = int_to_key(keys_out[take], orig_dtype)
        if not return_info:
            return result
        perm = idx_out[take].to(torch.int64) & 0xFFFFFFFF
    info = {
        "algorithm": cfg.algorithm,
        "backend": "sim",
        "counts": counts_out,
        "overflow": int(overflow.sum()),
        "balance": float(counts_out.max()) / max(1.0, n / p),
        "perm": perm,
        "n": n,
    }
    return result, info


_EXTERNAL_DTYPES = (torch.int32, torch.uint32, torch.float32, torch.int64,
                    torch.uint64, torch.float64)


def _resolve_external(external) -> Optional[ExternalPolicy]:
    """Explicit policy wins; else ``REPRO_EXTERNAL_BUDGET``."""
    if external is not None:
        return external
    env = os.environ.get("REPRO_EXTERNAL_BUDGET")
    return ExternalPolicy(budget=int(env)) if env else None


def _psort_external(x, n, p, policy, return_info, dev):
    """The external lane: the four passes from host memory, then the
    reference's reassembly of the output."""
    orig_dtype = x.dtype
    u = _get_keys(key_to_int(x.cpu()))        # host words, unsigned
    del x
    seconds = {}
    keys_out, idx_out, counts_out, overflow = _psort_external_once(
        u, n, p=p, policy=policy, device=dev, seconds=seconds)
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
