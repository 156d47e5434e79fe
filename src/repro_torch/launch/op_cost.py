"""Operator-level cost of one step (counterpart of
``repro/launch/hlo_cost.py``).

The reference reads the cost of a step off its compiled HLO.  An eager
step has no HLO: every ATen operator it dispatches is counted as it runs,
under a ``TorchDispatchMode``, on any device (the dry-run runs the step on
``meta``, where nothing is computed).  The conventions are the
reference's, per device (a rank of a mesh counts its own step):

  flops:      a matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm``, a
              convolution) 2·(result elements)·(contraction size), kept
              apart as ``dot_flops`` too; a sort n·log2 n over its results'
              n elements; views, allocations, copies and slices nothing;
              every other operator (elementwise, reductions, gathers,
              scatters) its results' elements.
  bytes:      Σ operand + result bytes per operator (an operand that
              repeats elements, a broadcast view, read once).  In eager
              mode every operator is a fusion boundary, so this is the
              upper bound.
  bytes_min:  the same over matmuls, copies (``copy_``, ``clone``,
              ``_to_copy`` within a dtype, ``cat``), slices written in place
              (``slice_scatter``, ``select_scatter``) and collectives
              only: the traffic a fully fused step would keep.  A copy
              that XLA fuses into an elementwise fusion is elementwise
              here too: a convert, a broadcast (a copy out of a view that
              repeats elements, as the GQA repeat of a KV cache), and a
              copy of what the step's elementwise operators made (a
              transpose of that repeat, the rotary halves concatenated).
              A layout copy of an argument, a matmul's result or a
              collective's counts, as XLA's ``copy``, and so does a write
              into part of a buffer, as XLA's ``dynamic-update-slice``.
  collectives: counted where the port's transport carries them
              (``core.comm``'s seam: ``_d_gather``, ``_d_alltoall``,
              ``_d_exchange``, an integer ``all_reduce``), by kind with the
              reference's wire conventions (an all-gather its result, an
              all-reduce twice its operand, the others the larger of
              operand and result), per mesh axis, and as the bytes this
              rank sends and receives.

``unknown_trip_counts`` is always 0: eager code has no opaque loops.
``temp_bytes`` is the peak, over the step's operators, of the bytes of
the storages the step made and still holds (its outputs among them, not
its arguments): the counterpart of XLA's ``temp_size``, reckoned on meta
from the storages' lifetimes; ``output_bytes`` those of the storages the
step made that its outputs hold.
"""
from __future__ import annotations

import collections
import math
import threading
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import comm

aten = torch.ops.aten

_MATMUL = {aten.mm.default, aten.addmm.default, aten.bmm.default,
           aten.baddbmm.default}
_COPIES = {aten.copy_.default, aten.clone.default, aten._to_copy.default,
           aten.cat.default}
_SLICES = {aten.slice_scatter.default, aten.select_scatter.default,
           aten.as_strided_scatter.default}
_SORTS = {aten.sort.default, aten.sort.stable, aten.sort.values,
          aten.sort.values_stable}
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.new_empty.default, aten.new_empty_strided.default,
         aten.empty_like.default, aten._unsafe_view.default,
         aten.detach.default, aten.lift_fresh.default,
         aten.set_.source_Storage_storage_offset, aten.set_.source_Tensor}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """The bytes an operator reads of an operand: its elements, or its
    storage's where it repeats elements (a broadcast view)."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


def _matmul_flops(func, args, out) -> float:
    """2·(result elements)·(contraction size)."""
    if func in (aten.mm.default, aten.bmm.default):
        k = args[0].shape[-1]
    else:                                  # addmm / baddbmm: (bias, a, b)
        k = args[1].shape[-1]
    return 2.0 * out.numel() * k


def _copy_sources(func, args) -> list:
    """The tensors a copy reads."""
    if func is aten.copy_.default:
        return [args[1]]
    if func is aten.cat.default:
        return [t for t in args[0] if isinstance(t, torch.Tensor)]
    return [args[0]]


def _repeats(t: torch.Tensor) -> bool:
    """A view that repeats elements (a broadcast)."""
    return any(stride == 0 and size > 1
               for size, stride in zip(t.shape, t.stride()))


def _conv_flops(args, out) -> float:
    w = args[1]
    return 2.0 * out.numel() * (w.numel() // w.shape[0])


class OpCost(TorchDispatchMode):
    """The counts of every operator dispatched while installed (the
    operators of autograd's backward and of a checkpoint's recompute
    among them)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.bytes_min = 0.0
        self.bytes_min_by_op: Dict[str, float] = collections.Counter()
        self.ops = 0
        self._live: Dict[int, int] = {}
        self._fusible: set = set()
        self._held = 0
        self.temp_bytes = 0
        self._lock = threading.Lock()

    # -- the storages the step makes, and their lifetimes ---------------

    def _release(self, key: int) -> None:
        with self._lock:
            self._held -= self._live.pop(key, 0)
            self._fusible.discard(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        with self._lock:
            self._live[key] = n
            self._held += n
            self.temp_bytes = max(self.temp_bytes, self._held)
        weakref.finalize(st, self._release, key)

    def made_bytes(self, tree) -> int:
        """The bytes of the storages the step made that ``tree``'s tensors
        hold (each storage once)."""
        seen = {}
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                key = t.untyped_storage()._cdata
                if key in self._live:
                    seen[key] = self._live[key]
        return sum(seen.values())

    # -- the operators ----------------------------------------------------

    def _fused_copy(self, func, args, outs) -> bool:
        """A copy that XLA fuses into an elementwise fusion, where it is no
        ``copy``: a convert (``_to_copy`` to another dtype), a broadcast
        (a copy out of a view that repeats elements, as the GQA repeat of
        a KV cache), or a copy of what the step's elementwise operators
        made (a transpose of a broadcast, a concatenation of the rotary
        halves), which XLA fuses with its producer.  A write into part of
        a buffer (a KV cache's new slot) is never fused."""
        if func is aten._to_copy.default and outs[0].dtype != args[0].dtype:
            return True
        if func is aten.copy_.default and \
                _nbytes(args[0]) < args[0].untyped_storage().nbytes():
            return False           # a write into part of a buffer: XLA's
                                   # dynamic-update-slice
        srcs = _copy_sources(func, args)
        return bool(srcs) and all(
            _repeats(t) or t.untyped_storage()._cdata in self._fusible
            for t in srcs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        # a result in an operand's storage (a view, an in-place update) is
        # no new storage
        held = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs if t.untyped_storage()._cdata not in held]
        for t in fresh:
            self._track(t)
        if func.is_view or func in _FREE:
            return out
        if func is aten.copy_.default:
            ins = ins[1:]                  # the destination is only written
        moved = sum(_read_bytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs)
        self.bytes += moved
        n_out = sum(t.numel() for t in outs)
        if func in _MATMUL or func is aten.convolution.default:
            f = _matmul_flops(func, args, outs[0]) if func in _MATMUL \
                else _conv_flops(args, outs[0])
            self.flops += f
            self.dot_flops += f
            self.bytes_min += moved
            self.bytes_min_by_op[str(func)] += moved
        elif (func in _COPIES and not self._fused_copy(func, args, outs)) \
                or func in _SLICES:
            self.bytes_min += moved
            self.bytes_min_by_op[str(func)] += moved
        elif func in _SORTS:
            self.flops += n_out * max(1.0, math.log2(max(n_out, 2)))
        else:                              # elementwise: fusible with its
            self.flops += n_out            # consumers' copies
            with self._lock:
                self._fusible.update(t.untyped_storage()._cdata
                                     for t in fresh)
        return out


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
    """``fn(*args, **kwargs)`` counted, operators and collectives: the
    reference's ``hlo_cost.analyze`` dict, with ``dot_flops``, the
    collectives' bytes per mesh axis and sent and received, each
    operator's share of ``bytes_min`` (the collectives' apart),
    ``temp_bytes``, ``output_bytes`` and the number of operators."""
    with comm.count_wire() as wire, OpCost() as cost:
        out = fn(*args, **kwargs)
        made = cost.made_bytes(out)
    del out
    return {
        "flops": cost.flops,
        "dot_flops": cost.dot_flops,
        "bytes": cost.bytes + wire.moved,
        "bytes_min": cost.bytes_min + wire.moved,
        "bytes_min_by_op": dict(cost.bytes_min_by_op.most_common()),
        "collective_bytes": dict(wire.wire),
        "collective_counts": dict(wire.counts),
        "collective_bytes_by_axis": dict(wire.by_axis),
        "sent_bytes": wire.sent,
        "received_bytes": wire.received,
        "unknown_trip_counts": 0,
        "temp_bytes": cost.temp_bytes,
        "output_bytes": made,
        "ops": cost.ops,
    }
