"""Wrapper of the k-way classifier kernel (counterpart of
``repro/kernels/kway/ops.py``).

``kway_classify`` is what ``core/external._classify_planes`` calls for
4-byte planes: pass C of the external lane over the p·budget elements of
one run index (nb = p), pass D over each run (nb = ⌈total / budget⌉).  On
a CUDA tensor it launches the kernel (csrc/kway.cu) or raises; on a CPU
tensor it runs the plain version (ref.py).  ``LAUNCHES`` counts the
launches.  Unlike the TPU wrapper it pads nothing: the kernel masks its
ragged edge, so the histogram needs no correction.  A call is one launch
and no other device work: the kernel zeroes its own histogram through an
accumulator kept here per stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

LAUNCHES = {"kway_classify": 0}
# per (device, stream): the kernel's zeroed histogram accumulator, acc[0]
# the ticket of its last block; each launch leaves it zero again
_ACC = {}

_P = ctypes.c_void_p
_I = ctypes.c_int64


@functools.cache
def _lib():
    lib = _build.load("kway")
    lib.kway_classify.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  ctypes.c_int, _P]
    lib.kway_classify.restype = ctypes.c_int
    return lib


def _fits(t, n, dev) -> bool:
    return (t.dtype == torch.int32 and t.dim() == 1 and t.shape[0] == n
            and t.device == dev and t.is_contiguous())


def _check(keys, ties, s_keys, s_ties, n_buckets):
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {dev}")
    C = keys.shape[0] if keys.dim() == 1 else -1
    S = s_keys.shape[0] if s_keys.dim() == 1 else -1
    for name, t, n in (("keys", keys, C), ("ties", ties, C),
                       ("s_keys", s_keys, S), ("s_ties", s_ties, S)):
        if not _fits(t, n, dev):
            raise TypeError(f"{name} must be a contiguous ({n},) int32 "
                            f"tensor on {dev}, got {tuple(t.shape)} "
                            f"{t.dtype} on {t.device}")
    if not 1 <= n_buckets < 2 ** 31:
        raise ValueError(f"n_buckets must be in [1, 2^31), got {n_buckets}")


def _accumulator(dev, stream: int, nb: int) -> torch.Tensor:
    key = (dev.index, stream)
    acc = _ACC.get(key)
    if acc is None or acc.shape[0] <= nb:
        acc = torch.zeros(max(nb + 1, 64), dtype=torch.int32, device=dev)
        _ACC[key] = acc
    return acc


def kway_classify(keys, ties, s_keys, s_ties, *, n_buckets: int):
    """Classify (key, tie) pairs against (S,) splitters: (bucket (C,) int32,
    hist (n_buckets,) int32); same contract as ``ref.kway_classify_ref``.
    On a CUDA tensor: one kernel launch on the current stream."""
    if keys.device.type == "cpu":
        return ref.kway_classify_ref(keys, ties, s_keys, s_ties,
                                     n_buckets=n_buckets)
    _check(keys, ties, s_keys, s_ties, n_buckets)
    dev = keys.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    bucket = torch.empty_like(keys)
    hist = torch.empty((n_buckets,), dtype=torch.int32, device=dev)
    err = _lib().kway_classify(
        keys.data_ptr(), ties.data_ptr(), s_keys.data_ptr(),
        s_ties.data_ptr(), bucket.data_ptr(), hist.data_ptr(),
        _accumulator(dev, stream, n_buckets).data_ptr(), keys.shape[0],
        s_keys.shape[0], n_buckets, stream)
    _build.check(err, "kway_classify")
    LAUNCHES["kway_classify"] += 1
    return bucket, hist
