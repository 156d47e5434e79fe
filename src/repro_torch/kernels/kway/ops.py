"""Wrapper of the k-way classifier kernel (counterpart of
``repro/kernels/kway/ops.py``).

``kway_classify`` is what ``core/external._classify_planes`` calls for
4-byte planes: pass C of the external lane over the p·budget elements of
one run index (nb = p), pass D over each run (nb = ⌈total / budget⌉).  On
a CUDA tensor it launches the kernel (csrc/kway.cu) or raises; on a CPU
tensor it runs the plain version (ref.py).  ``LAUNCHES`` counts the
launches.  Unlike the TPU wrapper it pads nothing: the kernel masks its
ragged edge, so the histogram needs no correction.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import ref

LAUNCHES = {"kway_classify": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int64


@functools.cache
def _lib():
    lib = _build.load("kway")
    lib.kway_classify.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I,
                                  ctypes.c_int, _P]
    lib.kway_classify.restype = ctypes.c_int
    return lib


def _check(keys, ties, s_keys, s_ties, n_buckets):
    if keys.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not "
                         f"{keys.device}")
    for name, t, n in (("keys", keys, keys.shape[0]),
                       ("ties", ties, keys.shape[0]),
                       ("s_keys", s_keys, s_keys.shape[0]),
                       ("s_ties", s_ties, s_keys.shape[0])):
        if t.dim() != 1 or t.shape[0] != n or t.dtype != torch.int32:
            raise TypeError(f"{name} must be ({n},) int32, got "
                            f"{tuple(t.shape)} {t.dtype}")
        if t.device != keys.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, on the keys' "
                             f"device")
    if not 1 <= n_buckets < 2 ** 31:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")


def kway_classify(keys, ties, s_keys, s_ties, *, n_buckets: int):
    """Classify (key, tie) pairs against (S,) splitters: (bucket (C,) int32,
    hist (n_buckets,) int32); same contract as ``ref.kway_classify_ref``."""
    if keys.device.type == "cpu":
        return ref.kway_classify_ref(keys, ties, s_keys, s_ties,
                                     n_buckets=n_buckets)
    _check(keys, ties, s_keys, s_ties, n_buckets)
    bucket = torch.empty_like(keys)
    hist = torch.empty((n_buckets,), dtype=torch.int32, device=keys.device)
    err = _lib().kway_classify(
        keys.data_ptr(), ties.data_ptr(), s_keys.data_ptr(),
        s_ties.data_ptr(), bucket.data_ptr(), hist.data_ptr(),
        keys.shape[0], s_keys.shape[0], n_buckets,
        torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(err, "kway_classify")
    LAUNCHES["kway_classify"] += 1
    return bucket, hist
