"""The paper's benchmark input instances (Helman et al. [5] + §VII), the
port's own numpy copy of ``repro/data/distributions.py``.

Each generator returns the *local* input for PE ``i`` of ``p`` as an int64
numpy array of ``m = n/p`` keys in [0, 2^32).  These are the inputs the
robustness claims are tested against:

  Uniform      independent random values
  Gaussian     independent Gaussian values
  BucketSorted locally random, globally sorted (hits hypercube routing)
  g-Group      g = √p groups, PE-correlated placement
  Zero         all elements equal
  DeterDupl    only log p distinct keys
  RandDupl     32 local buckets filled with values from 0..31
  Staggered    PE-correlated halves (hard for hypercube splits)
  Mirrored     bit-reversed PE ranges — √p·⌊n/√p⌋ concentration after
               log(p)/2 naive quicksort recursions (paper §VII)
  AllToOne     last element of PE i is p−i; naive k-way sample sort sends
               min(p, n/p) messages to PE 0 on level 1
  Reverse      globally reverse-sorted
"""
from __future__ import annotations

import numpy as np

_M32 = np.int64(2 ** 32 - 1)


def _rng(seed, i):
    return np.random.default_rng((seed * 1_000_003 + i) & 0x7FFFFFFF)


def uniform(i, p, m, seed=0):
    return _rng(seed, i).integers(0, 2 ** 32, size=m, dtype=np.int64)


def gaussian(i, p, m, seed=0):
    g = _rng(seed, i).normal(2 ** 31, 2 ** 28, size=m)
    return np.clip(g, 0, float(_M32)).astype(np.int64)


def bucket_sorted(i, p, m, seed=0):
    lo = (2 ** 32 // p) * i
    hi = lo + (2 ** 32 // p)
    return _rng(seed, i).integers(lo, max(hi, lo + 1), size=m, dtype=np.int64)


def g_group(i, p, m, seed=0):
    g = max(1, int(np.sqrt(p)))
    grp = (i + p // 2) % g                     # PE→group, offset pattern
    width = 2 ** 32 // g
    lo = grp * width
    return _rng(seed, i).integers(lo, lo + width, size=m, dtype=np.int64)


def zero(i, p, m, seed=0):
    return np.zeros(m, dtype=np.int64)


def deter_dupl(i, p, m, seed=0):
    k = max(1, int(np.log2(max(p, 2))))
    return _rng(seed, i).integers(0, k, size=m, dtype=np.int64)


def rand_dupl(i, p, m, seed=0):
    r = _rng(seed, i)
    sizes = r.multinomial(m, np.ones(32) / 32)
    vals = r.integers(0, 32, size=32)
    return np.repeat(vals, sizes).astype(np.int64)


def staggered(i, p, m, seed=0):
    # PE i gets values concentrated in the "staggered" partner range
    half = p // 2 or 1
    j = (i // 2 + (i % 2) * half) % p
    width = 2 ** 32 // p
    lo = j * width
    return _rng(seed, i).integers(lo, lo + width, size=m, dtype=np.int64)


def _bit_reverse(x, bits):
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def mirrored(i, p, m, seed=0):
    bits = max(1, p.bit_length() - 1)
    mi = _bit_reverse(i, bits)
    lo = (2 ** 31 // max(mi, 1)) if mi else 2 ** 31
    hi = 2 ** 31 // (mi + 1)
    lo, hi = min(lo, hi), max(lo, hi) + 1
    return _rng(seed, i).integers(lo, hi, size=m, dtype=np.int64)


def all_to_one(i, p, m, seed=0):
    r = _rng(seed, i)
    lo = min(p + (p - i) * ((2 ** 32 - p) // p), 2 ** 32 - 2)
    hi = min(p + (p - i + 1) * ((2 ** 32 - p) // p), 2 ** 32 - 1)
    out = r.integers(lo, max(hi, lo + 1), size=m, dtype=np.int64)
    if m:
        out[-1] = p - i
    return out


def reverse(i, p, m, seed=0):
    width = 2 ** 32 // p
    lo = (p - 1 - i) * width
    base = _rng(seed, i).integers(lo, lo + width, size=m, dtype=np.int64)
    return -np.sort(-base)


INSTANCES = {
    "Uniform": uniform, "Gaussian": gaussian, "BucketSorted": bucket_sorted,
    "g-Group": g_group, "Zero": zero, "DeterDupl": deter_dupl,
    "RandDupl": rand_dupl, "Staggered": staggered, "Mirrored": mirrored,
    "AllToOne": all_to_one, "Reverse": reverse,
}


def generate_instance(name: str, p: int, n: int, seed: int = 0):
    """Global array (n,) formed from the per-PE generators (PE-major)."""
    gen = INSTANCES[name]
    per = -(-n // p) if n else 0
    parts = []
    left = n
    for i in range(p):
        m = min(per, left)
        parts.append(gen(i, p, m, seed))
        left -= m
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)
