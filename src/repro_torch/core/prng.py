"""Bit-exact threefry2x32 counterpart of the ``jax.random`` calls on the
RAMS and RQuick paths: ``PRNGKey``, ``fold_in``, ``randint``, ``uniform``
and ``bernoulli``.

It reproduces jax 0.9.0 with ``jax_enable_x64`` on and
``jax_threefry_partitionable=True`` (the settings ``repro.core`` runs
under), so the shuffle destinations and the level samples of the port are
the reference's own.  The uint32 words are held in int64 tensors and every
wrapping operation is masked with ``& 0xFFFFFFFF``: torch has no uint32
arithmetic with shifts and remainders on every device.

Keys are int64 tensors of shape (..., 2) (the two uint32 words); a leading
batch shape carries one key per PE, which is how the PE-batched bodies
fold the PE index into a common seed.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block function (20 rounds) on broadcastable int64
    tensors holding uint32 words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed split into (hi, lo)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter pair (0, data).

    ``data`` is an int or an integer tensor; its shape broadcasts against
    the key's batch shape (a (p,) tensor of PE indices folds one index into
    each of p keys)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    k1, k2 = key[..., 0], key[..., 1]
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def _split2(key):
    """``jax.random.split(key, 2)`` in the partitionable layout."""
    k1, k2 = key[..., 0], key[..., 1]
    zero = torch.zeros_like(k1)
    a1, a2 = threefry2x32(k1, k2, zero, zero)
    b1, b2 = threefry2x32(k1, k2, zero, zero + 1)
    return torch.stack([a1, a2], -1), torch.stack([b1, b2], -1)


def _bits64(key, n: int):
    """64 random bits per element of a length-n draw, as (hi, lo) words.

    The partitionable layout hashes the 64-bit counter ``arange(n)`` split
    into its (hi, lo) words; n < 2^32 here, so the hi counter is 0."""
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0, None], key[..., 1, None],
                        torch.zeros_like(ctr), ctr)


_ONE_BITS = 0x3FF0000000000000                  # the bits of float64 1.0


def uniform(key: torch.Tensor, n=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in x64 mode, where it is float64
    in [0, 1): one 64-bit draw per element, its top 52 bits as the
    mantissa of a float in [1, 2), minus one.  ``n=None`` is the scalar
    shape ``()``.  A batch of keys gives one row per key."""
    hi, lo = _bits64(key, 1 if n is None else n)
    mant = (hi << 20) | (lo >> 12)               # bits >> 12, 52 bits
    out = (mant | _ONE_BITS).view(torch.float64) - 1.0
    return out[..., 0] if n is None else out


def bernoulli(key: torch.Tensor, n=None) -> torch.Tensor:
    """``jax.random.bernoulli(key)`` with its default p = 0.5 (a float64
    in x64 mode): ``uniform(key) < 0.5``, so the draw's top bit is 0."""
    return uniform(key, n) < 0.5


def randint(key: torch.Tensor, n: int, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` with the default
    int64 dtype of x64 mode; ``minval``/``maxval`` are ints or tensors that
    broadcast against the key's batch shape (one bound per PE).

    JAX draws two 64-bit words and reduces ``(hi·2^64 + lo) mod span`` as
    ``((hi mod span)·(2^64 mod span) + lo mod span) mod span``.  Each 64-bit
    word is itself reduced here from its two 32-bit halves so that every
    intermediate stays below 2^63; that needs ``span < 2^31``."""
    dev = key.device
    batch = key.shape[:-1]

    def bound(v):                                # scalar, or one per key
        v = torch.as_tensor(v, dtype=torch.int64, device=dev)
        return v.unsqueeze(-1) if v.dim() else v

    lo_v, hi_v = bound(minval), bound(maxval)
    span = torch.where(hi_v <= lo_v, torch.ones_like(hi_v), hi_v - lo_v)
    if int(span.max()) >= 1 << 31:
        raise ValueError("randint span must be below 2^31")
    k_hi, k_lo = _split2(key)
    w32 = (1 << 32) % span                       # 2^32 mod span

    def mod64(h, l):                             # (h·2^32 + l) mod span
        return ((h % span) * w32 + l % span) % span

    higher = mod64(*_bits64(k_hi, n))
    lower = mod64(*_bits64(k_lo, n))
    mult = (w32 * w32) % span                    # 2^64 mod span
    off = (higher * mult + lower) % span
    out = lo_v + off
    return out.expand(batch + (n,)) if batch else out.reshape(n)
