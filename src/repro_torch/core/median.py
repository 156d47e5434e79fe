"""Approximate median selection with a single reduction, and its rank
generalisation (counterpart of the window functions of
``repro/core/median.py``; see there for the algorithm).

Every PE takes the k elements around its local median; at each butterfly
step it exchanges its window with partner ``i ^ 2^t`` and keeps the middle
k of the merged 2k, so every PE of the subcube ends with the same window.
The rank windows do the same around a rank fraction per query (a batch of
B of them at once), seeding the candidates of the selection queries
(``queries.py``).

Windows live in the reference's lifted space, real key u ↦ u + 1 with 0
as the "-inf" filler and 2^64 − 1 as "+inf", a uint64.  The port holds a
lifted word sign-flipped in int64 (``lifted ^ 0x80…0``, so signed order is
the reference's unsigned order): the fillers are :data:`LO` = −2^63 and
:data:`HI` = 2^63 − 1.  Windows are (p, k) tensors, one row per PE.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import prng
from .hypercube import hc_exchange
from .types import SortShard

LO = -(1 << 63)                 # lifted 0, the -inf filler
HI = (1 << 63) - 1              # lifted 2^64 - 1, the +inf filler
_M32 = 0xFFFFFFFF


def lift(keys: torch.Tensor) -> torch.Tensor:
    """The port's words → lifted int64 words, the reference's ``u + 1`` in
    uint64 held sign-flipped.  An int32 word (4-byte key) is the unsigned
    key ``s + 2^31``, lifted ``+ 1``, flipped ``− 2^63``, and never wraps.
    An int64 word (8-byte key) is already the flipped u64, so its lift is
    ``s + 1``, and the largest key (INT64_MAX, the u64 2^64 − 1) wraps to
    :data:`LO`, the −inf filler, as the reference's uint64 does; the wrap
    is written out, with no signed overflow."""
    if keys.dtype == torch.int64:
        top = keys == HI
        return torch.where(top, LO, keys + ~top)
    return keys.to(torch.int64) + ((1 << 31) + 1 + LO)


def unlift(w: torch.Tensor, dtype: torch.dtype = torch.int32
           ) -> torch.Tensor:
    """Inverse of :func:`lift` for words of ``dtype``, wrapping like the
    reference's ``(w − 1)`` cast to the key's unsigned type: to uint32 a
    filler maps to the word of 0xFFFFFFFF or 0xFFFFFFFE; to uint64 ``LO``
    wraps to INT64_MAX, with no signed overflow."""
    if dtype == torch.int64:
        bottom = w == LO
        return torch.where(bottom, HI, w - (~bottom).to(torch.int64))
    u = ((w ^ LO) - 1) & _M32                      # the reference's uint32
    return (u - (1 << 31)).to(torch.int32)


def planes(words: torch.Tensor):
    """Sign-flipped u64 words (int64: lifted words, or 8-byte keys) → the
    partition kernel's planes: the u64's (hi, lo) u32 words as a
    sign-flipped int32 key plane (``hi − 2^31``) and an int32 tie plane
    holding ``lo``'s bits, which compare as the u64 does."""
    u = words ^ LO                                 # the u64's bits
    hi, lo = (u >> 32) & _M32, u & _M32
    key = (hi - (1 << 31)).to(torch.int32)
    tie = (lo - ((lo >> 31) << 32)).to(torch.int32)
    return key.contiguous(), tie.contiguous()


def _coin(seed: int, *fold) -> int:
    """``jax.random.bernoulli`` of ``PRNGKey(seed)`` folded with ``fold``,
    drawn on the host: the coin is one per subcube call, not per PE."""
    key = prng.PRNGKey(seed)
    for d in fold:
        key = prng.fold_in(key, d)
    return int(prng.bernoulli(key))


def local_window(shard: SortShard, k: int, coin: int) -> torch.Tensor:
    """Each PE's k elements around its local median, ±inf-filled: positions
    ``m//2 − k/2 (+ coin when m is odd)`` onward of its valid keys, LO
    before them and HI past the count.  A gather with a per-row start (no
    filler concatenation)."""
    assert k % 2 == 0, "window size k must be even"
    m = shard.count
    start = m // 2 - k // 2 + torch.where(m % 2 == 1, coin, 0)
    idx = start[:, None] + torch.arange(k, device=m.device)[None, :]
    got = torch.gather(shard.keys, 1, idx.clamp(0, shard.capacity - 1))
    return torch.where(idx < 0, LO,
                       torch.where(idx < m[:, None], lift(got), HI))


def merge_windows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Middle k of the merged 2k (the internal-node step), per row."""
    k = a.shape[1]
    merged = torch.sort(torch.cat([a, b], dim=1), dim=1)[0]
    return merged[:, k // 2:k // 2 + k].contiguous()


def local_rank_window(shard: SortShard, k: int,
                      frac: torch.Tensor) -> torch.Tensor:
    """Each PE's k elements around its local rank ``floor(frac·(m − 1))``
    for each of the (B,) float64 rank fractions ``frac``, ±inf-filled:
    (p, B, k) lifted words.  The start is computed in float64, cast to an
    integer and moved ``− k/2 + 1``, as the reference computes it."""
    assert k % 2 == 0, "window size k must be even"
    m = shard.count
    frac = torch.as_tensor(frac, dtype=torch.float64, device=m.device)
    r = torch.floor(frac.reshape(1, -1) * torch.clamp(
        m - 1, min=0).to(torch.float64)[:, None])                 # (p, B)
    start = r.to(torch.int64) - k // 2 + 1
    idx = start[:, :, None] + torch.arange(k, device=m.device)
    got = torch.gather(shard.keys, 1, idx.clamp(0, shard.capacity - 1)
                       .reshape(m.shape[0], -1)).reshape(idx.shape)
    return torch.where(idx < 0, LO,
                       torch.where(idx < m[:, None, None], lift(got), HI))


def merge_rank_windows(a: torch.Tensor, b: torch.Tensor,
                       frac: torch.Tensor) -> torch.Tensor:
    """The k-window of the merged 2k at rank fraction ``frac`` (B,):
    start ``clip(round(frac·2k) − k/2, 0, k)``, rounding half to even as
    ``jnp.round`` does.  ``a``, ``b`` are (p, B, k)."""
    k = a.shape[-1]
    merged = torch.sort(torch.cat([a, b], dim=-1), dim=-1)[0]
    frac = torch.as_tensor(frac, dtype=torch.float64, device=a.device)
    start = torch.clamp(torch.round(frac * (2 * k)).to(torch.int32) - k // 2,
                        0, k).to(torch.int64)                       # (B,)
    idx = start[:, None] + torch.arange(k, device=a.device)         # (B, k)
    return torch.gather(merged, -1, idx.expand(a.shape[:-1] + (k,)))


def butterfly_rank_window(shard: SortShard, p: int, dims: Sequence[int],
                          k: int, fracs: torch.Tensor) -> torch.Tensor:
    """Per-query rank windows (p, B, k), agreed across the subcube spanned
    by ``dims``: the leaf windows, then at each step the partner's
    windows (one ``ppermute`` of the (B, k) words a PE) merged at each
    query's fraction."""
    w = local_rank_window(shard, k, fracs)
    for t in dims:
        w = merge_rank_windows(w, hc_exchange(w, p, t), fracs)
    return w


def butterfly_median_window(shard: SortShard, p: int, dims: Sequence[int],
                            k: int, seed: int) -> torch.Tensor:
    """All PEs of the subcube spanned by ``dims`` obtain the same k-window;
    the centring coin is drawn from ``PRNGKey(seed)``, with no PE term."""
    w = local_window(shard, k, _coin(seed))
    for t in dims:
        w = merge_windows(w, hc_exchange(w, p, t))
    return w


def splitter_from_window(w: torch.Tensor, seed: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's window median, still lifted: ``w[k/2 − 1 + coin]``, or
    the other middle entry where the coin picked a filler.  Returns
    (splitter (p,), is_empty (p,)); a window of fillers only means the
    subcube holds no elements."""
    k = w.shape[1]
    coin = _coin(seed, 1)
    s, other = w[:, k // 2 - 1 + coin], w[:, k // 2 - coin]
    s = torch.where((s == LO) | (s == HI), other, s)
    return s, (s == LO) | (s == HI)
