"""Distributed selection and query primitives, the sort-free fast paths
(counterpart of ``repro/core/queries.py``; see there for the algorithm).

``top_k``, ``rank_of_key``, ``percentile`` and ``range_query`` need one
order statistic and a small extraction, not a sort.  Each refinement round
proposes candidates (a 16-point grid over the active key interval, a
16-point sketch pooled from every PE's keys in it, and in round 0 the
butterfly rank window of ``median.py``), counts them with one ``psum`` of
per-PE ``searchsorted`` ranks, and either finds the rank-t key among them
or shrinks the interval by at least 4 bits; ``ceil(bits/4)`` static rounds
pin it exactly, so every answer is bit for bit the full sort's.

Queries run against a :class:`ResidentData`: the dataset as (p, cap) rows
of the port's sign-flipped words (int32 for 4-byte keys, int64 for 8-byte
ones), each row sorted by :func:`shard_data` through ``local_sort`` (the
tile-sort and run-merge kernels on the card for 4-byte keys).  The per-PE
bodies run over all p rows at once with the port's collectives, recorded
under the reference's ``query:*`` tags; a batch of B queries runs every
round on (p, B, ·) tensors and reads its answers back once.

Unsigned arithmetic of the reference (the grid's span, ``cands ± 1``) is
written out so that no signed word overflows: 4-byte words as unsigned
values in int64, 8-byte words as two 32-bit halves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import comm
from .median import HI, LO, butterfly_rank_window, unlift
from .rams import quantile_splitters
from .types import SortShard, key_to_int, local_sort, pad_value, \
    resolve_device

GRID = 16       # deterministic interval-grid candidates per round
SKETCH = 16     # pooled stride-sketch candidates per round
WINDOW_K = 16   # butterfly rank-window size (4-byte keys only)

QUERY_KINDS = ("sort", "top_k", "rank_of_key", "percentile", "range_query")
BACKENDS = ("sim", "shard_map")

_M32 = 0xFFFFFFFF


def n_rounds(bits: int) -> int:
    """Static refinement rounds: the 16-point grid splits the active
    interval into ≥ 17 parts, so each round resolves ≥ 4 key bits."""
    return -(-bits // 4)


# ---------------------------------------------------------------------------
# Resident data
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResidentData:
    """A dataset laid out for repeated queries: (p, cap) rows of the
    port's words on the device (PE-major, ``psort``'s input layout), each
    sorted ascending with the pad word as its tail, the (p,) int32 valid
    counts, n, and the keys' numpy dtype."""

    keys: torch.Tensor          # (p, cap) int32 / int64 words, rows sorted
    counts: torch.Tensor        # (p,) int32
    n: int
    orig_dtype: np.dtype

    @property
    def p(self) -> int:
        return self.keys.shape[0]

    @property
    def cap(self) -> int:
        return self.keys.shape[1]

    @property
    def bits(self) -> int:
        return self.keys.element_size() * 8

    @property
    def device(self) -> torch.device:
        return self.keys.device


def _np_dtype(x: torch.Tensor) -> np.dtype:
    return np.dtype(str(x.dtype).removeprefix("torch."))


def _upload(device, *arrays):
    """numpy arrays → tensors on ``device`` in one host-to-device copy,
    which on the card goes from pinned memory and does not wait: a batch's
    only synchronisation is the read back of its answers."""
    parts, offs, off = [], [], 0
    for a in arrays:
        raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        offs.append(off)
        parts += [raw, np.zeros(-raw.size % 8, np.uint8)]
        off += raw.size + parts[-1].size
    buf = torch.from_numpy(np.concatenate(parts))
    if torch.device(device).type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    return [buf[o:o + a.nbytes].view(torch.from_numpy(
        np.empty(0, a.dtype)).dtype).reshape(a.shape)
        for o, a in zip(offs, arrays)]


def _words_of(a: np.ndarray, device) -> torch.Tensor:
    """numpy keys → the port's words on ``device``, converted on the host
    and sent with :func:`_upload`."""
    w = key_to_int(torch.from_numpy(np.ascontiguousarray(a))).numpy()
    return _upload(device, w)[0]


def _np_keys(w: np.ndarray, dtype) -> np.ndarray:
    """The port's words (numpy int32 / int64) → keys of ``dtype``, the
    reference's ``uint_to_key`` of the unsigned word."""
    dtype = np.dtype(dtype)
    it = w.dtype.type
    if dtype.kind == "i":
        return w.view(dtype)
    if dtype.kind == "u":
        return (w ^ it(np.iinfo(it).min)).view(dtype)
    return np.where(w < 0, w ^ it(np.iinfo(it).max), w).view(dtype)


def shard_data(keys, p: int, *, device=None) -> ResidentData:
    """Shard 1-D keys (numpy or torch) over p PEs and sort each shard, on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    x = keys if isinstance(keys, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(keys))
    if x.dim() != 1:
        raise ValueError(f"resident data must be 1-D; got {tuple(x.shape)}")
    if p < 1 or p & (p - 1):
        raise ValueError(f"p={p} must be a power of two (hypercube layout)")
    orig = _np_dtype(x)
    dev = resolve_device(device)
    n = x.shape[0]
    s = key_to_int(x.to(dev))
    per = -(-max(n, 1) // p)
    flat = torch.full((p * per,), pad_value(s.dtype), dtype=s.dtype,
                      device=dev)
    flat[:n] = s
    del s
    counts = torch.clamp(n - per * torch.arange(p, device=dev), 0, per)
    rows = local_sort(SortShard(flat.reshape(p, per), {}, counts),
                      max_count=min(per, n)).keys
    return ResidentData(rows, counts.to(torch.int32), n, orig)


# ---------------------------------------------------------------------------
# Per-PE bodies over all p rows
# ---------------------------------------------------------------------------


def _local_ranks(rows, count, cands):
    """(#row < c, #row ≤ c) for the (p, ...) candidates of each PE,
    restricted to the valid prefix (``count`` (p,) int64), int64."""
    p = rows.shape[0]
    flat = cands.reshape(p, -1).contiguous()
    c = count[:, None]
    lt = torch.minimum(torch.searchsorted(rows, flat), c)
    le = torch.minimum(torch.searchsorted(rows, flat, right=True), c)
    return lt.reshape(cands.shape), le.reshape(cands.shape)


def _counts_body(rows, count, cands):
    """Global (n_lt, n_le) of each PE's (p, nc) candidates: one psum."""
    with comm.tagged("query:counts"):
        lt, le = _local_ranks(rows, count, cands)
        g = comm.psum(torch.stack([lt, le], dim=1))
    return g[:, 0], g[:, 1]


def _sketch_candidates(rows, count, lo, hi):
    """SKETCH pooled candidates per query (p, B, SKETCH): each PE's stride
    sketch of its keys inside [lo, hi], one all_gather, and evenly spaced
    order statistics of the pooled samples."""
    p, cap = rows.shape
    B = lo.shape[1]
    pad = pad_value(rows.dtype)
    c = count[:, None]
    a = torch.minimum(torch.searchsorted(rows, lo), c)               # (p, B)
    b = torch.minimum(torch.searchsorted(rows, hi, right=True), c)
    ln = b - a
    jj = torch.arange(SKETCH, device=rows.device)
    pos = a[..., None] + ((2 * jj + 1) * ln[..., None]) // (2 * SKETCH)
    samp = torch.gather(rows, 1, pos.clamp(0, cap - 1).reshape(p, -1))
    samp = torch.where(ln[..., None] > 0, samp.reshape(p, B, SKETCH), pad)
    g = comm.all_gather(samp)                                  # (p, p, B, S)
    pooled = torch.sort(g.transpose(1, 2).reshape(p * B, -1), dim=1)[0]
    del g
    sk = quantile_splitters(pooled, SKETCH + 1, invalid=pad).reshape(
        p, B, SKETCH)
    sk = torch.where(sk == pad, lo[..., None], sk)
    return torch.minimum(torch.maximum(sk, lo[..., None]), hi[..., None])


def _halves(w):
    """int64 words → the unsigned 64-bit value as (hi, lo) 32-bit halves,
    each held in int64."""
    return (w >> 32) + (1 << 31), w & _M32


def _join(hi, lo):
    """Inverse of :func:`_halves`; no product or sum leaves int64."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def _grid_candidates(lo, hi):
    """GRID probes splitting [lo, hi] into ≥ 17 parts, ``lo + min(j ·
    max(span // 17, 1), span)`` for j = 1..16 in the keys' unsigned
    arithmetic (the span, the sum wrapping as the reference's do): (…,
    GRID) words of ``lo``'s dtype."""
    j = torch.arange(1, GRID + 1, device=lo.device)
    if lo.dtype == torch.int32:
        lu = lo.to(torch.int64) + (1 << 31)
        span = (hi.to(torch.int64) + (1 << 31) - lu) & _M32
        off = torch.minimum(
            j * torch.clamp(span // (GRID + 1), min=1)[..., None],
            span[..., None])
        return (((lu[..., None] + off) & _M32) - (1 << 31)).to(torch.int32)
    lh, ll = _halves(lo)
    hh, hl = _halves(hi)
    sl = hl - ll                                        # span, mod 2^64
    borrow = (sl < 0).to(torch.int64)
    sl = sl + (borrow << 32)
    sh = (hh - lh - borrow) & _M32
    qh = sh // (GRID + 1)                               # span // 17, long
    ql = ((sh - qh * (GRID + 1)) * (1 << 32) + sl) // (GRID + 1)
    ql = torch.where((qh == 0) & (ql == 0), 1, ql)      # max(step, 1)
    pl = j * ql[..., None]                              # j · step < 2^64
    oh = j * qh[..., None] + (pl >> 32)
    ol = pl & _M32
    sh, sl = sh[..., None], sl[..., None]
    within = (oh < sh) | ((oh == sh) & (ol <= sl))      # min(off, span)
    oh, ol = torch.where(within, oh, sh), torch.where(within, ol, sl)
    cl = ll[..., None] + ol                             # lo + off, mod 2^64
    ch = (lh[..., None] + oh + (cl >> 32)) & _M32
    return _join(ch, cl & _M32)


def _window_candidates(rows, count, fracs, p: int):
    """Round-0 candidates from the butterfly rank window (4-byte keys):
    the window's keys, and key 1 for every ±inf filler, as the
    reference's code computes it (its docstring says 0)."""
    dims = list(range(p.bit_length() - 1))
    sh = SortShard(keys=rows, vals={}, count=count)
    with comm.tagged("query:window"):
        w = butterfly_rank_window(sh, p, dims, WINDOW_K, fracs)
    filler = (w == LO) | (w == HI)
    return torch.where(filler, 1 - (1 << 31), unlift(w))


def _select_body(rows, count, ranks, fracs, p: int, bits: int,
                 use_window: bool):
    """Exact global order statistics of the (B,) 1-indexed ``ranks``:
    (ans (p, B) words, n_lt (p, B), n_le (p, B)), the same on every PE."""
    R = n_rounds(bits)
    P, B = rows.shape[0], ranks.shape[0]
    dt, dev = rows.dtype, rows.device
    umax = pad_value(dt)
    umin = -umax - 1                                    # the unsigned 0
    lo = torch.full((P, B), umin, dtype=dt, device=dev)
    hi = torch.full((P, B), umax, dtype=dt, device=dev)
    done = torch.zeros((P, B), dtype=torch.bool, device=dev)
    ans = lo.clone()
    wc = _window_candidates(rows, count, fracs, p) if use_window else None
    t = ranks[None, :, None]
    for r in range(R):
        with comm.tagged(f"query:round{r}"):
            parts = [_grid_candidates(lo, hi),
                     _sketch_candidates(rows, count, lo, hi)]
            if r == 0 and wc is not None:
                parts.append(wc)
            cands = torch.cat(parts, dim=2)                 # (P, B, nb)
            lt, le = _local_ranks(rows, count, cands)
            g = comm.psum(torch.stack([lt, le], dim=1))
        glt, gle = g[:, 0], g[:, 1]
        # a candidate straddling the rank is the answer; otherwise every
        # candidate brackets it (c + 1 at umax and c − 1 at 0 are never
        # selected, so those lanes keep c instead of overflowing)
        hit = (glt < t) & (t <= gle)
        anyhit = hit.any(dim=2)
        cand_ans = torch.where(hit, cands, umin).amax(dim=2)
        lo_new = torch.where(gle < t, cands + (cands != umax).to(dt),
                             lo[..., None]).amax(dim=2)
        hi_new = torch.where(glt >= t, cands - (cands != umin).to(dt),
                             hi[..., None]).amin(dim=2)
        upd = ~done & anyhit
        ans = torch.where(upd, cand_ans, ans)
        done = done | upd
        lo = torch.where(done, lo, torch.maximum(lo, lo_new))
        hi = torch.where(done, hi, torch.minimum(hi, hi_new))
        pinched = ~done & (lo >= hi)
        ans = torch.where(pinched, lo, ans)
        done = done | pinched
    ans = torch.where(done, ans, lo)
    with comm.tagged("query:verify"):
        lt, le = _local_ranks(rows, count, ans)
        g = comm.psum(torch.stack([lt, le], dim=1))
    return ans, g[:, 0], g[:, 1]


def _extract_gt(rows, count, theta, k_cap: int):
    """Each PE's tail of keys strictly above ``theta`` (p, B), at most
    ``k_cap`` of them: (vals (p, B, k_cap) pad-filled, ln (p, B))."""
    P, cap = rows.shape
    c = count[:, None]
    s = torch.minimum(torch.searchsorted(rows, theta, right=True), c)
    ln = c - s
    jj = torch.arange(k_cap, device=rows.device)
    pos = (s[..., None] + jj).clamp(0, cap - 1)
    vals = torch.gather(rows, 1, pos.reshape(P, -1)).reshape(pos.shape)
    return torch.where(jj < ln[..., None], vals, pad_value(rows.dtype)), ln


# ---------------------------------------------------------------------------
# Host-level query API
# ---------------------------------------------------------------------------


def _check_backend(backend: str):
    if backend == "shard_map":
        raise NotImplementedError(
            "backend='shard_map' is not ported yet: ROADMAP queue 1 item 7 "
            "(torch.distributed backend)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")


def _as_batch(x, dtype=None):
    a = np.asarray(x) if dtype is None else np.asarray(x, dtype)
    scalar = a.ndim == 0
    return np.atleast_1d(a), scalar


def _select(data: ResidentData, ranks_np, use_window: bool, *extra):
    """The selection body on ``data``'s device for host ranks: (ans, n_lt,
    n_le) and the ``extra`` host arrays, uploaded with the ranks."""
    fracs = (ranks_np - 1) / max(data.n - 1, 1)           # float64
    ranks, fracs, *rest = _upload(data.device, np.asarray(ranks_np,
                                                          np.int64),
                                  fracs, *extra)
    return _select_body(data.keys, data.counts.to(torch.int64), ranks,
                        fracs, data.p, data.bits, use_window) + tuple(rest)


def _read_back(*rows) -> np.ndarray:
    """Row 0 of each (p, B) device result, read back in one copy as
    (len(rows), B) int64."""
    return torch.stack([r[0].to(torch.int64) for r in rows]).cpu().numpy()


def _words_np(data: ResidentData, a: np.ndarray) -> np.ndarray:
    return a.astype(np.int32 if data.bits == 32 else np.int64)


def select_rank(data: ResidentData, ranks, *, backend: str = "sim",
                axis: str = "sort", mesh=None, window: bool = True):
    """Exact keys of the given global ranks (1-indexed, ascending order).

    Returns ``(values, n_lt, n_le)``: ``values[b]`` is bitwise
    ``np.sort(keys)[ranks[b] - 1]`` and the counts are the elements
    strictly below / at or below it.  ``axis`` and ``mesh`` name the
    reference's shard_map layout, which the sim backend does not read."""
    _check_backend(backend)
    ranks_np, scalar = _as_batch(ranks, np.int64)
    if data.n < 1:
        raise ValueError("select_rank on empty resident data")
    if (ranks_np < 1).any() or (ranks_np > data.n).any():
        raise ValueError(f"ranks must lie in [1, n={data.n}]; got {ranks_np}")
    if ranks_np.size == 0:
        # the reference's error: its reshape of a batch of 0 divides by 0
        raise ZeroDivisionError("select_rank of an empty batch of ranks")
    use_window = window and data.bits == 32 and data.p > 1
    host = _read_back(*_select(data, ranks_np, use_window))
    ans = _np_keys(_words_np(data, host[0]), data.orig_dtype)
    glt, gle = host[1], host[2]
    if scalar:
        return ans[0], glt[0], gle[0]
    return ans, glt, gle


def rank_of_key(data: ResidentData, keys, *, backend: str = "sim",
                axis: str = "sort", mesh=None):
    """Global ranks of the given key values, ``(n_lt, n_le)``: the
    elements strictly below / at or below each key, compared as the
    keys' unsigned words."""
    _check_backend(backend)
    k_np, scalar = _as_batch(keys, data.orig_dtype)
    u = _words_of(k_np, data.device)
    glt, gle = _counts_body(data.keys, data.counts.to(torch.int64),
                            u[None].expand(data.p, -1))
    glt, gle = _read_back(glt, gle)
    if scalar:
        return glt[0], gle[0]
    return glt, gle


def percentile(data: ResidentData, q, *, backend: str = "sim",
               axis: str = "sort", mesh=None):
    """Exact percentile values (NumPy ``interpolation="lower"``): the
    element at sorted index ``floor(q/100 · (n − 1))``."""
    q_np, scalar = _as_batch(q, np.float64)
    if (q_np < 0).any() or (q_np > 100).any():
        raise ValueError(f"percentiles must lie in [0, 100]; got {q_np}")
    ranks = np.floor(q_np / 100.0 * (data.n - 1)).astype(np.int64) + 1
    vals, _, _ = select_rank(data, ranks, backend=backend, axis=axis,
                             mesh=mesh)
    return vals[0] if scalar else vals


def top_k(data: ResidentData, k, *, backend: str = "sim",
          axis: str = "sort", mesh=None):
    """The k largest resident keys, ascending: bitwise
    ``np.sort(keys)[-k:]``; a list of arrays for a (B,) batch of k.

    One exact selection finds θ, the key of rank n − k + 1; each PE's
    tail above θ is compacted on the device, the k − n_gt copies of θ
    added and every row sorted, so a batch reads back once."""
    _check_backend(backend)
    k_np, scalar = _as_batch(k, np.int64)
    if (k_np < 1).any() or (k_np > data.n).any():
        raise ValueError(f"k must lie in [1, n={data.n}]; got {k_np}")
    ranks = data.n - k_np + 1
    k_cap = int(min(data.cap, k_np.max()))
    use_window = data.bits == 32 and data.p > 1
    count = data.counts.to(torch.int64)
    ans, _, gle, kk = _select(data, ranks, use_window, k_np)
    vals, ln = _extract_gt(data.keys, count, ans, k_cap)
    dev, dt = data.device, data.keys.dtype
    B, kmax = len(k_np), int(k_np.max())
    theta, n_gt = ans[0], data.n - gle[0]                       # (B,)
    above = ln.sum(dim=0)                                       # (B,)
    # each PE's tail at its offset among the PEs before it; entries past
    # a tail go to a dump column
    jj = torch.arange(k_cap, device=dev)
    dst = (torch.cumsum(ln, dim=0) - ln)[..., None] + jj       # (p, B, k)
    dst = torch.where((jj < ln[..., None]) & (dst < kmax), dst, kmax)
    dst = dst + torch.arange(B, device=dev)[:, None] * (kmax + 1)
    buf = torch.full((B * (kmax + 1),), pad_value(dt), dtype=dt, device=dev)
    buf.scatter_(0, dst.reshape(-1), vals.reshape(-1))
    buf = buf.reshape(B, kmax + 1)[:, :kmax]
    col = torch.arange(kmax, device=dev)[None, :]
    buf = torch.where((col >= n_gt[:, None]) & (col < kk[:, None]),
                      theta[:, None], buf)
    out = torch.sort(buf, dim=1)[0]                # the first k of row b
    host = torch.cat([out.to(torch.int64), above[:, None], n_gt[:, None]],
                     dim=1).cpu().numpy()
    if not np.array_equal(host[:, kmax], host[:, kmax + 1]):
        raise AssertionError((host[:, kmax], host[:, kmax + 1]))
    words = _words_np(data, host[:, :kmax])
    outs = [_np_keys(np.ascontiguousarray(words[b, :k_np[b]]),
                     data.orig_dtype) for b in range(B)]
    return outs[0] if scalar else outs


def range_query(data: ResidentData, lo, hi, *, backend: str = "sim",
                axis: str = "sort", mesh=None):
    """Number of resident keys in the half-open interval [lo, hi): the
    oracle's ``searchsorted(hi, "left") − searchsorted(lo, "left")``, 0
    when hi ≤ lo."""
    _check_backend(backend)
    lo_np, scalar = _as_batch(lo, data.orig_dtype)
    hi_np, _ = _as_batch(hi, data.orig_dtype)
    if lo_np.shape != hi_np.shape:
        raise ValueError(f"lo/hi shape mismatch: {lo_np.shape} vs "
                         f"{hi_np.shape}")
    both = _words_of(np.concatenate([lo_np, hi_np]), data.device)
    glt, _ = _counts_body(data.keys, data.counts.to(torch.int64),
                          both[None].expand(data.p, -1))
    glt = _read_back(glt)[0]
    b = len(lo_np)
    cnt = np.maximum(glt[b:] - glt[:b], 0)
    return cnt[0] if scalar else cnt


# ---------------------------------------------------------------------------
# Counted traces
# ---------------------------------------------------------------------------


def trace_query(kind: str, n: int, p: int, *, batch: int = 1,
                dtype=np.uint32, k: Optional[int] = None,
                device=None) -> comm.CommTrace:
    """The collectives one batched query launches, per PE, as the
    reference's ``trace_query`` counts them.  The reference evaluates the
    body on shapes alone; the port runs it on ``device`` (the card unless
    the caller passes ``"cpu"``) over rows of pad words inside a
    ``comm.counting`` scope: the same events.  ``kind="sort"`` is
    ``trace_collectives(n, SortConfig(p=p))``."""
    if kind not in QUERY_KINDS:
        raise ValueError(f"unknown query kind {kind!r}; know {QUERY_KINDS}")
    if p < 1 or p & (p - 1):
        raise ValueError(f"p={p} must be a power of two")
    if kind == "sort":
        from .api import SortConfig, trace_collectives
        return trace_collectives(n, SortConfig(p=p), device=device)
    dev = resolve_device(device)
    bits = np.dtype(dtype).itemsize * 8
    per = -(-max(n, 1) // p)
    dt = torch.int32 if bits == 32 else torch.int64
    rows = torch.full((p, per), pad_value(dt), dtype=dt, device=dev)
    count = torch.zeros(p, dtype=torch.int64, device=dev)
    with comm.counting() as trace:
        if kind in ("rank_of_key", "range_query"):
            nc = batch if kind == "rank_of_key" else 2 * batch
            _counts_body(rows, count, rows.new_zeros((p, nc)))
        else:
            ranks = torch.ones(batch, dtype=torch.int64, device=dev)
            fracs = torch.zeros(batch, dtype=torch.float64, device=dev)
            ans, _, _ = _select_body(rows, count, ranks, fracs, p, bits,
                                     bits == 32 and p > 1)
            if kind == "top_k":
                k_cap = int(min(per * p, k if k is not None else 16))
                _extract_gt(rows, count, ans, max(1, k_cap))
    return trace
