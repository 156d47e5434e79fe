"""Out-of-core external sorting: shards larger than the device's budget
(counterpart of ``repro/core/external.py``; see there for the algorithm
and its proofs).

  Pass A — run formation: every PE's shard lives in host memory and
    streams through the device in ``budget``-element chunks, each sorted
    by (key, tie) with tie = ``_mix32(global index)``.  The PEs' chunks of
    one run index go through the device as one (p, budget) batch.
  Pass B — splitter fit: every run contributes an every-g-th-element
    sketch; one all_gather pools them and ``quantile_splitters`` picks the
    p − 1 global splitters.
  Pass C — per-run exchange: for each run index, classify all PEs' runs
    against the splitters (the Hopper k-way classifier, ``kernels/kway``)
    and route them through the slotted all-to-all, whose slots are
    provisioned from the sketches so that they never overflow.
  Pass D — k-way merge, per PE: cut the received runs at internal
    splitters fitted from their sketches (the classifier again), stream
    the cut intervals through the device sort and concatenate them
    (``merge="classifier"``), or merge on the host with a tournament
    (``merge="losertree"``, the reference engine).

Where the state lives.  Runs, sketches and provisioning stay on the host
as numpy arrays in the reference's **unsigned** dtypes (uint32 or uint64
keys, uint32 ties and indices), so each per-PE function takes and returns
what its counterpart does.  Device tensors hold the port's sign-flipped
words (``types.py``); ``_put_keys``/``_get_keys`` (and ``_put_bits``/
``_get_bits`` for uint32 planes carried in int32) are the only crossings.
4-byte keys sort by tie, then stably by key, in two int32 passes of
``local_sort_fast`` (the Hopper local-sort kernels on the card), which
equals the reference's sort of the composite ``key << 32 | tie``; 8-byte
keys keep separate planes and sort the same way with torch's stable sort,
which is the reference's ``lexsort`` (ties are unique).

Each pass runs under a ``record_function`` scope (``ext:runs``,
``ext:splitters``, ``ext:exchange``, ``ext:merge``), and every device
sort of a chunk under ``ext:sort``.  The ``io(direction,
nbytes)`` callback of ``form_runs``/``merge_runs`` is called around every
host↔device copy.  Under a ``comm.counting`` scope the lane records the
reference's trace: its collectives under the reference's tags
(``ext:splitters``, ``ext:pass{r}``, ``ext:merge``) and its
``ext:h2d``/``ext:d2h`` copies at the reference's sizes (runs padded to
the budget in pass A, to a power of two in pass D), tagged ``ext:runs``
and ``ext:merge``.  Pass A forms the runs of all PEs together, so its
copies are recorded after it, PE by PE in the reference's order.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from . import comm
from .hypercube import _alltoall_route
from .rams import _INVALID, _M32, _mix32, as_int32_bits, quantile_splitters
from .types import SortShard, pad_value, resolve_device
from repro_torch.kernels.bitonic import local_sort_fast
from repro_torch.kernels.kway import kway_classify

_HI32 = np.uint32(0xFFFFFFFF)
_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}
_UNSIGNED = {torch.int32: np.uint32, torch.int64: np.uint64}
_FLIP = {torch.int32: -(1 << 31), torch.int64: -(1 << 63)}


@dataclasses.dataclass(frozen=True)
class ExternalPolicy:
    """Out-of-core streaming policy for ``psort(..., external=...)``.

    ``budget`` is the device-resident element budget per PE buffer: shards
    with n/p > budget stream through the device in ceil(n/p / budget)
    runs.  ``sketch_per_run`` sizes the per-run quantile sketch.
    ``merge`` picks the pass-D engine: ``"classifier"`` (the k-way
    classifier engine, device-streamed) or ``"losertree"`` (host
    tournament merge).  ``double_buffer`` copies chunk r+1 to the device
    while chunk r sorts.  ``slot_factor`` scales the sketch-provisioned
    exchange slots (1.0 = the proven bound).
    """

    budget: int
    sketch_per_run: int = 32
    double_buffer: bool = True
    merge: str = "classifier"
    slot_factor: float = 1.0

    def __post_init__(self):
        if self.budget < 1:
            raise ValueError(f"ExternalPolicy.budget must be >= 1, got "
                             f"{self.budget}")
        if self.merge not in ("classifier", "losertree"):
            raise ValueError(f"ExternalPolicy.merge must be 'classifier' or "
                             f"'losertree', got {self.merge!r}")
        if self.sketch_per_run < 1:
            raise ValueError("ExternalPolicy.sketch_per_run must be >= 1")


# ---------------------------------------------------------------------------
# the host <-> device boundary
# ---------------------------------------------------------------------------


def _put_keys(a, device) -> torch.Tensor:
    """Host unsigned keys -> the port's sign-flipped words on ``device``."""
    a = np.ascontiguousarray(a)
    s = torch.from_numpy(a.view(_SIGNED[a.dtype])).to(device)
    return s ^ _FLIP[s.dtype]


def _get_keys(s: torch.Tensor) -> np.ndarray:
    return (s ^ _FLIP[s.dtype]).cpu().numpy().view(_UNSIGNED[s.dtype])


def _put_bits(a, device) -> torch.Tensor:
    """Host uint32 plane (ties, indices) -> int32 bits on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32)).to(device)


def _get_bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------


def _lex_order(keys, ties):
    """Row-wise permutation sorting by (key, tie): by tie, then stably by
    key.  ``ties`` hold uint32 values in int64."""
    order = torch.sort(ties, dim=1, stable=True)[1]
    by_key = torch.sort(torch.gather(keys, 1, order), dim=1, stable=True)[1]
    return torch.gather(order, 1, by_key)


def _sort_planes(k, i, count, cmax: int):
    """Sort padded (rows, L) (key, idx) chunks by the external (key, tie)
    order, each row's first ``count`` entries valid, ``cmax`` the largest
    count (a host int).

    Returns the (key, tie, idx) planes, tie as int32 bits, with the invalid
    tail at (pad, 0xFFFFFFFF).  The tie is derived here (``_mix32(idx)``),
    so host code never re-implements the mix."""
    L = k.shape[1]
    valid = torch.arange(L, device=k.device)[None, :] < count[:, None]
    tie = torch.where(valid, _mix32(i.to(torch.int64)), _M32)
    km = torch.where(valid, k, pad_value(k.dtype))
    if k.dtype == torch.int32:
        # by tie, then stably by key: two passes of the local sort (the
        # Hopper kernels on the card) carrying the positions, which equal
        # one stable sort of the composite key << 32 | tie.  The caller's
        # cmax spares both passes the read back of count.max().
        pos = torch.arange(L, dtype=torch.int32, device=k.device)
        _, order = local_sort_fast(
            (tie - (1 << 31)).to(torch.int32), pos.expand_as(k).contiguous(),
            count, max_count=cmax)
        ks, order = local_sort_fast(torch.gather(km, 1, order.long()), order,
                                    count, max_count=cmax)
        perm = order.long()
        return (ks, as_int32_bits(torch.gather(tie, 1, perm)),
                torch.gather(i, 1, perm))
    perm = _lex_order(km, tie)
    return (torch.gather(km, 1, perm),
            as_int32_bits(torch.gather(tie, 1, perm)),
            torch.gather(i, 1, perm))


def _classify_planes(k, t, s_keys, s_ties, nb: int):
    """bucket = #splitters lexicographically <= (k, t), in [0, nb-1], over
    1-D device planes.

    4-byte planes go through the k-way classifier kernel (its plain
    version on the CPU); 8-byte keys take a broadcast lex compare, the
    reference's in-graph fallback, fine at the splitter counts of the
    external lane."""
    if k.dtype == torch.int32 and nb >= 2:
        return kway_classify(k, t, s_keys, s_ties, n_buckets=nb)[0]
    if s_keys.shape[0] == 0:
        return torch.zeros(k.shape, dtype=torch.int32, device=k.device)
    sk, kk = s_keys[:, None], k[None, :]
    st = (s_ties.to(torch.int64) & _M32)[:, None]
    tt = (t.to(torch.int64) & _M32)[None, :]
    le = (sk < kk) | ((sk == kk) & (st <= tt))
    return le.sum(dim=0, dtype=torch.int32)


def _sorted_chunks(chunk, R: int, *, device, double_buffer: bool, io):
    """Stream R host chunks through the device sort, one after another.

    ``chunk(r)`` gives host planes (keys (rows, L) unsigned, idx (rows, L)
    uint32, counts (rows,)); yields each chunk's sorted host planes (key,
    tie, idx), trimmed to the longest row, and its counts.  With
    ``double_buffer`` on CUDA, chunk r+1 is staged in pinned host memory
    and copied with ``non_blocking=True`` on a second stream before chunk
    r's sort is read back; the sort waits on that copy's event."""
    side = (torch.cuda.Stream(device) if device.type == "cuda"
            and double_buffer else None)

    def put(r):
        k, i, cnt = chunk(r)
        k = np.ascontiguousarray(k)
        i = np.ascontiguousarray(i, np.uint32)
        io("ext:h2d", k.nbytes + i.nbytes)
        if side is None:
            return _put_keys(k, device), _put_bits(i, device), cnt, None
        with torch.cuda.stream(side):
            kd = torch.from_numpy(k.view(_SIGNED[k.dtype])).pin_memory().to(
                device, non_blocking=True)
            idd = torch.from_numpy(i.view(np.int32)).pin_memory().to(
                device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return kd, idd, cnt, ready

    nxt = put(0)
    for r in range(R):
        kd, idd, cnt, ready = nxt
        if double_buffer and r + 1 < R:
            nxt = put(r + 1)            # in flight while chunk r sorts
        if ready is not None:
            main = torch.cuda.current_stream(device)
            main.wait_event(ready)
            kd.record_stream(main)
            idd.record_stream(main)
            kd = kd ^ _FLIP[kd.dtype]
        count = torch.as_tensor(np.asarray(cnt, np.int64), device=device)
        w = int(np.max(cnt, initial=0))
        with record_function("ext:sort"):
            ks, ts, is_ = _sort_planes(kd, idd, count, w)
        del kd, idd
        out = (_get_keys(ks[:, :w]), _get_bits(ts[:, :w]),
               _get_bits(is_[:, :w]))
        io("ext:d2h", sum(a.nbytes for a in out))
        yield out + (np.asarray(cnt),)
        if not double_buffer and r + 1 < R:
            nxt = put(r + 1)


def _no_io(direction, nbytes):
    return None


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _record_runs_io(io, counts, budget: int, itemsize: int,
                    double_buffer: bool) -> None:
    """The reference's pass-A copies, PE by PE (its ``form_runs``): every
    run goes in padded to the budget, (key, idx), and comes back as its
    (key, tie, idx); with double buffering run r + 1 goes in before run r
    comes back."""
    for n in counts:
        sizes = [min(budget, int(n) - r * budget)
                 for r in range(max(1, -(-int(n) // budget)))]
        io("ext:h2d", budget * (itemsize + 4))
        for r, size in enumerate(sizes):
            if double_buffer and r + 1 < len(sizes):
                io("ext:h2d", budget * (itemsize + 4))
            io("ext:d2h", size * (itemsize + 8))
            if not double_buffer and r + 1 < len(sizes):
                io("ext:h2d", budget * (itemsize + 4))


# ---------------------------------------------------------------------------
# host-side mirrors (numpy — sketch provisioning and the loser-tree ref)
# ---------------------------------------------------------------------------


def np_bucket(k, t, s_keys, s_ties):
    """Host mirror of :func:`_classify_planes` (lex splitter count)."""
    k, t = np.asarray(k), np.asarray(t)
    s_keys, s_ties = np.asarray(s_keys), np.asarray(s_ties)
    if s_keys.shape[0] == 0:
        return np.zeros(k.shape[0], np.int64)
    le = ((s_keys[:, None] < k[None, :])
          | ((s_keys[:, None] == k[None, :]) & (s_ties[:, None] <= t[None, :])))
    return le.sum(axis=0)


def run_sketch(k, t, s: int):
    """Every-g-th-element quantile sketch of one sorted run.

    g = ceil(L/s), sketch = run[g-1::g] (at most s points; empty run →
    empty sketch).  Returns (sketch_keys, sketch_ties, g).
    """
    k, t = np.asarray(k), np.asarray(t)
    L = k.shape[0]
    g = max(1, -(-L // s))
    return k[g - 1::g], t[g - 1::g], g


def provision(sketch_k, sketch_t, g: int, s_keys, s_ties, nb: int):
    """Per-interval element bound for one run, from its sketch: an interval
    holding q of the run's stride-g sketch points holds at most (q+2)·g of
    its elements (the run-slice capacity invariant).  Returns (nb,)."""
    q = np.zeros(nb, np.int64)
    if len(sketch_k):
        b = np_bucket(sketch_k, sketch_t, s_keys, s_ties)
        np.add.at(q, np.clip(b, 0, nb - 1), 1)
    return (q + 2) * g


def form_runs(keys, idx, *, budget: int, double_buffer: bool = True,
              io=None, device=None
              ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Pass A for one PE: chunk a host-resident shard into sorted runs.

    ``keys`` (uint32 or uint64) and ``idx`` (uint32) are host arrays of the
    PE's valid elements, any length.  Returns ``max(1, ceil(len/budget))``
    runs of host (key, tie, idx) triples, each sorted by (key, tie).
    ``io(direction, nbytes)`` is called around every host↔device copy."""
    keys, idx = np.asarray(keys), np.asarray(idx)
    n = keys.shape[0]
    B = int(budget)
    R = max(1, -(-n // B))

    def chunk(r):
        lo, hi = r * B, min((r + 1) * B, n)
        return keys[None, lo:hi], idx[None, lo:hi], np.array([hi - lo])

    return [(k[0], t[0], i[0]) for k, t, i, _ in _sorted_chunks(
        chunk, R, device=resolve_device(device),
        double_buffer=double_buffer, io=io or _no_io)]


def _losertree_merge(runs):
    """Host k-way tournament merge (binary-heap loser tree) — the
    reference engine ``merge="classifier"`` is tested against."""
    kd, td, id_ = runs[0][0].dtype, runs[0][1].dtype, runs[0][2].dtype
    out = list(heapq.merge(*[zip(k.tolist(), t.tolist(), i.tolist())
                             for k, t, i in runs]))
    if not out:
        return (np.zeros(0, kd), np.zeros(0, td), np.zeros(0, id_))
    k, t, i = zip(*out)
    return (np.asarray(k, kd), np.asarray(t, td), np.asarray(i, id_))


def merge_runs(runs, *, budget: int, merge: str = "classifier",
               sketch_per_run: int = 32, io=None, device=None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pass D for one PE: k-way merge of sorted host (key, tie, idx) runs.

    ``"classifier"`` fits ceil(total/budget) − 1 internal splitters from
    the pooled run sketches, cuts every run at them (the k-way classifier
    on the device), and streams the interval chunks through the device
    sort; the chunks are disjoint ordered intervals, so their
    concatenation is the sorted whole.  ``"losertree"`` merges on the
    host.  Equal to a lexsort of the concatenation either way."""
    runs = [r for r in runs if r[0].shape[0]]
    if not runs:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                np.zeros(0, np.uint32))
    if merge == "losertree":
        return _losertree_merge(runs)
    note = io or _no_io
    total = sum(r[0].shape[0] for r in runs)
    m = max(1, -(-total // int(budget)))
    if len(runs) == 1:
        return runs[0]
    dev = resolve_device(device)

    # internal splitters from the pooled sketches (host-side quantiles)
    pk = np.concatenate([run_sketch(k, t, sketch_per_run)[0]
                         for k, t, _ in runs])
    pt = np.concatenate([run_sketch(k, t, sketch_per_run)[1]
                         for k, t, _ in runs])
    order = np.lexsort((pt, pk))
    q = np.clip((np.arange(1, m, dtype=np.int64) * len(order)) // m, 0,
                len(order) - 1)
    s_keys, s_ties = pk[order][q], pt[order][q]
    m = s_keys.shape[0] + 1
    sk, st = _put_keys(s_keys, dev), _put_bits(s_ties, dev)

    # cut every run at the splitters: device classify, host boundaries
    # (the io sizes are the reference's: its runs and chunks go in padded
    # to a power of two)
    bounds = []
    for k, t, _ in runs:
        note("ext:h2d", _pow2(k.shape[0]) * (k.itemsize + t.itemsize))
        bucket = _classify_planes(_put_keys(k, dev), _put_bits(t, dev), sk,
                                  st, m).cpu().numpy()
        note("ext:d2h", bucket.nbytes)
        # run is sorted → bucket is nondecreasing → interval j is
        # [bounds[j], bounds[j+1])
        bounds.append(np.concatenate(
            [np.searchsorted(bucket, np.arange(m)), [k.shape[0]]]))

    # stream the non-empty interval chunks through the device sort
    chunks = [j for j in range(m)
              if any(b[j + 1] > b[j] for b in bounds)]
    width = _pow2(max([sum(int(b[j + 1] - b[j]) for b in bounds)
                       for j in range(m)] + [1]))

    def chunk_io(direction, nbytes):
        note(direction, width * (runs[0][0].itemsize + 4)
             if direction == "ext:h2d" else nbytes)

    def chunk(r):
        j = chunks[r]
        kc = np.concatenate([k[b[j]:b[j + 1]]
                             for (k, _, _), b in zip(runs, bounds)])
        ic = np.concatenate([i[b[j]:b[j + 1]]
                             for (_, _, i), b in zip(runs, bounds)])
        return kc[None], ic[None], np.array([kc.shape[0]])

    out = [(k[0], t[0], i[0]) for k, t, i, _ in _sorted_chunks(
        chunk, len(chunks), device=dev, double_buffer=False, io=chunk_io)]
    return tuple(np.concatenate([o[n] for o in out]) for n in range(3))


# ---------------------------------------------------------------------------
# the distributed passes over all PEs at once, and the four in a row
# ---------------------------------------------------------------------------


def _fit_splitters(sk, st, *, p: int, device=None):
    """Pass B: pool the per-PE sketches, pick p − 1 global splitters.

    ``sk``/``st`` are host (p, S) HI-padded sketch planes.  One tiled
    all_gather per plane; the quantile pick is RAMS's.  Returns host
    (p − 1,) planes."""
    dev = resolve_device(device)
    gk = comm.all_gather(_put_keys(sk, dev), tiled=True)
    gt = comm.all_gather(_put_bits(st, dev), tiled=True).to(
        torch.int64) & _M32
    if gk.dtype == torch.int32:
        spl = quantile_splitters(torch.sort((gk.to(torch.int64) << 32) | gt,
                                            dim=1)[0], p)[0]
        return (_get_keys((spl >> 32).to(torch.int32)),
                _get_bits(as_int32_bits(spl & _M32)))
    perm = _lex_order(gk, gt)
    gk, gt = torch.gather(gk, 1, perm), torch.gather(gt, 1, perm)
    n_valid = (~((gk == pad_value(torch.int64)) & (gt == _M32))).sum(
        dim=1, keepdim=True)
    q = torch.arange(1, p, device=dev)[None, :] * n_valid // p
    q = torch.clamp(q, 0, gk.shape[1] - 1)
    return (_get_keys(torch.gather(gk, 1, q)[0]),
            _get_bits(as_int32_bits(torch.gather(gt, 1, q)[0])))


def _exchange_pass(kr, ir, counts, s_keys, s_ties, *, p: int, slot_cap: int,
                   device=None):
    """Pass C, one run index: classify every PE's run against the global
    splitters, route the run slices through one slotted all_to_all, and
    sort what each PE received.

    ``kr``/``ir`` are host (p, L) planes valid up to ``counts``.  Returns
    host (p, W) sorted planes (key, tie, idx) for W the largest received
    count, the (p,) received counts and the (p,) overflow."""
    dev = resolve_device(device)
    k, i = _put_keys(kr, dev), _put_bits(ir, dev)
    c = torch.as_tensor(np.asarray(counts, np.int64), device=dev)
    rows, cap = k.shape
    valid = torch.arange(cap, device=dev)[None, :] < c[:, None]
    tie = torch.where(valid, _mix32(i.to(torch.int64)), _M32)
    bucket = _classify_planes(
        k.reshape(-1), as_int32_bits(tie).reshape(-1),
        _put_keys(s_keys, dev), _put_bits(s_ties, dev), p).reshape(rows, cap)
    dest = torch.where(valid, bucket.to(torch.int64), p)
    del bucket
    wide = k.dtype == torch.int64
    if wide:
        keys = torch.where(valid, k, pad_value(torch.int64))
    else:
        keys = torch.where(valid, (k.to(torch.int64) << 32) | tie, _INVALID)
    del k, tie, valid
    out, ovf = _alltoall_route(SortShard(keys=keys, vals={"idx": i},
                                         count=c), dest, p, slot_cap)
    del keys, i, dest
    ok = out.keys if wide else (out.keys >> 32).to(torch.int32)
    w = int(out.count.max())
    with record_function("ext:sort"):
        ko, to, io_ = _sort_planes(ok, out.vals["idx"], out.count, w)
    return (_get_keys(ko[:, :w]), _get_bits(to[:, :w]),
            _get_bits(io_[:, :w]), out.count.cpu().numpy(),
            ovf.cpu().numpy())


def _merge_barrier(counts, *, p: int, device=None) -> int:
    """Pass D's one collective: psum the per-PE received totals before the
    merges.  Returns the global total."""
    c = torch.as_tensor(np.asarray(counts, np.int64),
                        device=resolve_device(device))
    return int(comm.psum(c)[0])


def _psort_external_once(u, n: int, *, p: int, policy: ExternalPolicy,
                         device=None, seconds: Optional[dict] = None):
    """Run the four external passes once.

    ``u`` is the full host key array (uint32 or uint64); returns host
    ``(keys (1, p, out_cap), idx (1, p, out_cap), counts (1, p), overflow
    (1, p))`` — the reference's contract.  ``seconds``, when given, gets
    the host-clock seconds of passes "A" to "D" (each ends in a copy to the
    host, so the clock covers the device work)."""
    u = np.asarray(u)
    dev = resolve_device(device)
    per = -(-max(n, 1) // p)
    B = int(policy.budget)
    R = max(1, -(-per // B))
    s = int(policy.sketch_per_run)
    hi_k = np.iinfo(u.dtype).max             # the reference's pad word
    counts = np.minimum(np.maximum(n - per * np.arange(p), 0),
                        per).astype(np.int64)
    clock = {} if seconds is None else seconds
    t0 = time.perf_counter()

    # --- pass A: run formation, the p chunks of one run index at a time --
    def slab(r):
        lo = r * B
        c = np.clip(counts - lo, 0, B)
        k = np.full((p, int(c.max(initial=0))), hi_k, u.dtype)
        i = np.zeros(k.shape, np.uint32)
        for pe in range(p):
            a = pe * per + lo
            k[pe, :c[pe]] = u[a:a + c[pe]]
            i[pe, :c[pe]] = np.arange(a, a + c[pe], dtype=np.uint32)
        return k, i, c

    with record_function("ext:runs"):
        slabs = list(_sorted_chunks(slab, R, device=dev,
                                    double_buffer=policy.double_buffer,
                                    io=_no_io))
    io = comm.io_recorder("ext:runs")
    if io is not None:
        _record_runs_io(io, counts, B, u.itemsize, policy.double_buffer)
    clock["A"] = time.perf_counter() - t0

    # --- pass B: splitter fit on the run sketches -------------------------
    t0 = time.perf_counter()
    S = R * s
    sk = np.full((p, S), hi_k, u.dtype)
    st = np.full((p, S), _HI32, np.uint32)
    gs = np.ones((p, R), np.int64)
    sklen = np.zeros((p, R), np.int64)
    for r, (k, t, _, c) in enumerate(slabs):
        for pe in range(p):
            qk, qt, g = run_sketch(k[pe, :c[pe]], t[pe, :c[pe]], s)
            sk[pe, r * s:r * s + len(qk)] = qk
            st[pe, r * s:r * s + len(qk)] = qt
            gs[pe, r], sklen[pe, r] = g, len(qk)
    with record_function("ext:splitters"), comm.tagged("ext:splitters"):
        s_keys, s_ties = _fit_splitters(sk, st, p=p, device=dev)
    clock["B"] = time.perf_counter() - t0

    # --- pass C: per-run slotted exchanges --------------------------------
    t0 = time.perf_counter()
    received = [[] for _ in range(p)]
    recv_counts = np.zeros(p, np.int64)
    overflow = np.zeros(p, np.int64)
    for r in range(R):
        k, _, i, c = slabs[r]
        slabs[r] = None                     # the host copy is consumed
        # provision the slot from the sketches (the capacity invariant)
        cap_rd = max(
            int(provision(sk[pe, r * s:r * s + sklen[pe, r]],
                          st[pe, r * s:r * s + sklen[pe, r]],
                          int(gs[pe, r]), s_keys, s_ties, p).max())
            for pe in range(p))
        slot_cap = max(4, int(math.ceil(policy.slot_factor * cap_rd)))
        with record_function("ext:exchange"), comm.tagged(f"ext:pass{r}"):
            ko, to, io_, co, oo = _exchange_pass(
                k, i, c, s_keys, s_ties, p=p, slot_cap=slot_cap, device=dev)
        del k, i
        overflow += np.asarray(oo, np.int64)
        for pe in range(p):
            cnt = int(co[pe])
            recv_counts[pe] += cnt
            received[pe].append((ko[pe, :cnt], to[pe, :cnt],
                                 io_[pe, :cnt]))
    clock["C"] = time.perf_counter() - t0

    # --- pass D: merge barrier + per-PE k-way merge -----------------------
    t0 = time.perf_counter()
    with record_function("ext:merge"):
        with comm.tagged("ext:merge"):
            _merge_barrier(recv_counts, p=p, device=dev)
        io = comm.io_recorder("ext:merge")
        merged = []
        for pe in range(p):
            merged.append(merge_runs(received[pe], budget=B,
                                     merge=policy.merge, sketch_per_run=s,
                                     io=io, device=dev))
            received[pe] = None
    out_counts = np.array([len(m[0]) for m in merged], np.int32)
    out_cap = max(4, int(out_counts.max(initial=1)))
    k_out = np.full((1, p, out_cap), hi_k, u.dtype)
    i_out = np.zeros((1, p, out_cap), np.uint32)
    for pe in range(p):
        cnt = out_counts[pe]
        k_out[0, pe, :cnt] = merged[pe][0]
        i_out[0, pe, :cnt] = merged[pe][2]
    clock["D"] = time.perf_counter() - t0
    return (k_out, i_out, out_counts.reshape(1, p),
            overflow.astype(np.int32).reshape(1, p))
