#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches its own error):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA source of the port with nvcc, in parallel, timed,
   and each local-sort kernel's registers, shared memory and spills as
   ``ptxas -v`` reports them;
3. every RAMS kernel at the shapes of the main path at p = 256, n = 2^26
   (sort and merge on (256, 2 196 992) with an int32 payload, partition on
   (256, 1 048 576) with nb = 64): equal to its plain PyTorch version on
   the card, timed with CUDA events (kernel, plain, library call) beside
   its bound; the whole local sort on full rows and at the main path's
   occupancy (about 2^18 valid keys per row, a tail of pad words), and on
   all-equal keys;
3b. the k-way classifier at the shapes of the external lane (C = 2^25
   with nb = 16 for pass C, C = 2^21 with nb = 8 for pass D) and with
   splitters out of lex order (C = 2^25, nb = 2, 128, 2048): bucket and
   histogram equal to the plain version's, timed beside its bound;
4. ``psort`` end to end on the card with RAMS at p = 256, n = 2^26 uint32
   keys, on Uniform, Zero and AllToOne: wall time after a warm-up run, peak
   device memory, balance, overflow and kernel launches, with the output
   checked (nondecreasing, n − overflow elements, ``perm`` a partial
   permutation with ``input[perm] == output``, equal to ``np.sort`` where
   nothing overflowed, every RAMS kernel launched);
5. the card and the CPU (plain versions) agree bit for bit at p = 64,
   n = 2^20 Uniform, where the reference drops 3442 keys;
6. ``psort`` through the external lane at p = 16, n = 2^28 uint32 keys,
   budget 2^21 (8 runs per PE, the classifier engine), on Uniform and Zero
   after a warm-up: wall time, keys/s, peak device memory, peak host RSS,
   host-clock seconds of passes A–D and kernel launches, with the output
   checked (overflow 0, equal to ``torch.sort`` of the input on the card,
   ``perm`` a permutation with ``input[perm] == output``, the classifier
   and the local-sort kernels launched);
7. the card and the CPU agree bit for bit on the external lane at p = 16,
   n = 2^20, budget 2^13, and double buffering off equals on;
8. RQuick at p = 2^18 emulated PEs, n = 2^26 uint32 keys (n/p = 2^8):
   its two kernels at the shapes of that path (``tile_sort`` on
   (2^18, 1024) rows with an int32 payload and 2^8 to 2^10 valid keys per
   row; ``partition_classify`` with nb = 2 on the lifted key planes, both
   ``inclusive`` values) against their plain versions, timed beside their
   bounds; ``psort(algorithm="rquick")`` end to end on Uniform, Zero and
   AllToOne after a warm-up, with the checks of phase 4; and the card
   against the CPU bit for bit for ``rquick`` and ``ntb-quick`` at p = 64,
   n = 2^20;
9. printed last, after phase 10: one ``kernels`` JSON line (a row per
   kernel, path and shape, NTB-AMS's at RAMS's), the card line, and the
   ``ok`` line;
10. the other algorithms, each at its regime: every kernel of those
   paths at the shapes each path gives it (``partition_classify`` alone,
   no rank, with nb = p = 256 at SSort's (256, 2^20) and NS-SSort's
   (256, 2^19), ~2^18 valid keys per row; ``tile_sort`` and one
   ``run_merge`` pass at (256, 2^19) with 2^18 valid keys per row, the
   first sort of every path and both of bitonic's, and at SSort's
   (256, p·slot_cap) after the shuffle and the route; ``tile_sort`` at
   RFIS's (2^18, 4) and (2^18, 2048) and GatherM's (2^12, 4) rows), each
   against its plain version and timed beside its bound; then ``psort``
   after a warm-up with RFIS at p = 2^18, n = 2^18 (n/p = 1), GatherM and
   AllGatherM at p = 2^12, n = 2^9 (n/p = 2^-3; the sim layout holds
   p·p·capacity slots), each on Uniform and Zero, and SSort, NS-SSort,
   bitonic and NTB-AMS at p = 256, n = 2^26 on Uniform, Staggered and
   Zero (where the non-robust ones overflow, as the reference does), with
   the checks of phase 4 and each path's kernels launched; and the card
   against the CPU bit for bit for ``ssort``, ``ns-ssort``, ``bitonic``
   and ``ntb-ams`` at p = 64, n = 2^20, ``rfis`` at p = 2^10, n = 2^12,
   ``gatherm`` and ``allgatherm`` at p = 2^8, n = 2^5.

Every algorithm of ``repro_torch.psort`` runs: ``rams`` (phases 4, 5),
``rquick`` and ``ntb-quick`` (8), the external lane (6, 7), and ``rfis``,
``gatherm``, ``allgatherm``, ``ssort``, ``ns-ssort``, ``bitonic`` and
``ntb-ams`` (10).

It imports torch, numpy and the port only.  Without a CUDA device, or
without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
OPS_PER_S = 67e12                # H100 SXM float32 outside the tensor cores,
                                 # taken for 32-bit integer compares (same)
REPS = 5
P_MAIN, LOG_N_MAIN = 256, 26
INSTANCES_MAIN = ("Uniform", "Zero", "AllToOne")
P_CHECK, LOG_N_CHECK, OVERFLOW_CHECK = 64, 20, 3442
P_EXT, LOG_N_EXT, BUDGET_EXT = 16, 28, 1 << 21
INSTANCES_EXT = ("Uniform", "Zero")
LOG_N_EXT_CHECK, BUDGET_EXT_CHECK = 20, 1 << 13
P_RQUICK, LOG_N_RQUICK = 1 << 18, 26
INSTANCES_RQUICK = ("Uniform", "Zero", "AllToOne")
# the kernels each path launches
RAMS_KERNELS = ("tile_sort", "run_merge", "partition_classify",
                "partition_rank")
EXTERNAL_KERNELS = ("kway_classify", "tile_sort", "run_merge")
RQUICK_KERNELS = ("tile_sort", "partition_classify")
# phase 10: each other path's p, log2 n, instances and kernels.  RFIS at
# its band (n/p = 1) at the survey's 2^18 PEs; GatherM and AllGatherM at
# n/p = 2^-3, cut to p = 2^12 because the sim layout carries p·p·capacity
# slots; the four baselines at the RAMS phase's size
P_RFIS, LOG_N_RFIS = 1 << 18, 18
P_GATHER, LOG_N_GATHER = 1 << 12, 9
SSORT_KERNELS = ("tile_sort", "run_merge", "partition_classify")
OTHER_PATHS = (
    ("rfis", P_RFIS, LOG_N_RFIS, ("Uniform", "Zero"), ("tile_sort",)),
    ("gatherm", P_GATHER, LOG_N_GATHER, ("Uniform", "Zero"), ("tile_sort",)),
    ("allgatherm", P_GATHER, LOG_N_GATHER, ("Uniform", "Zero"),
     ("tile_sort",)),
    ("ssort", P_MAIN, LOG_N_MAIN, ("Uniform", "Staggered", "Zero"),
     SSORT_KERNELS),
    ("ns-ssort", P_MAIN, LOG_N_MAIN, ("Uniform", "Staggered", "Zero"),
     SSORT_KERNELS),
    ("bitonic", P_MAIN, LOG_N_MAIN, ("Uniform", "Staggered", "Zero"),
     ("tile_sort", "run_merge")),
    ("ntb-ams", P_MAIN, LOG_N_MAIN, ("Uniform", "Staggered", "Zero"),
     RAMS_KERNELS),
)
# the card against the CPU, bit for bit: (algorithm, p, log2 n)
OTHER_CHECKS = (("ssort", 64, 20), ("ns-ssort", 64, 20), ("bitonic", 64, 20),
                ("ntb-ams", 64, 20), ("rfis", 1 << 10, 12),
                ("gatherm", 1 << 8, 5), ("allgatherm", 1 << 8, 5))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_abs_err(torch, pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
        err = max(err, int(d))
    return err


def measure(torch, results, name, source, replaces, got, want, fn, plain,
            nbytes, ops, library=None, shape=None, **extra):
    """Hold one kernel against its plain version, time both (and the library
    call, where there is one), emit the row and keep it in ``results``."""
    err = max_abs_err(torch, zip(got, want))
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version "
                             f"(max abs err {err})")
    b_ms, b_by = bound(nbytes, ops)
    row = {"name": name, "shape": shape, "route": "cuda", "source": source,
           "replaces": replaces, "max_abs_err": err,
           "ms": cuda_ms(torch, fn), "plain_ms": cuda_ms(torch, plain),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None if library is None
           else cuda_ms(torch, library)}
    emit({"phase": "kernel", **extra, **row,
          "kernel_ms": row["ms"]})
    results.setdefault(name, row)
    return row


def ptxas_report(log: str) -> dict:
    """Registers, static shared memory and spills of every kernel in one
    nvcc log (``-Xptxas -v``)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)_kernel", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def padded(torch, x, width, fill):
    """``x`` (rows, C) with columns of ``fill`` up to a multiple of
    ``width``, so a library call can take its (rows·C/width, width) view."""
    extra = -x.shape[1] % width
    return torch.cat([x, x.new_full((x.shape[0], extra), fill)], 1)


def kernel_phases(torch):
    """Phase 3: each RAMS kernel against its plain version at main-path
    shapes."""
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import partition as pt
    from repro_torch.kernels.bitonic import ref as bref
    from repro_torch.kernels.partition import ref as pref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows, C = P_MAIN, 2_196_992            # level-0 route output at n = 2^26
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    vals = torch.arange(rows * C, device=dev,
                        dtype=torch.int32).reshape(rows, C)
    n = rows * C
    results = {}

    def record(*args, **kw):
        return measure(torch, results, *args, **kw)

    def lib_segments(k, v, width):
        """The library's stable sort of every ``width`` segment (k and v
        padded to a multiple of it with the pad word, which sorts last)."""
        ks, order = torch.sort(k.view(-1, width), dim=1, stable=True)
        return (ks.view(rows, -1),
                torch.gather(v.view(-1, width), 1, order).view(rows, -1))

    src_b = "src/repro_torch/kernels/bitonic/csrc/bitonic.cu"
    src_p = "src/repro_torch/kernels/partition/csrc/partition.cu"
    t = bt.TILE
    pad_word = 2 ** 31 - 1
    kp, vp = padded(torch, keys, t, pad_word), padded(torch, vals, t, 0)
    tiles_sorted = bt.sort_tiles(keys, vals)
    lib = [a[:, :C] for a in lib_segments(kp, vp, t)]
    if max_abs_err(torch, zip(tiles_sorted, lib)) != 0:
        raise AssertionError("tile_sort differs from the library's "
                             "segmented stable sort")
    del lib
    record("tile_sort", src_b, "src/repro/kernels/bitonic/bitonic.py:121",
           tiles_sorted, bref.sort_tiles_ref(keys, vals, t),
           lambda: bt.sort_tiles(keys, vals),
           lambda: bref.sort_tiles_ref(keys, vals, t),
           nbytes=16 * n, ops=n * (t.bit_length() - 1),
           library=lambda: lib_segments(kp, vp, t), shape=[rows, C])
    del kp, vp
    runs_k, runs_v = tiles_sorted
    del tiles_sorted
    # one merge pass: a stable sort of two adjacent sorted runs is their
    # left-ties-first merge
    kp = padded(torch, runs_k, 2 * t, pad_word)
    vp = padded(torch, runs_v, 2 * t, 0)
    merged = bt.merge_runs(runs_k, runs_v, t)
    lib = [a[:, :C] for a in lib_segments(kp, vp, 2 * t)]
    if max_abs_err(torch, zip(merged, lib)) != 0:
        raise AssertionError("run_merge differs from the library's "
                             "segmented stable sort")
    del lib
    record("run_merge", src_b, "src/repro/kernels/bitonic/bitonic.py:146",
           merged, bref.merge_runs_ref(runs_k, runs_v, t),
           lambda: bt.merge_runs(runs_k, runs_v, t),
           lambda: bref.merge_runs_ref(runs_k, runs_v, t),
           nbytes=16 * n, ops=n * t.bit_length(),
           library=lambda: lib_segments(kp, vp, 2 * t), shape=[rows, C])
    del runs_k, runs_v, merged, kp, vp
    torch.cuda.empty_cache()
    # the whole local sort (tile sort + every merge pass) beside the
    # library's stable sort + payload gather, which computes the same
    def lib_sort():
        ks, order = torch.sort(keys, dim=1, stable=True)
        return ks, torch.gather(vals, 1, order)
    got = bt.local_sort_fast(keys, vals)
    err = max_abs_err(torch, zip(got, lib_sort()))
    if err != 0:
        raise AssertionError("local_sort_fast differs from a stable sort")
    del got
    passes = bt.ops.merge_passes(C)
    emit({"phase": "local_sort", "shape": [rows, C], "merge_passes": passes,
          "max_abs_err": err,
          "kernel_ms": cuda_ms(torch, lambda: bt.local_sort_fast(keys, vals)),
          "plain_ms": cuda_ms(torch, lambda: bref.sort_ref(keys, vals)),
          "library_ms": cuda_ms(torch, lib_sort),
          "bound_ms": bound(16 * n * (1 + passes), 0)[0]})
    # the main path's occupancy: about 2^18 valid keys per row (the level-0
    # output), then pad words; the library's full-row stable sort computes
    # the same function there, because the pad word sorts last, and so
    # does its sort of the longest prefix alone
    count = (1 << 18) - 2000 + (torch.arange(rows, device=dev) * 997) % 4000
    col = torch.arange(C, device=dev)
    keys = torch.where(col[None, :] < count[:, None], keys, pad_word)
    del col
    def lib_prefix():
        """The library's stable sort + gather of the longest valid prefix
        only, the tail copied: the same function on ~1/8 of the data."""
        w = int(count.max())
        ks, order = torch.sort(keys[:, :w], dim=1, stable=True)
        vs = torch.gather(vals[:, :w], 1, order)
        return torch.cat([ks, keys[:, w:]], 1), torch.cat([vs, vals[:, w:]],
                                                          1)
    got = bt.local_sort_fast(keys, vals, count)
    err = max(max_abs_err(torch, zip(got, lib_sort())),
              max_abs_err(torch, zip(got, lib_prefix())),
              max_abs_err(torch, zip(got, bref.sort_ref(keys, vals, count))))
    if err != 0:
        raise AssertionError("count-aware local_sort_fast differs from a "
                             "stable sort")
    del got
    valid = int(count.sum())
    passes = bt.ops.merge_passes(int(count.max()))
    occ = {"kernel_ms": cuda_ms(torch, lambda: bt.local_sort_fast(
        keys, vals, count)),
        "plain_ms": cuda_ms(torch, lambda: bref.sort_ref(keys, vals, count)),
        "library_ms": cuda_ms(torch, lib_sort),
        "library_prefix_ms": cuda_ms(torch, lib_prefix)}
    emit({"phase": "local_sort_occupancy", "shape": [rows, C],
          "valid_keys": valid, "merge_passes": passes, "max_abs_err": err,
          **occ, "kernel_over_library": occ["kernel_ms"] / occ["library_ms"],
          "kernel_over_library_prefix": occ["kernel_ms"]
          / occ["library_prefix_ms"],
          "bound_ms": bound(16 * valid * (1 + passes) + 16 * (n - valid),
                            0)[0]})
    # all keys equal (the Zero instance): every diagonal inside one tie run
    keys.zero_()
    got = bt.local_sort_fast(keys, vals)
    err = max_abs_err(torch, zip(got, bref.sort_ref(keys, vals)))
    if err != 0 or not torch.equal(got[1], vals):
        raise AssertionError("local_sort_fast on equal keys differs from its "
                             "plain version")
    del got
    emit({"phase": "local_sort_equal_keys", "shape": [rows, C],
          "max_abs_err": err,
          "kernel_ms": cuda_ms(torch, lambda: bt.local_sort_fast(keys,
                                                                  vals))})
    del keys, vals, count
    torch.cuda.empty_cache()

    # partition at level 0: (256, 2^20) locally sorted keys, nb = 64
    rows, C, nb = P_MAIN, 1 << 20, 64
    keys = torch.sort(torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C),
                                    generator=g, device=dev,
                                    dtype=torch.int32), dim=1)[0]
    ties = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    pick = torch.randint(0, C, (rows, nb - 1), generator=g, device=dev)
    comp = (torch.gather(keys, 1, pick).to(torch.int64) << 32) | (
        torch.gather(ties, 1, pick).to(torch.int64) & 0xFFFFFFFF)
    comp = torch.sort(comp, dim=1)[0]
    s_keys = (comp >> 32).to(torch.int32).contiguous()
    s_ties = ((comp & 0xFFFFFFFF) - ((comp & 0x80000000) << 1)).to(
        torch.int32).contiguous()
    count = C - (torch.arange(rows, device=dev) * 997) % 5000
    n = rows * C
    tiles = -(-C // pt.PTILE)
    hist_bytes = rows * tiles * (nb + 1) * 4
    # keys and ties are read only below the count, buckets written for all
    # slots; plus the histogram and each row's splitters and count
    valid = int(count.sum())
    cl = pt.classify(keys, ties, s_keys, s_ties, count, n_buckets=nb)
    record("partition_classify", src_p,
           "src/repro/kernels/partition/partition.py:72", cl,
           pref.classify_ref(keys, ties, s_keys, s_ties, count, n_buckets=nb,
                             tile=pt.PTILE),
           lambda: pt.classify(keys, ties, s_keys, s_ties, count,
                               n_buckets=nb),
           lambda: pref.classify_ref(keys, ties, s_keys, s_ties, count,
                                     n_buckets=nb, tile=pt.PTILE),
           nbytes=8 * valid + 4 * n + hist_bytes + rows * (8 * nb),
           ops=valid * (nb - 1).bit_length(), shape=[rows, C])
    bucket, th = cl
    del cl
    off = torch.cumsum(th, dim=1, dtype=torch.int32) - th
    record("partition_rank", src_p,
           "src/repro/kernels/partition/partition.py:72",
           [pt.rank(bucket, off, n_buckets=nb)],
           [pref.rank_ref(bucket, off, n_buckets=nb, tile=pt.PTILE)],
           lambda: pt.rank(bucket, off, n_buckets=nb),
           lambda: pref.rank_ref(bucket, off, n_buckets=nb, tile=pt.PTILE),
           nbytes=8 * n + hist_bytes, ops=n, shape=[rows, C])
    got = pt.partition_buckets(keys, ties, s_keys, s_ties, n_buckets=nb,
                               count=count)
    want = pref.partition_ref(keys, ties, s_keys, s_ties, n_buckets=nb,
                              count=count)
    err = max_abs_err(torch, zip(got, want))
    if err != 0 or not torch.equal(got[2].sum(1, dtype=torch.int64), count):
        raise AssertionError("partition_buckets differs from partition_ref")
    emit({"phase": "partition", "shape": [rows, C], "nb": nb,
          "max_abs_err": err,
          "kernel_ms": cuda_ms(torch, lambda: pt.partition_buckets(
              keys, ties, s_keys, s_ties, n_buckets=nb, count=count)),
          "plain_ms": cuda_ms(torch, lambda: pref.partition_ref(
              keys, ties, s_keys, s_ties, n_buckets=nb, count=count)),
          "library_ms": None, "bound_ms": bound(16 * n, 0)[0]})
    del keys, ties, bucket, th, off, got, want
    torch.cuda.empty_cache()
    return results


def kway_phase(torch):
    """Phase 3b: the k-way classifier against its plain version at the
    shapes of the external lane, and with splitters out of lex order."""
    from repro_torch.kernels import kway as kw
    from repro_torch.kernels.kway import ref as kref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    src = "src/repro_torch/kernels/kway/csrc/kway.cu"
    results = {}
    # (what, C, nb, splitters in lex order); the first is the main row
    shapes = [("pass C", P_EXT * BUDGET_EXT, P_EXT, True),
              ("pass D", BUDGET_EXT, 8, True),
              ("unordered ties", P_EXT * BUDGET_EXT, 2, False),
              ("unordered ties", P_EXT * BUDGET_EXT, 128, False),
              ("unordered ties", P_EXT * BUDGET_EXT, 2048, False)]
    for what, C, nb, ordered in shapes:
        # the runs of one pass: sorted segments of BUDGET_EXT keys
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (C,), generator=g,
                             device=dev, dtype=torch.int32)
        keys = torch.sort(keys.view(-1, min(C, BUDGET_EXT)), dim=1)[0]
        keys = keys.reshape(-1)
        ties = torch.randint(-2 ** 31, 2 ** 31 - 1, (C,), generator=g,
                             device=dev, dtype=torch.int32)
        pick = torch.randint(0, C, (nb - 1,), generator=g, device=dev)
        s_keys = torch.sort(keys[pick])[0]
        s_ties = ties[pick]
        if ordered:
            comp = torch.sort((s_keys.to(torch.int64) << 32)
                              | (s_ties.to(torch.int64) & 0xFFFFFFFF))[0]
            s_keys = (comp >> 32).to(torch.int32)
            s_ties = ((comp & 0xFFFFFFFF) - ((comp & 0x80000000) << 1)).to(
                torch.int32)
        s_keys, s_ties = s_keys.contiguous(), s_ties.contiguous()
        got = kw.kway_classify(keys, ties, s_keys, s_ties, n_buckets=nb)
        if int(got[1].sum()) != C:
            raise AssertionError(f"kway histogram sums to "
                                 f"{int(got[1].sum())}, not C = {C}")
        measure(torch, results, "kway_classify", src,
                "src/repro/kernels/kway/kway.py:59", got,
                kref.kway_classify_ref(keys, ties, s_keys, s_ties,
                                       n_buckets=nb),
                lambda: kw.kway_classify(keys, ties, s_keys, s_ties,
                                         n_buckets=nb),
                lambda: kref.kway_classify_ref(keys, ties, s_keys, s_ties,
                                               n_buckets=nb),
                nbytes=12 * C + 4 * nb + 8 * (nb - 1), ops=C * (nb - 1),
                shape=[C], nb=nb, what=what)
        del keys, ties, got
        torch.cuda.empty_cache()
    return results


def rquick_kernel_phase(torch):
    """Phase 8, first part: ``tile_sort`` and ``partition_classify`` at the
    shapes of the RQuick path at p = 2^18, n = 2^26 — rows of C = 1024
    (twice the input capacity 512) holding 2^8 to 2^10 valid keys, and
    one splitter per row over the lifted (hi, lo) planes, whose hi word is
    0 or 1 (the key 0xFFFFFFFF lifts to 2^32)."""
    from repro_torch.core.median import lift
    from repro_torch.core.rquick import _planes
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import partition as pt
    from repro_torch.kernels.bitonic import ref as bref
    from repro_torch.kernels.partition import ref as pref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    rows = P_RQUICK
    C = 2 * 2 * ((1 << LOG_N_RQUICK) // P_RQUICK)
    pad_word = 2 ** 31 - 1                   # the flip of 0xFFFFFFFF
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    keys[::7, 0] = pad_word                  # valid keys of 0xFFFFFFFF
    vals = torch.arange(rows * C, device=dev,
                        dtype=torch.int32).reshape(rows, C)
    count = C // 4 + (torch.arange(rows, device=dev) * 997) % (3 * C // 4 + 1)
    col = torch.arange(C, device=dev)
    keys = torch.where(col[None, :] < count[:, None], keys, pad_word)
    del col
    valid = int(count.sum())
    rows_out = []

    def record(*args, **kw):
        row = measure(torch, {}, *args, path="rquick", **kw)
        if kw.get("inclusive", True):        # one row per kernel kept
            rows_out.append(row)

    def lib_sort():
        """The library's stable row sort + payload gather: the same
        function, because the tail past the count holds pad words, which
        sort last and keep their order."""
        ks, order = torch.sort(keys, dim=1, stable=True)
        return ks, torch.gather(vals, 1, order)

    got = bt.sort_tiles(keys, vals, count)
    if max_abs_err(torch, zip(got, lib_sort())) != 0:
        raise AssertionError("tile_sort at the RQuick shape differs from "
                             "the library's stable sort")
    record("tile_sort", "src/repro_torch/kernels/bitonic/csrc/bitonic.cu",
           "src/repro/kernels/bitonic/bitonic.py:121", got,
           bref.sort_tiles_ref(keys, vals, bt.TILE, count),
           lambda: bt.sort_tiles(keys, vals, count),
           lambda: bref.sort_tiles_ref(keys, vals, bt.TILE, count),
           nbytes=16 * rows * C, ops=valid * (C.bit_length() - 1),
           library=lib_sort, shape=[rows, C], valid_keys=valid)
    sorted_keys = got[0]
    del got, vals
    torch.cuda.empty_cache()
    e_key, e_tie = _planes(lift(sorted_keys))
    pick = (torch.arange(rows, device=dev) * 7919) % count
    s_key, s_tie = _planes(lift(torch.gather(sorted_keys, 1,
                                             pick[:, None])))
    del sorted_keys, pick
    for inclusive in (True, False):
        cl = pt.classify(e_key, e_tie, s_key, s_tie, count, n_buckets=2,
                         inclusive=inclusive)
        record("partition_classify",
               "src/repro_torch/kernels/partition/csrc/partition.cu",
               "src/repro/kernels/partition/partition.py:72", cl,
               pref.classify_ref(e_key, e_tie, s_key, s_tie, count,
                                 n_buckets=2, tile=pt.PTILE,
                                 inclusive=inclusive),
               lambda: pt.classify(e_key, e_tie, s_key, s_tie, count,
                                   n_buckets=2, inclusive=inclusive),
               lambda: pref.classify_ref(e_key, e_tie, s_key, s_tie, count,
                                         n_buckets=2, tile=pt.PTILE,
                                         inclusive=inclusive),
               # as at the RAMS shape: reads below the count only
               nbytes=8 * valid + 4 * rows * C + rows * (8 * 2 + 4 * 3),
               ops=valid,
               shape=[rows, C], nb=2, inclusive=inclusive)
        del cl
    del e_key, e_tie, s_key, s_tie, keys, count
    torch.cuda.empty_cache()
    return rows_out


def rquick_phase(torch, np, psort, SortConfig, generate_instance,
                 launch_counts, reset_launch_counts):
    """Phase 8, second and third parts: ``psort`` with RQuick at p = 2^18,
    n = 2^26 end to end, then the card against the CPU at p = 64.
    Returns the launches of the first measured sort."""
    n = 1 << LOG_N_RQUICK
    cfg = SortConfig(p=P_RQUICK, algorithm="rquick")
    first = None
    for i, name in enumerate(INSTANCES_RQUICK):
        x = generate_instance(name, P_RQUICK, n).astype(np.uint32)
        if i == 0:                                   # warm-up
            psort(x, cfg)
            torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = psort(x, cfg, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_sorted(torch, np, x, out, info, n)
        missing = [k for k in RQUICK_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the RQuick "
                                 f"path: {missing}")
        if info["algorithm"] != "rquick":
            raise AssertionError(f"algorithm {info['algorithm']} ran")
        if first is None:
            first = launches
        emit({"phase": "rquick_psort", "instance": name, "p": P_RQUICK,
              "n": n, "algorithm": info["algorithm"], "wall_s": wall,
              "keys_per_s": n / wall, "max_memory_allocated": peak,
              "balance": info["balance"], "overflow": info["overflow"],
              "launches": launches})
        del out, info, x
        torch.cuda.empty_cache()

    n = 1 << LOG_N_CHECK
    x = generate_instance("Uniform", P_CHECK, n).astype(np.uint32)
    for algorithm in ("rquick", "ntb-quick"):
        cfg = SortConfig(p=P_CHECK, algorithm=algorithm)
        go, gi = psort(x, cfg, return_info=True, device="cuda")
        co, ci = psort(x, cfg, return_info=True, device="cpu")
        same = (torch.equal(go.view(torch.int32).cpu(), co.view(torch.int32))
                and torch.equal(gi["perm"].cpu(), ci["perm"])
                and torch.equal(gi["counts"].cpu(), ci["counts"])
                and gi["overflow"] == ci["overflow"])
        emit({"phase": "rquick_cuda_vs_cpu", "algorithm": algorithm,
              "p": P_CHECK, "n": n, "instance": "Uniform",
              "identical": same, "overflow_cuda": gi["overflow"],
              "overflow_cpu": ci["overflow"]})
        if not same:
            raise AssertionError(f"{algorithm}: cuda and cpu runs differ")
        check_sorted(torch, np, x, go, gi, n)
    return first


def sort_kernel_rows(torch, g, rows, C, count, paths, merge):
    """``tile_sort`` and, with ``merge``, one ``run_merge`` pass of width
    TILE on (rows, C) int32 keys with an int32 payload, the first count[r]
    keys of row r valid and pad words after them: each against its plain
    version, timed beside its bound and the library's stable sort + gather
    of the same segments of the prefix that holds every valid key.  The
    merge is timed as one launch into buffers made beforehand, as
    ``local_sort_fast`` launches it.  Returns [(row, paths)]."""
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels.bitonic import ref as bref
    dev = torch.device("cuda")
    src = "src/repro_torch/kernels/bitonic/csrc/bitonic.cu"
    t, pad_word = bt.TILE, 2 ** 31 - 1
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    col = torch.arange(C, device=dev)
    keys = torch.where(col[None, :] < count[:, None], keys, pad_word)
    del col
    vals = torch.arange(rows * C, device=dev,
                        dtype=torch.int32).reshape(rows, C)
    valid, cmax = int(count.sum()), int(count.max())
    info = {"shape": [rows, C], "valid_keys": valid, "paths": list(paths)}

    def lib_segments(k, v, seg):
        seg = min(seg, C)
        w = -(-cmax // seg) * seg
        ks, order = torch.sort(k[:, :w].reshape(-1, seg), dim=1, stable=True)
        return ks.view(rows, w), torch.gather(v[:, :w].reshape(-1, seg), 1,
                                              order).view(rows, w)

    def same_as_library(got, lib, what):
        w = lib[0].shape[1]
        if max_abs_err(torch, zip((a[:, :w] for a in got), lib)) != 0:
            raise AssertionError(f"{what} at {rows} x {C} differs from the "
                                 f"library's segmented stable sort")

    got = bt.sort_tiles(keys, vals, count)
    same_as_library(got, lib_segments(keys, vals, t), "tile_sort")
    out = [(measure(
        torch, {}, "tile_sort", src,
        "src/repro/kernels/bitonic/bitonic.py:121", got,
        bref.sort_tiles_ref(keys, vals, t, count),
        lambda: bt.sort_tiles(keys, vals, count),
        lambda: bref.sort_tiles_ref(keys, vals, t, count),
        nbytes=16 * rows * C, ops=valid * (min(C, t).bit_length() - 1),
        library=lambda: lib_segments(keys, vals, t), **info), paths)]
    del keys, vals
    if merge:
        runs_k, runs_v = got
        ok, ov = runs_k.clone(), runs_v.clone()
        merged = bt.merge_runs(runs_k, runs_v, t, count)
        same_as_library(merged, lib_segments(runs_k, runs_v, 2 * t),
                        "run_merge")
        out.append((measure(
            torch, {}, "run_merge", src,
            "src/repro/kernels/bitonic/bitonic.py:146", merged,
            bref.merge_runs_ref(runs_k, runs_v, t, count),
            lambda: bt.ops.launch_run_merge(runs_k, runs_v, count, t, cmax,
                                            ok, ov),
            lambda: bref.merge_runs_ref(runs_k, runs_v, t, count),
            nbytes=16 * valid, ops=valid * t.bit_length(),
            library=lambda: lib_segments(runs_k, runs_v, 2 * t), **info),
            paths))
        del runs_k, runs_v, ok, ov, merged
    del got
    torch.cuda.empty_cache()
    return out


def other_kernel_phase(torch):
    """Phase 10, first part: each kernel of the other paths at the shapes
    those paths give it, against its plain version, timed beside its
    bound.  ``partition_classify`` alone (no rank) with nb = p = 256 and
    zero ties at SSort's (256, 2^20) and NS-SSort's (256, 2^19), ~2^18
    valid keys per row; the local sort's kernels at every path's first
    sort, (256, 2^19) with 2^18 valid keys per row (both of bitonic's
    sorts), and at SSort's and NS-SSort's sorts after the shuffle or the
    route, (256, p·slot_cap) with ~2^18; ``tile_sort`` at RFIS's (2^18, 4)
    and (2^18, 2048) rows and at GatherM's and AllGatherM's (2^12, 4),
    each with at most one valid key per row.  Returns [(row, paths)]."""
    from repro_torch.kernels import partition as pt
    from repro_torch.kernels.partition import ref as pref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    pad_word = 2 ** 31 - 1
    rows_out = []
    rows, nb = P_MAIN, P_MAIN
    near = (1 << 18) - 2000 + (torch.arange(rows, device=dev) * 997) % 4000
    full = torch.full((rows,), 1 << 18, dtype=torch.int64, device=dev)

    for path, C, count in (("ssort", 1 << 20, near),
                           ("ns-ssort", 1 << 19, full)):
        keys = torch.sort(torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C),
                                        generator=g, device=dev,
                                        dtype=torch.int32), dim=1)[0]
        col = torch.arange(C, device=dev)
        keys = torch.where(col[None, :] < count[:, None], keys, pad_word)
        del col
        ties = torch.zeros_like(keys)
        pick = torch.randint(0, int(count.min()), (nb - 1,), generator=g,
                             device=dev)
        s_keys = torch.sort(keys[0, pick])[0].expand(rows,
                                                     nb - 1).contiguous()
        s_ties = torch.zeros_like(s_keys)
        valid = int(count.sum())
        row = measure(
            torch, {}, "partition_classify",
            "src/repro_torch/kernels/partition/csrc/partition.cu",
            "src/repro/kernels/partition/partition.py:72",
            pt.classify(keys, ties, s_keys, s_ties, count, n_buckets=nb),
            pref.classify_ref(keys, ties, s_keys, s_ties, count,
                              n_buckets=nb, tile=pt.PTILE),
            lambda: pt.classify(keys, ties, s_keys, s_ties, count,
                                n_buckets=nb),
            lambda: pref.classify_ref(keys, ties, s_keys, s_ties, count,
                                      n_buckets=nb, tile=pt.PTILE),
            # what the path needs: key + tie reads below the count, a
            # bucket per slot, each row's splitters and count.  The
            # per-tile histogram the kernel also writes is left out: the
            # path reads none of it
            nbytes=8 * valid + 4 * rows * C + rows * (8 * (nb - 1) + 8),
            ops=valid * (nb - 1).bit_length(), shape=[rows, C], nb=nb,
            valid_keys=valid,
            histogram_bytes=rows * (-(-C // pt.PTILE)) * (nb + 1) * 4,
            paths=[path])
        rows_out.append((row, (path,)))
        del keys, ties, s_keys, s_ties, pick
        torch.cuda.empty_cache()

    # the shuffle's and the route's output: p slots of samplesort's
    # slot_cap = ceil(2·mean + 6·sqrt(mean) + 6), mean = capacity / p
    mean = 2 * (1 << LOG_N_MAIN) // P_MAIN / P_MAIN
    slot_cap = int(math.ceil(2 * mean + 6 * math.sqrt(mean) + 6))
    rows_out += sort_kernel_rows(torch, g, rows, 1 << 19, full,
                                 ("bitonic",), merge=True)
    rows_out += sort_kernel_rows(torch, g, rows, P_MAIN * slot_cap, near,
                                 ("ssort", "ns-ssort"), merge=True)
    one = torch.ones(P_RFIS, dtype=torch.int64, device=dev)
    for C in (4, 2048):
        rows_out += sort_kernel_rows(torch, g, P_RFIS, C, one, ("rfis",),
                                     merge=False)
    gathered = (torch.arange(P_GATHER, device=dev)
                < (1 << LOG_N_GATHER)).to(torch.int64)
    rows_out += sort_kernel_rows(torch, g, P_GATHER, 4, gathered,
                                 ("gatherm", "allgatherm"), merge=False)
    return rows_out


def other_paths_phase(torch, np, psort, SortConfig, generate_instance,
                      launch_counts, reset_launch_counts):
    """Phase 10, second and third parts: ``psort`` with each other
    algorithm at its size (``OTHER_PATHS``) after a warm-up, with the
    checks of phase 4 and its kernels launched; then each on the card
    against the CPU bit for bit (``OTHER_CHECKS``).  Returns each path's
    launches in its first measured sort."""
    first = {}
    for algorithm, p, log_n, instances, kernels in OTHER_PATHS:
        n = 1 << log_n
        cfg = SortConfig(p=p, algorithm=algorithm)
        for i, name in enumerate(instances):
            x = generate_instance(name, p, n).astype(np.uint32)
            if i == 0:                               # warm-up
                psort(x, cfg)
                torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, info = psort(x, cfg, return_info=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            check_other(torch, np, x, out, info, n, p)
            missing = [k for k in kernels if launches[k] <= 0]
            if missing:
                raise AssertionError(f"kernels never launched on the "
                                     f"{algorithm} path: {missing}")
            first.setdefault(algorithm, launches)
            emit({"phase": "other_psort", "algorithm": info["algorithm"],
                  "instance": name, "p": p, "n": n, "wall_s": wall,
                  "keys_per_s": n / wall, "max_memory_allocated": peak,
                  "balance": info["balance"], "overflow": info["overflow"],
                  "launches": launches})
            del out, info, x
            torch.cuda.empty_cache()

    for algorithm, p, log_n in OTHER_CHECKS:
        n = 1 << log_n
        x = generate_instance("Uniform", p, n).astype(np.uint32)
        cfg = SortConfig(p=p, algorithm=algorithm)
        go, gi = psort(x, cfg, return_info=True, device="cuda")
        co, ci = psort(x, cfg, return_info=True, device="cpu")
        same = (torch.equal(go.view(torch.int32).cpu(), co.view(torch.int32))
                and torch.equal(gi["perm"].cpu(), ci["perm"])
                and torch.equal(gi["counts"].cpu(), ci["counts"])
                and gi["overflow"] == ci["overflow"])
        emit({"phase": "other_cuda_vs_cpu", "algorithm": algorithm, "p": p,
              "n": n, "instance": "Uniform", "identical": same,
              "overflow_cuda": gi["overflow"], "overflow_cpu": ci["overflow"]})
        if not same:
            raise AssertionError(f"{algorithm}: cuda and cpu runs differ")
        check_other(torch, np, x, go, gi, n, p)
    return first


def check_other(torch, np, x_np, out, info, n, p):
    """Phase-4 assertions on a psort result of any algorithm.  AllGatherM
    returns PE 0's copy, and its ``perm`` holds every PE's: p equal
    copies, the first of which the checks read."""
    if info["algorithm"] == "allgatherm":
        perm = info["perm"]
        if perm.numel() != p * n or not bool(
                (perm.view(p, n) == perm[None, :n]).all()):
            raise AssertionError("allgatherm's perm is not p copies of one")
        info = {**info, "perm": perm[:n]}
    check_sorted(torch, np, x_np, out, info, n)


def check_sorted(torch, np, x_np, out, info, n):
    """Phase-4 assertions on one psort result (all on the card)."""
    dev = out.device
    o = out.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ovf = info["overflow"]
    if o.numel() != n - ovf:
        raise AssertionError(f"{o.numel()} keys out, expected n - overflow "
                             f"= {n - ovf}")
    if o.numel() > 1 and not bool((o[1:] >= o[:-1]).all()):
        raise AssertionError("output is not nondecreasing")
    perm = info["perm"]
    sp = torch.sort(perm)[0]
    if sp.numel() > 1 and not bool((sp[1:] > sp[:-1]).all()):
        raise AssertionError("perm has a repeated entry")
    if sp.numel() and not (0 <= int(sp[0]) and int(sp[-1]) < n):
        raise AssertionError("perm indexes outside the input")
    xin = torch.from_numpy(x_np.view(np.int32)).to(dev).to(
        torch.int64) & 0xFFFFFFFF
    if not torch.equal(xin[perm], o):
        raise AssertionError("input[perm] != output")
    if ovf == 0 and not np.array_equal(
            np.sort(x_np), o.cpu().numpy().astype(np.uint32)):
        raise AssertionError("output differs from np.sort(input)")


def check_external(torch, np, x_np, out, info, n):
    """Phase-6 assertions on one external psort result (all on the card):
    the lane ran, nothing overflowed, the output is the sorted input and
    ``perm`` a permutation with ``input[perm] == output``."""
    if info["algorithm"] != "external" or info["overflow"] != 0:
        raise AssertionError(f"algorithm {info['algorithm']}, overflow "
                             f"{info['overflow']}")
    flip = -(1 << 31)
    words = torch.from_numpy(x_np.view(np.int32)).to(out.device) ^ flip
    o = out.view(torch.int32) ^ flip
    if not torch.equal(torch.sort(words)[0], o):
        raise AssertionError("output differs from torch.sort(input)")
    perm = info["perm"]
    seen = torch.zeros(n, dtype=torch.bool, device=out.device)
    seen[perm] = True
    if perm.numel() != n or not bool(seen.all()):
        raise AssertionError("perm is not a permutation of the input")
    if not torch.equal(words[perm], o):
        raise AssertionError("input[perm] != output")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script measures the port on a GPU")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        return fail(f"the port is not beside this script ({src}/repro_torch)")
    sys.path.insert(0, str(src))
    from repro_torch import ExternalPolicy, SortConfig, psort
    from repro_torch.data import generate_instance
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    # --- 1. the card ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: str(v.relative_to(src.parent))
                      for k, v in _build.SOURCES.items()}})
    log = _build.BUILD_LOG.get("bitonic")        # None: no log kept
    emit({"phase": "ptxas", "source": "bitonic",
          "kernels": None if log is None else ptxas_report(log)})

    # --- 3. kernels against their plain versions -----------------------------
    kernels = kernel_phases(torch)
    kernels.update(kway_phase(torch))

    # --- 4. psort end to end at p = 256, n = 2^26 ----------------------------
    n = 1 << LOG_N_MAIN
    cfg = SortConfig(p=P_MAIN)
    main_launches = None
    for i, name in enumerate(INSTANCES_MAIN):
        x = generate_instance(name, P_MAIN, n).astype(np.uint32)
        if i == 0:                                   # warm-up
            psort(x, cfg)
            torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = psort(x, cfg, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_sorted(torch, np, x, out, info, n)
        missing = [k for k in RAMS_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{missing}")
        if main_launches is None:
            main_launches = launches
        emit({"phase": "psort", "instance": name, "p": P_MAIN, "n": n,
              "algorithm": info["algorithm"], "wall_s": wall,
              "keys_per_s": n / wall, "max_memory_allocated": peak,
              "balance": info["balance"], "overflow": info["overflow"],
              "launches": launches})
        del out, info, x

    # --- 5. card vs CPU at p = 64, n = 2^20 ----------------------------------
    n = 1 << LOG_N_CHECK
    x = generate_instance("Uniform", P_CHECK, n).astype(np.uint32)
    cfg = SortConfig(p=P_CHECK)
    go, gi = psort(x, cfg, return_info=True, device="cuda")
    co, ci = psort(x, cfg, return_info=True, device="cpu")
    same = (torch.equal(go.view(torch.int32).cpu(), co.view(torch.int32))
            and torch.equal(gi["perm"].cpu(), ci["perm"])
            and torch.equal(gi["counts"].cpu(), ci["counts"])
            and gi["overflow"] == ci["overflow"])
    emit({"phase": "cuda_vs_cpu", "p": P_CHECK, "n": n, "instance": "Uniform",
          "identical": same, "overflow_cuda": gi["overflow"],
          "overflow_cpu": ci["overflow"]})
    if not same:
        raise AssertionError("cuda and cpu runs differ")
    if gi["overflow"] != OVERFLOW_CHECK:
        raise AssertionError(f"overflow {gi['overflow']} != the reference's "
                             f"{OVERFLOW_CHECK}")
    check_sorted(torch, np, x, go, gi, n)

    # --- 6. psort through the external lane at p = 16, n = 2^28 ------------
    n = 1 << LOG_N_EXT
    cfg = SortConfig(p=P_EXT, external=ExternalPolicy(budget=BUDGET_EXT))
    warm = generate_instance("Uniform", P_EXT, 1 << 22).astype(np.uint32)
    psort(warm, SortConfig(p=P_EXT, external=ExternalPolicy(          # 8 runs
        budget=BUDGET_EXT >> 6)))
    torch.cuda.synchronize()
    del warm
    ext_launches = None
    for name in INSTANCES_EXT:
        x = generate_instance(name, P_EXT, n).astype(np.uint32)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = psort(x, cfg, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        check_external(torch, np, x, out, info, n)
        missing = [k for k in EXTERNAL_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the external "
                                 f"lane: {missing}")
        if ext_launches is None:
            ext_launches = launches
        emit({"phase": "external", "instance": name, "p": P_EXT, "n": n,
              "budget": BUDGET_EXT, "runs": info["external"]["runs"],
              "merge": info["external"]["merge"], "wall_s": wall,
              "keys_per_s": n / wall, "max_memory_allocated": peak,
              "peak_host_rss_bytes": rss,
              "pass_seconds": info["pass_seconds"],
              "balance": info["balance"], "overflow": info["overflow"],
              "counts": info["counts"].tolist(), "launches": launches})
        del out, info, x

    # --- 7. card vs CPU on the external lane at p = 16, n = 2^20 -----------
    n = 1 << LOG_N_EXT_CHECK
    x = generate_instance("Uniform", P_EXT, n).astype(np.uint32)
    cfg = SortConfig(p=P_EXT, external=ExternalPolicy(
        budget=BUDGET_EXT_CHECK))
    runs = {}
    for label, dev, db in (("cuda", "cuda", True), ("cpu", "cpu", True),
                           ("cuda_single_buffer", "cuda", False)):
        c = cfg.replace(external=ExternalPolicy(budget=BUDGET_EXT_CHECK,
                                                double_buffer=db))
        o, i = psort(x, c, return_info=True, device=dev)
        runs[label] = (o.view(torch.int32).cpu(), i["perm"].cpu(),
                       i["counts"].cpu(), i["overflow"])
    same = {label: all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                       for a, b in zip(runs["cuda"], r))
            for label, r in runs.items() if label != "cuda"}
    emit({"phase": "external_cuda_vs_cpu", "p": P_EXT, "n": n,
          "budget": BUDGET_EXT_CHECK, "instance": "Uniform",
          "identical": same, "overflow": runs["cuda"][3]})
    if not all(same.values()):
        raise AssertionError(f"external runs differ: {same}")
    if not np.array_equal(np.sort(x), runs["cuda"][0].numpy().view(
            np.uint32)):
        raise AssertionError("external output differs from np.sort(input)")

    # --- 8. RQuick at p = 2^18, n = 2^26 --------------------------------------
    rquick_rows = rquick_kernel_phase(torch)
    rquick_launches = rquick_phase(torch, np, psort, SortConfig,
                                   generate_instance, launch_counts,
                                   reset_launch_counts)

    # --- 10. the other algorithms at their sizes ----------------------------
    t10 = time.perf_counter()
    other_rows = other_kernel_phase(torch)
    other_launches = other_paths_phase(torch, np, psort, SortConfig,
                                       generate_instance, launch_counts,
                                       reset_launch_counts)
    emit({"phase": "other_done", "seconds": time.perf_counter() - t10})

    # --- 9. summary (printed last) -----------------------------------------
    # a row per kernel, path and shape: its time at that shape and its
    # launches in that path's measured run (RAMS where a kernel runs there)
    rows = []
    for name, row in kernels.items():
        path = "rams" if name in RAMS_KERNELS else "external"
        rows.append((row, path, (main_launches if path == "rams"
                                 else ext_launches)[name]))
    for row in rquick_rows:
        rows.append((row, "rquick", rquick_launches[row["name"]]))
    for name in RAMS_KERNELS:                  # NTB-AMS: RAMS's shapes
        rows.append((kernels[name], "ntb-ams",
                     other_launches["ntb-ams"][name]))
    for row, paths in other_rows:
        for path in paths:
            rows.append((row, path, other_launches[path][row["name"]]))
    emit({"kernels": [
        {"name": row["name"], "path": path, "shape": row["shape"],
         "route": row["route"],
         "source": row["source"], "replaces": row["replaces"],
         "launches": launches, "max_abs_err": row["max_abs_err"],
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row["library_ms"]} for row, path, launches in rows]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
