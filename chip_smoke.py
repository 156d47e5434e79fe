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
   (256, 1 048 576) with nb = 64, every classify variant): equal to its
   plain PyTorch version on the card, timed with CUDA events (kernel,
   plain, library call) beside its bound; the whole local sort on full
   rows and at the main path's occupancy (about 2^18 valid keys per row, a
   tail of pad words), and on all-equal keys;
3b. the k-way classifier at the shapes of the external lane (C = 2^25
   with nb = 16 for pass C, C = 2^21 with nb = 8 for pass D), with
   sorted splitter keys and ties in no order (C = 2^25, nb = 2, 128,
   2048), with splitters in random order (nb = 2048, which every block
   sorts) and with more splitters than one shared-memory tree holds
   (nb = 2^16): bucket and
   histogram equal to the plain version's; its device time per launch
   (``torch.profiler`` over back-to-back calls, which also counts the
   device operations of a call), the host-clock time per call and CUDA
   events around one call, beside its bound (bytes 12·C + 4·nb +
   8·(nb − 1), compares C·⌈log2 nb⌉), the plain version and the library's
   ``torch.searchsorted`` of the int64 composites over sorted splitters;
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
   row; ``partition_classify`` with nb = 2 on the lifted key planes, every
   variant of the inclusive pass and the strict pass's histogram) against
   their plain versions, timed beside their bounds; ``psort(algorithm="rquick")`` end to end on Uniform, Zero and
   AllToOne after a warm-up, with the checks of phase 4; and the card
   against the CPU bit for bit for ``rquick`` and ``ntb-quick`` at p = 64,
   n = 2^20;
9. printed last, after phase 12: one ``kernels`` JSON line (a row per
   kernel, classify variant, path and shape, NTB-AMS's at RAMS's and
   every row of phase 3b, with each variant's launches in that path's
   run), the card line, and the ``ok`` line;
10. the other algorithms, each at its regime: every kernel of those
   paths at the shapes each path gives it (every ``partition_classify``
   variant with nb = p = 256 at SSort's (256, 2^20) and NS-SSort's
   (256, 2^19), ~2^18 valid keys per row, and the buckets-only variant at
   SSort's shape on the (hi, lo) planes of int64 keys; ``tile_sort`` and one
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
   ``gatherm`` and ``allgatherm`` at p = 2^8, n = 2^5;
11. 8-byte keys: the card against the CPU bit for bit on int64, uint64
   and float64 keys for the eight algorithms that take them (``rquick``,
   ``ntb-quick``, ``rfis``, ``ssort``, ``ns-ssort``, ``bitonic``,
   ``gatherm``, ``allgatherm``) at the check sizes of phases 8 and 10;
   then each sorts int64 Uniform keys at its phase-8 or phase-10 cell with
   the checks of phase 4 (RFIS at p = 2^16, n = 2^16 first; it keeps the
   cut, and says so, when 8x that peak would pass 70 GB at p = 2^18);
12. collective traces (``trace_collectives``): on the card equal to the
   CPU's, event for event, for every algorithm at the card-vs-CPU check
   sizes and the external lane at phase 7's; then one ``table1`` JSON line,
   the paper's Table I taken on the card: launches, point-to-point
   launches, fused launches and wire bytes per PE (and the lane's
   host-device bytes) at each path's cell.

Every algorithm of ``repro_torch.psort`` runs: ``rams`` (phases 4, 5),
``rquick`` and ``ntb-quick`` (8), the external lane (6, 7), and ``rfis``,
``gatherm``, ``allgatherm``, ``ssort``, ``ns-ssort``, ``bitonic`` and
``ntb-ams`` (10), and all but the AMS family on 8-byte keys (11).

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
# the kernels of the RAMS path, and the launches (the classify: of the
# variant the path reads) each path must show
RAMS_KERNELS = ("tile_sort", "run_merge", "partition_classify",
                "partition_rank")
RAMS_LAUNCHES = ("tile_sort", "run_merge", "partition_classify:rank",
                 "partition_rank")
EXTERNAL_KERNELS = ("kway_classify", "tile_sort", "run_merge")
RQUICK_KERNELS = ("tile_sort", "partition_classify:hist")
# phase 10: each other path's p, log2 n, instances and kernels.  RFIS at
# its band (n/p = 1) at the survey's 2^18 PEs; GatherM and AllGatherM at
# n/p = 2^-3, cut to p = 2^12 because the sim layout carries p·p·capacity
# slots; the four baselines at the RAMS phase's size
P_RFIS, LOG_N_RFIS = 1 << 18, 18
P_GATHER, LOG_N_GATHER = 1 << 12, 9
SSORT_KERNELS = ("tile_sort", "run_merge", "partition_classify:bucket")
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
     RAMS_LAUNCHES),
)
# the card against the CPU, bit for bit: (algorithm, p, log2 n)
OTHER_CHECKS = (("ssort", 64, 20), ("ns-ssort", 64, 20), ("bitonic", 64, 20),
                ("ntb-ams", 64, 20), ("rfis", 1 << 10, 12),
                ("gatherm", 1 << 8, 5), ("allgatherm", 1 << 8, 5))
# phase 11: 8-byte keys.  Each algorithm that takes them at its phase-8 or
# phase-10 cell, and the kernel launch each path must show (its local sorts
# take the library's sort: the tile sort takes 4-byte words only)
KEYS64_PATHS = (
    ("rquick", P_RQUICK, LOG_N_RQUICK, "partition_classify:hist"),
    ("ntb-quick", P_RQUICK, LOG_N_RQUICK, "partition_classify:hist"),
    ("rfis", P_RFIS, LOG_N_RFIS, None),
    ("gatherm", P_GATHER, LOG_N_GATHER, None),
    ("allgatherm", P_GATHER, LOG_N_GATHER, None),
    ("ssort", P_MAIN, LOG_N_MAIN, "partition_classify:bucket"),
    ("ns-ssort", P_MAIN, LOG_N_MAIN, "partition_classify:bucket"),
    ("bitonic", P_MAIN, LOG_N_MAIN, None),
)
KEYS64_CHECKS = (("rquick", 64, 20), ("ntb-quick", 64, 20)) + tuple(
    c for c in OTHER_CHECKS if c[0] != "ntb-ams")
# phase 12: the collective traces, card against CPU at the check sizes,
# and Table I at each path's cell
TRACE_CHECKS = ((("rams", P_CHECK, LOG_N_CHECK), ("rquick", 64, 20),
                 ("ntb-quick", 64, 20)) + OTHER_CHECKS)
TRACE_CELLS = ((("rams", P_MAIN, LOG_N_MAIN),
                ("rquick", P_RQUICK, LOG_N_RQUICK),
                ("ntb-quick", P_RQUICK, LOG_N_RQUICK))
               + tuple(path[:3] for path in OTHER_PATHS))
# RFIS's cut if its projected peak at p = 2^18 passes this: the projection
# is 8x the peak at p = 2^16 (the gathered rows, columns and route shards
# hold p · 2^(cb) · capacity slots, 2^29 against 2^26)
P_RFIS_CUT, LOG_N_RFIS_CUT, RFIS_PEAK_LIMIT = 1 << 16, 16, 70e9


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


def launch_key(row) -> str:
    """The launch counter of a row's kernel: the classify's per variant."""
    return row["name"] + (f":{row['variant']}" if row.get("variant") else "")


def measure(torch, results, name, source, replaces, got, want, fn, plain,
            nbytes, ops, library=None, shape=None, variant=None, ms=None,
            **extra):
    """Hold one kernel against its plain version, time both (and the library
    call, where there is one; the kernel with CUDA events around one call
    unless the caller measured ``ms``), emit the row and keep it in
    ``results`` under its launch key."""
    if len(got) != len(want):
        raise AssertionError(f"{name} returns {len(got)} outputs, its plain "
                             f"version {len(want)}")
    err = max_abs_err(torch, zip(got, want))
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version "
                             f"(max abs err {err})")
    b_ms, b_by = bound(nbytes, ops)
    row = {"name": name, "shape": shape, "variant": variant, "route": "cuda",
           "source": source, "replaces": replaces, "max_abs_err": err,
           "ms": cuda_ms(torch, fn) if ms is None else ms,
           "plain_ms": cuda_ms(torch, plain),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None if library is None
           else cuda_ms(torch, library)}
    emit({"phase": "kernel", **extra, **row,
          "kernel_ms": row["ms"]})
    results.setdefault(launch_key(row), row)
    return row


SRC_P = "src/repro_torch/kernels/partition/csrc/partition.cu"
REPLACES_P = "src/repro/kernels/partition/partition.py:72"


def partition_rows(torch, keys, ties, s_keys, s_ties, count, nb,
                   inclusive=True, wants=None, **extra):
    """Every classify launch variant (or those in ``wants``) at one path's
    shape, each against its plain version with ``max_abs_err`` 0, timed
    beside the bound of the bytes that launch moves: 8 per valid key (key
    and tie, read below the count only), 4 per bucket written, its
    histogram (per tile for the rank, per row otherwise), each row's
    splitters and count.  The bucket variant is also timed beside the
    library's ``torch.searchsorted`` on the int64 composites (what the
    plain version calls), which gives the bucket ids without the trash
    bucket.  Returns the rows, keyed by launch key."""
    from repro_torch.kernels import partition as pt
    from repro_torch.kernels.partition import ref as pref
    rows, C = keys.shape
    valid = int(count.sum())
    tiles = -(-C // pt.PTILE)
    out_bytes = {"rank": 4 * rows * C + 4 * rows * tiles * (nb + 1),
                 "bucket_hist": 4 * rows * C + 4 * rows * nb,
                 "bucket": 4 * rows * C, "hist": 4 * rows * nb}
    out = {}
    for want in wants or pt.WANTS:
        kw = dict(n_buckets=nb, inclusive=inclusive, want=want)
        library = None
        if want == "bucket":
            elem = pref._composite(keys, ties)
            spl = pref._composite(s_keys, s_ties).contiguous()

            def library():
                return torch.searchsorted(spl, elem, right=inclusive)
        measure(torch, out, "partition_classify", SRC_P, REPLACES_P,
                pt.classify(keys, ties, s_keys, s_ties, count, **kw),
                pref.classify_ref(keys, ties, s_keys, s_ties, count,
                                  tile=pt.PTILE, **kw),
                lambda: pt.classify(keys, ties, s_keys, s_ties, count, **kw),
                lambda: pref.classify_ref(keys, ties, s_keys, s_ties, count,
                                          tile=pt.PTILE, **kw),
                nbytes=8 * valid + out_bytes[want] + rows * 8 * nb,
                ops=valid * max(1, (nb - 1).bit_length()), library=library,
                shape=[rows, C], variant=want, nb=nb, inclusive=inclusive,
                valid_keys=valid, **extra)
        library = elem = spl = None
        torch.cuda.empty_cache()
    return out


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
    results.update(partition_rows(torch, keys, ties, s_keys, s_ties, count,
                                  nb, path="rams"))
    cl = pt.classify(keys, ties, s_keys, s_ties, count, n_buckets=nb)
    bucket, th = cl
    del cl
    off = torch.cumsum(th, dim=1, dtype=torch.int32) - th
    record("partition_rank", SRC_P, REPLACES_P,
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


def device_ms(torch, fn, kernel: str, reps: int):
    """Device time per launch of ``kernel`` over ``reps`` back-to-back
    calls of ``fn`` under ``torch.profiler`` (the kernel's own intervals,
    so the host's time between launches does not count), and the number
    of device operations (kernels, copies, memsets) per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = [e for e in ops if kernel in e.name]
    if len(mine) != reps:
        raise AssertionError(f"the profiler saw {len(mine)} launches of "
                             f"{kernel} in {reps} calls")
    total_us = sum(e.time_range.end - e.time_range.start for e in mine)
    return total_us / reps / 1e3, len(ops) / reps


def wall_ms(torch, fn, reps: int) -> float:
    """Host-clock milliseconds per call over ``reps`` back-to-back calls,
    ended by one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def kway_phase(torch):
    """Phase 3b: the k-way classifier against its plain version at the
    shapes of the external lane, with splitters out of lex order, and with
    more splitters than one shared-memory tree holds.  Returns the rows."""
    from repro_torch.kernels import kway as kw
    from repro_torch.kernels.kway import ref as kref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    src = "src/repro_torch/kernels/kway/csrc/kway.cu"
    rows = []
    # (what, C, nb, splitters: "lex" order, sorted keys with "ties" in no
    # order, or "shuffled" (a sort in every block), calls timed back to
    # back).  Random distinct keys rarely tie, so "ties" splitters are in
    # lex order but for the rare pick of equal keys
    shapes = [("pass C", P_EXT * BUDGET_EXT, P_EXT, "lex", 20),
              ("pass D", BUDGET_EXT, 8, "lex", 200),
              ("unordered ties", P_EXT * BUDGET_EXT, 2, "ties", 20),
              ("unordered ties", P_EXT * BUDGET_EXT, 128, "ties", 20),
              ("unordered ties", P_EXT * BUDGET_EXT, 2048, "ties", 20),
              ("shuffled", P_EXT * BUDGET_EXT, 2048, "shuffled", 20),
              ("past one tree", P_EXT * BUDGET_EXT, 1 << 16, "ties", 5)]
    for what, C, nb, order, reps in shapes:
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
        if order == "shuffled":
            perm = torch.randperm(nb - 1, generator=g, device=dev)
            s_keys, s_ties = s_keys[perm], s_ties[perm]
        if order == "lex":
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
        elem = kref._composite(keys, ties)
        spl = torch.sort(kref._composite(s_keys, s_ties))[0]

        def run():
            return kw.kway_classify(keys, ties, s_keys, s_ties, n_buckets=nb)

        dev_ms, ops = device_ms(torch, run, "kway_classify_kernel", reps)
        row = measure(
            torch, {}, "kway_classify", src,
            "src/repro/kernels/kway/kway.py:59", got,
            kref.kway_classify_ref(keys, ties, s_keys, s_ties, n_buckets=nb),
            run,
            lambda: kref.kway_classify_ref(keys, ties, s_keys, s_ties,
                                           n_buckets=nb),
            nbytes=12 * C + 4 * nb + 8 * (nb - 1),
            ops=C * max(1, (nb - 1).bit_length()),
            library=lambda: torch.searchsorted(spl, elem, right=True),
            shape=[C], ms=dev_ms, nb=nb, what=what,
            event_ms=cuda_ms(torch, run), wall_ms=wall_ms(torch, run, reps),
            device_ops_per_call=ops)
        rows.append({**row, "what": what})
        del keys, ties, got, elem, spl
        torch.cuda.empty_cache()
    return rows


def rquick_kernel_phase(torch):
    """Phase 8, first part: ``tile_sort`` and ``partition_classify`` at the
    shapes of the RQuick path at p = 2^18, n = 2^26 — rows of C = 1024
    (twice the input capacity 512) holding 2^8 to 2^10 valid keys, and
    one splitter per row over the lifted (hi, lo) planes, whose hi word is
    0 or 1 (the key 0xFFFFFFFF lifts to 2^32)."""
    from repro_torch.core.median import lift, planes
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels.bitonic import ref as bref
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
        rows_out.append(measure(torch, {}, *args, path="rquick", **kw))

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
    e_key, e_tie = planes(lift(sorted_keys))
    pick = (torch.arange(rows, device=dev) * 7919) % count
    s_key, s_tie = planes(lift(torch.gather(sorted_keys, 1, pick[:, None])))
    del sorted_keys, pick
    # every variant of the inclusive pass (the path launches the histogram
    # only), and the strict pass's histogram, which the path launches too
    rows_out += partition_rows(torch, e_key, e_tie, s_key, s_tie, count, 2,
                               path="rquick").values()
    partition_rows(torch, e_key, e_tie, s_key, s_tie, count, 2,
                   inclusive=False, wants=("hist",), path="rquick")
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
    from repro_torch.core.median import planes
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
        rows_out += [(row, (path,)) for row in partition_rows(
            torch, keys, ties, s_keys, s_ties, count, nb,
            path=path).values()]
        del keys, ties, s_keys, s_ties, pick
        torch.cuda.empty_cache()

    # SSort on 8-byte keys: the (hi, lo) planes of sorted int64 words, so
    # the ties are not zero, against u64 splitters drawn from the keys
    words = torch.randint(-2 ** 63, 2 ** 63 - 1, (rows, 1 << 20),
                          generator=g, device=dev, dtype=torch.int64)
    col = torch.arange(1 << 20, device=dev)
    words = torch.where(col[None, :] < near[:, None],
                        torch.sort(words, dim=1)[0], 2 ** 63 - 1)
    del col
    pick = torch.randint(0, int(near.min()), (nb - 1,), generator=g,
                         device=dev)
    keys, ties = planes(words)
    s_keys, s_ties = planes(torch.sort(words[0, pick])[0].expand(
        rows, nb - 1))
    del words, pick
    rows_out += [(row, ("ssort-int64",)) for row in partition_rows(
        torch, keys, ties, s_keys, s_ties, near, nb, wants=("bucket",),
        path="ssort-int64").values()]
    del keys, ties, s_keys, s_ties
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
    """Phase-4 assertions on one psort result (all on the card): uint32
    keys, or int64 keys (phase 11)."""
    dev = out.device
    if out.dtype == torch.int64:
        return check_sorted64(torch, np, x_np, out, info, n)
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


def check_sorted64(torch, np, x_np, out, info, n):
    """The assertions of phase 4 on a psort result of int64 keys."""
    ovf = info["overflow"]
    if out.numel() != n - ovf:
        raise AssertionError(f"{out.numel()} keys out, expected n - overflow "
                             f"= {n - ovf}")
    if out.numel() > 1 and not bool((out[1:] >= out[:-1]).all()):
        raise AssertionError("output is not nondecreasing")
    perm = info["perm"]
    sp = torch.sort(perm)[0]
    if sp.numel() > 1 and not bool((sp[1:] > sp[:-1]).all()):
        raise AssertionError("perm has a repeated entry")
    if sp.numel() and not (0 <= int(sp[0]) and int(sp[-1]) < n):
        raise AssertionError("perm indexes outside the input")
    if not torch.equal(torch.from_numpy(x_np).to(out.device)[perm], out):
        raise AssertionError("input[perm] != output")
    if ovf == 0 and not np.array_equal(np.sort(x_np), out.cpu().numpy()):
        raise AssertionError("output differs from np.sort(input)")


def keys64(np, generate_instance, name, p, n, dtype):
    """The instance as 8-byte keys with its order and ties: the u32 word u
    as the u64 ``u << 32 | u`` (int64 views those bits), or the float64
    ``(u − 2^31) · 0.37``."""
    u = generate_instance(name, p, n).astype(np.uint64)
    if dtype == np.float64:
        return (u.astype(np.float64) - 2.0 ** 31) * 0.37
    return ((u << np.uint64(32)) | u).view(dtype)


def keys64_phase(torch, np, psort, SortConfig, generate_instance,
                 launch_counts, reset_launch_counts):
    """Phase 11: 8-byte keys.  First the card against the CPU bit for bit
    for int64, uint64 and float64 keys with each of the eight algorithms
    that take them, at the check sizes (which also warms their int64
    kernels); then each sorts int64 Uniform keys at its phase-8 or phase-10
    cell with the checks of phase 4, and its path's classify launched.
    RFIS first runs at p = 2^16, n = 2^16 and takes the cell only if 8x
    that peak stays under 70 GB.  Returns each path's launches."""
    for algorithm, p, log_n in KEYS64_CHECKS:
        n = 1 << log_n
        cfg = SortConfig(p=p, algorithm=algorithm)
        for dtype in (np.int64, np.uint64, np.float64):
            x = keys64(np, generate_instance, "Uniform", p, n, dtype)
            go, gi = psort(x, cfg, return_info=True, device="cuda")
            co, ci = psort(x, cfg, return_info=True, device="cpu")
            same = (go.dtype == co.dtype
                    and torch.equal(go.cpu().view(torch.int64),
                                    co.view(torch.int64))
                    and torch.equal(gi["perm"].cpu(), ci["perm"])
                    and torch.equal(gi["counts"].cpu(), ci["counts"])
                    and gi["overflow"] == ci["overflow"])
            emit({"phase": "keys64_cuda_vs_cpu", "algorithm": algorithm,
                  "dtype": np.dtype(dtype).name, "p": p, "n": n,
                  "instance": "Uniform", "identical": same,
                  "overflow_cuda": gi["overflow"],
                  "overflow_cpu": ci["overflow"]})
            if not same:
                raise AssertionError(f"{algorithm} on {np.dtype(dtype).name} "
                                     f"keys: cuda and cpu runs differ")
            if dtype == np.int64:
                check_other(torch, np, x, go, gi, n, p)

    def one_sort(algorithm, p, log_n):
        n = 1 << log_n
        x = keys64(np, generate_instance, "Uniform", p, n, np.int64)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = psort(x, SortConfig(p=p, algorithm=algorithm),
                          return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if out.dtype != torch.int64:
            raise AssertionError(f"{algorithm} returned {out.dtype} keys")
        check_other(torch, np, x, out, info, n, p)
        row = {"phase": "keys64_psort", "algorithm": info["algorithm"],
               "dtype": "int64", "instance": "Uniform", "p": p, "n": n,
               "wall_s": wall, "keys_per_s": n / wall,
               "max_memory_allocated": peak, "balance": info["balance"],
               "overflow": info["overflow"], "launches": launches}
        del out, info, x
        torch.cuda.empty_cache()
        return row

    first = {}
    for algorithm, p, log_n, kernel in KEYS64_PATHS:
        if algorithm == "rfis":
            small = one_sort(algorithm, P_RFIS_CUT, LOG_N_RFIS_CUT)
            projected = 8 * small["max_memory_allocated"]
            cut = projected > RFIS_PEAK_LIMIT
            emit({**small, "phase": "keys64_rfis_reckoning",
                  "projected_peak_at_p_2_18": projected, "cut": cut})
            if cut:
                p, log_n = P_RFIS_CUT, LOG_N_RFIS_CUT
        row = one_sort(algorithm, p, log_n)
        if kernel is not None and row["launches"][kernel] <= 0:
            raise AssertionError(f"{kernel} never launched on the 8-byte "
                                 f"{algorithm} path")
        emit(row)
        first[algorithm] = row["launches"]
    return first


def trace_phase(torch, SortConfig, ExternalPolicy, trace_collectives):
    """Phase 12: every algorithm's collective trace on the card equals its
    trace on the CPU, event for event, at the card-vs-CPU check sizes (the
    external lane at phase 7's); then the paper's Table I on the card:
    launches, point-to-point launches and wire bytes per PE (and the
    lane's host-device bytes) at each path's cell, one JSON line."""
    def events(t):
        return [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
                for e in t.events]

    ext_check = SortConfig(p=P_EXT, external=ExternalPolicy(
        budget=BUDGET_EXT_CHECK))
    checks = [(a, p, log_n, SortConfig(p=p, algorithm=a))
              for a, p, log_n in TRACE_CHECKS]
    checks.append(("external", P_EXT, LOG_N_EXT_CHECK, ext_check))
    for algorithm, p, log_n, cfg in checks:
        got = trace_collectives(1 << log_n, cfg, device="cuda")
        want = trace_collectives(1 << log_n, cfg, device="cpu")
        same = (events(got) == events(want)
                and got.summary(p) == want.summary(p)
                and got.io_bytes() == want.io_bytes())
        emit({"phase": "trace_cuda_vs_cpu", "algorithm": algorithm, "p": p,
              "n": 1 << log_n, "events": len(got.events),
              "identical": same})
        if not same:
            raise AssertionError(f"{algorithm}: the trace on the card "
                                 f"differs from the CPU's")
    cells = [(a, p, log_n, SortConfig(p=p, algorithm=a))
             for a, p, log_n in TRACE_CELLS]
    cells.append(("external", P_EXT, LOG_N_EXT, SortConfig(
        p=P_EXT, external=ExternalPolicy(budget=BUDGET_EXT))))
    table = []
    for algorithm, p, log_n, cfg in cells:
        t = trace_collectives(1 << log_n, cfg, device="cuda")
        table.append({"algorithm": algorithm, "p": p, "n": 1 << log_n,
                      "launches": t.launches,
                      "p2p_launches": t.p2p_launches,
                      "fused_launches": t.fused_launches,
                      "wire_bytes": t.wire_bytes(),
                      "io_bytes": t.io_bytes(),
                      "counts": t.counts()})
    emit({"table1": table})


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
    from repro_torch import (ExternalPolicy, SortConfig, psort,
                             trace_collectives)
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
    kway_rows = kway_phase(torch)

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
        missing = [k for k in RAMS_LAUNCHES if launches[k] <= 0]
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

    # --- 11. 8-byte keys -----------------------------------------------------
    t11 = time.perf_counter()
    keys64_launches = keys64_phase(torch, np, psort, SortConfig,
                                   generate_instance, launch_counts,
                                   reset_launch_counts)
    emit({"phase": "keys64_done", "seconds": time.perf_counter() - t11})

    # --- 12. collective traces ----------------------------------------------
    t12 = time.perf_counter()
    trace_phase(torch, SortConfig, ExternalPolicy, trace_collectives)
    emit({"phase": "trace_done", "seconds": time.perf_counter() - t12})

    # --- 9. summary (printed last) -----------------------------------------
    # a row per kernel (classify: per variant), path and shape: its time at
    # that shape and its launches in that path's measured run
    rows = []
    for key, row in kernels.items():
        rows.append((row, "rams", main_launches[key]))
    for row in kway_rows:
        rows.append((row, "external", ext_launches["kway_classify"]))
    for row in rquick_rows:
        rows.append((row, "rquick", rquick_launches[launch_key(row)]))
    for key, row in kernels.items():          # NTB-AMS: RAMS's shapes
        if row["name"] in RAMS_KERNELS:
            rows.append((row, "ntb-ams", other_launches["ntb-ams"][key]))
    for row, paths in other_rows:
        for path in paths:
            launches = keys64_launches["ssort"] if path == "ssort-int64" \
                else other_launches[path]
            rows.append((row, path, launches[launch_key(row)]))
    emit({"kernels": [
        {"name": row["name"], "variant": row["variant"], "path": path,
         "what": row.get("what"),
         "shape": row["shape"], "route": row["route"],
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
