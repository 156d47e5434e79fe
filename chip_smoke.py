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
9. printed last, after phase 14: one ``kernels`` JSON line (a row per
   kernel, classify variant, path and shape, NTB-AMS's at RAMS's, every
   row of phase 3b, and the streamed paths of phase 14 at their barrier
   paths' shapes, with each variant's launches in that path's run), the
   card line, and the ``ok`` line;
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
   host-device bytes) at each path's cell;
13. selection: the committed profile (``repro_torch/profiles/h100-sim.json``,
   the port's ``DEFAULT_MODEL``), which must name an H100, its constants
   and its regime tables at p = 2^8, 2^12 and 2^18; a fresh profile from
   phase 1 of ``tools/calibrate_torch.py`` at p = 2^6 and 2^8 beside it
   (every constant finite and positive, ``overlap`` in [0, 1]); then
   ``psort(algorithm="auto")`` at the cells of RAMS, RQuick, RFIS and
   GatherM above on Uniform keys, bit for bit equal to the algorithm it
   picked, with both wall times (a pick whose reckoned peak passes 60 GB
   is printed with that size and not run);
14. the streamed exchange (``overlap=True``) against the barrier path, bit
   for bit, with both wall times, peaks and launches: RAMS and SSort at
   p = 256, n = 2^26 on Uniform and Zero (first the local sort's kernels
   at the shapes of the blocks they sort there), and the external lane at
   p = 16, n = 2^20, budget 2^13 (also against the CPU); the card against
   the CPU for ``rams`` and ``ssort`` at p = 64, n = 2^20; and phase 12's
   trace check with ``overlap=True``, its ``ovl:`` chunk events included.

15. batched keys and nested meshes: the RAMS kernels at the batched RAMS
   cell's shapes (1024 rows: ``tile_sort`` and a ``run_merge`` pass on
   level 0's route output, every classify variant and ``partition_rank``
   with nb = 64), as phase 3 times them; batched RAMS, d = 4 rows of
   n = 2^24 at p = 256 (the RAMS cell's state), on four Uniform rows and
   on [Uniform, Zero, AllToOne, Staggered], after a warm-up: wall, peak,
   each row's overflow and the launches, every row bit for bit its 1-D
   sort on the card (keys, perm, counts, overflow) with the checks of
   phase 4, and the four 1-D walls beside the batched one; batched
   RQuick, d = 4 rows of n = 2^24 at p = 2^16 (the RQuick cell's rows),
   rows 0 and 1 against their 1-D sorts; nested RAMS at p = 256,
   n = 2^26 on the meshes (16, 16) (schedule [4, 4]) and (4, 64) ([2, 3,
   3]), each bit for bit the flat sort on its schedule, both walls and
   peaks, its trace on the card equal to the CPU's at n = 2^18 and its
   inter/intra bytes and inter-axis ``all_to_all`` tags at the cell; the
   card against the CPU bit for bit for the ten algorithms batched
   (d = 2, p = 16, n = 2^14), nested on (2, 8), batched and nested, and
   RAMS and SSort batched with ``overlap=True``.  The ``kernels`` line
   gains the rows of ``rams-batched``, ``rquick-batched`` (phase 8's
   shapes) and ``rams-nested`` (phase 3's), with their runs' launches.
16. query serving (``repro_torch.core.queries``, ``SortService``) over the
   RAMS cell's data: ``tile_sort`` and a ``run_merge`` pass at the
   ingest's (256, 2^18) full rows of keys, against their plain versions;
   ``shard_data`` at p = 256, n = 2^26 Uniform uint32 (wall, peak, its
   launches, rows equal to the library's row sort); every query kind bit
   for bit against one ``torch.sort`` of the keys on Uniform, Zero and
   Staggered uint32 and int64 Uniform (``select_rank`` over 64 ranks with
   the window on and off, ``percentile``, ``top_k`` for k = 1 … 64 and
   4096, ``rank_of_key``, ``range_query``); per batch on Uniform the
   median wall of 5 after a warm-up, its host syncs (``torch.profiler``)
   and peak, beside phase 4's RAMS wall; the reference CLI's stream of 512
   queries through ``SortService`` under ``selection``, ``fullsort``
   (bitonic's sorted copy: RAMS drops keys at this cell) and ``auto``,
   p50/p99 per kind and queries/s, every answer against the oracle; and
   the card against the CPU at p = 64, n = 2^20 (every kind on uint32,
   int64, uint64 and float64 keys, the service under ``selection`` and
   ``fullsort``, ``trace_query`` for every kind and key width).  The
   ``kernels`` line gains the ``serve-ingest`` rows with the ingest's
   launches.
17. faults and elastic rescale (``SortConfig(fault_policy=...)``): the
   card against the CPU bit for bit (output, counts, overflow, perm, the
   fault record, the attempts and every trace event) for the reference's
   fast-lane cases at p = 8 (a kill and a straggler for GatherM,
   AllGatherM, RFIS, RQuick, RAMS, bitonic and SSort; the nested (2, 4)
   kill; batched RQuick; ``"auto"``; two kills; the exhausted budget) and
   for the external lane at p = 16, n = 2^20 (kills in ``ext:merge`` and
   ``ext:pass1``, a rescale that crosses into the lane); a kill in RAMS's
   ``level1`` at p = 256, n = 2^25 and a straggler there, each equal bit
   for bit to the fault-free sort at p = 128, with each attempt's wall,
   the total against that sort's wall, the rescaled attempt's peak against
   its peak, each over the allocation before its call (at most 5 % more),
   and every RAMS kernel launched; and the
   RAMS cell (p = 256, n = 2^26) with that kill, whose rescale to p = 128
   is refused (capacity 2^20), as the reference's, with the memory
   released.  The ``kernels`` line gains the ``rams-fault`` rows (the RAMS
   kernels at the rescaled attempt's shapes) with the killed run's
   launches.

Every algorithm of ``repro_torch.psort`` runs: ``rams`` (phases 4, 5,
14, 15), ``rquick`` and ``ntb-quick`` (8), the external lane (6, 7, 14),
``rfis``, ``gatherm``, ``allgatherm``, ``ssort``, ``ns-ssort``,
``bitonic`` and ``ntb-ams`` (10; ``ssort`` also 14), all but the AMS
family on 8-byte keys (11), ``"auto"`` (13), every in-core one on
batched keys and nested meshes (15), and the query path with its ingest
(the local sort) and bitonic behind the service's sorted copy (16), and
the fault lane over seven algorithms and the external lane (17).  Before
phase 1 the script checks that the kernels are switched on
(``local_kernels()``).  Each phase prints its seconds.

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
# phase 13: the regime cells at which "auto" runs against the algorithm it
# picks, and the reckoned peak past which a choice is printed, not run
AUTO_CELLS = (("rams", P_MAIN, LOG_N_MAIN), ("rquick", P_RQUICK, LOG_N_RQUICK),
              ("rfis", P_RFIS, LOG_N_RFIS), ("gatherm", P_GATHER,
                                             LOG_N_GATHER))
REGIME_PS = (1 << 8, 1 << 12, 1 << 18)
FRESH_PS = (1 << 6, 1 << 8)
AUTO_PEAK_LIMIT = 60e9
# phase 14: the streamed exchange (overlap=True) against the barrier path
OVERLAP_PATHS = (("rams", RAMS_LAUNCHES), ("ssort", SSORT_KERNELS))
OVERLAP_INSTANCES = ("Uniform", "Zero")
OVERLAP_CHECKS = (("rams", P_CHECK, LOG_N_CHECK),
                  ("ssort", P_CHECK, LOG_N_CHECK))
# phase 15: batched keys and nested meshes.  d sorts of 2^24 keys hold the
# state of the RAMS cell (p = 256) and of the RQuick cell (2^16 PEs each);
# the nested meshes run at the RAMS cell, their traces checked at 2^18
D_BATCH, LOG_N_BATCH, LOG_P_MAIN = 4, 24, 8
P_BATCH_RQUICK = 1 << 16
BATCH_MIXED = ("Uniform", "Zero", "AllToOne", "Staggered")
NESTED_MESHES = ((16, 16), (4, 64))
LOG_N_NESTED_TRACE = 18
ALGORITHMS = ("rams", "ntb-ams", "rquick", "ntb-quick", "rfis", "ssort",
              "ns-ssort", "bitonic", "gatherm", "allgatherm")
# phase 16: query serving over the RAMS cell's data (256 rows of 2^18 keys
# resident on the card); batches of 64 queries, the reference CLI's mix;
# the service's sorted copy is bitonic's, exact on any input and the
# fastest exact sort at this cell (RAMS's second level drops 25 204 keys
# here, RQuick takes seconds); the card against the CPU at p = 64, n = 2^20
P_SERVE, LOG_N_SERVE = P_MAIN, LOG_N_MAIN
SERVE_INSTANCES = ("Uniform", "Zero", "Staggered")
SERVE_B, SERVE_TOPK_BIG, SERVE_QUERIES = 64, 4096, 512
SERVE_MIX = "top_k=4,percentile=2,rank_of_key=2,range_query=1"
SERVE_SORT = "bitonic"
P_SERVE_CHECK, LOG_N_SERVE_CHECK = P_CHECK, LOG_N_CHECK
SERVE_B_CHECK, SERVE_QUERIES_CHECK = 16, 64
# phase 17: the fault lane.  The card against the CPU at p = 8 for the
# reference's fast-lane algorithms; the lane's crossing budget lies between
# n/16 and n/8 at its check cell; RAMS killed at n = 2^25 (p = 256 → 128,
# capacity 2^19: survivable) and at the RAMS cell (→ capacity 2^20, which
# RAMS refuses, as the reference does); the memory slack of its checks
FAULT_ALGOS = ("gatherm", "allgatherm", "rfis", "rquick", "rams", "bitonic",
               "ssort")
BUDGET_FAULT_CROSS = 3 << 15
LOG_N_FAULT = 25
FAULT_SLACK = 64 << 20
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


def device_ms(torch, fn, kernel: str, reps: int, tries: int = 3):
    """Device time per launch of ``kernel`` over ``reps`` back-to-back
    calls of ``fn`` under ``torch.profiler`` (the kernel's own intervals,
    so the host's time between launches does not count), and the number
    of device operations (kernels, copies, memsets) per call.

    The profiler now and then loses one activity record of a window of
    many short launches, so a window that does not show exactly ``reps``
    launches is profiled again, up to ``tries`` windows in all; a count
    that is wrong in every window fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [e for e in ops if kernel in e.name]
        if len(mine) == reps:
            total_us = sum(e.time_range.end - e.time_range.start
                           for e in mine)
            return total_us / reps / 1e3, len(ops) / reps
        seen.append(len(mine))
        print(f"  profiler window saw {len(mine)} launches of {kernel} in "
              f"{reps} calls; profiling again", flush=True)
    raise AssertionError(f"the profiler saw {seen} launches of {kernel} in "
                         f"{reps} calls in each of {tries} windows")


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


def trace_phase(torch, SortConfig, ExternalPolicy, trace_collectives,
                overlap=False):
    """Phase 12: every algorithm's collective trace on the card equals its
    trace on the CPU, event for event, at the card-vs-CPU check sizes (the
    external lane at phase 7's); then the paper's Table I on the card:
    launches, point-to-point launches and wire bytes per PE (and the
    lane's host-device bytes) at each path's cell, one JSON line.  With
    ``overlap`` (phase 14) the check only, of the streamed exchanges."""
    def events(t):
        return [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
                for e in t.events]

    ext_check = SortConfig(p=P_EXT, overlap=overlap, external=ExternalPolicy(
        budget=BUDGET_EXT_CHECK))
    checks = [(a, p, log_n, SortConfig(p=p, algorithm=a, overlap=overlap))
              for a, p, log_n in TRACE_CHECKS]
    checks.append(("external", P_EXT, LOG_N_EXT_CHECK, ext_check))
    for algorithm, p, log_n, cfg in checks:
        got = trace_collectives(1 << log_n, cfg, device="cuda")
        want = trace_collectives(1 << log_n, cfg, device="cpu")
        same = (events(got) == events(want)
                and got.summary(p) == want.summary(p)
                and got.io_bytes() == want.io_bytes())
        emit({"phase": "trace_cuda_vs_cpu", "algorithm": algorithm, "p": p,
              "n": 1 << log_n, "overlap": overlap,
              "events": len(got.events), "ovl_events": sum(
                  1 for e in got.events if (e.tag or "").startswith("ovl:")),
              "identical": same})
        if not same:
            raise AssertionError(f"{algorithm}: the trace on the card "
                                 f"differs from the CPU's")
    if overlap:
        return
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


def calibrate_tool():
    """``tools/calibrate_torch.py`` of this checkout, as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tools" / "calibrate_torch.py"
    spec = importlib.util.spec_from_file_location("calibrate_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_result(torch, a, b) -> bool:
    """Two psort results (output, info) equal bit for bit: keys, perm,
    counts and overflow."""
    (ao, ai), (bo, bi) = a, b
    return (torch.equal(ao.view(torch.int32).cpu(), bo.view(torch.int32).cpu())
            and torch.equal(ai["perm"].cpu(), bi["perm"].cpu())
            and torch.equal(ai["counts"].cpu(), bi["counts"].cpu())
            and ai["overflow"] == bi["overflow"])


def timed_psort(torch, psort, x, cfg, reset_launch_counts, launch_counts,
                **kw):
    """One psort after a reset of the launch counts: (out, info, wall s,
    launches, peak bytes)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, info = psort(x, cfg, return_info=True, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, info, wall, launch_counts(),
            torch.cuda.max_memory_allocated())


def selection_phase(torch, np, psort, SortConfig, generate_instance,
                    launch_counts, reset_launch_counts):
    """Phase 13: the committed profile (the port's DEFAULT_MODEL) and its
    regime tables; a fresh profile from the tool's phase 1 beside it; then
    ``psort(algorithm="auto")`` at each regime cell, bit for bit equal to
    the algorithm it picked (a pick whose reckoned peak passes 60 GB is
    printed with that size and not run)."""
    from repro_torch.core import selection
    t0 = time.perf_counter()
    model = selection.DEFAULT_MODEL
    consts = ("alpha", "alpha_c", "alpha_hop", "beta", "local_rate",
              "partition_rate", "io_beta", "overlap")
    emit({"phase": "profile", "name": model.name,
          "card": model.meta.get("card"),
          **{k: getattr(model, k) for k in consts}})
    if "H100" not in str(model.meta.get("card")):
        raise AssertionError(f"the committed profile was not measured on an "
                             f"H100: {model.meta.get('card')!r}")
    for p in REGIME_PS:
        emit({"phase": "regime_table", "p": p, "rows": [
            [e, a] for e, _, a in selection.regime_table(p, range(-8, 24))]})
    tool = calibrate_tool()
    fresh = tool.measure_profile(FRESH_PS, "fresh", "cuda")
    emit({"phase": "profile_fresh", "p": list(FRESH_PS),
          "card": fresh.meta["card"],
          **{k: getattr(fresh, k) for k in consts},
          "committed": {k: getattr(model, k) for k in consts}})
    for k in consts:
        v = getattr(fresh, k)
        if not math.isfinite(v) or (k != "overlap" and v <= 0):
            raise AssertionError(f"fresh profile: {k} = {v}")
    if not 0.0 <= fresh.overlap <= 1.0:
        raise AssertionError(f"fresh profile: overlap {fresh.overlap}")
    for cell, p, log_n in AUTO_CELLS:
        n = 1 << log_n
        chosen = selection.select_algorithm(n, p)
        need = tool.reckon_bytes(chosen, n, p)
        row = {"phase": "auto", "cell": cell, "p": p, "n": n,
               "chosen": chosen, "reckoned_bytes": need}
        if need > AUTO_PEAK_LIMIT:
            emit({**row, "run": False})
            continue
        x = generate_instance("Uniform", p, n).astype(np.uint32)
        auto = timed_psort(torch, psort, x, SortConfig(p=p), reset_launch_counts,
                           launch_counts)
        named = timed_psort(torch, psort, x, SortConfig(p=p, algorithm=chosen),
                            reset_launch_counts, launch_counts)
        same = same_result(torch, auto[:2], named[:2])
        emit({**row, "run": True, "algorithm": auto[1]["algorithm"],
              "wall_s": auto[2], "named_wall_s": named[2],
              "max_memory_allocated": auto[4], "identical": same})
        if not same or auto[1]["algorithm"] != chosen:
            raise AssertionError(f"auto at {cell}'s cell differs from "
                                 f"{chosen}")
        del auto, named, x
        torch.cuda.empty_cache()
    emit({"phase": "selection_done", "seconds": time.perf_counter() - t0})


def overlap_phase(torch, np, psort, SortConfig, ExternalPolicy,
                  generate_instance, launch_counts, reset_launch_counts,
                  trace_collectives):
    """Phase 14: ``overlap=True`` against the barrier path, bit for bit,
    with both wall times and launches: RAMS and SSort at p = 256,
    n = 2^26 (Uniform, Zero), the external lane at p = 16, n = 2^20,
    budget 2^13; the card against the CPU with ``overlap=True``; and
    phase 12's trace check with ``overlap=True``.  Returns the launches of
    each streamed path's first measured sort, and the local sort's kernel
    rows at the shapes of the blocks it sorts."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    spread = torch.arange(P_MAIN, device=dev) * 997
    # the blocks each streamed exchange sorts as they arrive, at
    # p = 256, n = 2^26: the shuffle's (and SSort's route's) 256 blocks of
    # slot_cap 4374 with ~1024 keys, RAMS level 0's of 8582 with ~1024,
    # level 1's 16 blocks of 132 614 with ~16 384 (one merge pass)
    chunk_rows = []
    for C, valid, merge, paths in (
            (4374, 1024, False, ("rams-overlap", "ssort-overlap")),
            (8582, 1024, False, ("rams-overlap",)),
            (132614, 1 << 14, True, ("rams-overlap",))):
        count = valid - 32 + spread % 64
        chunk_rows += sort_kernel_rows(torch, g, P_MAIN, C, count, paths,
                                       merge)
    first = {}
    n = 1 << LOG_N_MAIN
    for algorithm, kernels in OVERLAP_PATHS:
        cfg = SortConfig(p=P_MAIN, algorithm=algorithm)
        for i, name in enumerate(OVERLAP_INSTANCES):
            x = generate_instance(name, P_MAIN, n).astype(np.uint32)
            if i == 0:                               # warm-up
                psort(x, cfg.replace(overlap=True))
                torch.cuda.synchronize()
            bar = timed_psort(torch, psort, x, cfg, reset_launch_counts,
                              launch_counts)
            ovl = timed_psort(torch, psort, x, cfg.replace(overlap=True),
                              reset_launch_counts, launch_counts)
            same = same_result(torch, bar[:2], ovl[:2])
            check_sorted(torch, np, x, ovl[0], ovl[1], n)
            missing = [k for k in kernels if ovl[3][k] <= 0]
            first.setdefault(algorithm, ovl[3])
            emit({"phase": "overlap_psort", "algorithm": algorithm,
                  "instance": name, "p": P_MAIN, "n": n, "identical": same,
                  "barrier_wall_s": bar[2], "overlap_wall_s": ovl[2],
                  "ratio": ovl[2] / bar[2],
                  "barrier_max_memory_allocated": bar[4],
                  "overlap_max_memory_allocated": ovl[4],
                  "overflow": ovl[1]["overflow"],
                  "barrier_launches": bar[3], "overlap_launches": ovl[3]})
            if not same:
                raise AssertionError(f"{algorithm} {name}: overlap=True "
                                     f"differs from the barrier path")
            if missing:
                raise AssertionError(f"kernels never launched on the "
                                     f"streamed {algorithm} path: {missing}")
            del bar, ovl, x
            torch.cuda.empty_cache()

    n = 1 << LOG_N_EXT_CHECK
    x = generate_instance("Uniform", P_EXT, n).astype(np.uint32)
    cfg = SortConfig(p=P_EXT, algorithm="external", external=ExternalPolicy(
        budget=BUDGET_EXT_CHECK))
    psort(x, cfg.replace(overlap=True))                # warm-up
    bar = timed_psort(torch, psort, x, cfg, reset_launch_counts,
                      launch_counts)
    ovl = timed_psort(torch, psort, x, cfg.replace(overlap=True),
                      reset_launch_counts, launch_counts)
    cpu = psort(x, cfg.replace(overlap=True), return_info=True, device="cpu")
    same = same_result(torch, bar[:2], ovl[:2])
    same_cpu = same_result(torch, ovl[:2], cpu)
    first["external"] = ovl[3]
    emit({"phase": "overlap_external", "p": P_EXT, "n": n,
          "budget": BUDGET_EXT_CHECK, "identical": same,
          "identical_cpu": same_cpu, "barrier_wall_s": bar[2],
          "overlap_wall_s": ovl[2], "ratio": ovl[2] / bar[2],
          "barrier_launches": bar[3], "overlap_launches": ovl[3]})
    if not (same and same_cpu):
        raise AssertionError("the streamed external lane differs")
    # at this budget (one tile) a run needs no merge pass: the lane's
    # classify and tile sorts are its kernels
    missing = [k for k in ("kway_classify", "tile_sort") if ovl[3][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the streamed "
                             f"lane: {missing}")

    for algorithm, p, log_n in OVERLAP_CHECKS:
        n = 1 << log_n
        x = generate_instance("Uniform", p, n).astype(np.uint32)
        cfg = SortConfig(p=p, algorithm=algorithm, overlap=True)
        go = psort(x, cfg, return_info=True, device="cuda")
        co = psort(x, cfg, return_info=True, device="cpu")
        same = same_result(torch, go, co)
        emit({"phase": "overlap_cuda_vs_cpu", "algorithm": algorithm,
              "p": p, "n": n, "identical": same,
              "overflow": go[1]["overflow"]})
        if not same:
            raise AssertionError(f"{algorithm}: streamed cuda and cpu runs "
                                 f"differ")
        check_sorted(torch, np, x, go[0], go[1], n)
    trace_phase(torch, SortConfig, ExternalPolicy, trace_collectives,
                overlap=True)
    emit({"phase": "overlap_done", "seconds": time.perf_counter() - t0})
    return first, chunk_rows


def batch_kernel_rows(torch):
    """Phase 15, first part: the RAMS kernels at the shapes of the batched
    RAMS cell (d = 4 sorts of n = 2^24 at p = 256: 1024 rows of capacity
    2^17), as phase 3 times them: ``tile_sort`` and one ``run_merge`` pass
    on level 0's route output (1024, 256·2246) with ~2^16 valid keys per
    row, and every classify variant and ``partition_rank`` with nb = 64
    on the level's (1024, 2^18) sorted keys with ~2^16 valid.  Returns
    (rows keyed by launch key, [(row, paths)] of the local sort)."""
    return rams_kernel_rows(torch, D_BATCH * P_MAIN, P_MAIN,
                            1 << (LOG_N_BATCH - LOG_P_MAIN), "rams-batched",
                            seed=15)


def rams_kernel_rows(torch, rows, p, per, path, seed):
    """The RAMS kernels at the shapes of level 0 of a sort of ``rows``
    rows of ``per`` keys on p PEs (rows = d·p), as phase 3 times them:
    ``tile_sort`` and one ``run_merge`` pass on the level's route output
    (rows, p·slot_cap) and every classify variant and ``partition_rank``
    with nb = 64 on its (rows, 4·per) sorted keys (the shuffle's
    capacity), ~per valid keys per row in both.  Returns (rows keyed by
    launch key, [(row, paths)] of the local sort)."""
    from repro_torch.core.rams import _slot_cap
    from repro_torch.kernels import partition as pt
    from repro_torch.kernels.partition import ref as pref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    C, nb = 4 * per, 64
    count = per - (torch.arange(rows, device=dev) * 997) % 2000
    sort_rows = sort_kernel_rows(torch, g, rows, p * _slot_cap(C, p, 2.0),
                                 count, (path,), merge=True)
    col = torch.arange(C, device=dev)
    keys = torch.sort(torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C),
                                    generator=g, device=dev,
                                    dtype=torch.int32), dim=1)[0]
    keys = torch.where(col[None, :] < count[:, None], keys, 2 ** 31 - 1)
    del col
    ties = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    pick = torch.randint(0, int(count.min()), (rows, nb - 1), generator=g,
                         device=dev)
    comp = torch.sort((torch.gather(keys, 1, pick).to(torch.int64) << 32)
                      | (torch.gather(ties, 1, pick).to(torch.int64)
                         & 0xFFFFFFFF), dim=1)[0]
    s_keys = (comp >> 32).to(torch.int32).contiguous()
    s_ties = ((comp & 0xFFFFFFFF) - ((comp & 0x80000000) << 1)).to(
        torch.int32).contiguous()
    del pick, comp
    results = partition_rows(torch, keys, ties, s_keys, s_ties, count, nb,
                             path=path)
    bucket, th = pt.classify(keys, ties, s_keys, s_ties, count, n_buckets=nb)
    off = torch.cumsum(th, dim=1, dtype=torch.int32) - th
    valid = int(count.sum())
    measure(torch, results, "partition_rank", SRC_P, REPLACES_P,
            [pt.rank(bucket, off, n_buckets=nb)],
            [pref.rank_ref(bucket, off, n_buckets=nb, tile=pt.PTILE)],
            lambda: pt.rank(bucket, off, n_buckets=nb),
            lambda: pref.rank_ref(bucket, off, n_buckets=nb, tile=pt.PTILE),
            nbytes=8 * rows * C + 4 * th.numel(), ops=valid,
            shape=[rows, C], path=path)
    del keys, ties, s_keys, s_ties, bucket, th, off
    torch.cuda.empty_cache()
    return results, sort_rows


def same_rows(torch, a, b) -> bool:
    """Two 1-D psort outputs (keys or perm) bit for bit, on any device."""
    return a.shape == b.shape and torch.equal(
        a.view(torch.int32).cpu() if a.element_size() == 4 else a.cpu(),
        b.view(torch.int32).cpu() if b.element_size() == 4 else b.cpu())


def batch_against_rows(torch, np, psort, x, cfg, batched, n, rows,
                       reset_launch_counts, launch_counts):
    """Each of ``rows`` of a timed batched run (out, info, wall, launches,
    peak) against the port's 1-D sort of that row on the card, bit for
    bit (keys, perm, counts, overflow), with the checks of phase 4.
    Returns the 1-D walls and each row's overflow."""
    out, info = batched[0], batched[1]
    walls, overflows = [], []
    for r in rows:
        one = timed_psort(torch, psort, x[r], cfg, reset_launch_counts,
                          launch_counts)
        got = out[r]
        ovf = n - int(info["counts"][r].sum())
        same = (same_rows(torch, got, one[0])
                and same_rows(torch, info["perm"][r],
                              one[1]["perm"])
                and torch.equal(info["counts"][r].cpu(),
                                one[1]["counts"].cpu())
                and ovf == one[1]["overflow"])
        if not same:
            raise AssertionError(f"{cfg.algorithm}: row {r} of the batch "
                                 f"differs from its 1-D sort")
        check_sorted(torch, np, x[r], got, {
            "perm": info["perm"][r], "overflow": ovf}, n)
        walls.append(one[2])
        overflows.append(ovf)
        del one, got
    return walls, overflows


def batched_phase(torch, np, psort, SortConfig, generate_instance,
                  launch_counts, reset_launch_counts, trace_collectives):
    """Phase 15: batched (d, n) keys and nested meshes on the card.

    Batched RAMS, d = 4 rows of n = 2^24 at p = 256 (the RAMS cell's 2^27
    slots), on four Uniform rows of their own seeds and on [Uniform,
    Zero, AllToOne, Staggered], after a warm-up; batched RQuick, d = 4
    rows of n = 2^24 at p = 2^16 (RQuick's cell's 2^18 rows of 1024);
    nested RAMS at the RAMS cell (p = 256, n = 2^26) on the meshes
    (16, 16) and (4, 64) against the flat sort on the same schedule, with
    both walls and peaks, and each mesh's trace on the card against the
    CPU's; then the card against the CPU for the ten algorithms batched,
    nested, batched and nested, and RAMS and SSort batched with
    ``overlap=True``.  Returns the launches of the batched RAMS, batched
    RQuick and nested RAMS runs."""
    t0 = time.perf_counter()
    launches = {}
    n = 1 << LOG_N_BATCH
    cfg = SortConfig(p=P_MAIN, algorithm="rams")
    for label, names in (("uniform", ("Uniform",) * D_BATCH),
                         ("mixed", BATCH_MIXED)):
        x = np.stack([generate_instance(name, P_MAIN, n, seed=r).astype(
            np.uint32) for r, name in enumerate(names)])
        if label == "uniform":                       # warm-up
            psort(x, cfg)
            torch.cuda.synchronize()
        batched = timed_psort(torch, psort, x, cfg, reset_launch_counts,
                              launch_counts)
        missing = [k for k in RAMS_LAUNCHES if batched[3][k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the batched "
                                 f"RAMS path: {missing}")
        launches.setdefault("rams-batched", batched[3])
        walls, overflows = batch_against_rows(
            torch, np, psort, x, cfg, batched, n, range(D_BATCH),
            reset_launch_counts, launch_counts)
        emit({"phase": "batched_rams", "batch": label,
              "instances": list(names), "d": D_BATCH, "p": P_MAIN, "n": n,
              "identical_rows": True, "wall_s": batched[2],
              "rows_wall_s": walls, "rows_wall_sum_s": sum(walls),
              "max_memory_allocated": batched[4],
              "overflow_rows": overflows,
              "overflow": batched[1]["overflow"],
              "balance": batched[1]["balance"], "launches": batched[3]})
        del batched, x
        torch.cuda.empty_cache()

    cfg = SortConfig(p=P_BATCH_RQUICK, algorithm="rquick")
    x = np.stack([generate_instance("Uniform", P_BATCH_RQUICK, n,
                                    seed=r).astype(np.uint32)
                  for r in range(D_BATCH)])
    batched = timed_psort(torch, psort, x, cfg, reset_launch_counts,
                          launch_counts)
    missing = [k for k in RQUICK_KERNELS if batched[3][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the batched "
                             f"RQuick path: {missing}")
    launches["rquick-batched"] = batched[3]
    walls, overflows = batch_against_rows(
        torch, np, psort, x, cfg, batched, n, (0, 1), reset_launch_counts,
        launch_counts)
    emit({"phase": "batched_rquick", "d": D_BATCH, "p": P_BATCH_RQUICK,
          "n": n, "identical_rows": [0, 1], "wall_s": batched[2],
          "rows_wall_s": walls, "max_memory_allocated": batched[4],
          "overflow_rows": overflows, "overflow": batched[1]["overflow"],
          "balance": batched[1]["balance"], "launches": batched[3]})
    del batched, x
    torch.cuda.empty_cache()
    emit({"phase": "batched_done", "seconds": time.perf_counter() - t0})

    from repro_torch.core.rams import nested_level_bits
    n = 1 << LOG_N_MAIN
    x = generate_instance("Uniform", P_MAIN, n).astype(np.uint32)
    for mesh in NESTED_MESHES:
        bits = tuple(nested_level_bits(*mesh))
        nested_cfg = SortConfig(mesh_shape=mesh, algorithm="rams")
        flat_cfg = SortConfig(p=P_MAIN, algorithm="rams",
                              algo_kw={"level_bits": bits})
        psort(x, nested_cfg)                         # warm-up
        torch.cuda.synchronize()
        nest = timed_psort(torch, psort, x, nested_cfg, reset_launch_counts,
                           launch_counts)
        flat = timed_psort(torch, psort, x, flat_cfg, reset_launch_counts,
                           launch_counts)
        same = same_result(torch, nest[:2], flat[:2])
        check_sorted(torch, np, x, nest[0], nest[1], n)
        missing = [k for k in RAMS_LAUNCHES if nest[3][k] <= 0]
        launches.setdefault("rams-nested", nest[3])
        t_card = trace_collectives(1 << LOG_N_NESTED_TRACE, nested_cfg,
                                   device="cuda")
        t_cpu = trace_collectives(1 << LOG_N_NESTED_TRACE, nested_cfg,
                                  device="cpu")
        t_cell = trace_collectives(n, nested_cfg, device="cuda")
        trace_same = [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
                      for e in t_card.events] == [
            (e.primitive, e.bytes, e.group_size, e.axis, e.tag)
            for e in t_cpu.events]
        inter = t_cell.filter(primitive="all_to_all", axis="inter").tags()
        emit({"phase": "nested_rams", "mesh_shape": list(mesh),
              "level_bits": list(bits), "p": P_MAIN, "n": n,
              "identical_to_flat": same, "nested_wall_s": nest[2],
              "flat_wall_s": flat[2], "ratio": nest[2] / flat[2],
              "nested_max_memory_allocated": nest[4],
              "flat_max_memory_allocated": flat[4],
              "overflow": nest[1]["overflow"],
              "nested_launches": nest[3], "flat_launches": flat[3],
              "trace_identical_cpu": trace_same,
              "trace_n": 1 << LOG_N_NESTED_TRACE,
              "wire_bytes_by_axis": {a: s["wire_bytes"] for a, s in
                                     t_cell.by_axis().items()},
              "inter_all_to_all_tags": inter})
        if not same:
            raise AssertionError(f"nested RAMS on {mesh} differs from the "
                                 f"flat run on {bits}")
        if missing:
            raise AssertionError(f"kernels never launched on the nested "
                                 f"RAMS path: {missing}")
        if not trace_same:
            raise AssertionError(f"the nested trace on {mesh} differs on "
                                 f"the card from the CPU's")
        if inter != ["level0", "shuffle"]:
            raise AssertionError(f"inter-axis all_to_all tags {inter}")
        del nest, flat
        torch.cuda.empty_cache()
    del x
    emit({"phase": "nested_done", "seconds": time.perf_counter() - t0})

    # the card against the CPU at the check size, every in-core algorithm
    d, p, n = 2, 1 << 4, 1 << 14
    xs = np.stack([generate_instance(name, p, n, seed=r).astype(np.uint32)
                   for r, name in enumerate(("Uniform", "Staggered"))])
    layouts = (("batched", xs, {"p": p}), ("nested", xs[0],
                                           {"mesh_shape": (2, 8)}),
               ("batched-nested", xs, {"mesh_shape": (2, 8)}))
    checks = [(a, label, keys, kw) for a in ALGORITHMS
              for label, keys, kw in layouts]
    checks += [(a, "batched-overlap", xs, {"p": p, "overlap": True})
               for a in ("rams", "ssort")]
    for algorithm, label, keys, kw in checks:
        c = SortConfig(algorithm=algorithm, **kw)
        go = psort(keys, c, return_info=True, device="cuda")
        co = psort(keys, c, return_info=True, device="cpu")
        rows = range(len(keys)) if keys.ndim == 2 else (slice(None),)
        same = (all(same_rows(torch, go[0][r], co[0][r])
                    and same_rows(torch, go[1]["perm"][r], co[1]["perm"][r])
                    for r in rows)
                and torch.equal(go[1]["counts"].cpu(), co[1]["counts"])
                and go[1]["overflow"] == co[1]["overflow"])
        emit({"phase": "batched_cuda_vs_cpu", "algorithm": algorithm,
              "layout": label, "d": d if keys.ndim == 2 else 1, "p": p,
              "n": n, **{k: list(v) if isinstance(v, tuple) else v
                         for k, v in kw.items() if k != "p"},
              "identical": same, "overflow": go[1]["overflow"]})
        if not same:
            raise AssertionError(f"{algorithm} {label}: cuda and cpu runs "
                                 f"differ")
    emit({"phase": "batched_nested_done",
          "seconds": time.perf_counter() - t0})
    return launches


def ingest_kernel_rows(torch):
    """Phase 16, first part: ``tile_sort`` and one ``run_merge`` pass at
    the shape the serving ingest gives them, (256, 2^18) full rows of
    keys with no payload (``shard_data`` at p = 256, n = 2^26), each
    against its plain version, timed beside its bound (8 bytes a key:
    read once, written once) and the library's sort of the same segments.
    Returns the rows keyed by kernel."""
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels.bitonic import ref as bref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    src = "src/repro_torch/kernels/bitonic/csrc/bitonic.cu"
    rows, C = P_SERVE, 1 << (LOG_N_SERVE - LOG_P_MAIN)
    t = bt.TILE
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    count = torch.full((rows,), C, dtype=torch.int64, device=dev)
    info = {"shape": [rows, C], "valid_keys": rows * C,
            "path": "serve-ingest"}

    def segments(k, seg):
        return torch.sort(k.reshape(-1, seg), dim=1)[0].view(rows, C)

    out = {}
    runs = bt.sort_tiles(keys, None, count)[0]
    measure(torch, out, "tile_sort", src,
            "src/repro/kernels/bitonic/bitonic.py:121", [runs],
            [bref.sort_tiles_ref(keys, None, t, count)[0]],
            lambda: bt.sort_tiles(keys, None, count),
            lambda: bref.sort_tiles_ref(keys, None, t, count),
            nbytes=8 * rows * C, ops=rows * C * (t.bit_length() - 1),
            library=lambda: segments(keys, t), **info)
    del keys
    merged = torch.empty_like(runs)
    measure(torch, out, "run_merge", src,
            "src/repro/kernels/bitonic/bitonic.py:146",
            [bt.merge_runs(runs, None, t, count)[0]],
            [bref.merge_runs_ref(runs, None, t, count)[0]],
            lambda: bt.ops.launch_run_merge(runs, None, count, t, C, merged,
                                            None),
            lambda: bref.merge_runs_ref(runs, None, t, count),
            nbytes=8 * rows * C, ops=rows * C * t.bit_length(),
            library=lambda: segments(runs, 2 * t), **info)
    del runs, merged
    torch.cuda.empty_cache()
    return out


def key_words(torch, x, device):
    """numpy keys → the port's words (``key_to_int``) on ``device``."""
    from repro_torch.core.types import key_to_int
    return key_to_int(torch.from_numpy(x).to(device))


def same_bits(np, a, b) -> bool:
    """Two numpy keys or arrays equal bit for bit, dtype included."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def serve_args(torch, np, rng, x, oracle, batch):
    """Query batches of phase 16 over keys ``x`` (numpy) with sorted
    words ``oracle`` on the card: ranks with 1, 2, n/2, n − 1 and n;
    percentiles with 0 and 100; k = 1 … batch; keys with the minimum, the
    maximum and one absent from the data; intervals with an empty one
    (lo = hi), one with hi < lo and (min, max)."""
    n = len(x)
    ranks = np.concatenate([[1, 2, n // 2, n - 1, n], rng.integers(
        1, n + 1, size=batch - 5)]).astype(np.int64)
    qs = np.concatenate([[0.0, 100.0], rng.uniform(0, 100, batch - 2)])
    lo_key, hi_key = x.min(), x.max()
    info = np.iinfo(x.dtype) if x.dtype.kind in "iu" else None
    draws = (rng.integers(info.min, info.max, size=64, dtype=x.dtype,
                          endpoint=True) if info is not None
             else rng.uniform(-1e12, 1e12, 64).astype(x.dtype))
    w = key_words(torch, draws, oracle.device)
    absent = (torch.searchsorted(oracle, w) ==
              torch.searchsorted(oracle, w, right=True)).cpu().numpy()
    if not absent.any():
        raise AssertionError("no absent key among 64 draws")
    absent_key = draws[np.argmax(absent)]
    keys = np.concatenate([[lo_key, hi_key, absent_key],
                           x[rng.integers(0, n, batch - 3)]]).astype(x.dtype)
    a, b = x[rng.integers(0, n, batch)], x[rng.integers(0, n, batch)]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo[0] = hi[0]                                     # empty
    lo[1], hi[1] = x.max(), x.min()                   # hi < lo
    lo[2], hi[2] = x.min(), x.max()
    return {"ranks": ranks, "q": qs, "k": np.arange(1, batch + 1),
            "keys": keys, "lo": lo, "hi": hi}


def serve_expected(torch, np, oracle, dtype, args):
    """The oracle's answers (sorted words ``oracle`` on the card) to the
    batches of :func:`serve_args`, as the port returns them."""
    from repro_torch.core.queries import _np_keys
    dev, n = oracle.device, oracle.numel()

    def keys(words):
        return _np_keys(words.cpu().numpy(), dtype)

    def ranks(words):
        return (torch.searchsorted(oracle, words).cpu().numpy(),
                torch.searchsorted(oracle, words, right=True).cpu().numpy())

    sel = oracle[torch.as_tensor(args["ranks"] - 1, device=dev)]
    pct = oracle[torch.as_tensor(np.floor(args["q"] / 100.0 * (n - 1))
                                 .astype(np.int64), device=dev)]
    lo = torch.searchsorted(oracle, key_words(torch, args["lo"], dev))
    hi = torch.searchsorted(oracle, key_words(torch, args["hi"], dev))
    return {"select": (keys(sel),) + ranks(sel), "percentile": keys(pct),
            "top_k": [keys(oracle[n - int(k):]) for k in args["k"]],
            "rank_of_key": ranks(key_words(torch, args["keys"], dev)),
            "range_query": np.maximum((hi - lo).cpu().numpy(), 0)}


def serve_answers(np, Q, data, args, window=True):
    """Every query kind over ``data`` on the batches of
    :func:`serve_args` (``window`` for select_rank)."""
    return {"select": Q.select_rank(data, args["ranks"], window=window),
            "percentile": Q.percentile(data, args["q"]),
            "top_k": Q.top_k(data, args["k"]),
            "rank_of_key": Q.rank_of_key(data, args["keys"]),
            "range_query": Q.range_query(data, args["lo"], args["hi"])}


def same_answers(np, got, want) -> list:
    """The kinds whose answers differ bit for bit."""
    bad = []
    for kind, w in want.items():
        g = got[kind]
        if isinstance(w, (tuple, list)):
            ok = len(g) == len(w) and all(same_bits(np, a, b)
                                          for a, b in zip(g, w))
        else:
            ok = same_bits(np, g, w)
        if not ok:
            bad.append(kind)
    return bad


def host_syncs(torch, fn) -> dict:
    """Synchronising CUDA runtime calls of one ``fn()``, as
    ``torch.profiler`` records them on the host, less those it records
    around an empty window (its own)."""
    from torch.profiler import ProfilerActivity, profile
    names = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize", "cudaMemcpy")

    def count(f):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            f()
        return {e.key: e.count for e in prof.key_averages()
                if e.key in names}
    own, got = count(lambda: None), count(fn)
    return {k: v - own.get(k, 0) for k, v in got.items()
            if v != own.get(k, 0)}


def device_breakdown(torch, fn, top: int = 8) -> dict:
    """Where one ``fn()`` spends the card's time under ``torch.profiler``:
    its wall, the device operations and their summed time, and the
    ``top`` operation names by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    busy = sum(t for _, t in by_name.values()) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_ops": sum(n for n, _ in by_name.values()),
            "top": [{"name": name[:90], "launches": n, "ms": t / 1e3}
                    for name, (n, t) in ranked]}


def time_batch(torch, fn, reps: int = REPS):
    """(median wall s of ``reps`` calls after a warm-up, peak bytes of one
    call, its host syncs): each call ends with its answers on the host."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    fn()
    peak = torch.cuda.max_memory_allocated()
    return statistics.median(walls), peak, host_syncs(torch, fn)


def service_run(torch, np, SortService, SortConfig, parse_mix, gen_stream,
                keys, p, policy, queries, device, seed=0):
    """The reference CLI's stream of ``queries`` requests over ``keys``
    through one ``SortService``: (service, results in order, drain wall
    s)."""
    svc = SortService(keys, config=SortConfig(p=p, algorithm=SERVE_SORT),
                      policy=policy, max_batch=SERVE_B, device=device)
    rng = np.random.default_rng(seed)
    pool = keys[rng.integers(0, len(keys), size=256)]
    for kind, arg in gen_stream(rng, len(keys), queries,
                                parse_mix(SERVE_MIX), pool):
        svc.submit(kind, arg)
    t0 = time.perf_counter()
    done = svc.drain()
    return svc, done, time.perf_counter() - t0


def check_service(torch, np, done, oracle, dtype):
    """Every answer of a drained stream against the oracle (sorted words
    on the card; the keys are unsigned, so the key order is the word
    order on both paths)."""
    from repro_torch.core.queries import _np_keys
    n = oracle.numel()
    bad = 0
    for r in done:
        kind, arg, v = r.request.kind, r.request.arg, r.value
        if kind == "top_k":
            ok = same_bits(np, v, _np_keys(oracle[n - arg:].cpu().numpy(),
                                           dtype))
        elif kind == "percentile":
            i = int(np.floor(arg / 100.0 * (n - 1)))
            ok = same_bits(np, np.asarray(v), _np_keys(
                oracle[i:i + 1].cpu().numpy(), dtype)[0])
        elif kind == "rank_of_key":
            w = key_words(torch, np.asarray([arg], dtype), oracle.device)
            ok = tuple(v) == (int(torch.searchsorted(oracle, w)),
                              int(torch.searchsorted(oracle, w, right=True)))
        else:
            lo, hi = key_words(torch, np.asarray(arg, dtype), oracle.device)
            ok = int(v) == max(int(torch.searchsorted(oracle, hi[None]))
                               - int(torch.searchsorted(oracle, lo[None])),
                               0)
        bad += not ok
    return bad


def serve_phase(torch, np, generate_instance, launch_counts,
                reset_launch_counts, rams_wall):
    """Phase 16: query serving over the RAMS cell's data on the card.

    The ingest (``shard_data``, p = 256, n = 2^26 Uniform uint32): wall,
    peak and launches, rows equal to the library's row sort; then on
    Uniform, Zero and Staggered uint32 and int64 Uniform, every query kind
    bit for bit against one ``torch.sort`` of the keys (select_rank with
    the window on and off, percentile, top_k for k = 1 … 64 and 4096,
    rank_of_key, range_query); the median wall of 5 per batch after a
    warm-up, its host syncs and peak, beside phase 4's RAMS wall; the
    reference CLI's stream of 512 queries through ``SortService`` under
    ``selection``, ``fullsort`` and ``auto``, every answer against the
    oracle; and the card against the CPU at p = 64, n = 2^20 (every kind
    on uint32, int64, uint64 and float64 keys, the service under
    ``selection`` and ``fullsort``, ``trace_query`` for every kind and
    key width).  Returns the ingest's launches."""
    from repro_torch.core import queries as Q
    from repro_torch import SortConfig
    from repro_torch.launch.sort_serve import (SortService, _gen_stream,
                                               parse_mix)
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    p, n = P_SERVE, 1 << LOG_N_SERVE

    # --- the ingest
    x = generate_instance("Uniform", p, n).astype(np.uint32)
    Q.shard_data(x, p)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    data = Q.shard_data(x, p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rows = key_words(torch, x, dev).reshape(p, -1)
    same = (torch.equal(data.keys, torch.sort(rows, dim=1)[0])
            and bool((data.counts == n // p).all()))
    row_sort_ms = cuda_ms(torch, lambda: torch.sort(rows, dim=1))
    del rows
    emit({"phase": "serve_ingest", "p": p, "n": n, "instance": "Uniform",
          "wall_s": wall, "max_memory_allocated": peak,
          "resident_bytes": data.keys.numel() * data.keys.element_size(),
          "launches": launches, "rows_equal_library_sort": same,
          "library_row_sort_ms": row_sort_ms})
    if not same:
        raise AssertionError("shard_data's rows differ from torch.sort")
    missing = [k for k in ("tile_sort", "run_merge") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the ingest: "
                             f"{missing}")

    # --- every kind against the oracle, and the batches timed
    rng = np.random.default_rng((16, 1))      # apart from the PEs' seeds
    datasets = [(name, "uint32") for name in SERVE_INSTANCES] + [
        ("Uniform", "int64")]
    for name, dtype in datasets:
        if dtype == "int64":
            x = keys64(np, generate_instance, name, p, n, np.int64)
        elif name != "Uniform":
            x = generate_instance(name, p, n).astype(np.uint32)
        if name != "Uniform" or dtype == "int64":
            data = Q.shard_data(x, p)
        oracle = torch.sort(key_words(torch, x, dev))[0]
        args = serve_args(torch, np, rng, x, oracle, SERVE_B)
        want = serve_expected(torch, np, oracle, x.dtype, args)
        bad = {}
        for window in ((True, False) if dtype == "uint32" else (True,)):
            got = serve_answers(np, Q, data, args, window)
            bad[f"window={window}"] = same_answers(np, got, want)
        big = Q.top_k(data, SERVE_TOPK_BIG)
        big_ok = same_bits(np, big, Q._np_keys(
            oracle[n - SERVE_TOPK_BIG:].cpu().numpy(), x.dtype))
        emit({"phase": "serve_oracle", "instance": name, "dtype": dtype,
              "p": p, "n": n, "batch": SERVE_B, "differs": bad,
              "top_k_4096_identical": big_ok})
        if any(bad.values()) or not big_ok:
            raise AssertionError(f"{name} {dtype}: answers differ from the "
                                 f"oracle: {bad}, top_k 4096 {big_ok}")
        if name == "Uniform":
            batches = {
                "select_rank": lambda: Q.select_rank(data, args["ranks"]),
                "percentile": lambda: Q.percentile(data, args["q"]),
                "top_k": lambda: Q.top_k(data, args["k"]),
                "top_k_4096": lambda: Q.top_k(data, SERVE_TOPK_BIG),
                "rank_of_key": lambda: Q.rank_of_key(data, args["keys"]),
                "range_query": lambda: Q.range_query(data, args["lo"],
                                                     args["hi"])}
            if dtype == "uint32":
                batches["select_rank_no_window"] = lambda: Q.select_rank(
                    data, args["ranks"], window=False)
            emit({"phase": "serve_breakdown", "kind": "select_rank",
                  "dtype": dtype, "p": p, "n": n, "batch": SERVE_B,
                  **device_breakdown(torch, batches["select_rank"])})
            for kind, fn in batches.items():
                med, bpeak, syncs = time_batch(torch, fn)
                emit({"phase": "serve_batch", "kind": kind, "dtype": dtype,
                      "p": p, "n": n,
                      "batch": 1 if kind == "top_k_4096" else SERVE_B,
                      "rounds": Q.n_rounds(data.bits) if kind not in (
                          "rank_of_key", "range_query") else 0,
                      "wall_s": med, "max_memory_allocated": bpeak,
                      "host_syncs": syncs, "rams_psort_wall_s": rams_wall})
        del data, oracle, x
        torch.cuda.empty_cache()
    emit({"phase": "serve_oracle_done", "seconds": time.perf_counter() - t0})

    # --- SortService at the cell: the CLI's stream, three policies
    keys = np.random.default_rng(0).integers(0, 1 << 32, size=n).astype(
        np.uint32)
    oracle = torch.sort(key_words(torch, keys, dev))[0]
    for policy in ("selection", "fullsort", "auto"):
        svc, done, wall = service_run(torch, np, SortService, SortConfig,
                                      parse_mix, _gen_stream, keys, p,
                                      policy, SERVE_QUERIES, None)
        bad = check_service(torch, np, done, oracle, keys.dtype)
        routes = sorted({(r.request.kind, r.path) for r in done})
        emit({"phase": "serve_service", "policy": policy, "p": p, "n": n,
              "queries": len(done), "mix": SERVE_MIX, "sort": SERVE_SORT,
              "drain_wall_s": wall, "steps": len({(r.request.kind,
                                                   r.step_s) for r in done}),
              "routes": [list(r) for r in routes], "stats": svc.stats(),
              "wrong_answers": bad})
        if bad or len(done) != SERVE_QUERIES:
            raise AssertionError(f"SortService ({policy}): {bad} answers "
                                 f"differ from the oracle")
        del svc, done
        torch.cuda.empty_cache()
    del oracle, keys
    emit({"phase": "serve_service_done",
          "seconds": time.perf_counter() - t0})

    # --- the card against the CPU at p = 64, n = 2^20
    p, n = P_SERVE_CHECK, 1 << LOG_N_SERVE_CHECK
    rng = np.random.default_rng((16, 2))
    u = generate_instance("Uniform", p, n)
    for dtype in (np.uint32, np.int64, np.uint64, np.float64):
        x = u.astype(np.uint32) if dtype == np.uint32 else keys64(
            np, generate_instance, "Uniform", p, n, dtype)
        if dtype == np.float64:                     # both zeros
            x[:4] = [0.0, -0.0, -0.0, 0.0]
        dg, dc = Q.shard_data(x, p), Q.shard_data(x, p, device="cpu")
        oracle = torch.sort(key_words(torch, x, "cpu"))[0]
        args = serve_args(torch, np, rng, x, oracle, SERVE_B_CHECK)
        bad = {"rows": not (torch.equal(dg.keys.cpu(), dc.keys)
                            and torch.equal(dg.counts.cpu(), dc.counts))}
        for window in ((True, False) if dtype == np.uint32 else (True,)):
            bad[f"window={window}"] = same_answers(
                np, serve_answers(np, Q, dg, args, window),
                serve_answers(np, Q, dc, args, window))
        emit({"phase": "serve_cuda_vs_cpu", "dtype": np.dtype(dtype).name,
              "p": p, "n": n, "batch": SERVE_B_CHECK, "differs": bad})
        if any(bad.values()):
            raise AssertionError(f"{np.dtype(dtype).name}: card and CPU "
                                 f"answers differ: {bad}")
        del dg, dc, oracle
    keys = u.astype(np.uint32)
    for policy in ("selection", "fullsort"):
        runs = [service_run(torch, np, SortService, SortConfig, parse_mix,
                            _gen_stream, keys, p, policy,
                            SERVE_QUERIES_CHECK, d)[1]
                for d in ("cuda", "cpu")]
        same = [(r.request.kind, r.path, r.batch) for r in runs[0]] == [
            (r.request.kind, r.path, r.batch) for r in runs[1]] and all(
            same_bits(np, np.asarray(a.value), np.asarray(b.value))
            for a, b in zip(*runs))
        emit({"phase": "serve_service_cuda_vs_cpu", "policy": policy,
              "p": p, "n": n, "queries": SERVE_QUERIES_CHECK,
              "identical": same})
        if not same:
            raise AssertionError(f"SortService ({policy}): card and CPU "
                                 f"differ")
    for dtype in (np.uint32, np.uint64):
        for kind in Q.QUERY_KINDS:
            if kind == "sort" and dtype == np.uint64:
                continue                     # the sort's trace is uint32
            tg, tc = (Q.trace_query(kind, n, p, batch=4, dtype=dtype, k=8,
                                    device=d) for d in ("cuda", "cpu"))
            same = [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
                    for e in tg.events] == [
                (e.primitive, e.bytes, e.group_size, e.axis, e.tag)
                for e in tc.events]
            emit({"phase": "serve_trace_cuda_vs_cpu", "kind": kind,
                  "dtype": np.dtype(dtype).name, "p": p, "n": n,
                  "identical": same, "summary": tg.summary(p)})
            if not same:
                raise AssertionError(f"trace_query({kind}, "
                                     f"{np.dtype(dtype).name}) differs")
    emit({"phase": "serve_done", "seconds": time.perf_counter() - t0})
    return launches


def fault_events(trace):
    return [(e.primitive, e.bytes, e.group_size, e.axis, e.tag, e.pe)
            for e in trace.events]


def fault_run(torch, psort, SortConfig, x, faults, device, policy_kw=None,
              **cfg):
    """psort under the fault plan ``faults`` on ``device``: (out, info) or
    the error it raised, and the policy (its attempts and trace)."""
    from repro_torch.core import comm
    from repro_torch.runtime import FaultPolicy
    pol = FaultPolicy(plan=comm.FaultPlan(tuple(faults)),
                      **(policy_kw or {}))
    try:
        out = psort(x, SortConfig(fault_policy=pol, **cfg), return_info=True,
                    device=device)
    except comm.PEFailure as e:
        out = e
    return out, pol


def same_fault_run(torch, a, b) -> bool:
    """Two fault runs (card, CPU) equal: output, counts, overflow, perm,
    ``info["fault"]`` (or the same PEFailure), the attempts and every
    trace event."""
    (ra, pa), (rb, pb) = a, b
    if pa.attempts != pb.attempts or \
            fault_events(pa.trace) != fault_events(pb.trace):
        return False
    if isinstance(ra, Exception) or isinstance(rb, Exception):
        return (type(ra) is type(rb) and str(ra) == str(rb))
    (ao, ai), (bo, bi) = ra, rb
    rows = ao if isinstance(ao, list) else [ao]
    rows_b = bo if isinstance(bo, list) else [bo]
    return (len(rows) == len(rows_b)
            and all(same_rows(torch, u, v) for u, v in zip(rows, rows_b))
            and torch.equal(ai["perm"].cpu(), bi["perm"].cpu())
            and torch.equal(ai["counts"].cpu(), bi["counts"].cpu())
            and ai["overflow"] == bi["overflow"]
            and ai["fault"] == bi["fault"])


def fault_phase(torch, np, psort, SortConfig, ExternalPolicy,
                generate_instance, launch_counts, reset_launch_counts):
    """Phase 17: the fault lane (``SortConfig(fault_policy=...)``).

    (a) the card against the CPU, bit for bit, at p = 8: the reference's
    fast-lane cases (a kill and a straggler for seven algorithms, attempts
    8 → 4 → 2; the nested (2, 4) kill; batched RQuick; ``"auto"``; two
    kills; the exhausted budget); (b) the external lane at its check cell
    (p = 16, n = 2^20, budget 2^13): kills tagged ``ext:merge`` and
    ``ext:pass1``, and a rescale from p = 16 to 8 that crosses into the
    lane (budget 3·2^15, between n/16 and n/8), with ``kway_classify``
    launched; (c) a kill in RAMS's ``level1`` at p = 256, n = 2^25: the
    rescaled attempt at p = 128 equals the fault-free sort there bit for
    bit, each attempt's wall, the rescaled attempt's peak against the
    fault-free one's (the policy's logger resets the peak at the rescale
    and reads the allocation there), every RAMS kernel launched; (d) the
    same cell with a straggler (the first attempt completes, then is
    flagged); (e) the RAMS cell itself (p = 256, n = 2^26) with the kill
    of (c): the rescaled attempt's capacity 2^20 is refused as in the
    reference, and the dead attempts' memory is released.  Returns the
    launches of (c)."""
    from repro_torch.core import comm
    t0 = time.perf_counter()

    # (a) card against CPU at p = 8
    x8 = generate_instance("Uniform", 8, 8 * 1024).astype(np.int32)
    r = np.random.default_rng(3)
    cases = [(f"{a}-kill-straggler", x8,
              [comm.kill_pe(2), comm.delay_pe(1, factor=8.0)], None,
              {"p": 8, "algorithm": a}) for a in FAULT_ALGOS]
    cases += [
        ("rams-nested-kill", x8, [comm.kill_pe(5)], None,
         {"mesh_shape": (2, 4), "algorithm": "rams"}),
        ("rquick-batched-kill", r.integers(0, 1 << 20, size=(3, 4 * 1024)
                                           ).astype(np.int32),
         [comm.kill_pe(1)], None, {"p": 4, "algorithm": "rquick"}),
        ("auto-kill", x8, [comm.kill_pe(0)], None,
         {"p": 8, "algorithm": "auto"}),
        ("rfis-two-kills", x8, [comm.kill_pe(6), comm.kill_pe(1, after=2)],
         None, {"p": 8, "algorithm": "rfis"}),
        ("rquick-budget-exhausted", np.arange(4096, dtype=np.int32),
         [comm.kill_pe(0), comm.kill_pe(1)], {"max_restarts": 1},
         {"p": 4, "algorithm": "rquick"}),
    ]
    for label, x, faults, pkw, cfg in cases:
        card = fault_run(torch, psort, SortConfig, x, faults, "cuda", pkw,
                         **cfg)
        cpu = fault_run(torch, psort, SortConfig, x, faults, "cpu", pkw,
                        **cfg)
        same = same_fault_run(torch, card, cpu)
        emit({"phase": "fault_cuda_vs_cpu", "case": label,
              "attempts": card[1].attempts, "identical": same,
              "error": type(card[0]).__name__
              if isinstance(card[0], Exception) else None})
        if not same:
            raise AssertionError(f"fault case {label}: cuda and cpu differ")
        if isinstance(card[0], Exception) != (pkw is not None):
            raise AssertionError(f"fault case {label}: {card[0]!r}")
        del card, cpu

    # (b) the external lane at its check cell
    n = 1 << LOG_N_EXT_CHECK
    x = generate_instance("Uniform", P_EXT, n).astype(np.uint32)
    for label, faults, budget in (
            ("ext-merge-kill", [comm.kill_pe(3, tag="ext:merge")],
             BUDGET_EXT_CHECK),
            ("ext-pass1-kill", [comm.kill_pe(1, tag="ext:pass1")],
             BUDGET_EXT_CHECK),
            ("ext-crossing", [comm.kill_pe(2)], BUDGET_FAULT_CROSS)):
        cfg = {"p": P_EXT, "external": ExternalPolicy(budget=budget)}
        reset_launch_counts()
        card = fault_run(torch, psort, SortConfig, x, faults, "cuda", **cfg)
        launches = launch_counts()
        cpu = fault_run(torch, psort, SortConfig, x, faults, "cpu", **cfg)
        same = same_fault_run(torch, card, cpu)
        algos = [a["algorithm"] for a in card[1].attempts]
        emit({"phase": "fault_external", "case": label, "p": P_EXT, "n": n,
              "budget": budget, "attempts": card[1].attempts,
              "identical": same, "launches": launches})
        if not same:
            raise AssertionError(f"fault case {label}: cuda and cpu differ")
        if isinstance(card[0], Exception) or algos[-1] != "external" or \
                launches["kway_classify"] <= 0:
            raise AssertionError(f"fault case {label}: {algos}, {launches}")
        if label == "ext-crossing" and algos[0] == "external":
            raise AssertionError(f"no crossing into the lane: {algos}")
        check_external(torch, np, x, card[0][0], card[0][1], n)
        del card, cpu
    emit({"phase": "fault_checks_done", "seconds": time.perf_counter() - t0})

    # (c) and (d): RAMS at p = 256, n = 2^25, killed or straggling
    n = 1 << LOG_N_FAULT
    x = generate_instance("Uniform", P_MAIN, n).astype(np.uint32)
    ref_cfg = SortConfig(p=P_MAIN // 2, algorithm="rams")
    psort(x, ref_cfg)                                # warm-up at p = 128
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    ref = timed_psort(torch, psort, x, ref_cfg, reset_launch_counts,
                      launch_counts)
    check_sorted(torch, np, x, ref[0], ref[1], n)
    fault_launches = None
    for label, fault in (("kill", comm.kill_pe(17, tag="level1")),
                         ("straggler", comm.delay_pe(5, factor=8.0))):
        run = timed_fault(torch, psort, SortConfig, x, fault, P_MAIN,
                          reset_launch_counts, launch_counts)
        out, info = run["result"]
        same = same_result(torch, (out, info), ref[:2])
        check_sorted(torch, np, x, out, info, n)
        attempts = [(a["p"], a["ok"]) for a in run["attempts"]]
        missing = [k for k in RAMS_LAUNCHES if run["launches"][k] <= 0]
        # each peak over what was allocated before its call (the fault
        # runs hold the p = 128 result beside them)
        peak_ratio = (run["rescaled_peak"] - run["before"]) / (ref[4] - base)
        emit({"phase": "fault_rams", "case": label, "p": P_MAIN, "n": n,
              "fault": [fault.kind, fault.pe, fault.tag, fault.factor],
              "attempts": attempts, "identical_to_p128": same,
              "attempt_walls_s": run["walls"], "total_wall_s": run["wall"],
              "p128_wall_s": ref[2],
              "total_over_p128": run["wall"] / ref[2],
              "rescaled_peak": run["rescaled_peak"], "p128_peak": ref[4],
              "p128_allocated_before": base,
              "rescaled_peak_over_p128": peak_ratio,
              "allocated_at_rescale": run["at_rescale"],
              "allocated_before": run["before"],
              "overflow": info["overflow"], "launches": run["launches"]})
        if attempts != [(P_MAIN, False), (P_MAIN // 2, True)] or not same:
            raise AssertionError(f"fault {label}: attempts {attempts}, "
                                 f"identical {same}")
        if peak_ratio > 1.05:
            raise AssertionError(f"fault {label}: the rescaled attempt's "
                                 f"peak is {peak_ratio:.3f}x the p = 128 "
                                 f"sort's")
        if missing:
            raise AssertionError(f"kernels never launched on the fault "
                                 f"path: {missing}")
        if fault_launches is None:
            fault_launches = run["launches"]
        del run, out, info
    del ref, x
    torch.cuda.empty_cache()
    emit({"phase": "fault_rams_done", "seconds": time.perf_counter() - t0})

    # (e) the RAMS cell: the rescale to p = 128 passes RAMS's capacity
    n = 1 << LOG_N_MAIN
    x = generate_instance("Uniform", P_MAIN, n).astype(np.uint32)
    err, seen = None, {}
    try:
        timed_fault(torch, psort, SortConfig, x,
                    comm.kill_pe(17, tag="level1"), P_MAIN,
                    reset_launch_counts, launch_counts, record=seen)
    except ValueError as e:
        err = str(e)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    attempts = [(a["p"], a["ok"]) for a in seen["policy"].attempts]
    words = 4 * n
    emit({"phase": "fault_rams_cell", "p": P_MAIN, "n": n, "error": err,
          "attempts": attempts, "allocated_before": seen["before"],
          "allocated_at_rescale": seen["at_rescale"],
          "allocated_after": after, "input_device_bytes": words,
          "peak_after_rescale": torch.cuda.max_memory_allocated()})
    if err is None or "capacity < 2^20" not in err:
        raise AssertionError(f"the RAMS cell's rescale did not fail as the "
                             f"reference's: {err!r}")
    if attempts != [(P_MAIN, False), (P_MAIN // 2, False)]:
        raise AssertionError(f"the RAMS cell's attempts: {attempts}")
    if after > seen["before"] + FAULT_SLACK or \
            seen["at_rescale"][0] > seen["before"] + words + FAULT_SLACK:
        raise AssertionError("the dead attempts' memory was not released")
    del x
    torch.cuda.empty_cache()
    emit({"phase": "fault_done", "seconds": time.perf_counter() - t0})
    return fault_launches


def timed_fault(torch, psort, SortConfig, x, fault, p, reset_launch_counts,
                launch_counts, record=None):
    """RAMS at p under one fault, timed: its result, each attempt's wall
    (the rescale ends the first), the total, the allocation before the
    call and at each rescale, the rescaled attempt's peak (the logger
    resets it) and the launches.  ``record`` gets the policy and the
    allocations as they are taken, for a run that raises."""
    from repro_torch.core import comm
    from repro_torch.runtime import FaultPolicy
    rec = {} if record is None else record
    marks, at_rescale = [], []

    def logger(msg):
        if msg.startswith("[psort]"):           # psort's rescale
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            at_rescale.append(torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()

    pol = FaultPolicy(plan=comm.FaultPlan((fault,)), logger=logger)
    rec.update(policy=pol, at_rescale=at_rescale)
    torch.cuda.empty_cache()
    reset_launch_counts()
    torch.cuda.synchronize()
    rec["before"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    result = psort(x, SortConfig(p=p, algorithm="rams", fault_policy=pol),
                   return_info=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    edges = [t0] + marks + [t1]
    return {"result": result, "attempts": pol.attempts,
            "walls": [b - a for a, b in zip(edges, edges[1:])],
            "wall": t1 - t0, "before": rec["before"],
            "at_rescale": at_rescale,
            "rescaled_peak": torch.cuda.max_memory_allocated(),
            "launches": launch_counts()}


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
    from repro_torch.core import local_kernels
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    kernels_on = local_kernels()
    if not (kernels_on.sort and kernels_on.partition):
        return fail(f"the kernels are switched off ({kernels_on}): unset "
                    f"REPRO_LOCAL_KERNELS / REPRO_PALLAS_LOCAL_SORT")
    start = clock = time.perf_counter()

    def lap(name):
        """Print the seconds of the phase that just ended."""
        nonlocal clock
        now = time.perf_counter()
        emit({"phase": "seconds", "of": name, "seconds": now - clock})
        clock = now

    # --- 1. the card ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "local_kernels": {"sort": kernels_on.sort,
                            "partition": kernels_on.partition}})

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: str(v.relative_to(src.parent))
                      for k, v in _build.SOURCES.items()}})
    log = _build.BUILD_LOG.get("bitonic")        # None: no log kept
    emit({"phase": "ptxas", "source": "bitonic",
          "kernels": None if log is None else ptxas_report(log)})

    lap("1-2")

    # --- 3. kernels against their plain versions -----------------------------
    kernels = kernel_phases(torch)
    lap("3")
    kway_rows = kway_phase(torch)
    lap("3b")

    # --- 4. psort end to end at p = 256, n = 2^26 ----------------------------
    n = 1 << LOG_N_MAIN
    cfg = SortConfig(p=P_MAIN, algorithm="rams")
    main_launches = rams_uniform_wall = None
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
            main_launches, rams_uniform_wall = launches, wall
        emit({"phase": "psort", "instance": name, "p": P_MAIN, "n": n,
              "algorithm": info["algorithm"], "wall_s": wall,
              "keys_per_s": n / wall, "max_memory_allocated": peak,
              "balance": info["balance"], "overflow": info["overflow"],
              "launches": launches})
        del out, info, x

    lap("4")

    # --- 5. card vs CPU at p = 64, n = 2^20 ----------------------------------
    n = 1 << LOG_N_CHECK
    x = generate_instance("Uniform", P_CHECK, n).astype(np.uint32)
    cfg = SortConfig(p=P_CHECK, algorithm="rams")
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

    lap("5")

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

    lap("6")

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

    lap("7")

    # --- 8. RQuick at p = 2^18, n = 2^26 --------------------------------------
    rquick_rows = rquick_kernel_phase(torch)
    rquick_launches = rquick_phase(torch, np, psort, SortConfig,
                                   generate_instance, launch_counts,
                                   reset_launch_counts)
    lap("8")

    # --- 10. the other algorithms at their sizes ----------------------------
    t10 = time.perf_counter()
    other_rows = other_kernel_phase(torch)
    other_launches = other_paths_phase(torch, np, psort, SortConfig,
                                       generate_instance, launch_counts,
                                       reset_launch_counts)
    emit({"phase": "other_done", "seconds": time.perf_counter() - t10})
    lap("10")

    # --- 11. 8-byte keys -----------------------------------------------------
    t11 = time.perf_counter()
    keys64_launches = keys64_phase(torch, np, psort, SortConfig,
                                   generate_instance, launch_counts,
                                   reset_launch_counts)
    emit({"phase": "keys64_done", "seconds": time.perf_counter() - t11})
    lap("11")

    # --- 12. collective traces ----------------------------------------------
    t12 = time.perf_counter()
    trace_phase(torch, SortConfig, ExternalPolicy, trace_collectives)
    emit({"phase": "trace_done", "seconds": time.perf_counter() - t12})
    lap("12")

    # --- 13. selection ---------------------------------------------------------
    selection_phase(torch, np, psort, SortConfig, generate_instance,
                    launch_counts, reset_launch_counts)
    lap("13")

    # --- 14. the streamed exchange ---------------------------------------------
    overlap_launches, chunk_rows = overlap_phase(
        torch, np, psort, SortConfig, ExternalPolicy, generate_instance,
        launch_counts, reset_launch_counts, trace_collectives)
    lap("14")

    # --- 15. batched keys and nested meshes -----------------------------------
    batch_rows, batch_sort_rows = batch_kernel_rows(torch)
    batch_launches = batched_phase(torch, np, psort, SortConfig,
                                   generate_instance, launch_counts,
                                   reset_launch_counts, trace_collectives)
    lap("15")

    # --- 16. query serving ----------------------------------------------------
    serve_rows = ingest_kernel_rows(torch)
    serve_launches = serve_phase(torch, np, generate_instance, launch_counts,
                                 reset_launch_counts, rams_uniform_wall)
    lap("16")

    # --- 17. faults and elastic rescale --------------------------------------
    fault_rows, fault_sort_rows = rams_kernel_rows(
        torch, P_MAIN // 2, P_MAIN // 2, (1 << LOG_N_FAULT) // (P_MAIN // 2),
        "rams-fault", seed=17)
    fault_launches = fault_phase(torch, np, psort, SortConfig,
                                 ExternalPolicy, generate_instance,
                                 launch_counts, reset_launch_counts)
    lap("17")
    emit({"phase": "seconds", "of": "all",
          "seconds": time.perf_counter() - start})

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
    # the streamed paths of phase 14: the same kernels at the shapes of
    # their barrier paths, with the streamed sort's launches
    for key, row in kernels.items():
        rows.append((row, "rams-overlap", overlap_launches["rams"][key]))
    for row, paths in other_rows:
        if "ssort" in paths:
            rows.append((row, "ssort-overlap",
                         overlap_launches["ssort"][launch_key(row)]))
    for row in kway_rows:
        rows.append((row, "external-overlap",
                     overlap_launches["external"]["kway_classify"]))
    for row, paths in chunk_rows:
        for path in paths:
            rows.append((row, path, overlap_launches[path.split("-")[0]][
                launch_key(row)]))
    # phase 15: the RAMS kernels at the batched cell's shapes, RQuick's at
    # its cell's (the batched RQuick's rows), RAMS's main-path shapes for
    # the nested meshes; each with that path's launches
    for key, row in batch_rows.items():
        rows.append((row, "rams-batched", batch_launches["rams-batched"][key]))
    for row, paths in batch_sort_rows:
        rows.append((row, "rams-batched",
                     batch_launches["rams-batched"][launch_key(row)]))
    for row in rquick_rows:
        rows.append((row, "rquick-batched",
                     batch_launches["rquick-batched"][launch_key(row)]))
    for key, row in kernels.items():
        if row["name"] in RAMS_KERNELS:
            rows.append((row, "rams-nested",
                         batch_launches["rams-nested"][key]))
    # phase 16: the serving ingest's local sort, with its launches
    for key, row in serve_rows.items():
        rows.append((row, "serve-ingest", serve_launches[key]))
    # phase 17: the RAMS kernels at the rescaled attempt's shapes (p = 128,
    # n = 2^25), with the killed run's launches (both attempts)
    for key, row in fault_rows.items():
        rows.append((row, "rams-fault", fault_launches[key]))
    for row, paths in fault_sort_rows:
        rows.append((row, "rams-fault", fault_launches[launch_key(row)]))
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
