#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches its own error):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA source of the port with nvcc, in parallel, timed;
3. every RAMS kernel at the shapes of the main path at p = 256, n = 2^26
   (sort and merge on (256, 2 196 992) with an int32 payload, partition on
   (256, 1 048 576) with nb = 64): equal to its plain PyTorch version on
   the card, timed with CUDA events (kernel, plain, library call) beside
   its bound;
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
   launched);
7. the card and the CPU agree bit for bit on the external lane at p = 16,
   n = 2^20, budget 2^13, and double buffering off equals on;
8. one ``kernels`` JSON line, the card line, and the ``ok`` line last.

It imports torch, numpy and the port only.  Without a CUDA device, or
without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
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
# the kernels each path launches
RAMS_KERNELS = ("tile_sort", "run_merge", "partition_classify",
                "partition_rank")
EXTERNAL_KERNELS = ("kway_classify",)


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
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "max_abs_err": err,
           "ms": cuda_ms(torch, fn), "plain_ms": cuda_ms(torch, plain),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None if library is None
           else cuda_ms(torch, library)}
    emit({"phase": "kernel", "shape": shape, **extra, **row,
          "kernel_ms": row["ms"]})
    results.setdefault(name, row)
    return row


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
    passes = (-(-C // t) - 1).bit_length()
    emit({"phase": "local_sort", "shape": [rows, C], "merge_passes": passes,
          "max_abs_err": err,
          "kernel_ms": cuda_ms(torch, lambda: bt.local_sort_fast(keys, vals)),
          "plain_ms": cuda_ms(torch, lambda: bref.sort_ref(keys, vals)),
          "library_ms": cuda_ms(torch, lib_sort),
          "bound_ms": bound(16 * n * (1 + passes), 0)[0]})
    del keys, vals
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
    cl = pt.classify(keys, ties, s_keys, s_ties, count, n_buckets=nb)
    record("partition_classify", src_p,
           "src/repro/kernels/partition/partition.py:72", cl,
           pref.classify_ref(keys, ties, s_keys, s_ties, count, n_buckets=nb,
                             tile=pt.PTILE),
           lambda: pt.classify(keys, ties, s_keys, s_ties, count,
                               n_buckets=nb),
           lambda: pref.classify_ref(keys, ties, s_keys, s_ties, count,
                                     n_buckets=nb, tile=pt.PTILE),
           nbytes=12 * n + hist_bytes,
           ops=int(count.sum()) * (nb - 1).bit_length(), shape=[rows, C])
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

    # --- 8. summary ------------------------------------------------------------
    rows = []
    path_launches = {**{k: main_launches[k] for k in RAMS_KERNELS},
                     **{k: ext_launches[k] for k in EXTERNAL_KERNELS}}
    for name, row in kernels.items():
        rows.append({"name": name, "route": row["route"],
                     "source": row["source"], "replaces": row["replaces"],
                     "launches": path_launches[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
