#!/usr/bin/env python3
"""Where the time of one ``repro_torch.psort`` goes on the GPU.

    PYTHONPATH=src python3 tools/profile_torch_psort.py [--p 256]
        [--log-n 26] [--instance Uniform] [--out profile_out]
        [--algorithm rams|rquick|rfis|ssort|...] [--external] [--src src]

Runs one warm-up sort, then one sort under ``torch.profiler`` (CPU and
CUDA activity) and prints one JSON line: the card (nvidia-smi name and
power limit), the wall time of the profiled sort, the device's busy time
(the union of its kernel intervals) and idle share, the time of every
scope the port opens (``make_shard``, ``shuffle``, RAMS's ``level0``, …,
RQuick's ``iter0``, ``iter1``, …, or the external lane's ``ext:runs`` …
``ext:merge`` and ``ext:sort``: host span, the device's busy time inside
it and, where the profiler records it, device span), the kernels by total
device time, and the host operations by their own host time.
``--algorithm`` takes any algorithm of the port; RAMS defaults to p =
256 and RQuick to p = 2^18, both with n = 2^26, and every other one needs
``--p`` and ``--log-n`` (``chip_smoke.py`` phase 10 runs each at its
size).  RFIS's scopes are ``gather``, ``rank`` and ``route``, SSort's
``shuffle``, ``splitters`` and ``route``.  ``--external`` profiles the
external lane's cell instead: p = 16, n = 2^28, budget 2^21, warmed up
at n = 2^26.
``--src`` imports ``repro_torch`` from another tree (default: this
repository's ``src``), so that two trees can be profiled in one call.
The profiler's own table and a Chrome trace go under ``--out``.
It needs a CUDA device and fails without one.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

PHASES = ("make_shard", "shuffle", "level0", "level1", "level2",
          "reassemble", "ext:runs", "ext:splitters", "ext:exchange",
          "ext:merge", "ext:sort", "gather", "rank", "route", "splitters")
EXTERNAL_P, EXTERNAL_LOG_N, EXTERNAL_BUDGET = 16, 28, 1 << 21
DEFAULT_P = {"rams": 256, "rquick": 1 << 18}


def _is_phase(name: str) -> bool:
    return name in PHASES or re.fullmatch(r"iter\d+", name) is not None


def _union_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, default=None,
                    help="PEs (default 256 for RAMS, 2^18 for RQuick)")
    ap.add_argument("--algorithm", default="rams")
    ap.add_argument("--log-n", type=int, default=None,
                    help="log2 of the key count (default 26 for RAMS "
                         "and RQuick)")
    ap.add_argument("--instance", default="Uniform")
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--external", action="store_true")
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    args = ap.parse_args(argv)
    if not args.external and args.algorithm not in DEFAULT_P and (
            args.p is None or args.log_n is None):
        ap.error(f"--algorithm {args.algorithm} needs --p and --log-n")

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_torch_psort: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import ExternalPolicy, SortConfig, psort
    from repro_torch.data import generate_instance
    from repro_torch.kernels import launch_counts, reset_launch_counts

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    if args.external:
        p, n = EXTERNAL_P, 1 << EXTERNAL_LOG_N
        cfg = SortConfig(p=p, external=ExternalPolicy(budget=EXTERNAL_BUDGET))
        warm = generate_instance("Uniform", p, n >> 2).astype(np.uint32)
    else:
        p = args.p or DEFAULT_P[args.algorithm]
        n = 1 << (26 if args.log_n is None else args.log_n)
        cfg = SortConfig(p=p, algorithm=args.algorithm)
        warm = None
    x = generate_instance(args.instance, p, n).astype(np.uint32)
    psort(x if warm is None else warm, cfg)             # warm-up
    del warm
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, info = psort(x, cfg, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()

    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not _is_phase(e.name)]
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kernel[e.name][0] += e.time_range.end - e.time_range.start
        by_kernel[e.name][1] += 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    phases = {}
    for e in events:
        if _is_phase(e.name):
            side = "device_ms" if e.device_type == DeviceType.CUDA \
                else "host_ms"
            ph = phases.setdefault(e.name, {})
            ph[side] = ph.get(side, 0.0) + (e.time_range.end
                                            - e.time_range.start) / 1e3
            if side == "host_ms":
                a, b = e.time_range.start, e.time_range.end
                ph["busy_ms"] = ph.get("busy_ms", 0.0) + _union_us(
                    (max(k.time_range.start, a), min(k.time_range.end, b))
                    for k in kernels if k.time_range.start < b
                    and k.time_range.end > a) / 1e3
    host_ops = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type == DeviceType.CPU and not _is_phase(e.name):
            host_ops[e.name][0] += e.self_cpu_time_total
            host_ops[e.name][1] += 1
    top_host = sorted(host_ops.items(), key=lambda kv: -kv[1][0])[:15]

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "key_averages.txt").write_text(prof.key_averages().table(
        sort_by="device_time_total", row_limit=40))
    prof.export_chrome_trace(str(out / "trace.json"))
    print(json.dumps({
        "card": card, "device": torch.cuda.get_device_name(0),
        "tree": str(Path(args.src).resolve()), "p": p, "n": n,
        "algorithm": info["algorithm"], "instance": args.instance,
        "overflow": info["overflow"], "wall_ms_profiled": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches": len(kernels), "port_kernel_launches": launches,
        "phases": phases,
        "top_kernels": [{"name": k[:120], "ms": v[0] / 1e3, "count": v[1]}
                        for k, v in top],
        "top_host_ops_self": [{"name": k[:120], "ms": v[0] / 1e3,
                               "count": v[1]} for k, v in top_host]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
