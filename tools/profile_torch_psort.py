#!/usr/bin/env python3
"""Where the time of one ``repro_torch.psort`` goes on the GPU.

    PYTHONPATH=src python3 tools/profile_torch_psort.py [--p 256]
        [--log-n 26] [--instance Uniform] [--out profile_out]

Runs one warm-up sort, then one sort under ``torch.profiler`` (CPU and
CUDA activity) and prints one JSON line: the card (nvidia-smi name and
power limit), the wall time of the profiled sort, the device's busy time
(the union of its kernel intervals) and idle share, the time of every
phase scope the port opens (``make_shard``, ``shuffle``, ``level0``, …;
host span and, where the profiler records it, device span), and the
kernels by total device time.  The profiler's own table and a Chrome
trace go under ``--out``.  It needs a CUDA device and fails without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

PHASES = ("make_shard", "shuffle", "level0", "level1", "level2",
          "reassemble")


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
    ap.add_argument("--p", type=int, default=256)
    ap.add_argument("--log-n", type=int, default=26)
    ap.add_argument("--instance", default="Uniform")
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_torch_psort: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch import SortConfig, psort
    from repro_torch.data import generate_instance
    from repro_torch.kernels import launch_counts, reset_launch_counts

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    n = 1 << args.log_n
    x = generate_instance(args.instance, args.p, n).astype(np.uint32)
    cfg = SortConfig(p=args.p)
    psort(x, cfg)                                       # warm-up
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
               and e.name not in PHASES]
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kernel[e.name][0] += e.time_range.end - e.time_range.start
        by_kernel[e.name][1] += 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    phases = {}
    for e in events:
        if e.name in PHASES:
            side = "device_ms" if e.device_type == DeviceType.CUDA \
                else "host_ms"
            ph = phases.setdefault(e.name, {})
            ph[side] = ph.get(side, 0.0) + (e.time_range.end
                                            - e.time_range.start) / 1e3

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "key_averages.txt").write_text(prof.key_averages().table(
        sort_by="device_time_total", row_limit=40))
    prof.export_chrome_trace(str(out / "trace.json"))
    print(json.dumps({
        "card": card, "device": torch.cuda.get_device_name(0),
        "p": args.p, "n": n, "instance": args.instance,
        "overflow": info["overflow"], "wall_ms_profiled": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches": len(kernels), "port_kernel_launches": launches,
        "phases": phases,
        "top_kernels": [{"name": k[:120], "ms": v[0] / 1e3, "count": v[1]}
                        for k, v in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
