#!/usr/bin/env python3
"""Time the external lane's (key, tie) sort on the GPU.

    PYTHONPATH=src python3 tools/time_sort_planes.py

``repro_torch.core.external._sort_planes`` sorts 4-byte keys by (key,
tie) with two int32 passes of the local-sort kernels (by tie, then stably
by key).  This times it at the shapes of the lane's three passes at p =
16, budget 2^21 -- pass A (16, 2^21) full rows, pass C (16, 2^21 + 2^17)
with ragged counts, pass D (1, 2^21 + 12345) -- against the stable sort of
the int64 composite ``key << 32 | tie`` with ``torch.sort`` that it
replaced, after checking that both give the same planes bit for bit.
Each time is the median of 10 calls, with CUDA events (device
time, including any wait for the host) and the host clock (the call ends
in ``torch.cuda.synchronize()``); the largest count is given as a host
int, as the lane's callers give it.  It prints one JSON line per shape
after the card's name and power limit.

Then it sorts the lane's cell (p = 16, n = 2^28 Uniform, budget 2^21) in
one process, eight times, the lane's sort switched between the kernels
and the composite ``torch.sort`` in the order K C C K K C C K, and prints
each sort's wall time and pass seconds, after checking that both give the
same result.  One process for both removes what differs between processes
(host memory, the allocator's state) from the comparison.  It needs a
CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPS = 10


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_sort_planes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core.external import _sort_planes
    from repro_torch.core.rams import _M32, _mix32, as_int32_bits
    from repro_torch.kernels import launch_counts, reset_launch_counts

    def composite_sort(k, i, count):
        """The int64 composite path: one stable torch.sort."""
        L = k.shape[1]
        valid = torch.arange(L, device=k.device)[None, :] < count[:, None]
        tie = torch.where(valid, _mix32(i.to(torch.int64)), _M32)
        c = torch.where(valid, (k.to(torch.int64) << 32) | tie,
                        (1 << 63) - 1)
        ck, order = torch.sort(c, dim=1, stable=True)
        return ((ck >> 32).to(torch.int32), as_int32_bits(ck & _M32),
                torch.gather(i, 1, order))

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        dev, host = [], []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            fn()
            b.record()
            b.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(a.elapsed_time(b))
        return statistics.median(dev), statistics.median(host)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    shapes = [("A", 16, 1 << 21, False), ("C", 16, (1 << 21) + (1 << 17),
                                           True),
              ("D", 1, (1 << 21) + 12345, False)]
    for name, rows, L, ragged in shapes:
        k = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, L), generator=g,
                          device="cuda", dtype=torch.int32)
        i = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, L), generator=g,
                          device="cuda", dtype=torch.int32)
        count = torch.full((rows,), L, dtype=torch.int64, device="cuda")
        if ragged:
            count -= torch.randint(1 << 16, 1 << 17, (rows,), generator=g,
                                   device="cuda")
        cmax = int(count.max())
        new = _sort_planes(k, i, count, cmax)
        old = composite_sort(k, i, count)
        same = all(torch.equal(a, b) for a, b in zip(new, old))
        if not same:
            raise AssertionError(f"pass {name}: the kernel sort differs "
                                 f"from the composite sort")
        reset_launch_counts()
        _sort_planes(k, i, count, cmax)
        launches = launch_counts()
        kern_dev, kern_host = timed(lambda: _sort_planes(k, i, count, cmax))
        comp_dev, comp_host = timed(lambda: composite_sort(k, i, count))
        print(json.dumps({"card": card, "pass": name, "shape": [rows, L],
                          "identical": same, "launches": launches,
                          "kernels_device_ms": kern_dev,
                          "kernels_host_ms": kern_host,
                          "composite_device_ms": comp_dev,
                          "composite_host_ms": comp_host}), flush=True)
    lane_ab(torch, card, composite_sort)
    return 0


def lane_ab(torch, card, composite_sort):
    """The whole lane with each sort in turn, in one process."""
    import numpy as np
    from repro_torch import ExternalPolicy, SortConfig, psort
    from repro_torch.core import external
    from repro_torch.data import generate_instance
    p, n, budget = 16, 1 << 28, 1 << 21
    cfg = SortConfig(p=p, external=ExternalPolicy(budget=budget))
    kernels = external._sort_planes
    sorts = {"kernels": kernels,
             "composite": lambda k, i, count, cmax: composite_sort(k, i,
                                                                   count)}
    x = generate_instance("Uniform", p, n).astype(np.uint32)
    warm = x[:n >> 2]
    first = {}
    for name, fn in sorts.items():
        external._sort_planes = fn
        psort(warm, cfg)
        out, info = psort(x, cfg, return_info=True)
        first[name] = (out, info["perm"])
        del out, info
    same = all(torch.equal(a, b) for a, b in zip(first["kernels"],
                                                  first["composite"]))
    del first
    if not same:
        raise AssertionError("the lane's result differs between the sorts")
    for rep, name in enumerate("K C C K K C C K".split()):
        sort = "kernels" if name == "K" else "composite"
        external._sort_planes = sorts[sort]
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = psort(x, cfg, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"card": card, "lane": [p, n, budget], "rep": rep,
                          "sort": sort, "identical": same, "wall_s": wall,
                          "pass_seconds": info["pass_seconds"]}),
              flush=True)
        del info
    external._sort_planes = kernels


if __name__ == "__main__":
    sys.exit(main())
