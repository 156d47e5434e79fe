#!/usr/bin/env python3
"""Time the port's local-sort, partition and k-way kernels of one tree.

    python3 tools/time_torch_kernels.py [--src src] [--label name]

Builds the kernels of the tree whose ``src`` is given (default: this
repository's), then times each launch with CUDA events (median of
``REPS`` after one warm-up) at the shapes of ``chip_smoke.py``:
``tile_sort`` and one ``run_merge`` pass on (256, 2 196 992) int32 keys
with an int32 payload, ``partition_classify`` and ``partition_rank`` on
(256, 2^20) with nb = 64 (RAMS at p = 256, n = 2^26), and, where the tree
accepts 2^18 rows, ``tile_sort`` and ``partition_classify`` with nb = 2 on
(2^18, 1024) (RQuick at p = 2^18, n = 2^26), and ``kway_classify`` at
the external lane's pass C (C = 2^25, nb = 16) and pass D (C = 2^21,
nb = 8) and at nb = 2048, on sorted runs of 2^21 keys with splitters of
unordered ties (``kway_<row>`` with CUDA events around one call,
``kway_<row>_device`` the kernel's device time per launch under
``torch.profiler`` over back-to-back calls, ``kway_<row>_wall`` the host
clock per call over those calls).  ``partition_classify`` is
the call both trees take, the launch that feeds the rank; the
``partition_<path>`` entries time what each path calls,
``partition_buckets`` with its own flags (RQuick: the histogram; SSort and
NS-SSort, nb = 256 with ~2^18 valid keys per row on (256, 2^20) and
(256, 2^19): the buckets; RAMS: everything), so a tree whose wrapper has
fewer launch variants pays for the outputs it computes anyway.  The
inputs come from fixed seeds on the card, the same for every tree, so two
trees are compared by running this for each in turns in one call (parent,
this, this, parent).  Prints one JSON line with the card, the label and
the times in ms (null where the tree refuses the shape).  It needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPS = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="this")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import kway as kw
    from repro_torch.kernels import partition as pt
    _build.build_all(["bitonic", "partition", "kway"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def ints(shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                             device=dev, dtype=torch.int32)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def device_ms(fn, kernel, reps):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        return sum(us) / reps / 1e3

    out = {}

    def variants(name, *args, **kw):
        """Every classify variant of a tree that has them (``want``)."""
        for want in getattr(pt, "WANTS", ()):
            out[f"partition_classify_{name}_{want}"] = ms(
                lambda: pt.classify(*args, want=want, **kw))

    def path_call(flags, *args, **kw):
        """``partition_buckets`` with the path's flags, or without them
        where the tree has no such flags (it then computes every output
        but the ranks)."""
        try:
            return pt.partition_buckets(*args, want_pos=False, **flags, **kw)
        except TypeError:
            return pt.partition_buckets(*args, want_pos=False, **kw)

    rows, C = 256, 2_196_992
    keys, vals = ints((rows, C)), ints((rows, C))
    out["tile_sort"] = ms(lambda: bt.sort_tiles(keys, vals))
    runs = bt.sort_tiles(keys, vals)
    out["run_merge"] = ms(lambda: bt.merge_runs(*runs, bt.TILE))
    del keys, vals, runs
    for name, C, nb, reps in (("pass_c", 1 << 25, 16, 20),
                              ("pass_d", 1 << 21, 8, 200),
                              ("nb2048", 1 << 25, 2048, 20)):
        keys = torch.sort(ints((C >> 21, 1 << 21)), dim=1)[0].reshape(-1)
        ties = ints((C,))
        s_keys = torch.sort(keys[torch.randint(0, C, (nb - 1,), generator=g,
                                               device=dev)])[0]
        s_ties = ints((nb - 1,))

        def call():
            return kw.kway_classify(keys, ties, s_keys, s_ties, n_buckets=nb)
        out[f"kway_{name}"] = ms(call)
        out[f"kway_{name}_device"] = device_ms(call, "kway_classify", reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        out[f"kway_{name}_wall"] = (time.perf_counter() - t0) / reps * 1e3
        del keys, ties, s_keys, s_ties
    torch.cuda.empty_cache()

    rows, C, nb = 256, 1 << 20, 64
    keys = torch.sort(ints((rows, C)), dim=1)[0]
    ties = ints((rows, C))
    s_keys = torch.sort(ints((rows, nb - 1)), dim=1)[0]
    s_ties = ints((rows, nb - 1))
    count = C - (torch.arange(rows, device=dev) * 997) % 5000
    out["partition_classify"] = ms(lambda: pt.classify(
        keys, ties, s_keys, s_ties, count, n_buckets=nb))
    bucket, th = pt.classify(keys, ties, s_keys, s_ties, count, n_buckets=nb)
    off = torch.cumsum(th, dim=1, dtype=torch.int32) - th
    out["partition_rank"] = ms(lambda: pt.rank(bucket, off, n_buckets=nb))
    out["partition_rams"] = ms(lambda: pt.partition_buckets(
        keys, ties, s_keys, s_ties, n_buckets=nb, count=count))
    variants("rams", keys, ties, s_keys, s_ties, count, n_buckets=nb)
    del keys, ties, s_keys, s_ties, count, bucket, th, off
    torch.cuda.empty_cache()

    rows, nb = 256, 256
    for name, C in (("ssort", 1 << 20), ("ns_ssort", 1 << 19)):
        keys = torch.sort(ints((rows, C)), dim=1)[0]
        count = (1 << 18) - 2000 + (torch.arange(rows, device=dev) * 997) \
            % 4000
        ties = torch.zeros_like(keys)
        s_keys = torch.sort(keys[0, torch.randint(
            0, int(count.min()), (nb - 1,), generator=g, device=dev)])[0]
        s_keys = s_keys.expand(rows, nb - 1).contiguous()
        s_ties = torch.zeros_like(s_keys)
        out[f"partition_classify_{name}"] = ms(lambda: pt.classify(
            keys, ties, s_keys, s_ties, count, n_buckets=nb))
        out[f"partition_{name}"] = ms(lambda: path_call(
            {"want_hist": False}, keys, ties, s_keys, s_ties, n_buckets=nb,
            count=count))
        variants(name, keys, ties, s_keys, s_ties, count, n_buckets=nb)
        del keys, ties, s_keys, s_ties, count
        torch.cuda.empty_cache()

    rows, C = 1 << 18, 1024
    keys, vals = ints((rows, C)), ints((rows, C))
    count = C // 4 + (torch.arange(rows, device=dev) * 997) % (3 * C // 4 + 1)
    s_keys, s_ties = ints((rows, 1)), ints((rows, 1))
    for name, fn in (
            ("tile_sort_rquick", lambda: bt.sort_tiles(keys, vals, count)),
            ("partition_classify_rquick", lambda: pt.classify(
                keys, vals, s_keys, s_ties, count, n_buckets=2)),
            ("partition_rquick", lambda: path_call(
                {"want_bucket": False}, keys, vals, s_keys, s_ties,
                n_buckets=2, count=count))):
        try:
            out[name] = ms(fn)
        except ValueError:                 # a tree capped at 65 535 rows
            out[name] = None
    # the variants on sorted rows, as the RQuick path classifies them
    variants("rquick", torch.sort(keys, dim=1)[0], vals, s_keys, s_ties,
             count, n_buckets=2)
    print(json.dumps({"card": card, "label": args.label,
                      "tree": str(Path(args.src).resolve()), "ms": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
