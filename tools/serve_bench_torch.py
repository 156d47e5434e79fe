#!/usr/bin/env python3
"""Mixed-query serving benchmark of the port (counterpart of
``benchmarks/serve_bench.py``): per p and e = log2(n/p), the wall time of
answering a query micro-batch two ways, the sort-free selection path of
``repro_torch.core.queries`` against sorting first with ``psort`` and
indexing, plus the counting queries and a mixed-stream ``SortService``
drain.  Cells land in the reference's ``bench[p][name][e]`` shape (µs per
cell); the full-sort comparator is pinned to ``"rquick"``, as there.

    PYTHONPATH=src python3 tools/serve_bench_torch.py --e 6 18
    PYTHONPATH=src python3 tools/serve_bench_torch.py --smoke --device cpu \\
        --p 8 --e 6

Writes JSON to ``--out`` (default ``serve_out/serve_bench_torch.json``),
with the card's name and power limit; it imports torch, numpy and the
port only.  Every timed call ends with its answers on the host (the sorts
with a copy of the sorted keys to the host, as the reference's
``np.asarray`` does).
"""
from __future__ import annotations

import argparse
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch import SortConfig, psort  # noqa: E402
from repro_torch.core.queries import (percentile, range_query,  # noqa: E402
                                      rank_of_key, shard_data, top_k)
from repro_torch.launch.sort_serve import SortService  # noqa: E402

BATCH = 8           # queries per micro-batch in the per-kind cells
MIX_QUERIES = 24    # stream length of the serve/mixed cell


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_us(fn, iters: int, device, reps: int = 1) -> float:
    """Fastest wall time of ``fn`` in µs: the minimum over ``iters``
    measurements of a ``reps``-call chain, after one warm-up call."""
    fn()
    _sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(min(ts)) / reps * 1e6


def bench_p(p: int, e: int, iters: int, device, seed: int = 0,
            cheap_iters: int = 3):
    """All serve cells for one (p, e): {name: µs}."""
    n = p << e
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, size=n).astype(np.int64)
    data = shard_data(keys, p, device=device)
    ks = np.linspace(1, min(64, n), BATCH).astype(np.int64)
    qs = np.linspace(0.0, 100.0, BATCH)
    probe = keys[rng.integers(0, n, size=BATCH)]
    lo = np.minimum(probe, keys[rng.integers(0, n, size=BATCH)])
    hi = np.maximum(probe, keys[rng.integers(0, n, size=BATCH)])
    cfg = SortConfig(p=p, algorithm="rquick")

    def sorted_now():
        return psort(keys, cfg, device=device).cpu().numpy()

    def topk_fullsort():
        s = sorted_now()
        return [s[n - k:] for k in ks]

    def pct_fullsort():
        s = sorted_now()
        return s[np.floor(qs / 100.0 * (n - 1)).astype(np.int64)]

    ic = max(iters, cheap_iters)
    out = {
        "serve/top_k": _best_us(lambda: top_k(data, ks), ic, device,
                                reps=3),
        "serve/top_k_fullsort": _best_us(topk_fullsort, iters, device),
        "serve/percentile": _best_us(lambda: percentile(data, qs), ic,
                                     device, reps=3),
        "serve/percentile_fullsort": _best_us(pct_fullsort, iters, device),
        "serve/rank_of_key": _best_us(lambda: rank_of_key(data, probe), ic,
                                      device, reps=10),
        "serve/range_query": _best_us(lambda: range_query(data, lo, hi), ic,
                                      device, reps=10),
        "serve/sort": _best_us(sorted_now, iters, device),
    }

    def mixed():
        svc = SortService(keys, p, policy="selection", device=device)
        r = np.random.default_rng(seed + 1)
        for _ in range(MIX_QUERIES):
            kind = ("top_k", "percentile", "rank_of_key",
                    "range_query")[r.integers(4)]
            arg = {"top_k": int(ks[r.integers(BATCH)]),
                   "percentile": float(qs[r.integers(BATCH)]),
                   "rank_of_key": int(probe[r.integers(BATCH)]),
                   "range_query": (int(lo[r.integers(BATCH)]),
                                   int(hi[r.integers(BATCH)]))}[kind]
            svc.submit(kind, arg)
        svc.drain()

    out["serve/mixed"] = _best_us(mixed, ic, device) / MIX_QUERIES
    return out


def card_line(device) -> str:
    if device.type != "cuda":
        return f"cpu: {platform.processor() or platform.machine()}"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--p", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--e", type=int, nargs="+", default=[6],
                    help="log2(n/p) per cell")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="1 timed iteration of the full-sort cells (same "
                         "cell grid; the cheap cells keep 3)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default="serve_out/serve_bench_torch.json")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to rehearse")
    device = torch.device(args.device or "cuda")
    iters = 1 if args.smoke else args.iters
    card = card_line(device)
    print(card, flush=True)

    bench = {}
    for p in args.p:
        for e in args.e:
            cells = bench_p(p, e, iters, device, seed=args.seed)
            for name, us in cells.items():
                bench.setdefault(str(p), {}).setdefault(name, {})[str(e)] \
                    = us
            print(f"# p={p} e={e}: " + "  ".join(
                f"{k.split('/')[1]}={v:.0f}us" for k, v in cells.items()),
                flush=True)
            for kind in ("top_k", "percentile"):
                sel = cells[f"serve/{kind}"]
                full = cells[f"serve/{kind}_fullsort"]
                tag = "beats" if sel < full else "LOSES TO"
                print(f"#   {kind}: selection {tag} fullsort "
                      f"({sel:.0f}us vs {full:.0f}us, "
                      f"{full / max(sel, 1e-9):.1f}x)", flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "machine": card, "device": str(device), "torch": torch.__version__,
        "cuda": torch.version.cuda, "host": platform.node(), "p": args.p,
        "e": args.e, "iters": iters, "bench": bench}, indent=2,
        sort_keys=True))
    print(f"# wrote {out}")


if __name__ == "__main__":
    main()
