#!/usr/bin/env python3
"""Measure the port's α/β cost model on the card (counterpart of
``benchmarks/calibrate.py``), for ``psort(algorithm="auto")``.

    python3 tools/calibrate_torch.py --profile src/repro_torch/profiles/h100-sim.json
    python3 tools/calibrate_torch.py --fast --profile calibrate_out/h100-fast.json
    python3 tools/calibrate_torch.py --device cpu --p 8 --no-sweep --profile /tmp/cpu.json

Two phases on the sim layout (p PEs as the rows of one device's tensors):

1. **Microbenchmarks → the profile** (the reference's ``measure_profile``):
   α, a chain of tiny point-to-point steps (the hypercube exchange, the
   port's ``ppermute``); β, their payload slope between 64 and 4096 words
   per PE; α_c and α_hop, a chain of tiny
   ``all_gather`` at each swept p, regressed on p^(1/3); ``local_rate``,
   the port's local sort (the tile-sort and run-merge kernels on the card)
   of 2^14 words per PE; ``partition_rate``, ``partition_buckets`` at
   nb = 64 (the partition kernels); ``io_beta``, a pageable
   host→device→host round trip; ``overlap``, the larger of the
   double-buffered against the serial run formation and
   ``psort(overlap=True)`` against the barrier path (RAMS, p = 8,
   n/p = 2^8).  Every chain is timed between ``torch.cuda.synchronize()``
   calls, as the median of 5 after a warm-up.  Payload measurements run at
   the largest swept p.
2. **Sweep** (skipped by ``--no-sweep``): ``gatherm``, ``rfis``,
   ``rquick`` and ``rams`` within the reference's windows (``eligible``)
   on Uniform keys (seed 11), at p = 2^8, 2^12 and 2^16 over
   n/p = 2^e, e in {−8, −5, −3, −1, 0, 1, 2, 4, 6}, and e in {8, 10} at
   p = 2^8; each cell is the median of ``--iters`` sorts after a warm-up,
   with its counted-trace features (``cell_features``).  Before a cell
   runs, its peak device bytes are reckoned (:func:`reckon_bytes`); a
   cell over ``--peak-limit`` (60 GB) is skipped and listed with that
   size.  Then a non-negative least-squares fit of the five constants to
   the cells (``fit_profile``) goes into the profile's ``meta`` as a
   diagnostic, and the measured and predicted winners and crossovers per
   p are printed.

The profile (``--profile``) holds the card's ``nvidia-smi`` name and
power limit, the torch and CUDA versions and the grid in ``meta``; the
sweep's cells go to ``--out`` (``calibrate_out/calibrate_torch.json``).
It imports the port, numpy and scipy only.  ``--nested`` (the reference's
two-tier pass) is not ported: ROADMAP queue 1, item 5.
"""
from __future__ import annotations

import argparse
import json
import math
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch                                                        # noqa: E402

from repro_torch import SortConfig, psort, trace_collectives        # noqa: E402
from repro_torch.core import comm, external, selection              # noqa: E402
from repro_torch.core.selection import CostModel                    # noqa: E402
from repro_torch.core.types import resolve_device                   # noqa: E402
from repro_torch.data import generate_instance                      # noqa: E402

ALGOS = ("gatherm", "rfis", "rquick", "rams")
PS = (1 << 8, 1 << 12, 1 << 16)
EXPS = (-8, -5, -3, -1, 0, 1, 2, 4, 6)
EXPS_EXTRA = {1 << 8: (8, 10)}         # the dense end, where RAMS's p fits
EXPS_FAST = (-3, 0, 2)
PEAK_LIMIT = 60e9
# peak device bytes per slot of each algorithm's largest layout, rounded
# up from the peaks chip_smoke.py measured at each one's cell on an H100
# (RAMS 31.8 GB over p·p·slot_cap = 2^28.1 slots at p = 256, n = 2^26;
# RFIS 48.4 GB over p·2^⌈d/2⌉·capacity = 2^29 at p = n = 2^18; GatherM
# 1.97 GB over p·p·capacity = 2^26 at p = 2^12, n = 2^9; RQuick 21.0 GB
# over p·capacity = 2^27 at p = 2^18, n = 2^26)
BYTES_PER_SLOT = {"rams": 112, "rfis": 96, "gatherm": 32, "rquick": 160}
_FEATURES = ("p2p", "fused", "hops", "wire_words", "local_words")


def eligible(algo: str, e: int, p: int) -> bool:
    """The reference's measurement windows: each algorithm over its regime
    and a margin for locating the crossover."""
    if algo == "gatherm":
        return e <= 0
    if algo == "rfis":
        return e <= (4 if p >= 1024 else 6)
    if algo == "rams":
        return e >= 0
    return True


def _capacity(n: int, p: int) -> int:
    return max(4, int(math.ceil(-(-max(n, 1) // p) * 2.0)))


def reckon_bytes(algo: str, n: int, p: int) -> int:
    """Peak device bytes of one sim-layout sort, reckoned before it runs
    from the algorithm's largest layout: RAMS's slotted shuffle, p × p ×
    slot_cap (or its 2·capacity working shard); RFIS's gathered rows and
    columns, p · 2^⌈d/2⌉ · capacity; GatherM's doubling, p · p ·
    capacity; RQuick's shards, p · capacity."""
    cap = _capacity(n, p)
    d = p.bit_length() - 1
    if algo == "rams":
        mean = max(1.0, cap / p)
        slot_cap = int(math.ceil(2.0 * mean + 6 * math.sqrt(mean) + 6))
        slots = p * max(p * slot_cap, 2 * cap)
    elif algo == "rfis":
        slots = p * (1 << -(-d // 2)) * cap
    elif algo in ("gatherm", "allgatherm"):
        slots = p * p * cap
    else:
        slots = p * cap
    return slots * BYTES_PER_SLOT.get(algo, max(BYTES_PER_SLOT.values()))


def card_line(dev: torch.device) -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line."""
    if dev.type != "cuda":
        return f"cpu ({platform.processor() or platform.machine()})"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_seconds(fn, dev, iters: int = 5) -> float:
    fn()                                           # warm-up (and build)
    _sync(dev)
    ts = []
    for _ in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# Phase 1: microbenchmarks → the profile
# ---------------------------------------------------------------------------


def bench_ppermute(p: int, w: int, dev, chain: int = 16) -> float:
    """Seconds per point-to-point step of a w-word payload per PE at axis
    size p: the hypercube exchange (``hc_exchange``, the reference's
    ``ppermute`` with the XOR permutation), the step every hypercube
    algorithm of the port takes.  ``comm.ppermute`` with a general
    permutation rebuilds its index tables from the Python permutation at
    every call, which no algorithm does."""
    from repro_torch.core.hypercube import hc_exchange
    d = max(1, p.bit_length() - 1)
    x = torch.zeros((p, w), dtype=torch.int32, device=dev)

    def run():
        v = x
        for i in range(chain):
            v = hc_exchange(v, p, i % d) + 1      # +1: a new value a step
        return v
    return _median_seconds(run, dev) / chain


def bench_all_gather(p: int, w: int, dev, chain: int = 8) -> float:
    """Seconds per fused collective (a tiny tiled ``all_gather``) at p."""
    x = torch.zeros((p, w), dtype=torch.int32, device=dev)

    def run():
        acc = x
        for _ in range(chain):
            g = comm.all_gather(acc, tiled=True)            # (p, p·w)
            acc = g.reshape(p, p, w)[:, 0] + 1              # chained
        return acc
    return _median_seconds(run, dev) / chain


def _random_words(p: int, m: int, dev, seed: int = 0) -> torch.Tensor:
    """(p, m) random int32 words made on ``dev`` (set-up, not timed)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (p, m), generator=g,
                         dtype=torch.int64, device=dev).to(torch.int32)


def bench_local_sort_rate(p: int, dev, m: int = 1 << 14) -> float:
    """Local words/s in model units: sorting m words on each of p PEs
    costs m·lg m / local_rate, all PEs at once on the one device."""
    from repro_torch.kernels.bitonic import local_sort_fast
    keys = _random_words(p, m, dev)
    t = _median_seconds(lambda: local_sort_fast(keys), dev)
    return m * math.log2(m) / t


def bench_partition_rate(p: int, dev, m: int = 1 << 14,
                         nb: int = 64) -> float:
    """Partition words/s in model units: classify + rank + histogram of m
    sorted words into nb buckets costs m·lg(nb) / partition_rate."""
    from repro_torch.kernels.partition import partition_buckets
    keys = torch.sort(_random_words(p, m, dev), dim=1)[0]
    ties = _random_words(p, m, dev, seed=1)
    s_keys = torch.sort(_random_words(1, nb - 1, dev, seed=2), dim=1)[0]
    s_keys = s_keys.expand(p, nb - 1).contiguous()
    s_ties = torch.zeros_like(s_keys)
    count = torch.full((p,), m, dtype=torch.int64, device=dev)
    t = _median_seconds(lambda: partition_buckets(
        keys, ties, s_keys, s_ties, n_buckets=nb, count=count), dev)
    return m * math.log2(max(2, nb)) / t


def bench_io_rate(dev, m: int = 1 << 18) -> float:
    """Host↔device seconds per 32-bit word (``io_beta``): a pageable copy
    of m words to the device and back, halved."""
    x = np.zeros(m, np.int32)
    return _median_seconds(
        lambda: torch.from_numpy(x).to(dev).cpu(), dev) / (2 * m)


def _form_runs_seconds(m: int, budget: int, double_buffer: bool,
                       dev) -> float:
    r = np.random.default_rng(0)
    keys = r.integers(0, 2 ** 32, size=m, dtype=np.int64).astype(np.uint32)
    idx = np.arange(m, dtype=np.uint32)
    return _median_seconds(lambda: external.form_runs(
        keys, idx, budget=budget, double_buffer=double_buffer, device=dev),
        dev, iters=3)


def measure_overlap(dev, m: int = 1 << 16, budget: int = 1 << 13) -> float:
    """The share of run formation that the double-buffered copies hide,
    1 − t(double)/t(serial), clamped to [0, 0.99]."""
    t_serial = _form_runs_seconds(m, budget, False, dev)
    t_db = _form_runs_seconds(m, budget, True, dev)
    return float(min(0.99, max(0.0, 1.0 - t_db / max(t_serial, 1e-12))))


def overlap_pair_seconds(dev, p: int = 8, e: int = 8, algo: str = "rams",
                         iters: int = 7):
    """(barrier s, streamed s) of the same in-core psort cell."""
    n = p << e
    x = torch.from_numpy(generate_instance("Uniform", p, n, seed=11).astype(
        np.int32)).to(dev)
    cfg = SortConfig(p=p, algorithm=algo)
    t_b = _median_seconds(lambda: psort(x, cfg, device=dev), dev, iters)
    t_s = _median_seconds(lambda: psort(x, cfg.replace(overlap=True),
                                        device=dev), dev, iters)
    return t_b, t_s


def measure_profile(ps, name: str, device=None) -> CostModel:
    """The profile from the microbenchmarks (phase 1).  Where a slope or an
    intercept comes out non-positive, it is floored at a thousandth of the
    measured time it was read from, so every constant is positive."""
    dev = resolve_device(device)
    ps = sorted(int(p) for p in ps)
    pmax = ps[-1]
    w_lo, w_hi = 64, 4096
    t0 = time.perf_counter()

    def note(what, value):
        print(f"# phase 1: {what} = {value!r} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    alpha = bench_ppermute(pmax, 1, dev)
    t_lo, t_hi = bench_ppermute(pmax, w_lo, dev), bench_ppermute(pmax, w_hi,
                                                                  dev)
    beta = max((t_hi - t_lo) / (w_hi - w_lo), 1e-3 * t_hi / w_hi)
    note("ppermute s (w = 1, 64, 4096)", (alpha, t_lo, t_hi))
    hops = np.array([float(p) ** (1.0 / 3.0) for p in ps])
    t_coll = np.array([bench_all_gather(p, 1, dev) for p in ps])
    note("all_gather s", t_coll.tolist())
    floor = 1e-3 * float(t_coll.min())
    if len(ps) >= 2:
        slope, intercept = np.polyfit(hops, t_coll, 1)
        alpha_hop = max(float(slope), floor / float(hops.max()))
        alpha_c = max(float(intercept), floor)
    else:                                  # one p: the hop term is floored
        alpha_hop = floor / float(hops[0])
        alpha_c = max(float(t_coll[0]) - alpha_hop * float(hops[0]), floor)
    local_rate = bench_local_sort_rate(pmax, dev)
    partition_rate = bench_partition_rate(pmax, dev)
    io_beta = bench_io_rate(dev)
    note("local, partition words/s, io s/word",
         (local_rate, partition_rate, io_beta))
    overlap_io = measure_overlap(dev)
    t_b, t_s = overlap_pair_seconds(dev)
    note("overlap: run formation, (barrier s, streamed s)",
         (overlap_io, (t_b, t_s)))
    overlap_stream = float(min(0.99, max(0.0, 1.0 - t_s / max(t_b, 1e-12))))
    # one overlap knob discounts both the exchanges and the copies: the
    # larger of the two measured hidings, as the reference takes it
    overlap = max(overlap_io, overlap_stream)
    return CostModel(
        name=name, alpha=float(alpha), alpha_c=float(alpha_c),
        alpha_hop=float(alpha_hop), beta=float(beta),
        local_rate=float(local_rate), partition_rate=float(partition_rate),
        io_beta=float(io_beta), overlap=float(overlap),
        meta={
            "card": card_line(dev),
            "device": str(dev),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "microbench": {
                "method": "primitive microbenchmarks on the sim layout "
                          "(tools/calibrate_torch.py phase 1)",
                "p": ps, "p_payload": pmax,
                "ppermute_s": {"w1": alpha, f"w{w_lo}": t_lo,
                               f"w{w_hi}": t_hi},
                "all_gather_s": {str(p): float(t)
                                 for p, t in zip(ps, t_coll)},
                "local_sort_words_s": float(local_rate),
                "partition_words_s": float(partition_rate),
                "io_s_word": float(io_beta),
                "overlap_io_fraction": float(overlap_io),
                "overlap_stream_fraction": float(overlap_stream),
                "overlap_stream_seconds": {"barrier": t_b, "streamed": t_s},
            },
        })


def fit_profile(cells, name: str, floor: CostModel) -> CostModel:
    """Non-negative least squares of the five constants over measured
    (features, seconds) cells.  A constant the cells cannot identify (a
    zero weight) is floored at a thousandth of ``floor``'s, a measured
    profile, so that the result stays usable."""
    from scipy.optimize import nnls
    A = np.array([[c[f] for f in _FEATURES] for c in cells], float)
    t = np.array([c["seconds"] for c in cells], float)
    theta, _ = nnls(A, t)
    pred = A @ theta
    ss_res = float(np.sum((t - pred) ** 2))
    ss_tot = float(np.sum((t - t.mean()) ** 2)) or 1.0
    floors = (floor.alpha, floor.alpha_c, floor.alpha_hop, floor.beta,
              1.0 / floor.local_rate)
    alpha, alpha_c, alpha_hop, beta, inv_rate = (
        float(v) if v > 0 else 1e-3 * f for v, f in zip(theta, floors))
    return CostModel(
        name=name, alpha=alpha, alpha_c=alpha_c, alpha_hop=alpha_hop,
        beta=beta, local_rate=1.0 / inv_rate,
        meta={"fit": {"r2": 1.0 - ss_res / ss_tot,
                      "theta": [float(v) for v in theta],
                      "features": list(_FEATURES), "n_cells": len(cells)}})


# ---------------------------------------------------------------------------
# Phase 2: the sweep
# ---------------------------------------------------------------------------


def cell_features(n: int, p: int, algo: str, device=None) -> dict:
    """Counted-trace features of one cell (the port's
    ``trace_collectives``, equal to the reference's)."""
    tr = trace_collectives(n, SortConfig(p=p, algorithm=algo),
                           device=device)
    npp = n / p
    return {
        "p2p": tr.p2p_launches,
        "fused": tr.fused_launches,
        "hops": tr.fused_hops(p),
        "wire_words": tr.wire_bytes() / selection.BYTES_PER_WORD,
        "local_words": npp * math.log2(max(2, n)) + npp,
        "counts": tr.counts(),
        "wire_bytes": tr.wire_bytes(),
    }


def grid(ps, exps=None):
    """(p, e) cells of the sweep: ``exps`` for every p, or the default
    exponents plus the dense end at p = 2^8."""
    return [(p, e) for p in ps
            for e in (exps if exps is not None
                      else EXPS + EXPS_EXTRA.get(p, ()))]


def run_sweep(ps, exps, iters: int, device=None,
              peak_limit: float = PEAK_LIMIT, on_cell=None):
    """Time every eligible (p, e, algorithm) cell whose reckoned peak fits
    ``peak_limit``; ``on_cell(cells, skipped)`` is called after each.
    Returns (cells, skipped)."""
    dev = resolve_device(device)
    cells, skipped = [], []
    for p, e in grid(ps, exps):
        n = max(1, int(p * 2.0 ** e))
        x = None
        for algo in ALGOS:
            if not eligible(algo, e, p):
                continue
            need = reckon_bytes(algo, n, p)
            if need > peak_limit:
                skipped.append({"p": p, "e": e, "n": n, "algorithm": algo,
                                "reckoned_bytes": need})
                print(f"# skip p={p} 2^{e} {algo}: reckoned {need} bytes",
                      flush=True)
                continue
            if x is None:
                x = torch.from_numpy(generate_instance(
                    "Uniform", p, n, seed=11).astype(np.int32)).to(dev)
            cfg = SortConfig(p=p, algorithm=algo)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            try:
                seconds = _median_seconds(
                    lambda: psort(x, cfg, device=dev), dev, iters)
            except torch.OutOfMemoryError:
                # the reckoning was too low for this cell: list it, go on
                skipped.append({"p": p, "e": e, "n": n, "algorithm": algo,
                                "reckoned_bytes": need, "out_of_memory": True})
                print(f"# out of memory at p={p} 2^{e} {algo} (reckoned "
                      f"{need} bytes)", flush=True)
                torch.cuda.empty_cache()
                continue
            peak = torch.cuda.max_memory_allocated(dev) \
                if dev.type == "cuda" else None
            feat = cell_features(n, p, algo, dev)
            cells.append({"p": p, "e": e, "n": n, "algorithm": algo,
                          "seconds": seconds, "reckoned_bytes": need,
                          "max_memory_allocated": peak, **feat})
            print(f"calibrate/p{p}/npp2^{e}/{algo},{seconds * 1e6:.1f},"
                  f"p2p={feat['p2p']} fused={feat['fused']} "
                  f"wire={feat['wire_bytes']}B peak={peak}", flush=True)
            if on_cell is not None:
                on_cell(cells, skipped)
        del x
    return cells, skipped


def _winner_sequence(rows):
    """[(e, winner)] → [(e, previous, new)] at each change of winner."""
    out, prev = [], None
    for e, w in rows:
        if w != prev and prev is not None:
            out.append((e, prev, w))
        prev = w
    return out


def measured_crossovers(cells, p: int):
    by_e = {}
    for c in cells:
        if c["p"] == p:
            by_e.setdefault(c["e"], []).append((c["seconds"], c["algorithm"]))
    rows = [(e, min(v)[1]) for e, v in sorted(by_e.items())]
    return rows, _winner_sequence(rows)


def predicted_crossovers(p: int, exps, model: CostModel):
    rows = [(e, selection.select_algorithm(max(1, int(p * 2.0 ** e)), p,
                                           model=model))
            for e in sorted(exps)]
    return rows, _winner_sequence(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--p", type=int, nargs="+", default=list(PS),
                    help="emulated PE counts (powers of two)")
    ap.add_argument("--exps", type=int, nargs="+", default=None,
                    help="log2(n/p) grid for every p (default: the "
                         "reference's, plus 8 and 10 at p = 256)")
    ap.add_argument("--fast", action="store_true",
                    help=f"p = 256 only, grid {list(EXPS_FAST)}")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed sorts per cell, after one warm-up")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--name", default="h100-sim", help="profile name")
    ap.add_argument("--profile", required=True,
                    help="where to write the profile JSON")
    ap.add_argument("--out", default="calibrate_out/calibrate_torch.json",
                    help="where to write the sweep's cells")
    ap.add_argument("--no-sweep", action="store_true",
                    help="phase 1 only")
    ap.add_argument("--peak-limit", type=float, default=PEAK_LIMIT,
                    help="skip cells whose reckoned peak passes this")
    ap.add_argument("--nested", type=int, nargs=2, default=None,
                    metavar=("P_OUTER", "P_INNER"))
    args = ap.parse_args(argv)
    if args.nested:
        raise NotImplementedError("--nested is not ported yet: ROADMAP "
                                  "queue 1 item 5 (batched keys and nested "
                                  "meshes)")
    dev = resolve_device(args.device)
    ps = [1 << 8] if args.fast else args.p
    exps = list(EXPS_FAST) if args.fast else args.exps
    t0 = time.perf_counter()
    model = measure_profile(ps, args.name, dev)
    print(f"# profile: alpha={model.alpha!r} alpha_c={model.alpha_c!r} "
          f"alpha_hop={model.alpha_hop!r} beta={model.beta!r} "
          f"local_rate={model.local_rate!r} "
          f"partition_rate={model.partition_rate!r} "
          f"io_beta={model.io_beta!r} overlap={model.overlap!r} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    model.meta["grid"] = {"p": ps, "exps": exps if exps is not None
                          else {str(p): list(EXPS + EXPS_EXTRA.get(p, ()))
                                for p in ps},
                          "instance": "Uniform", "seed": 11,
                          "iters": args.iters, "sweep": not args.no_sweep}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    report = {"card": model.meta["card"], "profile": json.loads(
        model.to_json())}

    def write(**fields):
        # the profile and the cells so far are on disk after every step
        report.update(fields, seconds=time.perf_counter() - t0)
        out.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    model.save(args.profile)
    write()
    if not args.no_sweep:
        cells, skipped = run_sweep(
            ps, exps, args.iters, dev, args.peak_limit,
            on_cell=lambda c, k: write(cells=c, skipped=k))
        fit = fit_profile(cells, args.name, model)
        model.meta["sweep_fit"] = {**fit.meta["fit"], "alpha": fit.alpha,
                                   "alpha_c": fit.alpha_c,
                                   "alpha_hop": fit.alpha_hop,
                                   "beta": fit.beta,
                                   "local_rate": fit.local_rate}
        model.meta["skipped"] = skipped
        print(f"# sweep fit (diagnostic): R^2={fit.meta['fit']['r2']!r} "
              f"theta={fit.meta['fit']['theta']}", flush=True)
        crossings = {}
        for p in ps:
            p_exps = sorted({c["e"] for c in cells if c["p"] == p}
                            | {s["e"] for s in skipped if s["p"] == p})
            meas_rows, meas_x = measured_crossovers(cells, p)
            pred_rows, pred_x = predicted_crossovers(p, p_exps, model)
            crossings[str(p)] = {
                "measured_winners": meas_rows,
                "measured_crossovers": meas_x,
                "predicted_winners": pred_rows,
                "predicted_crossovers": pred_x}
            print(f"# p={p} measured : " + " ".join(
                f"2^{e}:{w}" for e, w in meas_rows), flush=True)
            print(f"# p={p} predicted: " + " ".join(
                f"2^{e}:{w}" for e, w in pred_rows), flush=True)
        model.save(args.profile)
        write(cells=cells, skipped=skipped, crossovers=crossings,
              profile=json.loads(model.to_json()))
    print(f"# wrote {args.profile} and {out} "
          f"({report['seconds']:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
