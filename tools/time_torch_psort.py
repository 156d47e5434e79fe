#!/usr/bin/env python3
"""Wall time of ``repro_torch.psort`` on the GPU, for one tree of the port.

    python3 tools/time_torch_psort.py [--src src] [--label name]
        [--p 256] [--algorithm rams] [--instances Uniform,Zero,AllToOne]
        [--reps 3] [--external-p 0] [--external-instances Uniform,Zero]

Imports ``repro_torch`` from ``--src`` (default: this repository's
``src``), so that two trees -- for example a ``git archive`` of the parent
commit and this one -- can be timed in turns on one card in one call.
After one warm-up sort it times ``--reps`` sorts of each instance with the
host clock around work that ends in ``torch.cuda.synchronize()``, and
prints one JSON line per sort: wall seconds, kernel launches and, for the
external lane, the host-clock seconds of passes A-D.  The cells are those
of ``chip_smoke.py``: RAMS (or ``--algorithm``) at (``--p``, 2^26) on
``--instances`` (``--p 0`` skips it), and the external lane at (``--external-p``,
2^28) with budget 2^21 (``--external-p 0``, the default, skips it).  The
first line is the card's name and power limit (nvidia-smi).  It needs a
CUDA device and fails without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

LOG_N = 26
INSTANCES = "Uniform,Zero,AllToOne"
EXTERNAL_LOG_N = 28
BUDGET = 1 << 21


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--p", type=int, default=256)
    ap.add_argument("--algorithm", default="rams")
    ap.add_argument("--instances", default=INSTANCES)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--external-p", type=int, default=0)
    ap.add_argument("--external-instances", default="Uniform,Zero")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_torch_psort: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"time_torch_psort: no repro_torch under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch import ExternalPolicy, SortConfig, psort
    from repro_torch.data import generate_instance
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    label = args.label or str(src)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "tree": label}), flush=True)
    _build.build_all()

    def run(cell, cfg, p, log_n, names, warm):
        n = 1 << log_n
        psort(warm, cfg)
        torch.cuda.synchronize()
        for name in names.split(","):
            x = generate_instance(name, p, n).astype(np.uint32)
            for rep in range(args.reps):
                torch.cuda.empty_cache()
                reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, info = psort(x, cfg, return_info=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                row = {"tree": label, "cell": cell, "instance": name,
                       "p": p, "n": n, "rep": rep, "wall_s": wall,
                       "overflow": info["overflow"],
                       "launches": launch_counts()}
                if "pass_seconds" in info:
                    row["pass_seconds"] = info["pass_seconds"]
                print(json.dumps(row), flush=True)
                del info

    if args.p:
        run(args.algorithm, SortConfig(p=args.p, algorithm=args.algorithm),
            args.p, LOG_N, args.instances,
            generate_instance("Uniform", args.p, 1 << LOG_N).astype(
                np.uint32))
    if args.external_p:
        p = args.external_p
        cfg = SortConfig(p=p, external=ExternalPolicy(budget=BUDGET))
        warm = generate_instance("Uniform", p, BUDGET * p * 2).astype(
            np.uint32)
        run("external", cfg, p, EXTERNAL_LOG_N, args.external_instances,
            warm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
