"""Aggregate the per-cell dry-run records into the roofline table
(counterpart of ``repro/launch/roofline.py``).

  PYTHONPATH=src python -m repro_torch.launch.roofline
      [--dir launch_results_torch] [--pod pod1]

Every number in it is reckoned from shapes by ``launch/dryrun.py``, not
measured.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import RESULTS_DIR

HW = ("NVIDIA H100 SXM 80 GB HBM3 at 700 W: 989 TFLOP/s dense bf16, "
      "3.35 TB/s HBM, NVLink 450 GB/s a card within a host of 8, "
      "50 GB/s a card across hosts")


def load(dir_: Path, pod: str = "pod1", variant: str = "base"):
    recs = []
    for f in sorted(dir_.glob(f"*__{pod}*.json")):
        r = json.loads(f.read_text())
        if r.get("variant", "base") != variant or r.get("rank", 0):
            continue
        recs.append(r)
    return recs


def fmt_row(r):
    if r["status"] == "skipped":
        return None
    if r["status"] != "ok":
        return f"| {r['arch']} | {r['shape']} | ERROR | | | | | |"
    t = r["roofline"]
    dom = r["dominant"].replace("_s", "")
    step = max(t.values())
    frac = t["compute_s"] / step if step else 0.0
    ratio = r.get("useful_flops_ratio")
    return (f"| {r['arch']} | {r['shape']} | {t['compute_s']:.4f} | "
            f"{t['memory_s']:.4f} | {t['collective_s']:.4f} | {dom} | "
            f"{ratio:.2f} | {frac:.1%} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(RESULTS_DIR))
    ap.add_argument("--pod", default="pod1")
    args = ap.parse_args(argv)
    recs = load(Path(args.dir), args.pod)
    chips = "single-pod 256 ranks" if args.pod == "pod1" \
        else "multi-pod 512 ranks"
    print(f"Roofline terms per (arch × shape), {chips}, one rank's step, "
          f"reckoned from shapes, not measured ({HW})\n")
    print("| arch | shape | T_comp [s] | T_mem [s] | T_coll [s] | dominant |"
          " 6ND/ops | roofline frac |")
    print("|---|---|---|---|---|---|---|---|")
    skips, errors = [], []
    for r in recs:
        row = fmt_row(r)
        if row is None:
            skips.append((r["arch"], r["shape"], r["reason"]))
        else:
            print(row)
            if r["status"] != "ok":
                errors.append((r["arch"], r["shape"], r.get("error", "")))
    if skips:
        print("\nSkipped cells:")
        for a, s, why in skips:
            print(f"  - {a} × {s}: {why}")
    if errors:
        print("\nCells that errored:")
        for a, s, why in errors:
            print(f"  - {a} × {s}: {why[:200]}")


if __name__ == "__main__":
    main()
