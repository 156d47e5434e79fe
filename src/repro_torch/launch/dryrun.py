"""The dry-run: one rank's step of every (architecture × input shape) on
the production meshes, reckoned from shapes alone, and its roofline
(counterpart of ``repro/launch/dryrun.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out-dir ...]

A cell builds the production mesh as one rank's layout
(``make_production_mesh(rank=...)``, rank 0 unless ``--rank``), the
model and optimizer state of the config on the ``meta`` device cut to
that rank's slices (``steps.abstract_state``, ``convert.shard_params``,
``sharded_specs``), the step's inputs (``input_specs``; decode:
``cache_specs``, the reference's placement of the decode state: a rank's
rows, and of each KV cache its heads, else its slots, over ``model``,
of rwkv6's and mamba2's recurrent states every head's slice of hd_k or
P, else their heads; the record's ``cache_layout`` and
``state_layout`` say which), and runs one
train, prefill or decode step of the port (``make_train_step``,
``make_prefill_step``, ``make_serve_step``) on them under ``op_cost``,
with the dry transport (``core.comm.dry``):
every collective a rank would launch is counted and moves nothing.  The
dry-run allocates nothing on any device, by design, as the reference's
compiles for emulated devices; ``chip_smoke.py`` phase 23 holds it to
measured steps on the card.  One JSON record per cell goes to
``launch_results_torch/``; ``--all`` runs each cell in a subprocess of
its own, so one cell's failure or memory cannot take down the sweep.

Roofline terms, per rank, on the NVIDIA H100 SXM 80 GB HBM3 at its
700 W power limit (the data sheet's peaks): compute = flops / 989 TFLOP/s
(dense bf16), memory = ``bytes_min`` / 3.35 TB/s, collective = each mesh
axis's wire bytes over that axis's link.  Ranks map to hosts row-major,
8 cards a host (a DGX H100): an axis whose ranks lie within one host
uses NVLink, 450 GB/s each way a card; an axis that spans hosts uses the
host network, one 400 Gb/s NIC a card, 50 GB/s.  On (data 16, model 16)
both axes span hosts: ``model``'s 16 ranks lie on two hosts, ``data``'s
on sixteen.

A rank holds what the reference's program holds there of the logits,
the loss and the decode state: the logits and the token losses of its
rows, the cache split over ``model``.  It splits the products of the
attention, the dense MLP and the head over ``model`` as GSPMD does, with
the weights where ``make_shardings`` puts them, and sums the partial
products over ``model``.  The MoE layer takes a rank's rows with its
experts where the reference's layouts hold them (the expert-parallel
dispatch the rank's experts, re-cut from where ``make_shardings`` puts
them; ``moe_local`` the slices in place).  rwkv6's and mamba2's blocks
run on a rank's block of heads with its slices of their weights, their
decode steps on the rank's slice of the recurrent state
(``models.ssm``).  ``useful_flops_ratio`` shows the redundancy that
remains (the norms, the sequence-parallel carry: ROADMAP queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config, list_archs, \
    shape_applicable
from repro_torch.core import comm
from repro_torch.dist.sharding import cache_split_dim, mesh_coord, \
    mesh_sizes
from repro_torch.launch import op_cost
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.convert import shard_params
from repro_torch.optim import tree as tr

RESULTS_DIR = Path(__file__).resolve().parents[3] / "launch_results_torch"

# NVIDIA H100 SXM 80 GB HBM3 at its 700 W power limit, per card (data sheet)
HW = "NVIDIA H100 SXM 80 GB HBM3, 700 W"
PEAK_FLOPS = 989e12            # dense bf16, tensor cores
HBM_BW = 3.35e12               # bytes/s
NVLINK_BW = 450e9              # bytes/s each way a card, within a host
NET_BW = 50e9                  # bytes/s a card across hosts: one 400 Gb/s NIC
CARDS_PER_HOST = 8


def apply_variant(cfg, variant: str):
    """The reference's perf variants (hill-climbing knobs), over the base
    config."""
    mods = {
        "banded_swa": dict(swa_banded=True),
        "remat_dots": dict(remat="dots"),
        "remat_none": dict(remat="none"),
        "moe_dense": dict(moe_impl="dense"),
        "moe_sort": dict(moe_impl="sort"),
        "moe_tp_fused": dict(moe_tp_fused=True),
        "prefill_last": dict(prefill_last_only=True),
        "moe_tp_fused_remat_dots": dict(moe_tp_fused=True, remat="dots"),
        "prefill_last_banded": dict(prefill_last_only=True, swa_banded=True),
        "seq_parallel": dict(act_seq_shard=True),
        "seq_parallel_tp_moe": dict(act_seq_shard=True, moe_tp_fused=True),
        "context_parallel": dict(attn_context_parallel=True),
        "ddp": dict(ddp=True),
        "ddp_dots": dict(ddp=True, remat="dots"),
        "cp_last": dict(attn_context_parallel=True, prefill_last_only=True),
    }[variant]
    return dataclasses.replace(cfg, **mods)


def _model_flops(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode: D = new tokens only."""
    n = cfg.active_param_count()
    if shape.kind == "decode":
        tokens = shape.global_batch          # one token per sequence
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n * tokens)


def axis_links(mesh) -> dict:
    """Each mesh axis's link for this rank: ``"nvlink"`` where the ranks
    along it lie on one host (ranks row-major, CARDS_PER_HOST a host),
    else ``"network"``."""
    if mesh is None:
        return {}
    grid = np.asarray(mesh.mesh)
    coord = mesh_coord(mesh)
    out = {}
    for k, name in enumerate(mesh.mesh_dim_names):
        at = [coord[a] for a in mesh.mesh_dim_names]
        at[k] = slice(None)
        hosts = {int(r) // CARDS_PER_HOST for r in grid[tuple(at)].reshape(-1)}
        out[name] = "nvlink" if len(hosts) == 1 else "network"
    return out


def roofline(cost: dict, mesh) -> tuple:
    """(terms in seconds, the dominant term) of a counted step."""
    links = axis_links(mesh)
    coll = sum(b / (NVLINK_BW if links.get(a) == "nvlink" else NET_BW)
               for a, b in cost["collective_bytes_by_axis"].items())
    terms = {"compute_s": cost["flops"] / PEAK_FLOPS,
             "memory_s": cost["bytes_min"] / HBM_BW,
             "collective_s": coll}
    return terms, max(terms, key=terms.get)


def _tensor_bytes(tree) -> int:
    """The bytes of the storages a module's weights, or a tree's tensors,
    hold (each storage once)."""
    leaves = list(tree.parameters()) if hasattr(tree, "parameters") \
        else tr.leaves(tree)
    seen = {}
    for leaf in leaves:
        for t in tr.layers(leaf):
            if hasattr(t, "untyped_storage"):
                st = t.untyped_storage()
                seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def reckon(cfg, shape, mesh, cache_dtype=torch.bfloat16) -> dict:
    """One rank's step of ``cfg`` on ``shape`` (a ``ShapeConfig``) on
    ``mesh`` (a ``MeshLayout``, or None for one device), on meta under
    ``op_cost`` with the dry transport: the counts, the roofline, the
    memory, and the 6·N·D yardstick.  A decode's caches are of
    ``cache_dtype`` (the reference's bf16 unless given)."""
    inputs, _ = S.input_specs(cfg, shape, mesh)
    with comm.dry():
        if shape.kind == "train":
            (model, opt), (_, os_) = S.abstract_state(cfg, mesh)
            model = shard_params(model, cfg, mesh).requires_grad_(True)
            opt = S.sharded_specs(opt, os_)
            state = S.TrainState(model, opt, 0)
            step_fn, _ = S.make_train_step(cfg, mesh)
            resident = {"weights": _tensor_bytes(model),
                        "opt": _tensor_bytes(opt)}
            cost = op_cost.analyze(step_fn, state, inputs)
        else:
            model, _ = S.abstract_state(cfg, mesh, with_opt=False)
            model = shard_params(model, cfg, mesh)
            resident = {"weights": _tensor_bytes(model)}
            if shape.kind == "prefill":
                step_fn = S.make_prefill_step(cfg, mesh)
                args = (model, inputs)
            else:
                cache, csh = S.cache_specs(cfg, shape, mesh, cache_dtype)
                cache = S.sharded_specs(cache, csh)
                resident["cache"] = _tensor_bytes(cache)
                step_fn = S.make_serve_step(cfg, mesh)
                args = (model, cache, inputs)
            with torch.no_grad():
                cost = op_cost.analyze(step_fn, *args)
    terms, dominant = roofline(cost, mesh)
    n_chips = math.prod(mesh_sizes(mesh).values()) if mesh is not None \
        else 1
    model_flops = _model_flops(cfg, shape)
    flops = cost["flops"]
    return dict(
        memory={"argument_size_in_bytes": sum(resident.values())
                + _tensor_bytes(inputs),
                "output_size_in_bytes": cost["output_bytes"],
                "temp_size_in_bytes": cost["temp_bytes"]},
        resident_bytes=resident,
        flops_per_device=flops,
        dot_flops_per_device=cost["dot_flops"],
        bytes_per_device=cost["bytes_min"],
        bytes_min_by_operator=cost["bytes_min_by_op"],
        bytes_upper_per_device=cost["bytes"],
        unknown_trip_counts=cost["unknown_trip_counts"],
        collective_bytes_per_device=cost["collective_bytes"],
        collective_counts=cost["collective_counts"],
        collective_bytes_by_axis=cost["collective_bytes_by_axis"],
        links=axis_links(mesh),
        sent_bytes_per_device=cost["sent_bytes"],
        received_bytes_per_device=cost["received_bytes"],
        operators=cost["ops"],
        roofline=terms, dominant=dominant,
        model_flops_global=model_flops,
        useful_flops_ratio=(model_flops / (flops * n_chips)
                            if flops else None),
        n_chips=n_chips,
    )


_LAYOUTS = {1: "length", 2: "heads"}     # a KV cache's split dimension
_STATE_LAYOUTS = {1: "heads", 2: "head_dim"}   # a wkv's or an ssm's


def cache_layout(cfg, shape, mesh) -> str:
    """How a rank holds the KV caches of a decode on ``mesh``: split on
    their ``"heads"`` or their ``"length"`` over ``model``, or its
    ``"rows"`` whole; rwkv6, which has none, its recurrent state's
    (:func:`state_layout`)."""
    state, _ = S.cache_specs(cfg, shape, mesh)
    if cfg.family == "ssm":
        return state_layout(cfg, shape, mesh)
    caches = [c for g in (state.caches, state.shared_caches or ())
              for c in g if getattr(c, "split", None) is not None]
    return _LAYOUTS[caches[0].split] if caches else "rows"


def state_layout(cfg, shape, mesh) -> str:
    """How a rank holds rwkv6's ``wkv`` or mamba2's ``ssm`` in a decode
    on ``mesh``: every head's slice of hd_k or P (``"head_dim"``), its
    ``"heads"``, or its ``"rows"`` whole."""
    state, _ = S.cache_specs(cfg, shape, mesh)
    dim = cache_split_dim(state.caches[0][0].shape, mesh)
    return _STATE_LAYOUTS.get(dim, "rows")


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             variant: str = "base", rank: int = 0):

    cfg = get_config(arch)
    if variant != "base":
        cfg = apply_variant(cfg, variant)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "multi_pod": multi_pod, "rank": rank,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    if not ok:
        rec.update(status="skipped", reason=why)
        return _dump(rec, out_dir)
    mesh = make_production_mesh(multi_pod=multi_pod, rank=rank)
    rec["mesh"] = mesh_sizes(mesh)
    if shape.kind == "decode":
        rec["cache_layout"] = cache_layout(cfg, shape, mesh)
        if cfg.family in ("ssm", "hybrid"):
            rec["state_layout"] = state_layout(cfg, shape, mesh)
    t0 = time.time()
    try:
        rec.update(reckon(cfg, shape, mesh))
        rec.update(status="ok", trace_s=round(time.time() - t0, 1), hw=HW)
    except Exception as e:  # noqa: BLE001 — record the failure, keep the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000])
    return _dump(rec, out_dir)


def _dump(rec, out_dir: Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "pod2" if rec["multi_pod"] else "pod1"
    name = f"{rec['arch']}__{rec['shape']}__{tag}"
    if rec.get("variant", "base") != "base":
        name += f"__{rec['variant']}"
    if rec.get("rank", 0):
        name += f"__rank{rec['rank']}"
    path = out_dir / f"{name}.json"
    path.write_text(json.dumps(rec, indent=1))
    extra = rec.get("dominant", rec.get("reason", rec.get("error", "")))
    print(f"[dryrun] {name}: {rec['status']} ({str(extra)[:120]})",
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose step is reckoned (default 0)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)

    if args.all:
        cells = [(a, s, mp) for a in list_archs() for s in SHAPES
                 for mp in ((False, True) if args.both_meshes
                            else (args.multi_pod,))]
        failures = 0
        for arch, shp, mp in cells:
            tag = "pod2" if mp else "pod1"
            suffix = "" if args.variant == "base" else f"__{args.variant}"
            if args.rank:
                suffix += f"__rank{args.rank}"
            fname = out_dir / f"{arch}__{shp}__{tag}{suffix}.json"
            if args.skip_existing and fname.exists() and \
                    json.loads(fname.read_text()).get("status") in (
                        "ok", "skipped"):
                print(f"[dryrun] skip existing {fname.name}", flush=True)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shp, "--out-dir", str(out_dir),
                   "--variant", args.variant, "--rank", str(args.rank)]
            if mp:
                cmd.append("--multi-pod")
            r = subprocess.run(cmd, check=False)
            failures += r.returncode != 0
        sys.exit(1 if failures else 0)

    rec = run_cell(args.arch, args.shape, args.multi_pod, out_dir,
                   args.variant, args.rank)
    if rec["status"] == "error":
        print(rec["error"], file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
