"""Batched serving driver (counterpart of ``repro/launch/serve.py``):
prefill-free token generation against a KV cache / recurrent state, with
request batching and per-step latency stats.  It runs on the card unless
the caller passes ``device="cpu"``.

On a ``(data, model)`` mesh of the ranks of a process group, ``serve`` is
SPMD: every rank draws the same weights from the seed and keeps its
slices of them (``convert.shard_params``), holds its slice of the decode
state (its rows, and of each KV cache its heads or its slots over
``model``, ``init_decode_state(..., mesh=)``), takes the next tokens of
its rows, and gathers those int32 tokens over the data axes where the
host reads them: every rank returns the same tokens, those of one
device.  ``--mesh d,m``
joins the group ``torchrun`` describes (gloo for ``--device cpu``), as
the query-serving CLI does; ranks sharing one card are gloo ranks
spawned by the caller (``chip_smoke.py`` phase 21).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --smoke --tokens 64 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m
  PYTHONPATH=src torchrun --nproc-per-node=8 -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m --smoke --mesh 2,4 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.types import resolve_device
from repro_torch.dist.sharding import check_world, gather_rows, world_ranks
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_mesh_shape
from repro_torch.launch.sort_serve import _join_ranks, latency_stats
from repro_torch.models import transformer as T
from repro_torch.models.convert import shard_params


def next_token_input(nxt, batch: int) -> dict:
    """Normalize a sampler output to the serve step's ``(batch, 1)`` int32
    token contract.  Accepts ``(batch,)`` or ``(batch, 1)``; anything
    wider (a multi-head sampler's ``(batch, heads)``) is ambiguous and
    rejected: reduce to one token per sequence before feeding."""
    if nxt.ndim == 1:
        nxt = nxt[:, None]
    if tuple(nxt.shape) != (batch, 1):
        raise ValueError(
            f"sampler output shape {tuple(nxt.shape)} does not satisfy the "
            f"(batch={batch}, 1) next-token contract; reduce multi-head "
            "samples to one token per sequence before feeding")
    return {"tokens": nxt.to(torch.int32)}


def serve(cfg, mesh=None, *, batch: int, tokens: int, cache_len: int = 256,
          seed: int = 0, logger=print, device=None):
    """Generate ``tokens`` steps for ``batch`` sequences from random
    weights drawn with ``seed``; returns (tokens (steps·batch,) or, audio,
    (steps·batch, codebooks), latency stats).  Each step's clock stops
    once its tokens are on the host.  On a mesh every rank of the process
    group calls it alike and gets the whole tokens; the mesh must hold
    every rank of the group."""
    check_world(mesh)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = shard_params(T.init_params(cfg, gen, device=dev), cfg, mesh)
    dstate = T.init_decode_state(cfg, batch, cache_len, torch.bfloat16,
                                 device=dev, mesh=mesh)
    step = S.make_serve_step(cfg, mesh)

    r = np.random.default_rng(seed)
    if cfg.family == "audio":
        inp = {"embeds": torch.from_numpy(
            r.normal(size=(batch, 1, cfg.d_model))).to(dev, torch.bfloat16)}
    else:
        inp = {"tokens": torch.from_numpy(
            r.integers(0, cfg.vocab, size=(batch, 1))).to(dev, torch.int32)}

    lat = []
    out_tokens = []
    with torch.inference_mode():
        for _ in range(tokens):
            t0 = time.perf_counter()
            nxt, dstate = step(model, dstate, inp)
            nxt = gather_rows(nxt, mesh, batch)      # the rows' tokens
            host = nxt.cpu().numpy()                 # waits for the step
            lat.append(time.perf_counter() - t0)
            out_tokens.append(host)
            if cfg.family != "audio":
                inp = next_token_input(nxt, batch)
    # the first step is the warm-up; with <= 1 post-warmup samples the
    # stats come back None-valued with a note instead of bogus percentiles
    stats = latency_stats(lat, warmup=1, rate_scale=batch, note_ctx="step")
    stats["tok_per_s"] = stats.pop("per_s")
    if stats["p50_ms"] is None:
        logger(f"[serve] {cfg.name}: {tokens} steps, batch {batch}: "
               f"{stats['note']}")
    else:
        logger(f"[serve] {cfg.name}: {tokens} steps, batch {batch}: "
               f"p50 {stats['p50_ms']:.2f}ms p99 {stats['p99_ms']:.2f}ms "
               f"{stats['tok_per_s']:.0f} tok/s")
    return np.concatenate(out_tokens, axis=0), stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mesh", default=None, help="data,model (optional)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    return serve(cfg, cli_mesh(args.mesh, args.device), batch=args.batch,
                 tokens=args.tokens, device=args.device)


def cli_mesh(spec, device):
    """``--mesh d,m``: none, or the (data, model) mesh of the process
    group ``torchrun`` describes (joined here: gloo for ``--device cpu``,
    NCCL otherwise); ``1,1`` without a group is no mesh.  A mesh of
    another size than the group's raises."""
    if spec is None or spec.lower() == "none":
        return None
    dd, mm = (int(x) for x in spec.split(","))
    _join_ranks(device)
    if dd * mm != max(world_ranks(), 1):
        raise ValueError(f"a mesh of {dd * mm} ranks in a process group of "
                         f"{world_ranks()}")
    if not world_ranks():
        return None
    return make_mesh_shape((dd, mm), ("data", "model"))


if __name__ == "__main__":
    main()
