"""Batched serving driver (counterpart of ``repro/launch/serve.py``):
prefill-free token generation against a KV cache / recurrent state, with
request batching and per-step latency stats.  It runs on the card unless
the caller passes ``device="cpu"``; serving on a mesh is ROADMAP item
10c.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --smoke --tokens 64 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.types import resolve_device
from repro_torch.launch import steps as S
from repro_torch.launch.sort_serve import latency_stats
from repro_torch.models import transformer as T

_MESH = ("serving on a mesh (make_shardings, shard_act, serve --mesh) is "
         "ROADMAP item 10c, not ported yet")


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
    once its tokens are on the host."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = T.init_params(cfg, gen, device=dev)
    dstate = T.init_decode_state(cfg, batch, cache_len, torch.bfloat16,
                                 device=dev)
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
    if args.mesh:
        raise NotImplementedError(_MESH)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    return serve(cfg, None, batch=args.batch, tokens=args.tokens,
                 device=args.device)


if __name__ == "__main__":
    main()
