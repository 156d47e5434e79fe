"""Serve a small model with batched requests: the PyTorch port's
counterpart of ``examples/serve_llm.py`` (the rwkv6 family's reduced
config decoding 64 tokens for a batch of 8 requests, reporting p50/p99
latency and throughput), on a (data 2, model 4) mesh of eight ranks by
default.

  PYTHONPATH=src torchrun --nproc-per-node=8 \\
      examples/serve_llm_torch.py --device cpu [--arch rwkv6-1.6b]

Every rank of the group ``torchrun`` sets up (gloo for ``--device cpu``,
NCCL on the card) holds its slices of the weights and gets every token;
the mesh must hold every rank.
"""
import argparse

import torch.distributed as dist

from repro_torch.configs import get_config, smoke_variant
from repro_torch.dist.sharding import world_ranks
from repro_torch.launch.serve import cli_mesh, serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="2,4", help="data,model")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    cfg = smoke_variant(get_config(args.arch))
    mesh = cli_mesh(args.mesh, args.device)
    first = not world_ranks() or dist.get_rank() == 0
    toks, stats = serve(cfg, mesh, batch=args.batch, tokens=args.tokens,
                        device=args.device,
                        logger=print if first else (lambda s: None))
    if first:
        print(f"[example] generated {toks.shape} tokens; stats: {stats}")


if __name__ == "__main__":
    main()
