"""Train a ~100M-parameter MoE transformer with the sort-based expert
dispatch, async checkpointing and crash recovery: the PyTorch port's
counterpart of ``examples/train_moe_100m.py``, on a (data 2, model 4)
mesh of eight ranks by default.

  PYTHONPATH=src torchrun --nproc-per-node=8 \\
      examples/train_moe_100m_torch.py --device cpu [--steps 200]

Every rank of the group ``torchrun`` sets up (gloo for ``--device cpu``,
NCCL on the card) trains its slices of the weights and optimizer state;
the mesh must hold every rank.
"""
import argparse
import dataclasses
import tempfile

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.dist.sharding import world_ranks
from repro_torch.launch.serve import cli_mesh
from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", default="2,4", help="data,model")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    # ~100M-param MoE: granite family scaled down (16 experts of d_ff=512,
    # d_model=512, 8 layers, 32k vocab) with EP over model axis = 4.
    cfg = dataclasses.replace(
        get_config("granite-moe-1b-a400m"), name="moe-100m",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, d_ff=512,
        vocab=32768, n_experts=16, top_k=4, remat="none")
    mesh = cli_mesh(args.mesh, args.device)
    first = not world_ranks() or dist.get_rank() == 0
    say = print if first else (lambda s: None)
    say(f"[example] {cfg.name}: {cfg.param_count()/1e6:.0f}M params "
        f"({cfg.active_param_count()/1e6:.0f}M active), sort dispatch, "
        f"mesh {args.mesh}")

    ckpt = args.ckpt_dir
    if ckpt is None:                 # one directory for every rank
        box = [tempfile.mkdtemp(prefix="moe100m_ckpt_") if first else None]
        if world_ranks():
            dist.broadcast_object_list(box, src=0)
        ckpt = box[0]
    final, losses = train(cfg, mesh, steps=args.steps, batch=8, seq=128,
                          ckpt_dir=ckpt, ckpt_every=50, logger=say,
                          device=args.device)
    say(f"[example] finished {final} steps; "
        f"loss {losses[0]:.3f} → {losses[-1]:.3f} (ckpts in {ckpt})")
    assert losses[-1] < losses[0], "loss must decrease"


if __name__ == "__main__":
    main()
