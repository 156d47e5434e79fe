"""End-to-end training loop (counterpart of ``repro/launch/train.py``).

Runs real steps on one device, the card unless the caller passes
``device="cpu"``, or SPMD on the ranks of a ``(data, model)`` mesh (and
``pod``, where the mesh has one): the deterministic data pipeline, async
checkpointing, crash recovery and the straggler watchdog around the
train step.  On a mesh every rank draws the same weights from the seed,
keeps its slices of them and of the optimizer state (as
``make_shardings`` places each leaf), passes the whole batch and
computes the loss of its rows, which ``loss_fn`` sums over the ranks
into the global loss: the one logged, the same on every rank; the
checkpoints hold the whole leaves, the reference's
layout, and a crash injected at a step fires on every rank, which all
restart from the same checkpoint.  ``--mesh d,m`` joins the process group
``torchrun`` describes (gloo for ``--device cpu``), as ``serve --mesh``
does; the mesh must hold every rank of the group.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --steps 20 --batch 8 --seq 2048 \\
      --ckpt-dir /path/to/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 10 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node=8 -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --smoke --steps 4 --batch 4 --seq 16 \\
      --mesh 2,4 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.dist.sharding import check_world
from repro_torch.launch import steps as S
from repro_torch.launch.serve import cli_mesh
from repro_torch.models import transformer as T
from repro_torch.models.convert import shard_params
from repro_torch.runtime import (CheckpointManager, StepWatchdog,
                                 run_with_restarts)


def build_everything(cfg, mesh, batch, seq, seed=0, device=None):
    """(state, step function, shardings): the model of ``cfg`` with random
    weights drawn from ``seed`` on ``device``, taking gradients, and its
    optimizer state.  On a mesh each rank keeps its slices of both, and
    the shardings (``steps.state_shardings``) say where each leaf lives;
    one device holds everything, so there are none (None)."""
    dev = resolve_device(device)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
    model = shard_params(model, cfg, mesh).requires_grad_(True)
    step_fn, opt_init = S.make_train_step(cfg, mesh)
    state = S.TrainState(model, opt_init(model), 0)
    return state, step_fn, S.state_shardings(cfg, mesh)


def train(cfg, mesh, *, steps: int, batch: int, seq: int,
          ckpt_dir=None, ckpt_every: int = 20, log_every: int = 10,
          crash_at=None, logger=print, device=None):
    """Train ``steps`` steps; with ``ckpt_dir``, checkpoint every
    ``ckpt_every`` steps and resume from the latest checkpoint after a
    crash (``crash_at``: a fault injected once, at the start of that
    step).  Returns (steps, the losses of the last attempt's steps).  On
    a mesh every rank of the process group calls it alike."""
    check_world(mesh)
    pipe = TokenPipeline(cfg.vocab, batch, seq, family=cfg.family,
                         d_model=cfg.d_model, n_codebooks=cfg.n_codebooks)
    mgr = CheckpointManager(ckpt_dir, mesh=mesh) if ckpt_dir else None
    watchdog = StepWatchdog()
    pending_fault = [crash_at]

    def run(start_step: int):
        if mgr:
            mgr.wait()          # a save still being written commits first
        state, step_fn, shards = build_everything(cfg, mesh, batch, seq,
                                                  device=device)
        if mgr and mgr.latest_step() is not None:
            state = mgr.restore(state, shardings=shards)
            logger(f"[train] restored step {int(state.step)}")
        losses = []
        for step in range(int(state.step), steps):
            if pending_fault[0] is not None and step == pending_fault[0]:
                pending_fault[0] = None      # fault fires once
                raise RuntimeError(f"injected fault at step {step}")
            watchdog.start()
            state, metrics = step_fn(state, pipe.batch_at(step))
            loss = float(metrics["loss"])
            losses.append(loss)
            slow = watchdog.stop(step)
            if slow:
                logger(f"[watchdog] straggler step {step}: "
                       f"{watchdog.times[-1]:.3f}s")
            if step % log_every == 0:
                logger(f"[train] step {step} loss {loss:.4f} "
                       f"lr {float(metrics['lr']):.2e} "
                       f"gnorm {float(metrics['grad_norm']):.3f} "
                       f"ms {1e3 * watchdog.times[-1]:.1f}")
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, state, shardings=shards)
        if mgr:
            mgr.wait()
            mgr.save(steps, state, shardings=shards)
            mgr.wait()
        return steps, losses

    if mgr:
        return run_with_restarts(lambda s: run(s), ckpt_manager=mgr,
                                 logger=logger)
    return run(0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default=None,
                    help="data,model (optional; under torchrun, every "
                         "rank of its group)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    mesh = cli_mesh(args.mesh, args.device)
    first = mesh is None or not any(mesh.get_coordinate())
    t0 = time.time()
    final, losses = train(cfg, mesh, steps=args.steps, batch=args.batch,
                          seq=args.seq, ckpt_dir=args.ckpt_dir,
                          device=args.device,
                          logger=print if first else lambda s: None)
    dt = time.time() - t0
    if first:
        print(f"[train] done: {final} steps in {dt:.1f}s; "
              f"loss {losses[0]:.3f} → {losses[-1]:.3f}")
    return final, losses


if __name__ == "__main__":
    main()
