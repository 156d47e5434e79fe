"""Train, serve and prefill step factories (counterpart of
``repro/launch/steps.py``).  ``input_specs``, ``cache_specs``,
``abstract_state`` and ``sharded_specs`` feed the reference's XLA dry-run
and wait with it.

The serve and prefill steps run on a mesh too (SPMD on its ranks, the
batch's rows over its data axes: ``models.transformer``); the train step
runs on one device (the model's): training on a mesh is ROADMAP item
10c.  It takes the reference's step: the loss and its gradients, the
optimizer's update of the weights and moments (in place), and the
metrics ``loss``, ``lr`` and ``grad_norm`` (the square root of the
float32 sum of squares over every gradient) as 0-d tensors.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.dist.sharding import data_axes_of
from repro_torch.models import transformer as T
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.optim.tree import Stacked, layers, param_tree

_MESH = ("training on a mesh (make_shardings, sharded optimizer state) is "
         "ROADMAP item 10c, not ported yet")


class TrainState(NamedTuple):
    params: Any          # the model (``T.Transformer``), trained in place
    opt: Any             # AdamWState / AdafactorState over its param_tree
    step: int


def batch_on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy) on ``device``: token ids and labels as
    int64, frame embeddings as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if not t.dtype.is_floating_point:
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def make_train_step(cfg, mesh, *, peak_lr: float = 3e-4, warmup: int = 200,
                    total: int = 10000):
    if mesh is not None:
        raise NotImplementedError(_MESH)
    opt_init, opt_update = make_optimizer(cfg.optimizer)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        model = state.params
        lr = cosine_schedule(state.step, peak_lr=peak_lr, warmup=warmup,
                             total=total)
        dev = next(model.parameters()).device
        model.zero_grad(set_to_none=True)
        loss = T.loss_fn(model, batch_on(batch, dev), cfg, mesh)
        loss.backward()
        params = param_tree(model)
        grads = {k: Stacked(t.grad for t in v) if isinstance(v, Stacked)
                 else v.grad for k, v in params.items()}
        gnorm = torch.zeros((), dtype=torch.float32, device=dev)
        for leaf in grads.values():
            for g in layers(leaf):
                gnorm = gnorm + g.float().square().sum()
        _, opt = opt_update(grads, state.opt, params, lr=lr)
        del grads
        model.zero_grad(set_to_none=True)
        return (TrainState(model, opt, state.step + 1),
                {"loss": loss.detach(), "lr": lr,
                 "grad_norm": torch.sqrt(gnorm)})

    def init(model):
        return opt_init(param_tree(model))

    return train_step, init


def make_serve_step(cfg, mesh):
    dax = data_axes_of(mesh) if mesh is not None else ("data",)

    def serve_step(model, dstate, inputs):
        logits, new_state = T.decode_step(model, dstate, inputs, cfg, mesh,
                                          dax)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, new_state

    return serve_step


def make_prefill_step(cfg, mesh):
    dax = data_axes_of(mesh) if mesh is not None else ("data",)

    def prefill_step(model, inputs):
        logits, _ = T.forward(model, inputs, cfg, mesh, dax,
                              last_only=getattr(cfg, "prefill_last_only",
                                                False))
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    return prefill_step
