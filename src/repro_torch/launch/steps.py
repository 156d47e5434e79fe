"""Serve and prefill step factories (counterpart of
``repro/launch/steps.py``).  ``make_train_step`` comes with the training
slice (ROADMAP item 10b); ``input_specs``, ``cache_specs``,
``abstract_state`` and ``sharded_specs`` feed the reference's XLA
dry-run and wait with it."""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T


def make_serve_step(cfg, mesh):
    def serve_step(model, dstate, inputs):
        logits, new_state = T.decode_step(model, dstate, inputs, cfg, mesh)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, new_state

    return serve_step


def make_prefill_step(cfg, mesh):
    def prefill_step(model, inputs):
        logits, _ = T.forward(model, inputs, cfg, mesh,
                              last_only=getattr(cfg, "prefill_last_only",
                                                False))
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    return prefill_step
