"""Synthetic token pipeline + length-balanced batching via the paper's
sort (counterpart of ``repro/data/pipeline.py``).

``TokenPipeline`` is a copy of the reference's (numpy): deterministic per
step (seeded by step index), so resuming from step k regenerates exactly
the batch stream from k.  ``length_balanced_batches`` sorts examples by
length with the port's ``psort`` (its local sorts and partitions on the
card's kernels), so that each batch packs similar lengths: keys massively
duplicated, the robustness case.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.types import resolve_device


class TokenPipeline:
    """Deterministic synthetic LM data (zipf-ish token stream)."""

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0,
                 family: str = "dense", d_model: int = 0,
                 n_codebooks: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.family = family
        self.d_model = d_model
        self.n_codebooks = n_codebooks

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        r = np.random.default_rng((self.seed, step))
        if self.family == "audio":
            emb = r.normal(0, 1, size=(self.batch, self.seq, self.d_model)
                           ).astype(np.float32)
            lab = r.integers(0, self.vocab,
                             size=(self.batch, self.seq, self.n_codebooks))
            return {"embeds": emb, "labels": lab.astype(np.int32)}
        # zipf-distributed tokens, shifted labels
        z = r.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def length_balanced_batches(lengths: np.ndarray, batch: int, p: int = None,
                            algorithm: str = "auto", device=None):
    """Group example ids into batches of similar length via distributed
    sort on ``device`` (the card unless ``device="cpu"``).

    Keys = lengths, payload = example id.  ``p`` defaults to the
    reference's ``min(8, devices)``: the card count on the card, 1 on the
    CPU.  Returns (batches (n//batch, batch) ids, padding_waste_ratio
    before, after)."""
    from repro_torch.core.api import SortConfig, psort

    dev = resolve_device(device)
    n = len(lengths)
    p = p or (min(8, torch.cuda.device_count()) if dev.type == "cuda"
              else 1)
    _, info = psort(lengths.astype(np.int32),
                    config=SortConfig(p=p, algorithm=algorithm),
                    return_info=True, device=dev)
    order = info["perm"].cpu().numpy().astype(np.int64)
    nb = n // batch
    batches = order[:nb * batch].reshape(nb, batch)

    def waste(idx):
        ls = lengths[idx.reshape(-1)].reshape(idx.shape)
        top = np.maximum(ls.max(axis=1, keepdims=True), 1)
        return float(np.mean(1.0 - ls / top))

    naive = np.arange(nb * batch).reshape(nb, batch)
    return batches, waste(naive), waste(batches)
