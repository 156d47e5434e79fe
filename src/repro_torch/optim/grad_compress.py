"""Gradient compression (counterpart of ``repro/optim/grad_compress.py``):
an int8 quantized reduce-scatter / all-gather mean with error feedback
(1-bit-Adam-style residual correction).

A full-precision all-reduce moves 4·B bytes; the int8 reduce-scatter and
int8 all-gather move about B each way, a ~4× cut in collective bytes.
Error feedback keeps the accumulated quantization error bounded, so
SGD-style convergence is kept.

The collectives go through ``repro_torch.core.comm``, so one body runs on
both of its backends: every value is (P, …) with a row per PE, the p rows
of the sim backend or, inside ``comm.distributed``, this rank's one row.
Both give the same bits: each PE's chunks are quantized from its own row,
and the received chunks are summed in source order, one add at a time.
Rounding is half to even, as ``jnp.round``'s.

The port follows the reference's compiled body, as XLA compiles it on
the CPU: a division by a constant becomes a product with its float32
reciprocal (``/ 127.0``, ``/ p``), and a multiply is fused into the add
or subtract after it (``a - q·s`` and the running sum of ``q·s`` are
fused multiply-adds, one rounding each).  The port takes those two steps
in float64, where ``q·s`` (an int8 times a float32) is exact, and rounds
once to float32: the residual is then the fused result bit for bit, and
each partial sum is too unless the float64 sum itself had to round onto a
float32 midpoint (a tiny addend far below the running sum).  Where XLA
compiles the sum as a tree (64 sources: two windows of 32) the bits can
differ by an ulp.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import comm

_INV_127 = float(np.float32(1.0 / 127.0))


def init_error_feedback(grads):
    """Zero residuals, float32, of each gradient's shape (a dict of
    tensors, or one tensor)."""
    if isinstance(grads, dict):
        return {k: init_error_feedback(g) for k, g in grads.items()}
    return torch.zeros(grads.shape, dtype=torch.float32, device=grads.device)


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each PE's row of ``x`` (P, …) as int8 with one float32 scale:
    (q, scale (P,))."""
    scale = x.abs().amax(dim=tuple(range(1, x.ndim))) * _INV_127 + 1e-12
    q = torch.clamp(torch.round(x / scale.reshape((-1,) + (1,) * (
        x.ndim - 1))), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_mean(g: torch.Tensor, err: torch.Tensor, axis_name: str,
                         p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-all-reduce one gradient leaf with an int8 wire format.

    ``g`` and ``err`` are (P, …): a row per PE of the open scope, whose
    sort axis (p PEs) is the reference's ``axis_name``.  Returns
    (mean_grad, new_err), each (P, …)."""
    P, shape = g.shape[0], tuple(g.shape[1:])
    flat = g.float().reshape(P, -1) + err.reshape(P, -1)
    n = flat.shape[1]
    pad = (-n) % p
    if pad:
        flat = torch.cat([flat, flat.new_zeros((P, pad))], dim=1)
    chunks = flat.reshape(P, p, -1)

    q, scale = _quant(chunks)
    err_new = (flat.double() - (q.double() * scale.double()[:, None, None])
               .reshape(P, -1)).float()[:, :n]
    # reduce-scatter: all-to-all the int8 chunks (+ per-source scales),
    # summed here in source order
    qs = comm.all_to_all(q.reshape(P, -1)).reshape(P, p, -1)
    scales = comm.all_gather(scale).double()                # (P, p)
    mine = (qs[:, 0].double() * scales[:, :1]).float()
    for j in range(1, p):
        mine = (mine.double() + qs[:, j].double() * scales[:, j:j + 1]
                ).float()
    mine = mine * float(np.float32(1.0 / p))
    # all-gather the reduced shard, again int8 on the wire
    q2, scale2 = _quant(mine)
    allq = comm.all_gather(q2, tiled=True)                  # (P, n + pad)
    alls = comm.all_gather(scale2)                          # (P, p)
    out = (allq.float().reshape(P, p, -1) * alls[:, :, None]).reshape(
        P, -1)[:, :n]
    return out.reshape((P,) + shape), err_new.reshape((P,) + shape)


def compressed_psum(grads, err_state, axis_name: str, p: int):
    """Tree-mapped compressed mean-all-reduce over a dict of (P, …)
    gradients: (mean grads, new residuals), dicts of the same keys."""
    outs = {k: compressed_psum_mean(g, err_state[k], axis_name, p)
            for k, g in grads.items()}
    return ({k: o[0] for k, o in outs.items()},
            {k: o[1] for k, o in outs.items()})
