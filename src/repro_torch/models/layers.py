"""Shared layers (counterpart of ``repro/models/layers.py``): RMSNorm,
RoPE, MLPs, embeddings, and the random initialisation of weights.

Plain functions on tensors; a module's weights are read by name (``p.up``,
``p.gate``, …), the keys of the reference's parameter dicts.  Dtypes
follow the reference: norms in float32, activations and weights in the
model's dtype.  Weights are made without gradients (serving); training
turns them on (``model.requires_grad_(True)``)."""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# --- RoPE ------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=64)
def _freqs_on(head_dim: int, theta: float, device: torch.device
              ) -> torch.Tensor:
    """:func:`rope_freqs` on ``device``, copied there once: a copy from
    pageable host memory at every call would wait for the device."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = _freqs_on(hd, float(theta), x.device)
    ang = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- MLPs ------------------------------------------------------------------


def mlp(x: torch.Tensor, p, act: str) -> torch.Tensor:
    h = x @ p.up
    if act == "silu":                        # gated SiLU (llama family)
        h = F.silu(x @ p.gate) * h
    elif act == "relu2":                     # squared ReLU (nemotron)
        h = F.relu(h).square()
    elif act == "gelu":                      # jax.nn.gelu: the tanh form
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(act)
    return h @ p.down


# --- Embedding ---------------------------------------------------------------


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def _token_losses(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Each token's CE, z-loss included, in float32; logits (..., V)
    f32-accumulated, labels int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean next-token CE; logits (..., V) f32-accumulated, labels int."""
    return _token_losses(logits, labels, z_loss).mean()


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                      z_loss: float = 1e-4) -> torch.Tensor:
    """The sum of :func:`_token_losses` (float32): on a mesh, a rank's
    rows' share of the mean, before the division by the global count of
    tokens and the sum over the ranks' rows."""
    return _token_losses(logits, labels, z_loss).sum()


# --- Initialisation ----------------------------------------------------------


def weight(t: torch.Tensor) -> nn.Parameter:
    """A weight, made without a gradient: serving runs under
    ``torch.inference_mode()``, and training asks for gradients with
    ``requires_grad_(True)``."""
    return nn.Parameter(t, requires_grad=False)


def normal(gen: Optional[torch.Generator], shape, dtype, scale: float,
           device) -> nn.Parameter:
    """``jax.random.normal(key, shape, dtype) * scale`` drawn from
    ``gen`` on the generator's device and moved to ``device``; with no
    generator, an uninitialised tensor (weights loaded afterwards)."""
    if gen is None:
        return weight(torch.empty(shape, dtype=dtype, device=device))
    t = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return weight(t.mul_(scale).to(device))


def full(shape, value: float, device, dtype=torch.float32) -> nn.Parameter:
    return weight(torch.full(shape, value, dtype=dtype, device=device))


def init_rms(d: int, device) -> nn.Parameter:
    return full((d,), 1.0, device)


class MLP(nn.Module):
    """``up`` (d, f), ``down`` (f, d) and, gated, ``gate`` (d, f)."""

    def __init__(self, d: int, f: int, gated: bool, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        self.up = normal(gen, (d, f), dtype, s_in, device)
        self.down = normal(gen, (f, d), dtype, s_out, device)
        self.gate = normal(gen, (d, f), dtype, s_in, device) if gated \
            else None

    def forward(self, x: torch.Tensor, act: str) -> torch.Tensor:
        return mlp(x, self, act)
