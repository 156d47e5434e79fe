"""Shared layers (counterpart of ``repro/models/layers.py``): RMSNorm,
RoPE, MLPs, embeddings, and the random initialisation of weights.

Plain functions on tensors; a module's weights are read by name (``p.up``,
``p.gate``, …), the keys of the reference's parameter dicts.  Dtypes
follow the reference: norms in float32, activations and weights in the
model's dtype.  Weights are made without gradients (serving); training
turns them on (``model.requires_grad_(True)``).

On a mesh a part whose weights stay where ``make_shardings`` puts them
carries a :class:`Split` (``p.tp``): each rank multiplies with its slice
of each weight (:func:`tp_project`, :func:`tp_matmul`) and the partial
products are summed over ``model``.  The dense MLP (and rwkv6's channel
mix) takes the rank's columns of ``up``/``gate`` and its rows of
``down`` and sums once; :func:`rms_norm_split` normalises a rank's block
of a dimension over the whole of it; :func:`cross_entropy_sum` takes a
rank's slice of the vocabulary."""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor, sp: "Split",
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` over the whole last dimension, of which ``x`` and
    ``scale`` are this rank's block (cut into ``sp.m``): the sums of
    squares of the blocks added up over ``model`` in rank order, in
    float32 (``sum_partials``).  Each rank's sum is a partial of the
    whole, so the backward hands each the whole gradient of the sum, as
    the shares of it every rank holds add up to."""
    from repro_torch.dist.sharding import sum_partials
    xf = x.float()
    var = sum_partials(xf.square().sum(dim=-1, keepdim=True), sp.mesh) \
        / (x.shape[-1] * sp.m)
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


# --- Tensor parallelism ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Split:
    """How a part's weights lie over ``model`` on a mesh: its size ``m``,
    this rank's index ``r`` along it, and for each weight split there the
    dimension of the layer's weight that ``make_shardings`` splits
    (``dims``; a weight not in it is whole on every rank).  ``take``,
    where a layer needs its weights split otherwise than they lie (the
    MoE experts), gives this rank's slices split as asked: ``take({name:
    dim})`` → ``{name: slice}``, a dimension of None for the whole
    weight."""
    mesh: object
    m: int
    r: int
    dims: Dict[str, int]
    take: Optional[Callable[[Dict[str, Optional[int]]],
                            Dict[str, torch.Tensor]]] = None

    def block(self, n: int) -> slice:
        """This rank's block of a dimension of ``n`` cut into ``m``."""
        return slice(self.r * (n // self.m), (self.r + 1) * (n // self.m))


def tp_reduce(ys: Sequence[torch.Tensor], sp: Split, split: bool
              ) -> List[torch.Tensor]:
    """The partial products ``ys`` (…, N_i) of the ranks along ``model``
    added up in rank order: with ``split`` this rank's block of each
    one's last dimension (cut into ``m``), all of them in one
    reduce-scatter (each one's blocks for rank j side by side), else each
    one whole, all of them in one all-reduce (of ``ys[0]``'s dtype)."""
    from repro_torch.dist.sharding import scatter_partials, sum_partials
    if not ys:
        return []
    if split:
        parts = [y.unflatten(-1, (sp.m, y.shape[-1] // sp.m)) for y in ys]
        got = scatter_partials(torch.cat(parts, -1).flatten(-2), sp.mesh)
        return list(got.split([p.shape[-1] for p in parts], -1))
    got = sum_partials(torch.cat([y.to(ys[0].dtype) for y in ys], -1),
                       sp.mesh)
    return list(got.split([y.shape[-1] for y in ys], -1))


def tp_project(x: torch.Tensor, sp: Split,
               specs: Sequence[Tuple[str, torch.Tensor, bool]]
               ) -> List[torch.Tensor]:
    """``x @ w`` for each ``(name, w, split)`` of ``specs``, ``x`` the
    same on every rank along ``model`` and ``w`` this rank's slice of the
    weight ``name``: with ``split`` this rank's block of the product's
    columns (cut into ``m``), else the whole product.  A weight split on
    its columns gives its block with no transfer; one split on its rows
    multiplies the rank's slice of ``x`` and the partial products are
    reduce-scattered onto the blocks, or summed, over ``model``, the
    products of one kind in one collective (:func:`tp_reduce`); a whole
    weight multiplies its block of columns.  Columns split for the whole
    product are gathered.  A stack of weights (…, K, N) multiplies a
    stack of activations batched (the MoE experts' buffers), ``name``'s
    dimension then that of one matrix of the stack."""
    from repro_torch.dist.sharding import gather_blocks
    out: List[Optional[torch.Tensor]] = [None] * len(specs)
    pending = {True: [], False: []}
    for i, (name, w, split) in enumerate(specs):
        dim = sp.dims.get(name)
        if dim == 1:
            y = x @ w
            out[i] = y if split else gather_blocks(y, sp.mesh, ("model",),
                                                   dim=y.ndim - 1)
        elif dim == 0:
            pending[split].append((i, x[..., sp.block(x.shape[-1])] @ w))
        else:
            out[i] = x @ (w[..., sp.block(w.shape[-1])] if split else w)
    for split, done in pending.items():
        for (i, _), y in zip(done, tp_reduce([y for _, y in done], sp,
                                             split)):
            out[i] = y
    return out


def tp_matmul(x: torch.Tensor, name: str, w: torch.Tensor, sp: Split,
              x_split: bool) -> torch.Tensor:
    """The whole ``x @ w``, the same on every rank along ``model``, for
    this rank's slice ``w`` of the weight ``name`` and ``x`` whole
    (``x_split`` False) or this rank's block of its last dimension (cut
    into ``m``).  A weight split on its rows multiplies the rank's block
    of ``x`` and the partial products are summed over ``model``; one
    split on its columns needs ``x`` whole (its blocks gathered) and its
    product's columns gathered; a whole weight takes the rows of the
    rank's block of ``x``."""
    from repro_torch.dist.sharding import gather_blocks, sum_partials
    dim = sp.dims.get(name)
    if dim == 1:
        if x_split:
            x = gather_blocks(x, sp.mesh, ("model",), dim=x.ndim - 1)
        y = x @ w
        return gather_blocks(y, sp.mesh, ("model",), dim=y.ndim - 1)
    if dim == 0:
        y = (x if x_split else x[..., sp.block(x.shape[-1])]) @ w
    elif x_split:
        y = x @ w[..., sp.block(w.shape[-2]), :]
    else:
        return x @ w
    return sum_partials(y, sp.mesh)


# --- MLPs ------------------------------------------------------------------


def _act(h: torch.Tensor, g: Optional[torch.Tensor], act: str
         ) -> torch.Tensor:
    if act == "silu":                        # gated SiLU (llama family)
        return F.silu(g) * h
    if act == "relu2":                       # squared ReLU (nemotron)
        return F.relu(h).square()
    if act == "gelu":                        # jax.nn.gelu: the tanh form
        return F.gelu(h, approximate="tanh")
    raise ValueError(act)


def mlp(x: torch.Tensor, p, act: str, up: str = "up", gate: str = "gate",
        down: str = "down") -> torch.Tensor:
    """The MLP of ``p``'s weights named ``up``, ``gate`` (gated SiLU
    only) and ``down``; with ``p.tp`` on the rank's columns of
    ``up``/``gate`` (the hidden width cut into ``model`` where it
    divides, else whole) and its rows of ``down``, the partial products
    summed once over ``model``."""
    w_up, w_down = getattr(p, up), getattr(p, down)
    w_gate = getattr(p, gate) if act == "silu" else None
    sp = getattr(p, "tp", None)
    if sp is None:
        return _act(x @ w_up, None if w_gate is None else x @ w_gate,
                    act) @ w_down
    hidden = w_up.shape[1] * (sp.m if sp.dims.get(up) == 1 else 1)
    split = hidden % sp.m == 0
    specs = [(up, w_up, split)] + ([] if w_gate is None else
                                   [(gate, w_gate, split)])
    hs = tp_project(x, sp, specs)
    return tp_matmul(_act(hs[0], hs[-1] if w_gate is not None else None,
                          act), down, w_down, sp, split)


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


def _vocab_token_losses(logits: torch.Tensor, labels: torch.Tensor,
                        lo: int, mesh, z_loss: float) -> torch.Tensor:
    """:func:`_token_losses` of ``logits``, this rank's vocabulary
    ``[lo, lo + logits.shape[-1])`` of the ranks along ``model``: the
    largest logit taken over ``model``, the sum of the exponentials and
    each label's logit (from the rank that holds it) summed over
    ``model`` in float32; every rank gets the same losses."""
    from repro_torch.dist.sharding import max_over, sum_partials
    lf = logits.float()
    top = max_over(lf.amax(dim=-1), mesh)
    exps = torch.exp(lf - top[..., None]).sum(dim=-1)
    at = labels.long() - lo
    mine = (at >= 0) & (at < lf.shape[-1])
    ll = torch.gather(lf, -1, at.clamp(0, lf.shape[-1] - 1)[..., None])
    ll = torch.where(mine, ll[..., 0], 0.0)
    both = sum_partials(torch.stack([exps, ll], dim=-1), mesh)
    lse = top + torch.log(both[..., 0])
    loss = lse - both[..., 1]
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                      z_loss: float = 1e-4, *, mesh=None,
                      vocab_lo: Optional[int] = None) -> torch.Tensor:
    """The sum of :func:`_token_losses` (float32): on a mesh, a rank's
    rows' share of the mean, before the division by the global count of
    tokens and the sum over the ranks' rows.  With ``vocab_lo`` the
    logits are this rank's slice of the vocabulary from ``vocab_lo`` on,
    the ranks along ``model`` holding the others: the losses are
    reckoned over every slice without putting the vocabulary together."""
    if vocab_lo is None:
        return _token_losses(logits, labels, z_loss).sum()
    return _vocab_token_losses(logits, labels, vocab_lo, mesh,
                               z_loss).sum()


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
