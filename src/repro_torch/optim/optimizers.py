"""Optimizers (counterpart of ``repro/optim/optimizers.py``): AdamW and
Adafactor (factored second moment for the 100B+ dense models), with the
reference's arithmetic in float32.

A tree of parameters, gradients or moments is a dict of leaves
(``tree.param_tree`` of a model, or any dict of tensors): a tensor, or a
:class:`~repro_torch.optim.tree.Stacked` of the L layers of one of the
reference's (L, …) leaves.  The update writes the parameters and the
moments in place and returns them with the new step count, so no second
copy of the state exists at any time.  AdamW is elementwise, so a stacked
leaf updates layer by layer; Adafactor factors and clips each leaf of the
reference whole, so its row and column statistics of a stacked leaf are
kept stacked (they are small), and the update's RMS is taken over all its
layers in two passes, one layer's float32 temporaries at a time.

On a mesh the trees hold each rank's slices.  AdamW is elementwise, so it
updates the slices as they are.  Adafactor's row and column means and
its clip span whole leaves: the update takes ``whole(key, (grad, vr, vc,
weight))``, a context that gives the leaf's parts whole and writes the
rank's slices back when it closes (``launch.steps``), and updates one
whole leaf at a time.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch

from .tree import Stacked, layers


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    step: int


def _zeros(t: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(tuple(t.shape) if shape is None else shape,
                       dtype=torch.float32, device=t.device)


def _like(leaf, fn):
    if isinstance(leaf, Stacked):
        return Stacked(fn(t) for t in leaf)
    return fn(leaf)


def adamw_init(params) -> AdamWState:
    return AdamWState(mu={k: _like(v, _zeros) for k, v in params.items()},
                      nu={k: _like(v, _zeros) for k, v in params.items()},
                      step=0)


def _scalar(x: float, params) -> torch.Tensor:
    """``x`` as a float32 0-d tensor on the weights' device (the card
    divides by a host scalar through its reciprocal, which rounds apart)."""
    device = layers(next(iter(params.values())))[0].device
    return torch.tensor(x, dtype=torch.float32, device=device)


def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, whole=None):
    step = state.step + 1
    lr = float(lr)
    sf = _scalar(float(step), params)
    c1 = 1.0 - _scalar(b1, params) ** sf
    c2 = 1.0 - _scalar(b2, params) ** sf
    for key, leaf in params.items():
        for g, m, v, p in zip(layers(grads[key]), layers(state.mu[key]),
                              layers(state.nu[key]), layers(leaf)):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            pf = p.detach().float()
            u += weight_decay * pf
            with torch.no_grad():
                p.copy_(pf - lr * u)
    return params, AdamWState(state.mu, state.nu, step)


class AdafactorState(NamedTuple):
    vr: Any              # row statistics (or full v for <2D params)
    vc: Any              # col statistics
    step: int


def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor_init(params) -> AdafactorState:
    def vr(p):
        shape = tuple(p.shape)
        return _zeros(layers(p)[0], shape[:-1] if _factored(p) else shape)

    def vc(p):
        shape = tuple(p.shape)
        return _zeros(layers(p)[0], shape[:-2] + shape[-1:]
                      if _factored(p) else (1,))

    return AdafactorState(vr={k: vr(v) for k, v in params.items()},
                          vc={k: vc(v) for k, v in params.items()},
                          step=0)


def _units(g, vr, vc, p):
    """The parts of one leaf updated at a time: (gradient, row and column
    statistics, weight).  A stacked leaf factored within each layer goes
    layer by layer, on views of its stacked statistics; a stacked leaf of
    vectors is stacked (the reference factors it across the layers)."""
    if not isinstance(p, Stacked):
        return [(g, vr, vc, p)]
    if p[0].ndim >= 2:
        return [(gk, vr[k], vc[k], pk)
                for k, (gk, pk) in enumerate(zip(layers(g), p))]
    gs = torch.stack([gk.float() for gk in layers(g)])
    return [(gs, vr, vc, torch.stack([pk.detach() for pk in p]))]


def _adafactor_leaf(g, vr, vc, p, *, beta, lr, eps, clip, weight_decay):
    factored = _factored(p)
    units = _units(g, vr, vc, p)
    facs, ss, n = [], 0.0, 0
    for gu, vru, vcu, pu in units:              # the second moments
        gf = gu.to(torch.float32, copy=True)
        g2 = gf.square() + eps
        if factored:
            vru.mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
            vcu.mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
            del g2
            facs.append((torch.rsqrt(vru / torch.clamp_min(
                vru.mean(dim=-1, keepdim=True), eps)), torch.rsqrt(vcu)))
        else:
            vru.mul_(beta).add_((1 - beta) * g2)
            del g2
            facs.append((torch.rsqrt(vru),))
        u = _scaled(gf, facs[-1])
        ss = ss + u.square().sum()
        n += u.numel()
        del u, gf
    # update clipping by RMS over the whole leaf
    rms = torch.sqrt(ss / n + 1e-12)
    denom = torch.clamp_min(rms / clip, 1.0)
    for (gu, _, _, pu), fac in zip(units, facs):
        u = _scaled(gu.to(torch.float32, copy=True), fac).div_(denom)
        pf = pu.detach().float()
        if weight_decay:
            u += weight_decay * pf
        new = pf - u.mul_(lr)
        with torch.no_grad():
            pu.copy_(new)
    if isinstance(p, Stacked) and p[0].ndim < 2:     # written back stacked
        with torch.no_grad():
            for k, pk in enumerate(p):
                pk.copy_(units[0][3][k])


def _scaled(gf: torch.Tensor, fac) -> torch.Tensor:
    """The unclipped update g·rfac·cfac, or g·rsqrt(v), written into the
    float32 gradient copy ``gf``."""
    if len(fac) == 2:
        rfac, cfac = fac
        return gf.mul_(rfac[..., None]).mul_(cfac[..., None, :])
    return gf.mul_(fac[0])


def adafactor_update(grads, state: AdafactorState, params, *, lr,
                     decay=0.8, eps=1e-30, clip=1.0, weight_decay=0.0,
                     whole=None):
    step = state.step + 1
    lr = float(lr)
    beta = 1.0 - (_scalar(float(step), params) + 1.0) ** (-decay)
    for key, leaf in params.items():
        parts = (grads[key], state.vr[key], state.vc[key], leaf)
        with (contextlib.nullcontext(parts) if whole is None
              else whole(key, parts)) as parts:
            _adafactor_leaf(*parts, beta=beta, lr=lr, eps=eps, clip=clip,
                            weight_decay=weight_decay)
    return params, AdafactorState(state.vr, state.vc, step)


def make_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)
