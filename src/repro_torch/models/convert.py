"""The reference's parameters and decode state, given as numpy arrays, in
the port's model (for the differential tests and for loading weights the
JAX package made).

``params_from_jax(cfg, tree)`` takes the tree of ``repro.models.
transformer.init_params`` with its leaves as numpy arrays (bfloat16 from
``ml_dtypes`` included) and loads it into a :class:`Transformer`: the
reference stacks each block leaf over the layers as (L, …), so
``blocks/attn/wq`` becomes ``blocks.0.attn.wq`` … ``blocks.{L-1}.attn.wq``;
zamba2's ``shared`` block, musicgen's ``heads`` and a tied embedding (no
``head``) map by name.  ``decode_state_from_jax`` does the same for a
``DecodeState``.  Both check that every weight and layer is covered, with
its shape, and keep each weight's dtype (float32 norms and routers, the
model's dtype elsewhere).

On a mesh (``params_from_jax(..., mesh=...)``, or ``shard_params`` of a
model drawn with a seed) each rank keeps only its slice of every weight,
as ``dist.sharding.make_shardings`` places the reference's leaf: the
weights sharded at rest, where ``forward`` and ``decode_step`` multiply
them (``models.transformer``), a few gathered whole at use.

``train_state_from_jax`` carries a whole training state across: the
reference's ``TrainState`` (weights, AdamW or Adafactor state, step) as
the port's, the model taking gradients and the moments of a stacked leaf
held per layer (``optim.tree.Stacked``); with a mesh, this rank's slices
of every leaf, placed as ``launch.steps.state_shardings`` says.
``train_state_leaves`` is its inverse: the port's state as the
reference's ``jax.tree.leaves`` (on a mesh, this rank's slices).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.dist.sharding import (leaf_slices, make_shardings,
                                       mesh_sizes, split_dims)

from repro_torch.launch.steps import TrainState
from repro_torch.optim import AdafactorState, AdamWState
from repro_torch.optim import tree as tr

from .attention import KVCache
from .ssm import MambaState, RWKVState
from .transformer import DecodeState, Transformer


def as_tensor(a) -> torch.Tensor:
    """A numpy array (``ml_dtypes.bfloat16`` included) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def shard_params(model: Transformer, cfg, mesh) -> Transformer:
    """Keep this rank's slice of every weight of ``model`` (in place), as
    ``make_shardings`` places its leaf on ``mesh`` (a ``Stacked`` leaf's
    dimension i is dimension i − 1 of each layer); the model records in
    ``at_rest`` which dimension of each weight is split over ``model``.
    No mesh: the model as it is."""
    if mesh is None:
        return model
    if getattr(model, "at_rest", None) is not None:
        raise ValueError("the model's weights are sharded already")
    params = tr.param_tree(model)
    placements = make_shardings(params, cfg, mesh)
    dims = split_dims(model, cfg, mesh)
    with torch.no_grad():
        for path, leaf in params.items():
            if not any(pl.is_shard() for pl in placements[path]):
                continue
            cut = leaf_slices(tuple(leaf.shape), placements[path], mesh)
            stacked = isinstance(leaf, tr.Stacked)
            for t in tr.layers(leaf):
                t.data = t.data[cut[1:] if stacked else cut].clone()
    model.at_rest = {"mesh": mesh_sizes(mesh), "dims": dims}
    return model


def resident_bytes(model) -> int:
    """The bytes of the weights ``model`` holds (on a mesh, this rank's
    slices)."""
    return sum(t.numel() * t.element_size() for t in model.parameters())


def params_from_jax(cfg, tree, device=None, mesh=None) -> Transformer:
    """A :class:`Transformer` of ``cfg`` holding the reference's weights
    ``tree`` (nested dicts of numpy arrays), on ``device`` (the card
    unless ``device="cpu"``); with a mesh, this rank's slices of them
    (:func:`shard_params`)."""
    model = Transformer(cfg, resolve_device(device))
    flat = {}
    for name, a in _flatten(tree).items():
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            if a.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: {a.shape[0]} layers, not "
                                 f"{cfg.n_layers}")
            for i in range(cfg.n_layers):
                flat[f"blocks.{i}.{rest}"] = a[i]
        else:
            flat[name] = a
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"weights the model lacks: "
                       f"{sorted(set(flat) - set(params))}; weights the "
                       f"tree lacks: {sorted(set(params) - set(flat))}")
    for name, t in params.items():
        src = as_tensor(flat[name])
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)}, the model's "
                             f"{tuple(t.shape)}")
        t.data.copy_(src.to(t.dtype))
    return shard_params(model, cfg, mesh)


def decode_state_from_jax(cfg, state, device=None) -> DecodeState:
    """The port's :class:`DecodeState` of the reference's (its leaves as
    numpy arrays, the per-layer caches stacked over the layers)."""
    dev = resolve_device(device)

    def t(a):
        return as_tensor(a).to(dev)

    def layers(stacked, n):
        return [{k: np.asarray(v)[i] for k, v in stacked._asdict().items()}
                for i in range(n)]

    pos = int(np.asarray(state.pos))
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        caches = [KVCache(t(c["k"]), t(c["v"]), pos)
                  for c in layers(state.caches, cfg.n_layers)]
        return DecodeState(caches, None, pos)
    if cfg.family == "ssm":
        caches = [RWKVState(t(c["wkv"]), t(c["last"]))
                  for c in layers(state.caches, cfg.n_layers)]
        return DecodeState(caches, None, pos)
    if cfg.family == "hybrid":
        caches = [MambaState(t(c["ssm"]), t(c["conv"]))
                  for c in layers(state.caches, cfg.n_layers)]
        n_sh = cfg.n_layers // cfg.attn_every
        shared = [KVCache(t(c["k"]), t(c["v"]), pos)
                  for c in layers(state.shared_caches, n_sh)]
        return DecodeState(caches, shared, pos)
    raise ValueError(cfg.family)


def train_state_from_jax(cfg, tree, device=None, mesh=None):
    """The port's ``TrainState`` of the reference's (its leaves as numpy
    arrays): the model (``params_from_jax``, taking gradients), the
    optimizer state over its ``param_tree`` and the step, on ``device``
    (the card unless ``device="cpu"``); with a mesh, this rank's slices
    of each."""
    from repro_torch.launch.steps import state_shardings
    dev = resolve_device(device)
    model = params_from_jax(cfg, tree.params, device=dev,
                            mesh=mesh).requires_grad_(True)
    params = tr.param_tree(Transformer(cfg, torch.device("meta")))

    def moments(sub, per_layer: bool):
        flat = {tuple(k.split(".")): v for k, v in _flatten(sub).items()}
        if set(flat) != set(params):
            raise KeyError(f"optimizer leaves {sorted(set(flat) ^ set(params))}"
                           f" differ from the weights'")
        out = {}
        for path in params:
            t = as_tensor(flat[path]).to(dev)
            out[path] = tr.Stacked(t.unbind(0)) if per_layer and isinstance(
                params[path], tr.Stacked) else t
        return out

    opt = tree.opt
    step = int(np.asarray(opt.step))
    if hasattr(opt, "mu"):
        opt = AdamWState(moments(opt.mu, True), moments(opt.nu, True), step)
    else:
        opt = AdafactorState(moments(opt.vr, False), moments(opt.vc, False),
                             step)
    if mesh is not None:                         # keep this rank's slices
        def cut(leaf, sh):
            part = sh.cut(leaf)
            if isinstance(part, tr.Stacked):
                return tr.Stacked(t.clone() for t in part)
            return part.clone() if torch.is_tensor(part) else part
        opt = tr.map_with(cut, opt, state_shardings(cfg, mesh).opt)
    return TrainState(model, opt, int(np.asarray(tree.step)))


def train_state_leaves(state) -> list:
    """The port's training state as the reference's ``jax.tree.leaves`` of
    its ``TrainState``, numpy arrays on the host (block leaves stacked as
    (L, …); bfloat16 given as float32, which holds it exactly)."""
    out = []
    for leaf in tr.leaves(state):
        arr, logical = tr.host_leaf(leaf)
        out.append(tr.as_tensor(arr, logical).float().numpy()
                   if logical == "bfloat16" else arr)
    return out
