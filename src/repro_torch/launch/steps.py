"""Train, serve and prefill step factories, and the stand-ins of their
inputs (counterpart of ``repro/launch/steps.py``).

A stand-in is a tensor on the ``meta`` device: its shape and dtype, no
storage.  :func:`abstract_state` gives the model and optimizer state of a
config on meta with the placements ``make_shardings`` gives each leaf,
:func:`input_specs` and :func:`cache_specs` the step's inputs and decode
state with theirs, and :func:`sharded_specs` cuts each leaf to a rank's
slice.  The dry-run (``launch/dryrun.py``) runs the port's own steps on
them; ``train.py``/``serve.py`` feed real tensors of the same shapes.
Token ids and labels are int64 (``batch_on``), where the reference's are
int32.

Every step runs on one device (the model's) or SPMD on the ranks of a
mesh (``models.transformer``: every rank passes the whole batch, keeps
its rows over the data axes, holds its slices of the weights and of the
decode state, and multiplies its slices of the attention's, the dense
MLP's, the head's, the MoE layer's, rwkv6's and mamba2's weights, the
partial products summed over ``model``).  The train step takes
the reference's step: the loss and its gradients, the optimizer's update
of the weights and moments (in place), and the metrics ``loss``, ``lr``
and ``grad_norm`` (the square root of the float32 sum of squares over
every gradient) as 0-d tensors, the same on every rank.  The serve and
prefill steps return the next tokens of the rank's rows (int32); a
caller gathers them over the data axes where it reads them
(``dist.sharding.gather_rows``, as ``launch.serve`` does).

On a mesh (:func:`loss_and_grads`) each rank backpropagates its own part
of the loss (``loss_fn``: its rows' token losses over the global count),
scaled by one over the ranks that hold the same rows (those along
``model``): each then holds a share of the gradient of what the ranks
along ``model`` hold alike.  The shares meet where they must: a sum of
partial products over ``model`` passes its gradient back as the same
all-reduce, so a weight a rank multiplies in place gets its slice's
whole gradient of the rank's rows; a gather passes it back as a
reduce-scatter, so a weight gathered at use gets the same.  Then
:func:`reduce_replicas` sums each over the axes the weight is
replicated along (the data axes, and ``model`` for a weight it does not
split, or under ``cfg.ddp``), in rank order.  Each rank then holds its
slices of the global gradient, the reference's under GSPMD.  The
optimizer state is placed by ``make_shardings`` on each state leaf's own
shape (:func:`state_shardings`); ``grad_norm`` counts each element
once.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.dist.sharding import (Sharding, act_axes, batch_axes_of,
                                       cache_split_dim, data_axes_of,
                                       mesh_sizes, named_shardings,
                                       reduce_replicas, sum_rows,
                                       _all_gather)
from repro_torch.models import transformer as T
from repro_torch.models.attention import KVCache
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.optim import tree as tr
from repro_torch.optim.tree import Stacked, layers, param_tree


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


def state_shardings(cfg, mesh) -> Optional[TrainState]:
    """The :class:`~repro_torch.dist.sharding.Sharding` of every leaf of
    a training state of ``cfg`` on ``mesh``: the weights' (by the
    reference's paths), the optimizer state's, each by the rule on its
    own whole shape, and the step's (whole); None without a mesh."""
    if mesh is None:
        return None
    params = param_tree(T.Transformer(cfg, torch.device("meta")))
    opt_init, _ = make_optimizer(cfg.optimizer)
    return TrainState(named_shardings(params, cfg, mesh),
                      named_shardings(opt_init(params), cfg, mesh),
                      named_shardings(0, cfg, mesh))


def loss_and_grads(model, batch: Dict[str, torch.Tensor], cfg, mesh=None,
                   data_axes=("data",), shardings=None):
    """(loss, grads): ``loss_fn`` on ``batch`` and the gradient of every
    weight, keyed by the reference's paths (a ``Stacked`` per block leaf).
    On a mesh every rank passes the whole batch and gets the global loss
    and its slices of the global gradient (``shardings``: the weights'
    :func:`state_shardings`, made here where not given)."""
    model.zero_grad(set_to_none=True)
    loss = T.loss_fn(model, batch, cfg, mesh, data_axes)
    if mesh is None:
        loss.backward()
    else:
        # each rank backpropagates its own part; the ranks that hold the
        # same rows (blocks of them over the row axes) share it
        sizes = mesh_sizes(mesh)
        labels = batch["labels"]
        blocks = math.prod(sizes[a] for a in T.row_axes(
            mesh, cfg, labels.shape[0]))
        loss.backward(torch.full_like(
            loss, blocks / math.prod(sizes.values())))
    params = param_tree(model)
    grads = {k: tuple(t.grad if t.grad is not None else torch.zeros_like(t)
                      for t in layers(v)) for k, v in params.items()}
    model.zero_grad(set_to_none=True)
    if mesh is not None:
        if shardings is None:
            shardings = state_shardings(cfg, mesh).params
        keys = [k for k in grads for _ in grads[k]]
        flat = reduce_replicas([g for k in grads for g in grads[k]],
                               [shardings[k] for k in keys])
        it = iter(flat)
        grads = {k: tuple(next(it) for _ in v) for k, v in grads.items()}
    return loss.detach(), {k: Stacked(v) if isinstance(params[k], Stacked)
                           else v[0] for k, v in grads.items()}


def grad_norm(grads, shardings=None) -> torch.Tensor:
    """The global norm of ``grads`` (a rank's slices on a mesh, with the
    weights' shardings): the float32 sum of squares of each leaf's slice,
    summed over the axes the leaf is split along, each element counted
    once."""
    parts: Dict[tuple, torch.Tensor] = {}
    for key, leaf in grads.items():
        axes = shardings[key].split_axes() if shardings else ()
        for g in layers(leaf):
            parts[axes] = parts.get(axes, 0.0) + g.float().square().sum()
    total = 0.0
    for axes in sorted(parts):
        part = parts[axes].reshape(1)
        for a in axes:
            part = sum_rows(_all_gather(part, shardings[key].mesh, a))
        total = total + part[0]
    return torch.sqrt(total)


@contextlib.contextmanager
def _whole_leaf(shardings, key, parts):
    """Adafactor's view of one leaf on a mesh: (gradient, vr, vc, weight)
    whole, gathered from the ranks' slices; on closing, this rank's slices
    of the updated vr, vc and weight written back."""
    shs = (shardings.params[key], shardings.opt.vr[key],
           shardings.opt.vc[key], shardings.params[key])
    full = tuple(sh.whole(x) for x, sh in zip(parts, shs))
    yield full
    with torch.no_grad():
        for x, f, sh in zip(parts[1:], full[1:], shs[1:]):
            if f is not x:                   # split: keep this rank's slice
                for dst, src in zip(layers(x), layers(sh.cut(f))):
                    dst.copy_(src)


def make_train_step(cfg, mesh, *, peak_lr: float = 3e-4, warmup: int = 200,
                    total: int = 10000):
    """(step, init): ``step(state, numpy batch) → (state, metrics)`` and
    ``init(model) → optimizer state``, on one device or, SPMD, on the
    ranks of ``mesh`` (the model sharded at rest on it, the optimizer
    state placed by :func:`state_shardings`)."""
    opt_init, opt_update = make_optimizer(cfg.optimizer)
    dax = data_axes_of(mesh) if mesh is not None else ("data",)
    shards = state_shardings(cfg, mesh)
    whole = None if shards is None else functools.partial(_whole_leaf,
                                                          shards)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        model = state.params
        lr = cosine_schedule(state.step, peak_lr=peak_lr, warmup=warmup,
                             total=total)
        dev = next(model.parameters()).device
        loss, grads = loss_and_grads(
            model, batch_on(batch, dev), cfg, mesh, dax,
            None if shards is None else shards.params)
        gnorm = grad_norm(grads, None if shards is None else shards.params)
        _, opt = opt_update(grads, state.opt, param_tree(model), lr=lr,
                            whole=whole)
        del grads
        return (TrainState(model, opt, state.step + 1),
                {"loss": loss, "lr": lr, "grad_norm": gnorm})

    def init(model):
        params = param_tree(model)
        if shards is None:
            return opt_init(params)
        dev = layers(next(iter(params.values())))[0].device

        def zeros(like, sh):                 # this rank's slice of zeros
            if isinstance(like, int):
                return like
            cut = [torch.zeros(t.shape, dtype=t.dtype, device=dev)
                   for t in layers(sh.cut(like))]
            return Stacked(cut) if isinstance(like, Stacked) else cut[0]
        meta = param_tree(T.Transformer(cfg, torch.device("meta")))
        return tr.map_with(zeros, opt_init(meta), shards.opt)

    return train_step, init


def make_serve_step(cfg, mesh):
    dax = data_axes_of(mesh) if mesh is not None else ("data",)

    def serve_step(model, dstate, inputs):
        """(the next tokens of the rank's rows, the new state)."""
        logits, new_state = T.decode_step(model, dstate, inputs, cfg, mesh,
                                          dax)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, new_state

    return serve_step


def make_prefill_step(cfg, mesh):
    dax = data_axes_of(mesh) if mesh is not None else ("data",)

    def prefill_step(model, inputs):
        """The next tokens of the rank's rows."""
        return T.next_tokens(model, inputs, cfg, mesh, dax,
                             last_only=getattr(cfg, "prefill_last_only",
                                               False))

    return prefill_step


# ---------------------------------------------------------------------------
# Stand-ins on the meta device: abstract state, inputs, decode state
# ---------------------------------------------------------------------------


_META = torch.device("meta")


def abstract_state(cfg, mesh, *, with_opt: bool = True):
    """The model of ``cfg`` on meta (whole) and, ``with_opt``, its
    optimizer state from ``opt_init``; beside them their shardings
    (``named_shardings``, the weights' keyed by the reference's paths;
    None without a mesh): ``((model, opt), (pshard, oshard))``, or
    ``(model, pshard)``."""
    model = T.Transformer(cfg, _META)
    pshard = named_shardings(model, cfg, mesh) if mesh is not None else None
    if not with_opt:
        return model, pshard
    opt_init, _ = make_optimizer(cfg.optimizer)
    opt = opt_init(param_tree(model))
    oshard = named_shardings(opt, cfg, mesh) if mesh is not None else None
    return (model, opt), (pshard, oshard)


def _own(leaf):
    """A cut leaf with storage of its own (a view's storage is the
    whole)."""
    if isinstance(leaf, Stacked):
        return Stacked(t.clone() for t in leaf)
    return leaf.clone() if isinstance(leaf, torch.Tensor) else leaf


def sharded_specs(shape_tree, shard_tree):
    """Each leaf of ``shape_tree`` cut to the rank's slice its sharding
    gives (``Sharding.cut``, on meta); no shardings: ``shape_tree``.  A
    model is cut by ``convert.shard_params``, which keeps its weights
    sharded at rest."""
    if shard_tree is None:
        return shape_tree
    return tr.map_with(lambda leaf, sh: _own(sh.cut(leaf)), shape_tree,
                       shard_tree)


def _batch_sharding(mesh, axes, ndim: int, model_dim: Optional[int] = None):
    """The placements of a leaf whose dimension 0 splits over ``axes``
    (and ``model_dim``, where given, over ``model``)."""
    from torch.distributed.tensor import Replicate, Shard
    return Sharding(mesh, tuple(
        Shard(0) if a in axes and ndim else
        Shard(model_dim) if a == "model" and model_dim is not None else
        Replicate() for a in mesh.mesh_dim_names))


def input_specs(cfg, shape, mesh):
    """(inputs, shardings): the step inputs of (arch × shape) on meta, the
    whole global batch (token ids and labels int64), and each one's
    placement: dimension 0 over ``batch_axes_of``'s axes (None without a
    mesh).  Every rank of a mesh passes the whole batch to the port's
    steps, which keep the rank's rows."""
    B, S = shape.global_batch, shape.seq_len

    def t(*dims, dtype=torch.int64):
        return torch.empty(dims, dtype=dtype, device=_META)
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            out = {"embeds": t(B, S, cfg.d_model, dtype=torch.bfloat16),
                   "labels": t(B, S, cfg.n_codebooks)}
        else:
            out = {"tokens": t(B, S)}
            if shape.kind == "train":
                out["labels"] = t(B, S)
    elif cfg.family == "audio":
        out = {"embeds": t(B, 1, cfg.d_model, dtype=torch.bfloat16)}
    else:
        out = {"tokens": t(B, 1)}
    if mesh is None:
        return out, None
    axes = batch_axes_of(mesh, cfg, batch=B)
    return out, {k: _batch_sharding(mesh, axes, v.ndim)
                 for k, v in out.items()}


def cache_specs(cfg, shape, mesh, dtype=torch.bfloat16):
    """(state, shardings): the decode state of (arch × shape) on meta
    (caches of ``dtype``, bf16 as the reference's, the whole batch) and
    each leaf's placement, the
    reference's: the batch over the data axes when it divides them, and
    over ``model`` by the reference's rule
    (``dist.sharding.cache_split_dim``) a KV cache's heads, else its
    length (each cache records which in ``split``, as
    ``init_decode_state`` on the mesh makes it), rwkv6's ``wkv`` on hd_k
    and mamba2's ``ssm`` on P, else their heads, and mamba2's conv window
    on its slots where ``model`` divides them (rwkv6's ``last`` whole).
    No mesh: the state and None."""
    B, S = shape.global_batch, shape.seq_len
    state = T.init_decode_state(cfg, B, S, dtype, device=_META)
    if mesh is None:
        return state, None
    axes = act_axes(mesh, B)

    def place(c):
        if not isinstance(c, KVCache):
            return c, tr.map_leaves(lambda leaf: _batch_sharding(
                mesh, axes, leaf.ndim, cache_split_dim(leaf.shape, mesh)), c)
        split = cache_split_dim(c.k.shape, mesh)
        kv = _batch_sharding(mesh, axes, c.k.ndim, split)
        whole = _batch_sharding(mesh, (), 0)
        return (c._replace(split=split), KVCache(
            kv, kv, whole, None if split is None else whole))

    labelled, shards = {}, {"pos": _batch_sharding(mesh, (), 0)}
    for g in ("caches", "shared_caches"):
        if getattr(state, g) is not None:
            pairs = [place(c) for c in getattr(state, g)]
            labelled[g] = [c for c, _ in pairs]
            shards[g] = [sh for _, sh in pairs]
    return state._replace(**labelled), state._replace(**shards)
