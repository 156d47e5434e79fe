"""Shared pieces of the training-stack differential tests
(``test_torch_loss*.py``, ``test_torch_train.py``,
``test_torch_checkpoint.py``): seeded batches with labels, and gradients
of both packages keyed by the reference's parameter paths, block leaves
stacked as (L, …)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.optim.tree import Stacked, param_tree
from torch_model_helpers import model_inputs


def train_batch(cfg, B, S, seed=0):
    """(reference batch, port batch): ``model_inputs`` plus labels,
    (B, S) or, audio, (B, S, n_codebooks)."""
    jin, tin = model_inputs(cfg, B, S, seed=seed)
    r = np.random.default_rng(seed + 1)
    shape = (B, S, cfg.n_codebooks) if cfg.family == "audio" else (B, S)
    lab = r.integers(0, cfg.vocab, size=shape).astype(np.int32)
    return ({**jin, "labels": jnp.asarray(lab)},
            {**tin, "labels": torch.from_numpy(lab).long()})


def by_path(tree, prefix=()):
    """A nested dict's leaves keyed by their path tuples."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(by_path(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def port_grads(model):
    """The model's gradients keyed as the reference's, stacked."""
    out = {}
    for path, leaf in param_tree(model).items():
        if isinstance(leaf, Stacked):
            out[path] = torch.stack([t.grad for t in leaf])
        else:
            out[path] = leaf.grad
    return out


def ref_value_and_grad(loss_fn, params, batch, cfg):
    """The reference's loss and gradients (keyed by path), jitted."""
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, batch, cfg)))(params)
    return loss, by_path(grads)
