"""Trees of tensors in the reference's layout: the port's stand-in for
the ``jax.tree`` calls of the training stack.

A tree is nested dicts, tuples, lists and NamedTuples; ``None`` holds no
leaf, and a leaf is a tensor, a numpy array, a Python number or a
:class:`Stacked`.  Leaves come in ``jax.tree.flatten``'s order: dict keys
sorted, sequences in order.  An ``nn.Module`` stands for its weights as
the reference's parameter dict (:func:`param_tree`), so a training state
holding the port's model flattens to the reference's leaves, block leaves
stacked over the layers as (L, …).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn


class Stacked(tuple):
    """The layers of one (L, …) leaf of the reference, held as L tensors of
    one shape and dtype: the port keeps a module per layer where the
    reference stacks the layers' weights and scans them."""

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self),) + tuple(self[0].shape)

    @property
    def ndim(self) -> int:
        return 1 + self[0].ndim

    @property
    def dtype(self):
        return self[0].dtype


def layers(leaf) -> tuple:
    """The tensors of a leaf: a :class:`Stacked`'s layers, or the tensor."""
    return tuple(leaf) if isinstance(leaf, Stacked) else (leaf,)


def param_tree(module: nn.Module) -> Dict[tuple, Any]:
    """The module's weights keyed by the reference's paths, in its order:
    ``blocks.{i}.attn.wq`` becomes layer i of the :class:`Stacked` leaf
    ``("blocks", "attn", "wq")``, ``shared.mlp.up`` the leaf ``("shared",
    "mlp", "up")``.  Sorted path tuples are ``jax.tree.flatten``'s order
    of the nested dicts."""
    out: Dict[tuple, Any] = {}
    stacks: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for name, t in module.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            stacks.setdefault(("blocks",) + tuple(parts[2:]), {})[
                int(parts[1])] = t
        else:
            out[tuple(parts)] = t
    for path, by_layer in stacks.items():
        out[path] = Stacked(by_layer[i] for i in range(len(by_layer)))
    return dict(sorted(out.items()))


def map_leaves(fn: Callable[[Any], Any], tree):
    """``tree`` with each leaf replaced by ``fn(leaf)``, called in
    flatten order.  A module stays the same object (``fn`` sees its
    weights, and may write them in place)."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        map_leaves(fn, param_tree(tree))
        return tree
    if isinstance(tree, dict):
        done = {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, Stacked):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def map_with(fn: Callable[[Any, Any], Any], tree, other):
    """``tree`` with each leaf replaced by ``fn(leaf, o)``, ``o`` the leaf
    of ``other`` (a tree of the same leaves) at the same place."""
    it = iter(leaves(other))
    return map_leaves(lambda leaf: fn(leaf, next(it)), tree)


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    out: List[Any] = []
    map_leaves(out.append, tree)
    return out


def host_leaf(leaf) -> Tuple[np.ndarray, str]:
    """A leaf's host copy as a checkpoint stores it, with its dtype's name:
    bfloat16 as its 16-bit pattern (uint16, labelled ``"bfloat16"``), a
    :class:`Stacked` as one (L, …) array, a Python int (a step counter)
    as int32, as the reference's."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    parts = layers(leaf)
    bf16 = parts[0].dtype == torch.bfloat16
    dtype = np.uint16 if bf16 else torch.empty(
        (), dtype=parts[0].dtype).numpy().dtype
    out = np.empty(tuple(leaf.shape), dtype)
    dst = out.view(np.int16) if bf16 else out
    for k, t in enumerate(parts):
        src = t.detach().view(torch.int16) if bf16 else t.detach()
        view = dst[k] if isinstance(leaf, Stacked) else dst
        torch.from_numpy(view).copy_(src)
    return out, ("bfloat16" if bf16 else str(out.dtype))


def as_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    """A host array read from a checkpoint as a CPU tensor of its logical
    dtype (bfloat16 from its 16-bit pattern)."""
    arr = np.ascontiguousarray(arr)
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_leaf(like, arr: np.ndarray, logical: str):
    """Restore one leaf into the place of ``like``: a tensor or a
    :class:`Stacked` is overwritten in place (each layer from its slice)
    and returned; a Python int comes back as one."""
    if isinstance(like, int):
        return int(arr)
    src = as_tensor(arr, logical)
    with torch.no_grad():
        for k, t in enumerate(layers(like)):
            t.copy_(src[k] if isinstance(like, Stacked) else src)
    return like
