"""The port's loss (``repro_torch.models.layers.cross_entropy``,
``transformer.loss_fn``) and its gradients (``loss.backward()``) against
the reference's (``jax.value_and_grad``) on the CPU, for every
architecture's float32 smoke variant with the reference's weights; and
``remat="full"`` against ``"none"``, bit for bit, and ``"dots"`` against
``"full"``.  Tolerance: float32
rtol 1e-4, atol 1e-5 (``tests/torch_model_helpers.py``).  bf16:
``test_torch_loss_bf16.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_model_helpers import assert_f32, model_pair
from torch_train_helpers import (port_grads, ref_value_and_grad,
                                 train_batch)

ARCH_NAMES = sorted(JARCHS)


@pytest.mark.parametrize("shape,z_loss", [((3, 7, 50), 1e-4),
                                          ((2, 5, 4, 33), 1e-4),
                                          ((4, 9, 64), 0.0)])
def test_cross_entropy_and_grad(shape, z_loss):
    r = np.random.default_rng(len(shape))
    logits = (3 * r.normal(size=shape)).astype(np.float32)
    labels = r.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)
    want, gwant = jax.value_and_grad(
        lambda x: JL.cross_entropy(x, jnp.asarray(labels), z_loss))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = L.cross_entropy(x, torch.from_numpy(labels), z_loss)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    assert_f32(got, want)
    assert_f32(x.grad, gwant)


def test_cross_entropy_accumulates_bf16_logits_in_float32():
    r = np.random.default_rng(5)
    logits = r.normal(size=(2, 6, 40)).astype(np.float32)
    labels = r.integers(0, 40, size=(2, 6)).astype(np.int32)
    want = JL.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16),
                            jnp.asarray(labels))
    got = L.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                          torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert_f32(got, want)


@pytest.fixture(scope="module")
def f32_runs():
    """Every architecture's reference loss and gradients at (B, S) =
    (2, 32) in float32, with the port's model on the same weights."""
    out = {}
    for arch in ARCH_NAMES:
        jc, tc, jp, model = model_pair(arch, "float32", seed=3)
        jb, tb = train_batch(jc, 2, 32, seed=4)
        loss, grads = ref_value_and_grad(JT.loss_fn, jp, jb, jc)
        out[arch] = (tc, model, tb, loss, grads)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_grads_f32(f32_runs, arch):
    tc, model, tb, loss, grads = f32_runs[arch]
    model.requires_grad_(True).zero_grad(set_to_none=True)
    got = T.loss_fn(model, tb, tc)
    got.backward()
    assert_f32(got, loss)
    mine = port_grads(model)
    assert set(mine) == set(grads)
    for path, g in grads.items():
        assert mine[path].dtype == torch.float32, path
        assert_f32(mine[path], g)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_remat_full_equals_none_bit_for_bit(f32_runs, arch):
    """Recomputing each block in the backward pass changes no bit of the
    loss or of any gradient (on the CPU)."""
    tc, model, tb, _, _ = f32_runs[arch]
    runs = []
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tc, remat=remat)
        model.requires_grad_(True).zero_grad(set_to_none=True)
        loss = T.loss_fn(model, tb, cfg)
        loss.backward()
        runs.append((loss.detach(), port_grads(model)))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


def test_remat_dots_is_the_dry_runs():
    """``"dots"`` (the dry-run's ``remat_dots`` variants) keeps the
    unbatched matmuls' outputs and recomputes the rest: the loss and
    every gradient of ``"full"``, within float32 rounding."""
    tc, model = model_pair("llama3.2-1b", "float32")[1::2]
    _, tb = train_batch(tc, 1, 8)
    runs = []
    for remat in ("full", "dots"):
        model.requires_grad_(True).zero_grad(set_to_none=True)
        loss = T.loss_fn(model, tb, dataclasses.replace(tc, remat=remat))
        loss.backward()
        runs.append((loss.detach(), port_grads(model)))
    (l0, g0), (l1, g1) = runs
    torch.testing.assert_close(l1, l0)
    for path in g0:
        torch.testing.assert_close(g1[path], g0[path], msg=str(path))


def test_serving_weights_take_no_gradient():
    """Weights are made without gradients; training asks for them."""
    tc, model = model_pair("llama3.2-1b", "float32")[1::2]
    assert not any(p.requires_grad for p in model.parameters())
