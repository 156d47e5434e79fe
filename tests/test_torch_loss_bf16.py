"""The port's loss and gradients in bfloat16 against the reference's on
the CPU, for every architecture's bf16 smoke variant with the reference's
weights.  The two packages round bf16 apart (``tests/
torch_model_helpers.py``), so the port is held to the reference's own
bf16 error: against the reference's float32 run on the same (upcast)
weights, the port's error in each gradient is no larger than the
reference's bf16 error (``assert_bf16``).

The loss is one number, and the reference's compiled bf16 loss is nearly
its float32 loss (XLA keeps the fused bf16 chains, and the logits on
their way into the float32 cross-entropy, at float32), so the scalar is
held as the serving tests hold the aux scalar, by a tolerance fixed from the dtype: the
port's bf16 loss within bf16's unit roundoff (2^-8) of the float32 loss,
and the reference's too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import transformer as JT
from repro_torch.models import transformer as T
from torch_model_helpers import assert_bf16, model_pair, upcast
from torch_train_helpers import (port_grads, ref_value_and_grad,
                                 train_batch)

ARCH_NAMES = sorted(JARCHS)
BF16_UNIT_ROUNDOFF = 2.0 ** -8


@pytest.fixture(scope="module")
def bf16_runs():
    """Every architecture's reference loss and gradients at (B, S) =
    (2, 32) in bf16, and its float32 truth on the upcast weights."""
    out = {}
    for arch in ARCH_NAMES:
        jc, tc, jp, model = model_pair(arch, "bfloat16", seed=5)
        jb, tb = train_batch(jc, 2, 32, seed=6)
        ref = ref_value_and_grad(JT.loss_fn, jp, jb, jc)
        jc32 = dataclasses.replace(jc, dtype="float32")
        truth = ref_value_and_grad(JT.loss_fn, upcast(jp), jb, jc32)
        out[arch] = (tc, model, tb, ref, truth)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_grads_bf16(bf16_runs, arch):
    tc, model, tb, (loss, grads), (loss32, grads32) = bf16_runs[arch]
    model.requires_grad_(True).zero_grad(set_to_none=True)
    got = T.loss_fn(model, tb, tc)
    got.backward()
    assert got.dtype == torch.float32
    for value in (float(got.detach()), float(loss)):
        np.testing.assert_allclose(value, float(loss32),
                                   rtol=BF16_UNIT_ROUNDOFF)
    mine = port_grads(model)
    assert set(mine) == set(grads)
    for path, g in grads.items():
        bf16 = g.dtype == jnp.bfloat16
        assert (mine[path].dtype == torch.bfloat16) == bf16, path
        assert_bf16(mine[path], g, grads32[path])
