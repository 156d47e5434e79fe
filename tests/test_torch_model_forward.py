"""The port's whole-model ``forward`` (``repro_torch.models.transformer``)
against the reference's on the CPU, for every architecture on float32 and
bf16 smoke variants with the reference's weights (``params_from_jax``),
``last_only`` and the prefill step, and the entry points' default device.
Tolerances: ``tests/torch_model_helpers.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.models import transformer as T
from torch_model_helpers import (assert_bf16, assert_f32, model_inputs,
                                 model_pair, upcast)

ARCH_NAMES = sorted(JARCHS)


# --- the whole forward ------------------------------------------------------


@pytest.fixture(scope="module")
def forward_runs():
    """Every architecture's reference forward at (B, S) = (2, 64), in
    float32 and in bf16 with its float32 truth, computed once."""
    out = {}
    for arch in ARCH_NAMES:
        for dtype in ("float32", "bfloat16"):
            jc, tc, jp, model = model_pair(arch, dtype, seed=1)
            jin, tin = model_inputs(jc, 2, 64, seed=2)
            run = jax.jit(lambda p, i, c=jc: JT.forward(p, i, c))
            want, aux = run(jp, jin)
            truth = None
            if dtype == "bfloat16":
                jc32 = dataclasses.replace(jc, dtype="float32")
                truth = jax.jit(lambda p, i, c=jc32: JT.forward(p, i, c))(
                    upcast(jp), jin)[0]
            out[arch, dtype] = (jc, tc, model, tin, want, aux, truth)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward(forward_runs, arch, dtype):
    jc, tc, model, tin, want, aux, truth = forward_runs[arch, dtype]
    got, got_aux = T.forward(model, tin, tc)
    exp = (2, 64, tc.n_codebooks, tc.vocab) if tc.family == "audio" \
        else (2, 64, tc.vocab)
    assert tuple(got.shape) == exp == tuple(want.shape)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert_f32(got, want)
        np.testing.assert_allclose(float(got_aux), float(aux), rtol=1e-5)
    else:
        assert_bf16(got, want, truth)
        np.testing.assert_allclose(float(got_aux), float(aux), rtol=2e-2)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b",
                                  "musicgen-large"])
def test_forward_last_only_and_prefill_step(forward_runs, arch):
    from repro_torch.launch import steps
    jc, tc, model, tin, want, _, _ = forward_runs[arch, "float32"]
    last, _ = T.forward(model, tin, tc, last_only=True)
    assert_f32(last, np.asarray(want)[:, -1:])
    nxt = steps.make_prefill_step(tc, None)(model, tin)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(),
                                  np.asarray(want)[:, -1].argmax(-1))


def test_entry_points_default_to_the_card():
    """Without a card and without ``device="cpu"`` the model stack
    refuses to fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = C.smoke_variant(C.get_config("llama3.2-1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_decode_state(cfg, 1, 8, torch.bfloat16)
    from repro_torch.data.pipeline import length_balanced_batches
    from repro_torch.launch.serve import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(cfg, None, batch=1, tokens=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        length_balanced_batches(np.arange(64), 8)
