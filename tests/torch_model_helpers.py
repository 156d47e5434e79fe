"""Shared pieces of the model-stack differential tests
(``test_torch_model*.py``, ``test_torch_moe.py``): the reference's
weights carried into the port through numpy, seeded inputs, and the two
tolerances.

float32: the port within ``F32`` of the reference (XLA's and torch's CPU
matmuls sum in different orders; the differences seen are ~1e-6 on
values of ~1).

bfloat16: the two packages round differently inside fused elementwise
chains (XLA keeps excess precision; its ``silu`` and torch's round apart
on about a third of bf16 inputs), so bf16 results differ by bf16 ulps
and, where a router's top-k has a near tie, by a whole expert.  The port
in bf16 is held to the reference's own bf16 error: against the float32
reference run on the same (upcast) weights and inputs, the port's RMS
error at most ``BF16_RMS`` times the reference's and its largest error
at most ``BF16_MAX`` times the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64, as in serving)
from repro.configs import get_config as jget, smoke_variant as jsmoke
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models.convert import as_tensor, params_from_jax

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_RMS, BF16_MAX = 1.5, 2.0


def configs(arch, dtype):
    """(reference, port) smoke configs of ``arch`` in ``dtype``."""
    return (dataclasses.replace(jsmoke(jget(arch)), dtype=dtype),
            dataclasses.replace(smoke_variant(get_config(arch)),
                                dtype=dtype))


def npt(tree):
    """A JAX pytree's leaves as numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def upcast(tree):
    """bf16 leaves as float32 (exact), the rest as they are."""
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, tree)


def model_pair(arch, dtype, seed=0):
    """(reference cfg, port cfg, reference params, port model)."""
    jc, tc = configs(arch, dtype)
    jp = JT.init_params(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, params_from_jax(tc, npt(jp), device="cpu")


def model_inputs(cfg, B, S, seed=0):
    """(reference inputs, port inputs): token ids, or frame embeddings
    for the audio family."""
    r = np.random.default_rng(seed)
    if cfg.family == "audio":
        emb = r.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(emb)}, {"embeds": torch.from_numpy(emb)}
    tok = r.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok)},
            {"tokens": torch.from_numpy(tok).long()})


def f32(x):
    """A JAX array or a tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))      # writable


def assert_f32(port, ref):
    np.testing.assert_allclose(f32(port), f32(ref), **F32)


def assert_bf16(port, ref, truth):
    """The port's bf16 result no further from the float32 ``truth`` than
    the reference's bf16 result is (see the module docstring)."""
    port, ref, truth = f32(port), f32(ref), f32(truth)
    assert port.shape == ref.shape == truth.shape
    assert np.isfinite(port).all()

    def rms(d):
        return float(np.sqrt(np.mean(np.square(d))))
    e_port, e_ref = rms(port - truth), rms(ref - truth)
    assert e_port <= BF16_RMS * e_ref + 1e-7, (e_port, e_ref)
    m_port = float(np.abs(port - truth).max())
    m_ref = float(np.abs(ref - truth).max())
    assert m_port <= BF16_MAX * m_ref + 1e-7, (m_port, m_ref)


def tensors(tree):
    """A dict of numpy arrays as a namespace of CPU tensors (a module's
    weights, read by name)."""
    from types import SimpleNamespace
    return SimpleNamespace(**{k: as_tensor(np.asarray(v))
                              for k, v in tree.items()})
