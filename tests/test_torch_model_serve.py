"""The port's decode and serving path (``decode_step``, the serve and
prefill steps, ``repro_torch.launch.serve``) against the reference's on
the CPU: several decode steps of every architecture on float32 and bf16
smoke variants (the caches converted by ``decode_state_from_jax`` and
compared after each step), teacher-forced decode against prefill, and
``serve``'s tokens for all ten smoke architectures.

The reference's ``serve`` makes bf16 caches whatever the model's dtype,
so a float32 model with a KV cache is refused at the first cache write
(``dynamic_update_slice``: a ``TypeError``), and the port refuses it
too.  The float32 comparison of ``serve`` runs both with caches of the
model's dtype (their ``init_decode_state`` wrapped for the test); bf16
caches, the real serving path, are compared step by step in bf16.
Tokens must be equal: in float32 the logits agree to ~1e-6, far inside
the top-two margins of these runs.
Tolerances: ``tests/torch_model_helpers.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import serve as JSV
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve as SV, steps
from repro_torch.models import transformer as T
from repro_torch.models.convert import decode_state_from_jax, params_from_jax
from torch_model_helpers import (assert_bf16, assert_f32, configs,
                                 model_inputs, model_pair, npt, upcast)

ARCH_NAMES = sorted(JARCHS)
STEPS = 4


def _step_inputs(cfg, B, seed):
    r = np.random.default_rng(seed)
    if cfg.family == "audio":
        e = r.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = r.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t).long()}


def _states_equal(tc, port, ref):
    """The port's decode state against the reference's, leaf by leaf."""
    conv = decode_state_from_jax(tc, npt(ref), device="cpu")
    assert port.pos == conv.pos
    for a, b in zip(port.caches, conv.caches):
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert_f32(x, y)
    for a, b in zip(port.shared_caches or [], conv.shared_caches or []):
        assert_f32(a.k, b.k)
        assert_f32(a.v, b.v)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_steps_float32(arch):
    """STEPS decode steps from a state converted from the reference's
    (caches of the model's dtype, written at positions 0 … STEPS-1 of a
    12-slot cache): logits and every cache leaf after each step."""
    jc, tc, jp, model = model_pair(arch, "float32", seed=3)
    jst = JT.init_decode_state(jc, 2, 12, jnp.float32)
    tst = decode_state_from_jax(tc, npt(jst), device="cpu")
    step = jax.jit(lambda p, s, i: JT.decode_step(p, s, i, jc))
    for t in range(STEPS):
        jin, tin = _step_inputs(jc, 2, 100 + t)
        jl, jst = step(jp, jst, jin)
        tl, tst = T.decode_step(model, tst, tin, tc)
        assert tuple(tl.shape) == tuple(jl.shape)
        assert_f32(tl, jl)
        _states_equal(tc, tst, jst)
    assert tst.pos == int(jst.pos) == STEPS


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_steps_bf16(arch):
    """The same in bf16 with bf16 caches (the serving path), held to the
    reference's own bf16 error against its float32 run."""
    jc, tc, jp, model = model_pair(arch, "bfloat16", seed=3)
    jc32 = dataclasses.replace(jc, dtype="float32")
    jst = JT.init_decode_state(jc, 2, 12, jnp.bfloat16)
    tst = decode_state_from_jax(tc, npt(jst), device="cpu")
    st32 = JT.init_decode_state(jc32, 2, 12, jnp.float32)
    p32 = upcast(jp)
    step = jax.jit(lambda p, s, i: JT.decode_step(p, s, i, jc))
    step32 = jax.jit(lambda p, s, i: JT.decode_step(p, s, i, jc32))
    for t in range(STEPS):
        jin, tin = _step_inputs(jc, 2, 100 + t)
        jl, jst = step(jp, jst, jin)
        truth, st32 = step32(p32, st32, jin)
        tl, tst = T.decode_step(model, tst, tin, tc)
        assert tl.dtype == torch.bfloat16
        assert_bf16(tl, jl, truth)


def test_decode_matches_prefill_dense():
    """Teacher-forced decode against prefill (the reference's
    ``test_decode_matches_prefill_dense``), in float32 with float32
    caches: the port's decode logits equal its own prefill's and the
    reference's decode's."""
    jc, tc, jp, model = model_pair("llama3.2-1b", "float32", seed=4)
    jin, tin = model_inputs(jc, 1, 8, seed=5)
    full, _ = T.forward(model, tin, tc)
    jst = JT.init_decode_state(jc, 1, 8, jnp.float32)
    st = T.init_decode_state(tc, 1, 8, torch.float32, device="cpu")
    step = jax.jit(lambda p, s, i: JT.decode_step(p, s, i, jc))
    for t in range(8):
        jl, jst = step(jp, jst, {"tokens": jin["tokens"][:, t:t + 1]})
        lg, st = T.decode_step(model, st,
                               {"tokens": tin["tokens"][:, t:t + 1]}, tc)
        assert_f32(lg[:, 0], full[:, t])
        assert_f32(lg, jl)


@pytest.fixture
def f32_caches(monkeypatch):
    """Both packages' ``init_decode_state`` making caches of the model's
    dtype (their serve asks for bf16)."""
    j_init, t_init = JT.init_decode_state, T.init_decode_state
    monkeypatch.setattr(JT, "init_decode_state",
                        lambda cfg, B, L, dtype: j_init(
                            cfg, B, L, jnp.dtype(cfg.dtype)))
    monkeypatch.setattr(T, "init_decode_state",
                        lambda cfg, B, L, dtype, device=None, mesh=None:
                        t_init(cfg, B, L, getattr(torch, cfg.dtype), device,
                               mesh))


def _serve_both(arch, dtype, monkeypatch, batch=2, tokens=5, cache_len=16):
    """``serve`` of both packages on the reference's weights (the port's
    ``init_params`` replaced by ``params_from_jax`` of the reference's
    draw with the same seed)."""
    jc, tc = configs(arch, dtype)
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    monkeypatch.setattr(T, "init_params", lambda cfg, gen, device=None:
                        params_from_jax(cfg, npt(jp), device=device))
    want, jstats = JSV.serve(jc, None, batch=batch, tokens=tokens,
                             cache_len=cache_len, logger=lambda s: None)
    got, stats = SV.serve(tc, None, batch=batch, tokens=tokens,
                          cache_len=cache_len, logger=lambda s: None,
                          device="cpu")
    return want, got, jstats, stats


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_tokens_float32(arch, f32_caches, monkeypatch):
    want, got, jstats, stats = _serve_both(arch, "float32", monkeypatch)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert stats["n"] == jstats["n"] == 4
    assert stats["p50_ms"] > 0 and stats["tok_per_s"] > 0


def test_serve_refuses_float32_with_bf16_caches():
    jc, tc = configs("llama3.2-1b", "float32")
    with pytest.raises(TypeError, match="same dtypes"):
        JSV.serve(jc, None, batch=1, tokens=2, logger=lambda s: None)
    with pytest.raises(TypeError, match="same dtypes"):
        SV.serve(tc, None, batch=1, tokens=2, logger=lambda s: None,
                 device="cpu")


def test_next_token_input_contract():
    flat = torch.tensor([3, 1, 4, 1])
    out = SV.next_token_input(flat, 4)
    assert tuple(out["tokens"].shape) == (4, 1)
    assert out["tokens"].dtype == torch.int32
    assert tuple(SV.next_token_input(flat[:, None], 4)["tokens"].shape) \
        == (4, 1)
    for bad in (torch.zeros((4, 2), dtype=torch.int32),
                torch.zeros((8,), dtype=torch.int32)):
        with pytest.raises(ValueError, match="next-token contract"):
            SV.next_token_input(bad, 4)
        with pytest.raises(ValueError, match="next-token contract"):
            JSV.next_token_input(jnp.asarray(bad.numpy()), 4)


def test_serve_cli_smoke(capsys):
    toks, stats = SV.main(["--arch", "rwkv6-1.6b", "--smoke", "--tokens",
                           "3", "--batch", "2", "--device", "cpu"])
    assert toks.shape == (6,)
    assert "[serve] rwkv6-1.6b-smoke: 3 steps, batch 2" in \
        capsys.readouterr().out


def test_serve_step_argmax_and_stats_guard():
    """The serve step's argmax (lowest index on ties, int32) and
    ``latency_stats``' note when one step leaves no sample."""
    cfg = smoke_variant(get_config("llama3.2-1b"))
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    st = T.init_decode_state(cfg, 2, 4, torch.bfloat16, device="cpu")
    nxt, st = steps.make_serve_step(cfg, None)(
        model, st, {"tokens": torch.zeros((2, 1), dtype=torch.long)})
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (2,)
    assert st.pos == 1
    msgs = []
    toks, stats = SV.serve(cfg, None, batch=2, tokens=1, device="cpu",
                           logger=msgs.append)
    assert stats["p50_ms"] is None and "warmup" in msgs[0]
