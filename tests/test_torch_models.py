"""The port's model stack (``repro_torch.configs``, ``repro_torch.models``)
against the reference's on the CPU: the configs field for field, then
each module on the same weights (``params_from_jax``) and seeded numpy
inputs — layers, attention (dense, chunked, sliding window, banded), the
SSM blocks, and the whole ``forward`` of every architecture on float32
and bf16 smoke variants.  Tolerances: ``tests/torch_model_helpers.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.configs import get_config as jget, shape_applicable as japplies
from repro.configs import smoke_variant as jsmoke
from repro.models import attention as JA, layers as JL, ssm as JS
from repro_torch import configs as C
from repro_torch.models import attention as A, layers as L, ssm as S
from repro_torch.models import transformer as T
from torch_model_helpers import (assert_bf16, assert_f32, configs, f32,
                                 npt, tensors, upcast)

ARCH_NAMES = sorted(JARCHS)


# --- configs -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_field_for_field(arch):
    ref, port = jget(arch), C.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.sub_quadratic == ref.sub_quadratic
    assert dataclasses.asdict(C.smoke_variant(port)) == dataclasses.asdict(
        jsmoke(ref))
    for name, shape in JSHAPES.items():
        assert dataclasses.asdict(C.SHAPES[name]) == dataclasses.asdict(shape)
        assert C.shape_applicable(port, C.SHAPES[name]) == japplies(ref,
                                                                    shape)


def test_registry():
    assert C.list_archs() == sorted(JARCHS)
    assert sorted(C.ARCHS) == sorted(JARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        C.get_config("gpt-2")


# --- layers ------------------------------------------------------------------


def _x(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def test_rms_norm_and_rope():
    x = _x((2, 8, 4, 16))
    scale = _x((16,), 1)
    assert_f32(L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
               JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    np.testing.assert_array_equal(L.rope_freqs(16, 1e4),
                                  JL.rope_freqs(16, 1e4))
    pos = np.arange(8)[None, :]
    for theta in (1e4, 5e5):
        assert_f32(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta),
                   JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["silu", "relu2", "gelu"])
def test_mlp(act):
    p = JL.init_mlp(jax.random.PRNGKey(2), 64, 128, act == "silu",
                    jnp.float32)
    x = _x((2, 8, 64))
    assert_f32(L.mlp(torch.from_numpy(x), tensors(p), act),
               JL.mlp(jnp.asarray(x), p, act))
    with pytest.raises(ValueError):
        L.mlp(torch.from_numpy(x), tensors(p), "tanh")


def test_embed():
    table = _x((32, 8))
    tok = np.random.default_rng(0).integers(0, 32, size=(2, 5))
    np.testing.assert_array_equal(
        L.embed(torch.from_numpy(tok), torch.from_numpy(table)).numpy(),
        np.asarray(JL.embed(jnp.asarray(tok), jnp.asarray(table))))


def test_init_draws_from_the_generator():
    cfg = C.smoke_variant(C.get_config("llama3.2-1b"))
    a = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = T.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.attn.wq"], sc["blocks.0.attn.wq"])
    assert sa["embed"].dtype == torch.bfloat16
    assert sa["blocks.0.ln1"].dtype == torch.float32
    # the reference's scales: 0.02 for the embedding, 1/sqrt(d) for wq
    assert abs(float(sa["embed"].float().std()) - 0.02) < 2e-3
    assert abs(float(sa["blocks.0.attn.wq"].float().std()) - 0.125) < 0.01
    assert not any(p.requires_grad for p in a.parameters())


# --- attention ---------------------------------------------------------------


def _attn_setup(arch, dtype, window=None, seed=0):
    jc, tc = configs(arch, dtype)
    if window is not None:
        jc = dataclasses.replace(jc, sliding_window=window)
        tc = dataclasses.replace(tc, sliding_window=window)
    p = JA.init_attention(jax.random.PRNGKey(seed), jc.d_model, jc.n_heads,
                          jc.n_kv_heads, jc.head_dim, jc.qk_norm,
                          jnp.dtype(dtype))
    return jc, tc, p


# (arch, window, block, banded): dense (S ≤ block), chunked, chunked with a
# window inside and across blocks, and the band with clamped blocks
ATTN_CASES = [("llama3.2-1b", None, 64, None), ("qwen3-14b", None, 16, None),
              ("llama3.2-1b", None, 16, None), ("llama3.2-1b", 24, 16, False),
              ("llama3.2-1b", 24, 16, True), ("mixtral-8x22b", 8, 16, True),
              ("mixtral-8x22b", 40, 16, True), ("mixtral-8x22b", 40, 64, None)]


@pytest.mark.parametrize("arch,window,block,banded", ATTN_CASES)
def test_attention_prefill(arch, window, block, banded):
    jc, tc, p = _attn_setup(arch, "float32", window)
    x = _x((2, 64, jc.d_model), 1)
    want = jax.jit(lambda x_, p_: JA.attention(x_, p_, jc, block=block,
                                               banded=banded))(
        jnp.asarray(x), p)
    got = A.attention(torch.from_numpy(x), tensors(p), tc, block=block,
                      banded=banded)
    assert_f32(got, want)


@pytest.mark.parametrize("banded", [False, True])
def test_attend_chunked_direct(banded):
    """``_attend_chunked`` on the same q, k, v (GQA, n_rep = 2)."""
    q, k, v = _x((2, 64, 4, 16), 0), _x((2, 64, 2, 16), 1), _x((2, 64, 2, 16),
                                                               2)
    want = JA._attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              2, 20, 16, banded)
    got = A._attend_chunked(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), 2, 20, 16, banded)
    assert_f32(got, want)
    dense = A._attend_dense(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), 2, 20)
    assert_f32(got, dense)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b"])
def test_attention_bf16(arch):
    jc, tc, p = _attn_setup(arch, "bfloat16")
    jc32 = dataclasses.replace(jc, dtype="float32")
    x = jnp.asarray(_x((2, 64, jc.d_model), 1), jnp.bfloat16)
    for block in (64, 16):
        want = JA.attention(x, p, jc, block=block)
        truth = JA.attention(x.astype(jnp.float32), upcast(p), jc32,
                             block=block)
        got = A.attention(torch.from_numpy(f32(x)).bfloat16(), tensors(
            npt(p)), tc, block=block)
        assert got.dtype == torch.bfloat16
        assert_bf16(got, want, truth)


def test_context_parallel_without_a_mesh_is_chunked():
    _, tc, p = _attn_setup("llama3.2-1b", "float32")
    tc = dataclasses.replace(tc, attn_context_parallel=True)
    x = torch.from_numpy(_x((1, 32, tc.d_model), 2))
    chunked = dataclasses.replace(tc, attn_context_parallel=False)
    assert torch.equal(A.attention(x, tensors(p), tc, block=16),
                       A.attention(x, tensors(p), chunked, block=16))


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention(window):
    """Ten single-token steps against the cache: outputs and cache equal
    the reference's, including the ring of a sliding window (6 slots)."""
    jc, tc, p = _attn_setup("llama3.2-1b", "float32", window)
    S_max = window or 16
    jcache = JA.init_cache(2, S_max, jc, jnp.float32)
    tcache = A.init_cache(2, S_max, tc, torch.float32, "cpu")
    tp = tensors(p)
    for t in range(10):
        x = _x((2, 1, jc.d_model), 10 + t)
        jo, jcache = JA.decode_attention(jnp.asarray(x), p, jc, jcache)
        to, tcache = A.decode_attention(torch.from_numpy(x), tp, tc, tcache)
        assert_f32(to, jo)
        assert tcache.pos == int(jcache.pos) == t + 1
        assert_f32(tcache.k, jcache.k)
        assert_f32(tcache.v, jcache.v)


def test_decode_attention_refuses_another_cache_dtype():
    """A float32 model's keys into a bf16 cache: the reference's
    ``dynamic_update_slice`` refuses them, and so does the port."""
    jc, tc, p = _attn_setup("llama3.2-1b", "float32")
    x = _x((2, 1, jc.d_model))
    with pytest.raises(TypeError, match="same dtypes"):
        JA.decode_attention(jnp.asarray(x), p, jc,
                            JA.init_cache(2, 8, jc, jnp.bfloat16))
    with pytest.raises(TypeError, match="same dtypes"):
        A.decode_attention(torch.from_numpy(x), tensors(p), tc,
                           A.init_cache(2, 8, tc, torch.bfloat16, "cpu"))


# --- SSM blocks --------------------------------------------------------------


@pytest.mark.parametrize("S_len", [64, 256])
def test_mamba2_prefill(S_len):
    jc, tc = configs("zamba2-2.7b", "float32")
    p = JS.init_mamba2(jax.random.PRNGKey(5), jc.d_model, jc.ssm_heads,
                       jc.ssm_state, jnp.float32)
    # nonzero A and dt bias, so the decays are not all alike
    r = np.random.default_rng(6)
    p = dict(p, A_log=jnp.asarray(r.normal(size=jc.ssm_heads), jnp.float32),
             dt_bias=jnp.asarray(r.normal(size=jc.ssm_heads), jnp.float32))
    x = _x((2, S_len, jc.d_model), 7)
    assert_f32(S.mamba2(torch.from_numpy(x), tensors(p), tc),
               jax.jit(lambda x_, p_: JS.mamba2(x_, p_, jc))(
                   jnp.asarray(x), p))


def test_ssd_chunked_state():
    r = np.random.default_rng(8)
    x, dt = r.normal(size=(2, 256, 4, 8)), r.random((2, 256, 4))
    A_, B_, C_ = -r.random(4), r.normal(size=(2, 256, 16)), \
        r.normal(size=(2, 256, 16))
    args = [a.astype(np.float32) for a in (x, dt, A_, B_, C_)]
    jy, jh = jax.jit(lambda *a: JS._ssd_chunked(*a, chunk=64))(
        *[jnp.asarray(a) for a in args])
    ty, th = S._ssd_chunked(*[torch.from_numpy(a) for a in args], chunk=64)
    assert_f32(ty, jy)
    assert_f32(th, jh)


def test_mamba2_decode():
    jc, tc = configs("zamba2-2.7b", "float32")
    p = JS.init_mamba2(jax.random.PRNGKey(5), jc.d_model, jc.ssm_heads,
                       jc.ssm_state, jnp.float32)
    di = 2 * jc.d_model
    hd = di // jc.ssm_heads
    r = np.random.default_rng(9)
    ssm0 = r.normal(size=(2, jc.ssm_heads, hd, jc.ssm_state)).astype(
        np.float32)
    conv0 = r.normal(size=(2, 3, di + 2 * jc.ssm_state)).astype(np.float32)
    jst = JS.MambaState(jnp.asarray(ssm0), jnp.asarray(conv0))
    tst = S.MambaState(torch.from_numpy(ssm0), torch.from_numpy(conv0))
    tp = tensors(p)
    step = jax.jit(lambda x_, p_, s_: JS.mamba2_decode(x_, p_, jc, s_))
    for t in range(3):
        x = _x((2, 1, jc.d_model), 20 + t)
        jo, jst = step(jnp.asarray(x), p, jst)
        to, tst = S.mamba2_decode(torch.from_numpy(x), tp, tc, tst)
        assert_f32(to, jo)
        assert_f32(tst.ssm, jst.ssm)
        assert_f32(tst.conv, jst.conv)


@pytest.mark.parametrize("S_len", [64, 256])
def test_rwkv6_prefill(S_len):
    jc, tc = configs("rwkv6-1.6b", "float32")
    p = JS.init_rwkv6(jax.random.PRNGKey(11), jc.d_model, jc.n_heads,
                      jnp.float32)
    r = np.random.default_rng(12)
    p = dict(p, u=jnp.asarray(r.normal(size=p["u"].shape), jnp.float32),
             w0=jnp.asarray(r.normal(size=p["w0"].shape) - 3, jnp.float32))
    x = _x((2, S_len, jc.d_model), 13)
    assert_f32(S.rwkv6(torch.from_numpy(x), tensors(p), tc),
               jax.jit(lambda x_, p_: JS.rwkv6(x_, p_, jc))(
                   jnp.asarray(x), p))


def test_rwkv6_decode_and_channelmix():
    jc, tc = configs("rwkv6-1.6b", "float32")
    p = JS.init_rwkv6(jax.random.PRNGKey(11), jc.d_model, jc.n_heads,
                      jnp.float32)
    cm = JS.init_rwkv_channelmix(jax.random.PRNGKey(14), jc.d_model,
                                 jc.d_ff, jnp.float32)
    hd = jc.d_model // jc.n_heads
    r = np.random.default_rng(15)
    wkv0 = r.normal(size=(2, jc.n_heads, hd, hd)).astype(np.float32)
    last0 = r.normal(size=(2, jc.d_model)).astype(np.float32)
    jst = JS.RWKVState(jnp.asarray(wkv0), jnp.asarray(last0))
    tst = S.RWKVState(torch.from_numpy(wkv0), torch.from_numpy(last0))
    tp, tcm = tensors(p), tensors(cm)
    step = jax.jit(lambda x_, p_, s_: JS.rwkv6_decode(x_, p_, jc, s_))
    for t in range(3):
        x = _x((2, 1, jc.d_model), 30 + t)
        jo, jst = step(jnp.asarray(x), p, jst)
        to, tst = S.rwkv6_decode(torch.from_numpy(x), tp, tc, tst)
        assert_f32(to, jo)
        assert_f32(tst.wkv, jst.wkv)
        assert_f32(tst.last, jst.last)
    x, xp = _x((2, 5, jc.d_model), 40), _x((2, 5, jc.d_model), 41)
    assert_f32(S.rwkv_channelmix(torch.from_numpy(x), torch.from_numpy(xp),
                                 tcm),
               JS.rwkv_channelmix(jnp.asarray(x), jnp.asarray(xp), cm))


def test_params_from_jax_checks_the_tree():
    """Every weight of the model must come from the tree, with its shape
    and the reference's layer count; each keeps the model's dtype."""
    from repro.models import transformer as JT
    from repro_torch.models.convert import params_from_jax
    jc, tc = configs("zamba2-2.7b", "bfloat16")
    tree = npt(JT.init_params(jax.random.PRNGKey(0), jc))
    model = params_from_jax(tc, tree, device="cpu")
    sd = model.state_dict()
    assert sd["shared.attn.wq"].dtype == torch.bfloat16
    assert sd["blocks.1.mamba.A_log"].dtype == torch.float32
    np.testing.assert_array_equal(
        sd["blocks.1.mamba.in_proj"].float().numpy(),
        f32(tree["blocks"]["mamba"]["in_proj"][1]))
    short = dict(tree, blocks=dict(tree["blocks"]))
    short["blocks"]["ln"] = short["blocks"]["ln"][:1]
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(tc, short, device="cpu")
    with pytest.raises(KeyError, match="norm_f"):
        params_from_jax(tc, {k: v for k, v in tree.items()
                             if k != "norm_f"}, device="cpu")
    wide = dict(tree, norm_f=np.ones(tc.d_model + 1, np.float32))
    with pytest.raises(ValueError, match="norm_f"):
        params_from_jax(tc, wide, device="cpu")
