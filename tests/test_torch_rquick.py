"""The port's RQuick path against the reference, bit for bit.

Stage tests feed the same shard state to both implementations through the
carry-across functions (``shard_from_numpy`` / ``shard_to_numpy``):
``merge_shards`` (both tie orders, per-PE tie flags, pad-word keys,
overflow), the XOR exchange and butterfly sum, ``hypercube_shuffle``
after each dimension and ``_split_point`` with and without tie-breaking.
End-to-end tests compare ``psort(algorithm="rquick")`` and ``"ntb-quick"``
with the reference's kernel-off run: sorted keys, per-PE counts, overflow
and perm, all integers, so the tolerance is 0.  Keys are compared in
full, payloads only inside ``[0, count)``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import SortConfig as JConfig
from repro.core import comm as jc
from repro.core import hypercube as jh
from repro.core import psort as j_psort
from repro.core import rquick as jq
from repro.core import types as jt
from repro.data.distributions import INSTANCES, generate_instance
from repro_torch import SortConfig, psort
from repro_torch.core import hypercube as th
from repro_torch.core import rquick as tq
from repro_torch.core import types as tt

AXIS = "pe"
SEED = 0x5EED                      # rquick's default seed
PAD = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _sorted_state(p, cap, seed, hi=1000, pad_keys=False, counts=None):
    """(keys u32, idx u32, counts) of p sorted padded shards: keys in
    [0, hi), some equal to the pad word when ``pad_keys``; counts random
    in [0, cap] with the edges 0, 1 and cap."""
    g = np.random.default_rng(seed)
    if counts is None:
        counts = g.integers(0, cap + 1, size=p)
        counts[:3] = [0, 1, cap][:p]
    keys = g.integers(0, hi, size=(p, cap)).astype(np.uint32)
    if pad_keys:
        keys[g.random((p, cap)) < 0.2] = PAD
    keys.sort(axis=1)
    col = np.arange(cap)[None, :]
    keys = np.where(col < counts[:, None], keys, np.uint32(PAD))
    idx = g.integers(0, 2 ** 32, size=(p, cap)).astype(np.uint32)
    return keys.astype(np.uint32), idx, np.asarray(counts, np.int32)


def _jshard(k, v, c):
    return jt.SortShard(k, {"idx": v}, c)


def _assert_shard(port, keys, vals, count):
    pk, pv, pc = tt.shard_to_numpy(port)
    assert np.array_equal(pc, count)
    assert np.array_equal(pk, keys)
    for i, c in enumerate(count):
        assert np.array_equal(pv["idx"][i, :c], vals[i, :c]), i


def _port(state):
    return tt.shard_from_numpy(state[0], {"idx": state[1]}, state[2])


def _run(fn, *arrays):
    return [np.asarray(a) for a in fn(*[jnp.asarray(a) for a in arrays])]


# ---------------------------------------------------------------------------
# merge_shards
# ---------------------------------------------------------------------------


@functools.cache
def _ref_merge(p, cap, tie):
    def body(ak, av, ac, bk, bv, bc):
        me = jc.axis_index(AXIS)
        tie_a = {"a": True, "b": False, "pe": me % 2 == 0}[tie]
        out, ovf = jt.merge_shards(_jshard(ak, av, ac), _jshard(bk, bv, bc),
                                   capacity=cap, tie_a_first=tie_a)
        return out.keys, out.vals["idx"], out.count, ovf
    return jax.jit(jc.sim_map(body, AXIS, p))


@pytest.mark.parametrize("tie", ["a", "b", "pe"])
@pytest.mark.parametrize("ca,cb,cap", [(16, 16, 32), (16, 24, 40),
                                       (16, 16, 20), (12, 20, 48)])
@pytest.mark.parametrize("pad_keys", [False, True])
def test_merge_shards_matches_reference(tie, ca, cb, cap, pad_keys):
    p = 8
    a = _sorted_state(p, ca, 1, hi=6, pad_keys=pad_keys)
    b = _sorted_state(p, cb, 2, hi=6, pad_keys=pad_keys)
    rk, rv, rc, ro = _run(_ref_merge(p, cap, tie), *a, *b)
    tie_a = {"a": True, "b": False,
             "pe": torch.arange(p) % 2 == 0}[tie]
    got, ovf = tt.merge_shards(_port(a), _port(b), capacity=cap,
                               tie_a_first=tie_a)
    _assert_shard(got, rk, rv, rc)
    assert np.array_equal(ovf.numpy(), ro)
    if cap < ca + cb:
        assert ro.sum() > 0                       # the overflow path ran
    if pad_keys:                # a valid pad-word key precedes every pad
        assert (rk == PAD).sum() > (np.arange(cap)[None] >= rc[:, None]).sum()


def test_merge_shards_refuses_8_byte_words():
    sh = tt.SortShard(torch.zeros((2, 4), dtype=torch.int64), {},
                      torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError, match="int32"):
        tt.merge_shards(sh, sh)


# ---------------------------------------------------------------------------
# hypercube machinery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("j", [0, 1, 3])
def test_exchange_shard_and_butterfly_sum(j):
    p, cap = 16, 12
    state = _sorted_state(p, cap, 3 + j)

    def body(k, v, c):
        sh = jh.exchange_shard(_jshard(k, v, c), AXIS, p, j)
        return (sh.keys, sh.vals["idx"], sh.count,
                jh.butterfly_sum(c, AXIS, p, list(range(j + 1))))
    rk, rv, rc, rs = _run(jax.jit(jc.sim_map(body, AXIS, p)), *state)
    got = th.exchange_shard(_port(state), p, j)
    _assert_shard(got, rk, rv, rc)
    s = th.butterfly_sum(torch.from_numpy(state[2].astype(np.int64)), p,
                         list(range(j + 1)))
    assert np.array_equal(s.numpy(), rs)


@functools.cache
def _ref_shuffle(p, t):
    def body(k, v, c):
        sh, ovf = jh.hypercube_shuffle(_jshard(k, v, c), AXIS, p, SEED,
                                       dims=list(range(t + 1)))
        return sh.keys, sh.vals["idx"], sh.count, ovf
    return jax.jit(jc.sim_map(body, AXIS, p))


@pytest.mark.parametrize("name", ["Uniform", "Zero", "AllToOne"])
def test_hypercube_shuffle_after_each_dimension(name):
    """The shard after dimensions 0..t of the shuffle, t = 0 … d−1, with
    ragged counts (an empty PE, a full one)."""
    p, per = 16, 24
    cap = 2 * per
    x = generate_instance(name, p, p * per).astype(np.uint32)
    counts = np.full(p, per, np.int32)
    counts[[0, 5]] = [0, 7]
    keys = np.full((p, cap), PAD, np.uint32)
    keys[:, :per] = np.sort(x.reshape(p, per), axis=1)
    keys = np.where(np.arange(cap)[None] < counts[:, None], keys,
                    np.uint32(PAD))
    keys.sort(axis=1)
    idx = np.arange(p * cap, dtype=np.uint32).reshape(p, cap)
    state = (keys, idx, counts)
    for t in range(p.bit_length() - 1):
        rk, rv, rc, ro = _run(_ref_shuffle(p, t), *state)
        got, ovf = th.hypercube_shuffle(_port(state), p, SEED,
                                        dims=list(range(t + 1)))
        _assert_shard(got, rk, rv, rc)
        assert np.array_equal(ovf.numpy(), ro)


@pytest.mark.parametrize("tie_break", [True, False])
@pytest.mark.parametrize("hi", [4, 1000, 2 ** 32])
def test_split_point_matches_reference(tie_break, hi):
    """Splitters from the keys themselves (so equal keys meet the
    splitter), the lifted top key 2^32 among them."""
    p, cap = 16, 40
    state = _sorted_state(p, cap, 7, hi=min(hi, 2 ** 32 - 1),
                          pad_keys=hi == 2 ** 32)
    g = np.random.default_rng(8)
    pick = g.integers(0, cap, size=p)
    s = state[0][np.arange(p), pick].astype(np.uint64) + np.uint64(1)
    s[0] = np.uint64(2 ** 32)                     # lifted 0xFFFFFFFF

    def body(k, v, c, sp):
        return jq._split_point(_jshard(k, v, c), sp, tie_break)
    want = np.asarray(jax.jit(jc.sim_map(body, AXIS, p))(
        *[jnp.asarray(a) for a in state], jnp.asarray(s)))
    s_port = torch.from_numpy((s ^ np.uint64(1 << 63)).view(np.int64))
    got = tq._split_point(_port(state), s_port, tie_break)
    assert np.array_equal(got.numpy(), want)


def test_planes_of_lifted_words():
    """The key plane orders like the lifted hi word, the tie plane holds
    the lo word's bits: lifted 1, 2^31, 2^32 and the ±inf fillers."""
    lifted = np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1],
                      np.uint64)
    key, tie = tq._planes(torch.from_numpy(
        (lifted ^ np.uint64(1 << 63)).view(np.int64)))
    hi = (lifted >> np.uint64(32)).astype(np.uint32)
    lo = lifted.astype(np.uint32)
    assert np.array_equal(key.numpy().view(np.uint32) ^ np.uint32(1 << 31),
                          hi)
    assert np.array_equal(tie.numpy().view(np.uint32), lo)


# ---------------------------------------------------------------------------
# psort end to end
# ---------------------------------------------------------------------------


def _compare_psort(x, p, algorithm="rquick"):
    want, wi = j_psort(x, config=JConfig(p=p, algorithm=algorithm,
                                         backend="sim"), return_info=True)
    got, gi = psort(x, SortConfig(p=p, algorithm=algorithm),
                    return_info=True, device="cpu")
    want = np.asarray(want)
    assert got.dtype == torch.uint32 and want.dtype == np.uint32
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32), want)
    assert np.array_equal(gi["counts"].numpy(), np.asarray(wi["counts"]))
    assert gi["overflow"] == wi["overflow"]
    assert np.array_equal(gi["perm"].numpy(),
                          np.asarray(wi["perm"]).astype(np.int64))
    assert gi["balance"] == float(wi["balance"])
    assert gi["n"] == wi["n"]
    assert gi["algorithm"] == wi["algorithm"] == algorithm
    return gi


@pytest.mark.parametrize("name", sorted(INSTANCES))
@pytest.mark.parametrize("p", [2, 4, 8])
def test_rquick_psort_matches_reference_on_every_instance(name, p):
    x = generate_instance(name, p, p * 100 - 3).astype(np.uint32)
    _compare_psort(x, p)


def test_rquick_psort_matches_reference_at_p64():
    x = generate_instance("Uniform", 64, 64 * 64 + 5).astype(np.uint32)
    info = _compare_psort(x, 64)
    assert info["overflow"] == 0


@pytest.mark.parametrize("name,overflows", [("Uniform", False),
                                            ("Zero", True)])
def test_ntb_quick_matches_reference(name, overflows):
    """Without tie-breaking every duplicate of the splitter goes one way:
    on Zero the shards overflow, and the port drops exactly the keys the
    reference drops."""
    x = generate_instance(name, 8, 8 * 100 - 3).astype(np.uint32)
    info = _compare_psort(x, 8, "ntb-quick")
    assert (info["overflow"] > 0) == overflows


def test_rquick_keywords():
    kw = {"window_k": 8, "dims": [0, 1, 2], "seed": 3}
    cfg = SortConfig(p=8, algorithm="rquick", algo_kw=kw)
    assert dict(cfg.algo_kw)["dims"] == (0, 1, 2)
    with pytest.raises(ValueError, match="unknown RQUICK keywords"):
        SortConfig(p=8, algorithm="rquick", algo_kw={"levels": 2})
    x = generate_instance("Uniform", 8, 797).astype(np.uint32)
    want = j_psort(x, config=JConfig(p=8, algorithm="rquick", backend="sim",
                                     algo_kw=kw))
    got = psort(x, cfg, device="cpu")
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                          np.asarray(want))


def test_unported_algorithms_still_raise():
    with pytest.raises(NotImplementedError, match="item 7"):
        SortConfig(p=8, algorithm="ssort")
