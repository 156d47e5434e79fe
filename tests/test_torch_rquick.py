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
from repro_torch.core.median import planes
from repro_torch.core import rquick as tq
from repro_torch.core import types as tt
from torch_helpers import (AXIS, PAD, assert_shard, compare_psort,
                           kernels_off, port_shard, sorted_state)

SEED = 0x5EED                      # rquick's default seed
pytestmark = pytest.mark.usefixtures(kernels_off.__name__)


def _jshard(k, v, c):
    return jt.SortShard(k, {"idx": v}, c)


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
    a = sorted_state(p, ca, 1, hi=6, pad_keys=pad_keys)
    b = sorted_state(p, cb, 2, hi=6, pad_keys=pad_keys)
    rk, rv, rc, ro = _run(_ref_merge(p, cap, tie), *a, *b)
    tie_a = {"a": True, "b": False,
             "pe": torch.arange(p) % 2 == 0}[tie]
    got, ovf = tt.merge_shards(port_shard(*a), port_shard(*b), capacity=cap,
                               tie_a_first=tie_a)
    assert_shard(got, rk, rv, rc)
    assert np.array_equal(ovf.numpy(), ro)
    if cap < ca + cb:
        assert ro.sum() > 0                       # the overflow path ran
    if pad_keys:                # a valid pad-word key precedes every pad
        assert (rk == PAD).sum() > (np.arange(cap)[None] >= rc[:, None]).sum()


def test_merge_shards_refuses_8_byte_words():
    """It refused them until 8-byte keys were ported; now int64 words merge
    as the reference's u64 keys do, pad-word keys and both tie orders
    included (``test_torch_keys64.py`` holds the whole grid)."""
    p, cap = 8, 24
    a = sorted_state(p, 16, 1, hi=6, pad_keys=True, dtype=np.uint64)
    b = sorted_state(p, 16, 2, hi=6, pad_keys=True, dtype=np.uint64)
    rk, rv, rc, ro = _run(_ref_merge(p, cap, "b"), *a, *b)
    got, ovf = tt.merge_shards(port_shard(*a), port_shard(*b), capacity=cap,
                               tie_a_first=False)
    assert got.keys.dtype == torch.int64
    assert_shard(got, rk, rv, rc)
    assert np.array_equal(ovf.numpy(), ro)


# ---------------------------------------------------------------------------
# hypercube machinery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("j", [0, 1, 3])
def test_exchange_shard_and_butterfly_sum(j):
    p, cap = 16, 12
    state = sorted_state(p, cap, 3 + j)

    def body(k, v, c):
        sh = jh.exchange_shard(_jshard(k, v, c), AXIS, p, j)
        return (sh.keys, sh.vals["idx"], sh.count,
                jh.butterfly_sum(c, AXIS, p, list(range(j + 1))))
    rk, rv, rc, rs = _run(jax.jit(jc.sim_map(body, AXIS, p)), *state)
    got = th.exchange_shard(port_shard(*state), p, j)
    assert_shard(got, rk, rv, rc)
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
        got, ovf = th.hypercube_shuffle(port_shard(*state), p, SEED,
                                        dims=list(range(t + 1)))
        assert_shard(got, rk, rv, rc)
        assert np.array_equal(ovf.numpy(), ro)


@pytest.mark.parametrize("tie_break", [True, False])
@pytest.mark.parametrize("hi", [4, 1000, 2 ** 32])
def test_split_point_matches_reference(tie_break, hi):
    """Splitters from the keys themselves (so equal keys meet the
    splitter), the lifted top key 2^32 among them."""
    p, cap = 16, 40
    state = sorted_state(p, cap, 7, hi=min(hi, 2 ** 32 - 1),
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
    got = tq._split_point(port_shard(*state), s_port, tie_break)
    assert np.array_equal(got.numpy(), want)


def test_planes_of_lifted_words():
    """The key plane orders like the lifted hi word, the tie plane holds
    the lo word's bits: lifted 1, 2^31, 2^32 and the ±inf fillers."""
    lifted = np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1],
                      np.uint64)
    key, tie = planes(torch.from_numpy(
        (lifted ^ np.uint64(1 << 63)).view(np.int64)))
    hi = (lifted >> np.uint64(32)).astype(np.uint32)
    lo = lifted.astype(np.uint32)
    assert np.array_equal(key.numpy().view(np.uint32) ^ np.uint32(1 << 31),
                          hi)
    assert np.array_equal(tie.numpy().view(np.uint32), lo)


# ---------------------------------------------------------------------------
# psort end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(INSTANCES))
@pytest.mark.parametrize("p", [2, 4, 8])
def test_rquick_psort_matches_reference_on_every_instance(name, p):
    x = generate_instance(name, p, p * 100 - 3).astype(np.uint32)
    compare_psort(x, p, "rquick")


def test_rquick_psort_matches_reference_at_p64():
    x = generate_instance("Uniform", 64, 64 * 64 + 5).astype(np.uint32)
    info = compare_psort(x, 64, "rquick")
    assert info["overflow"] == 0


@pytest.mark.parametrize("name,overflows", [("Uniform", False),
                                            ("Zero", True)])
def test_ntb_quick_matches_reference(name, overflows):
    """Without tie-breaking every duplicate of the splitter goes one way:
    on Zero the shards overflow, and the port drops exactly the keys the
    reference drops."""
    x = generate_instance(name, 8, 8 * 100 - 3).astype(np.uint32)
    info = compare_psort(x, 8, "ntb-quick")
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
    with pytest.raises(NotImplementedError, match="item 3"):
        SortConfig(p=8, algorithm="auto")
