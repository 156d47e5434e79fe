"""8-byte keys (int64, uint64, float64) on the port's in-core paths
against the reference's, bit for bit.

Every comparison here is with the reference's kernel-off run, never with
``np.sort``: the reference has behaviour of its own that the port keeps
(RQuick lifts a key ``u`` to ``u + 1`` in uint64, so the largest key wraps
to the −inf filler and comes back out of order).  Stage tests feed the
same shard state to both through ``shard_from_numpy`` with uint64 keys:
``merge_shards`` with pad-word keys, ``lift``/``unlift``, RQuick's split
point, SSort's destination map and RFIS's rank.  End to end, ``psort``
with the eight algorithms that take 8-byte keys: sorted keys, counts,
overflow and perm; ``rams`` and ``ntb-ams`` raise the reference's error.
All integers, so the tolerance is 0.
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
from repro.core import median as jm
from repro.core import psort as j_psort
from repro.core import rfis as jf
from repro.core import rquick as jq
from repro.core import types as jt
from repro.data.distributions import INSTANCES
from repro.kernels.partition import partition_buckets as j_partition
from repro_torch import SortConfig, psort
from repro_torch.core import median as tm
from repro_torch.core import rfis as tf
from repro_torch.core import rquick as tq
from repro_torch.core import samplesort as ts
from repro_torch.core import types as tt
from torch_helpers import (AXIS, PAD64, assert_shard, bits, compare_psort,
                           keys64, kernels_off, port_shard, run_sim,
                           sorted_state)

pytestmark = pytest.mark.usefixtures(kernels_off.__name__)
FLIP64 = np.uint64(1 << 63)
ALGORITHMS = ("rquick", "ntb-quick", "rfis", "ssort", "ns-ssort", "bitonic",
              "gatherm", "allgatherm")
N = 256                 # one n for every case, so the reference compiles
                        # once per (algorithm, p)


def _flipped(u):
    return torch.from_numpy((np.asarray(u, np.uint64) ^ FLIP64).view(
        np.int64))


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


@functools.cache
def _ref_merge(p, cap, tie):
    def body(ak, av, ac, bk, bv, bc):
        tie_a = {"a": True, "b": False,
                 "pe": jc.axis_index(AXIS) % 2 == 0}[tie]
        out, ovf = jt.merge_shards(jt.SortShard(ak, {"idx": av}, ac),
                                   jt.SortShard(bk, {"idx": bv}, bc),
                                   capacity=cap, tie_a_first=tie_a)
        return out.keys, out.vals["idx"], out.count, ovf
    return jax.jit(jc.sim_map(body, AXIS, p))


@pytest.mark.parametrize("tie", ["a", "b", "pe"])
@pytest.mark.parametrize("cap", [32, 20])
@pytest.mark.parametrize("hi", [6, 2 ** 64])
def test_merge_shards_of_8_byte_keys_matches_reference(tie, cap, hi):
    """Keys equal to the pad word 2^64 − 1 among the valid ones stay
    before every pad; 20 slots drop the largest keys (overflow)."""
    p = 8
    a = sorted_state(p, 16, 1, hi=hi, pad_keys=True, dtype=np.uint64)
    b = sorted_state(p, 16, 2, hi=hi, pad_keys=True, dtype=np.uint64)
    rk, rv, rc, ro = [np.asarray(t) for t in _ref_merge(p, cap, tie)(
        *[jnp.asarray(x) for x in (*a, *b)])]
    tie_a = {"a": True, "b": False, "pe": torch.arange(p) % 2 == 0}[tie]
    got, ovf = tt.merge_shards(port_shard(*a), port_shard(*b), capacity=cap,
                               tie_a_first=tie_a)
    assert_shard(got, rk, rv, rc)
    assert np.array_equal(ovf.numpy(), ro)
    assert (rk[np.arange(cap)[None] < rc[:, None]] == PAD64).any()


def test_lift_and_unlift_of_8_byte_keys_match_reference():
    """u + 1 in uint64: the largest key wraps to the −inf filler 0, and
    ``unlift`` wraps it back."""
    u = np.array([0, 1, 2 ** 32, 2 ** 63 - 1, 2 ** 63, PAD64 - 1, PAD64],
                 np.uint64)
    s = tt.key_to_int(torch.from_numpy(u.view(np.int64)).view(torch.uint64))
    lifted = tm.lift(s)
    want = np.asarray(jm.lift(jnp.asarray(u)))
    assert np.array_equal(lifted.numpy().view(np.uint64) ^ FLIP64, want)
    assert want[-1] == 0 and int(lifted[-1]) == tm.LO
    back = tm.unlift(lifted, torch.int64)
    assert back.dtype == torch.int64
    assert np.array_equal(bits(tt.int_to_key(back, torch.uint64)),
                          np.asarray(jm.unlift(jnp.asarray(want),
                                               jnp.uint64)))
    assert np.array_equal(bits(tt.int_to_key(back, torch.uint64)), u)


@pytest.mark.parametrize("tie_break", [True, False])
def test_split_point_of_8_byte_keys_matches_reference(tie_break):
    """Splitters lifted from the keys, the wrapped largest key (lifted 0)
    and the lifted 2^63 among them."""
    p, cap = 16, 40
    state = sorted_state(p, cap, 7, hi=2 ** 64, pad_keys=True,
                         dtype=np.uint64)
    g = np.random.default_rng(8)
    s = state[0][np.arange(p), g.integers(0, cap, size=p)] + np.uint64(1)
    s[:2] = [0, 2 ** 63 + 1]

    def body(k, v, c, sp):
        return jq._split_point(jt.SortShard(k, {"idx": v}, c), sp,
                               tie_break)
    want = run_sim(p, lambda *a: (body(*a),), *state, s)[0]
    got = tq._split_point(port_shard(*state), _flipped(s), tie_break)
    assert np.array_equal(got.numpy(), want)


def test_destinations_of_8_byte_keys_match_reference():
    """SSort's classify of u64 keys: the (hi, lo) planes of each key
    against u64 splitters drawn from the keys, the pad word among both."""
    p, cap = 16, 40
    keys, idx, count = sorted_state(p, cap, 43, hi=2 ** 64, pad_keys=True,
                                    dtype=np.uint64)
    g = np.random.default_rng(44)
    spl = np.sort(g.choice(keys.ravel(), p - 1))
    spl[-1] = PAD64
    want = []
    for k, c in zip(keys, count):
        k = jnp.asarray(k)
        s = jnp.asarray(spl)
        d, _, _ = j_partition(
            (k >> np.uint64(32)).astype(jnp.uint32), k.astype(jnp.uint32),
            (s >> np.uint64(32)).astype(jnp.uint32), s.astype(jnp.uint32),
            n_buckets=p, count=int(c), want_pos=False)
        want.append(np.asarray(d))
    got = ts._destinations(port_shard(keys, idx, count),
                           _flipped(spl).expand(p, p - 1))
    assert np.array_equal(got.numpy(), np.stack(want))


@pytest.mark.parametrize("p", [2, 8, 16])
@pytest.mark.parametrize("hi,pad_keys", [(1, False), (3, True),
                                         (2 ** 64, True)])
def test_rfis_rank_of_8_byte_keys_matches_reference(p, hi, pad_keys):
    """hi = 1: every key equal (Zero); hi = 3 with pad-word keys: a few
    values, each many times; the full range with the pad word 2^64 − 1."""
    state = sorted_state(p, 6, 21 + p, hi=hi, pad_keys=pad_keys, sort=False,
                         dtype=np.uint64)

    def body(k, v, c):
        r = jf.rfis_rank(jt.SortShard(k, {"idx": v}, c), AXIS, p)
        return r.row_data.keys, r.row_data.count, r.ranks, r.total
    rk, rc, rr, rt = run_sim(p, body, *state)
    got = tf.rfis_rank(port_shard(*state), p)
    assert np.array_equal(tt.shard_to_numpy(got.row_data)[0], rk)
    assert np.array_equal(got.row_data.count.numpy(), rc)
    assert np.array_equal(got.ranks.numpy(), rr)
    assert np.array_equal(got.total.numpy(), rt)


# ---------------------------------------------------------------------------
# psort end to end
# ---------------------------------------------------------------------------

# every instance at p = 4 for int64; Uniform, Zero and RandDupl for each
# dtype at p = 2, 4 and 8
_CASES = [(np.int64, 4, name) for name in sorted(INSTANCES)] + [
    (dtype, p, name) for dtype in (np.int64, np.uint64, np.float64)
    for p in (2, 4, 8) for name in ("Uniform", "Zero", "RandDupl")
    if (dtype, p) != (np.int64, 4)]


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("dtype,p,name", _CASES,
                         ids=[f"{d.__name__}-p{p}-{n}" for d, p, n in _CASES])
def test_psort_of_8_byte_keys_matches_reference(algorithm, dtype, p, name):
    """Keys, counts, overflow and perm equal the reference's, whatever it
    returns (SSort and NS-SSort overflow on Zero as it does)."""
    compare_psort(keys64(name, p, N, dtype), p, algorithm)


@pytest.mark.parametrize("dtype,top", [(np.uint64, PAD64),
                                       (np.int64, 2 ** 63 - 1)])
def test_rquick_missorts_the_largest_key_as_the_reference(dtype, top):
    """The reference's lift wraps the largest 8-byte key to the −inf
    filler, so RQuick returns it out of order; the port returns the same
    out-of-order output, and sorts the same keys without it."""
    g = np.random.default_rng(0)
    x = g.integers(0, 2 ** 64, size=256, dtype=np.uint64).view(dtype)
    x[17] = top
    compare_psort(x, 8, "rquick")
    got = psort(x, SortConfig(p=8, algorithm="rquick"),
                device="cpu").numpy()
    assert (got[1:] < got[:-1]).any()               # out of order
    x[17] = x[16]
    compare_psort(x, 8, "rquick")
    got = psort(x, SortConfig(p=8, algorithm="rquick"), device="cpu")
    assert np.array_equal(got.numpy(), np.sort(x))


@pytest.mark.parametrize("algorithm", ["rams", "ntb-ams"])
@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.float64])
def test_ams_family_refuses_8_byte_keys_as_the_reference(algorithm, dtype):
    x = keys64("Uniform", 4, 64, dtype)
    with pytest.raises(ValueError) as want:
        j_psort(x, config=JConfig(p=4, algorithm=algorithm, backend="sim"))
    with pytest.raises(ValueError) as got:
        psort(x, SortConfig(p=4, algorithm=algorithm), device="cpu")
    assert str(got.value) == str(want.value) == \
        "rams requires uint32 keys (use psort's transform)"
