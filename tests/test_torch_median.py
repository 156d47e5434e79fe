"""The port's median windows (``repro_torch.core.median``) against the
reference's (``repro.core.median``), bit for bit.

Lifted words are uint64 in the reference and sign-flipped int64 in the
port; ``_lifted`` maps the port's back.  Shard states are made with numpy
from a seed and fed to both through ``shard_from_numpy``; the reference
runs per PE under ``comm.sim_map``.  Everything compared is an integer,
so the tolerance is 0.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import comm as jc
from repro.core import median as jm
from repro.core import types as jt
from repro_torch.core import median as tm
from repro_torch.core import types as tt

AXIS = "pe"
SEED = 0x5EED
PAD = 0xFFFFFFFF
FLIP64 = np.uint64(1 << 63)


def _lifted(t: torch.Tensor) -> np.ndarray:
    """The port's lifted int64 words as the reference's uint64."""
    return t.numpy().view(np.uint64) ^ FLIP64


def _state(p, cap, seed, hi=2 ** 32, counts=None):
    """Sorted padded shards (keys u32, counts) with the extreme keys 0 and
    0xFFFFFFFF among the valid ones, counts 0, 1, odd, even and full."""
    g = np.random.default_rng(seed)
    if counts is None:
        counts = g.integers(0, cap + 1, size=p)
        counts[:4] = [0, 1, cap, cap - 1]
    keys = g.integers(0, hi, size=(p, cap), dtype=np.uint64)
    keys[:, :2] = [0, PAD]
    keys = np.sort(keys.astype(np.uint32), axis=1)
    keys = np.where(np.arange(cap)[None] < counts[:, None], keys,
                    np.uint32(PAD))
    return keys, np.asarray(counts, np.int32)


def _port_shard(keys, counts):
    return tt.shard_from_numpy(keys, {}, counts)


def test_lift_and_unlift():
    u = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, PAD - 1, PAD], np.uint32)
    s = tt.key_to_int(torch.from_numpy(u.view(np.int32)).view(torch.uint32))
    lifted = tm.lift(s)
    assert np.array_equal(_lifted(lifted), np.asarray(jm.lift(jnp.asarray(u))))
    back = tt.int_to_key(tm.unlift(lifted), torch.uint32)
    assert np.array_equal(back.view(torch.int32).numpy().view(np.uint32), u)
    fill = np.array([0, 2 ** 64 - 1], np.uint64)
    want = np.asarray(jm.unlift(jnp.asarray(fill), jnp.uint32))
    got = tm.unlift(torch.tensor([tm.LO, tm.HI]))
    assert np.array_equal(tt.int_to_key(got, torch.uint32).view(
        torch.int32).numpy().view(np.uint32), want)


@functools.cache
def _ref_window(p, k, coin):
    def body(keys, count):
        return jm.local_window(jt.SortShard(keys, {}, count), k,
                               jnp.int32(coin))
    return jax.jit(jc.sim_map(body, AXIS, p))


@pytest.mark.parametrize("k", [2, 16])
@pytest.mark.parametrize("coin", [0, 1])
@pytest.mark.parametrize("cap", [8, 33])
def test_local_window(k, coin, cap):
    p = 16
    keys, counts = _state(p, cap, cap + k)
    want = np.asarray(_ref_window(p, k, coin)(jnp.asarray(keys),
                                              jnp.asarray(counts)))
    got = tm.local_window(_port_shard(keys, counts), k, coin)
    assert np.array_equal(_lifted(got), want)


def test_merge_windows():
    p, k = 16, 16
    g = np.random.default_rng(3)
    a = np.sort(g.integers(0, 50, size=(p, k)).astype(np.uint64), axis=1)
    b = np.sort(g.integers(0, 50, size=(p, k)).astype(np.uint64), axis=1)
    a[:, :3], b[:, -3:] = 0, 2 ** 64 - 1              # the fillers
    want = np.asarray(jax.vmap(jm.merge_windows)(jnp.asarray(a),
                                                 jnp.asarray(b)))

    def port(w):
        return torch.from_numpy((w ^ FLIP64).view(np.int64))
    got = tm.merge_windows(port(a), port(b))
    assert np.array_equal(_lifted(got), want)


@functools.cache
def _ref_splitter(p, sub_dims, k, seed):
    def body(keys, count):
        w = jm.butterfly_median_window(jt.SortShard(keys, {}, count), AXIS,
                                       p, list(sub_dims), k, seed=seed)
        s, empty = jm.splitter_from_window(w, seed=seed)
        return w, s, empty
    return jax.jit(jc.sim_map(body, AXIS, p))


@pytest.mark.parametrize("hi", [3, 2 ** 32])
def test_window_and_splitter_per_iteration(hi):
    """The butterfly window and the splitter of every RQuick iteration:
    iteration ``it`` works on dimension j = d−1−it over the subcube of
    dimensions 0..j, with seed ``seed·1000003 + it``.  PEs 8–11 are empty,
    so at j = 1 one subcube has no elements and its window is filler."""
    p, cap, k = 16, 24, 16
    counts = np.random.default_rng(5).integers(0, cap + 1, size=p)
    counts[8:12] = 0
    keys, counts = _state(p, cap, 6, hi=hi, counts=counts)
    shard = _port_shard(keys, counts)
    d = p.bit_length() - 1
    empties = 0
    for it, j in enumerate(range(d - 1, -1, -1)):
        sub_dims = tuple(range(j + 1))
        seed = SEED * 1000003 + it
        w, s, empty = [np.asarray(a) for a in _ref_splitter(
            p, sub_dims, k, seed)(jnp.asarray(keys), jnp.asarray(counts))]
        got_w = tm.butterfly_median_window(shard, p, sub_dims, k, seed)
        got_s, got_e = tm.splitter_from_window(got_w, seed)
        assert np.array_equal(_lifted(got_w), w), it
        assert np.array_equal(_lifted(got_s), s), it
        assert np.array_equal(got_e.numpy(), empty), it
        empties += int(empty.sum())
    assert empties > 0                            # the empty branch ran
