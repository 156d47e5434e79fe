"""The port's key transforms and shard primitives (``repro_torch.core.types``)
against the reference's (``repro.core.types``), bit for bit.

Inputs are made with numpy from a seed and handed to both; the reference
runs one PE at a time under ``jax.vmap``, the port over all PEs at once.
Keys are compared in full, payloads only inside ``[0, count)`` (the
reference leaves pad payloads arbitrary).  Tolerance: none, integers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import types as jt
from repro_torch.core import types as tt

_U = {np.dtype(np.int32): np.uint32, np.dtype(np.uint32): np.uint32,
      np.dtype(np.float32): np.uint32, np.dtype(np.int64): np.uint64,
      np.dtype(np.uint64): np.uint64, np.dtype(np.float64): np.uint64}
_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.uint32): torch.uint32,
          np.dtype(np.float32): torch.float32,
          np.dtype(np.int64): torch.int64, np.dtype(np.uint64): torch.uint64,
          np.dtype(np.float64): torch.float64}


def _sample(dtype, n, seed):
    g = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = (g.standard_normal(n) * 1e6).astype(dt)
        x[:6] = [0.0, -0.0, np.inf, -np.inf, np.finfo(dt).max,
                 np.finfo(dt).min]
        return x
    info = np.iinfo(dt)
    x = g.integers(info.min, info.max, size=n, dtype=dt, endpoint=True)
    x[:3] = [info.min, info.max, 0]
    return x


def _to_unsigned(s: torch.Tensor) -> np.ndarray:
    """The reference's unsigned word of a port word (undo the sign flip)."""
    flip = -(1 << 31) if s.dtype == torch.int32 else -(1 << 63)
    a = (s ^ flip).numpy()
    return a.view(np.uint32 if s.dtype == torch.int32 else np.uint64)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32,
                                   np.int64, np.uint64, np.float64])
def test_key_transform_matches_reference(dtype):
    x = _sample(dtype, 4096, 1)
    ref = np.asarray(jt.key_to_uint(jnp.asarray(x)))
    s = tt.key_to_int(torch.from_numpy(x))
    assert np.array_equal(_to_unsigned(s), ref)
    back = tt.int_to_key(s, _TORCH[np.dtype(dtype)])
    u = _U[np.dtype(dtype)]
    got = back.view(torch.int32 if u == np.uint32 else torch.int64).numpy()
    assert np.array_equal(got.view(u), x.view(u))
    # signed order of the port word == unsigned order of the reference word
    order = np.argsort(s.numpy(), kind="stable")
    assert np.array_equal(order, np.argsort(ref, kind="stable"))


def test_int32_flipped_twice_is_the_input():
    x = _sample(np.int32, 1000, 2)
    s = tt.key_to_int(torch.from_numpy(x))
    assert np.array_equal(s.numpy(), x)


@pytest.mark.parametrize("dtype,ref", [(torch.int32, np.uint32),
                                       (torch.int64, np.uint64)])
def test_pad_value_is_the_flipped_all_ones_word(dtype, ref):
    pad = torch.tensor([tt.pad_value(dtype)], dtype=dtype)
    assert _to_unsigned(pad)[0] == jt.pad_value(ref)


def _ref_shards(keys_u32, counts, capacity, idx):
    """Reference make_shard, one PE at a time under vmap."""
    def one(k, c, v):
        sh = jt.make_shard(k, count=c, capacity=capacity, vals={"idx": v})
        return sh.keys, sh.vals["idx"], sh.count
    return [np.asarray(a) for a in jax.vmap(one)(
        jnp.asarray(keys_u32), jnp.asarray(counts, jnp.int32),
        jnp.asarray(idx))]


def _port_shard(keys_u32, counts, capacity, idx):
    k = torch.from_numpy(keys_u32.view(np.int32) ^ np.int32(-2 ** 31))
    return tt.make_shard(k, count=torch.as_tensor(counts), capacity=capacity,
                         vals={"idx": torch.from_numpy(idx.view(np.int32))})


def _assert_same(port: tt.SortShard, keys, vals, count):
    pk, pv, pc = tt.shard_to_numpy(port)
    assert np.array_equal(pk, keys)
    assert np.array_equal(pc, count)
    for i, c in enumerate(count):
        assert np.array_equal(pv["idx"][i, :c], vals[i, :c])


def _inputs(p, n, hi, seed):
    g = np.random.default_rng(seed)
    keys = g.integers(0, hi, size=(p, n), dtype=np.uint64).astype(np.uint32)
    keys[0, :3] = 0xFFFFFFFF                      # real keys equal to the pad
    idx = np.arange(p * n, dtype=np.uint32).reshape(p, n)
    counts = np.array([n, 0, 1, n // 2, n - 1, n, 3, n][:p], np.int64)
    return keys, idx, counts


@pytest.mark.parametrize("capacity", [None, 37, 64])
@pytest.mark.parametrize("hi", [5, 2 ** 32])
def test_make_shard_and_local_sort_match_reference(capacity, hi):
    keys, idx, counts = _inputs(8, 37, hi, 3)
    rk, rv, rc = _ref_shards(keys, counts, capacity, idx)
    _assert_same(_port_shard(keys, counts, capacity, idx), rk, rv, rc)


@pytest.mark.parametrize("new_cap", [20, 37, 50])
def test_resize_matches_reference(new_cap):
    keys, idx, counts = _inputs(8, 37, 100, 4)
    shard = _port_shard(keys, counts, None, idx)
    rk, rv, rc = _ref_shards(keys, counts, None, idx)

    def one(k, v, c):
        sh, ovf = jt.resize(jt.SortShard(k, {"idx": v}, c), new_cap)
        return sh.keys, sh.vals["idx"], sh.count, ovf
    ek, ev, ec, eo = [np.asarray(a) for a in jax.vmap(one)(
        jnp.asarray(rk), jnp.asarray(rv), jnp.asarray(rc))]
    got, ovf = tt.resize(shard, new_cap)
    _assert_same(got, ek, ev, ec)
    assert np.array_equal(ovf.numpy(), eo)


@pytest.mark.parametrize("seed", [5, 6])
def test_compact_matches_reference(seed):
    keys, idx, counts = _inputs(8, 37, 1000, seed)
    keep = np.random.default_rng(seed).random((8, 37)) < 0.5
    shard = _port_shard(keys, counts, None, idx)
    rk, rv, rc = _ref_shards(keys, counts, None, idx)

    def one(k, v, c, m):
        sh = jt.compact(jt.SortShard(k, {"idx": v}, c), m)
        return sh.keys, sh.vals["idx"], sh.count
    ek, ev, ec = [np.asarray(a) for a in jax.vmap(one)(
        jnp.asarray(rk), jnp.asarray(rv), jnp.asarray(rc), jnp.asarray(keep))]
    got = tt.compact(shard, torch.from_numpy(keep))
    _assert_same(got, ek, ev, ec)
    # compact keeps every payload: the full row is a permutation
    assert np.array_equal(np.sort(tt.shard_to_numpy(got)[1]["idx"], 1),
                          np.sort(tt.shard_to_numpy(shard)[1]["idx"], 1))


def test_local_sort_is_stable_with_duplicates_and_pad_keys():
    keys, idx, counts = _inputs(8, 200, 3, 7)
    shard = tt.SortShard(tt.key_to_int(torch.from_numpy(keys).view(
        torch.uint32)), {"idx": torch.from_numpy(idx.view(np.int32))},
        torch.as_tensor(counts))
    rk, rv, rc = _ref_shards(keys, counts, None, idx)
    _assert_same(tt.local_sort(shard), rk, rv, rc)


def test_shard_numpy_round_trip():
    keys, idx, counts = _inputs(8, 37, 2 ** 32, 8)
    sh = tt.shard_from_numpy(keys, {"idx": idx}, counts)
    k, v, c = tt.shard_to_numpy(sh)
    assert np.array_equal(k, keys) and np.array_equal(v["idx"], idx)
    assert np.array_equal(c, counts) and c.dtype == np.int32
    assert sh.keys.dtype == torch.int32 and sh.count.dtype == torch.int64


def test_local_sort_of_64_bit_keys_matches_reference():
    g = np.random.default_rng(9)
    keys = g.integers(0, 50, size=(4, 33), dtype=np.uint64)
    idx = np.arange(4 * 33, dtype=np.uint32).reshape(4, 33)
    counts = np.array([33, 0, 10, 32], np.int32)

    def one(k, v, c):
        sh = jt.make_shard(k, count=c, vals={"idx": v})
        return sh.keys, sh.vals["idx"]
    rk, rv = [np.asarray(a) for a in jax.vmap(one)(
        jnp.asarray(keys), jnp.asarray(idx), jnp.asarray(counts))]
    got = tt.make_shard(torch.from_numpy(keys.view(np.int64)).view(
        torch.uint64), count=torch.as_tensor(counts),
        vals={"idx": torch.from_numpy(idx.view(np.int32))})
    assert got.keys.dtype == torch.int64
    assert np.array_equal(_to_unsigned(got.keys), rk)
    for i, c in enumerate(counts):
        assert np.array_equal(got.vals["idx"][i, :c].numpy().view(np.uint32),
                              rv[i, :c])
