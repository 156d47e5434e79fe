"""Shared pieces of the port's differential tests (``test_torch_*.py``):
shard states made with numpy and carried across to both implementations,
the reference's per-PE functions run over the sim backend, and ``psort``
compared with the reference's kernel-off run bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import SortConfig as JConfig
from repro.core import comm as jc
from repro.core import psort as j_psort
from repro.core import types as jt
from repro.data.distributions import INSTANCES, generate_instance
from repro_torch import SortConfig, psort
from repro_torch.core import types as tt

AXIS = "pe"
PAD = 0xFFFFFFFF
PAD64 = 0xFFFFFFFFFFFFFFFF
# the fast lane's instances (as ``tests/test_differential.py``): duplicate
# heavy (Zero, g-Group) and skewed (Staggered); the others run as ``slow``
CORE_INSTANCES = ("Uniform", "Zero", "g-Group", "Staggered")


def instances():
    """Every instance of the paper, the non-core ones marked ``slow``."""
    return [pytest.param(name, marks=() if name in CORE_INSTANCES
                         else pytest.mark.slow) for name in sorted(INSTANCES)]


def sorted_state(p, cap, seed, hi=1000, pad_keys=False, counts=None,
                 sort=True, dtype=np.uint32):
    """(keys, idx u32, counts) of p padded shards: keys of ``dtype``
    (uint32, or uint64 for 8-byte keys) in [0, hi), some equal to the pad
    word when ``pad_keys``, sorted per PE when ``sort``; counts random in
    [0, cap] with the edges 0, 1 and cap."""
    g = np.random.default_rng(seed)
    if counts is None:
        counts = g.integers(0, cap + 1, size=p)
        counts[:3] = [0, 1, cap][:p]
    if dtype == np.uint64:
        keys = g.integers(0, hi, size=(p, cap), dtype=np.uint64)
        pad = np.uint64(PAD64)
    else:
        keys = g.integers(0, hi, size=(p, cap)).astype(np.uint32)
        pad = np.uint32(PAD)
    if pad_keys:
        keys[g.random((p, cap)) < 0.2] = pad
    if sort:
        keys.sort(axis=1)
    col = np.arange(cap)[None, :]
    keys = np.where(col < counts[:, None], keys, pad).astype(dtype)
    idx = g.integers(0, 2 ** 32, size=(p, cap)).astype(np.uint32)
    return keys, idx, np.asarray(counts, np.int32)


def keys64(name, p, n, dtype):
    """The instance ``name`` as 8-byte keys of ``dtype`` with the same
    order and ties: the u32 word u as the u64 ``u << 32 | u`` (the full
    range; int64 views those bits), or the float64 ``(u − 2^31) · 0.37``."""
    u = generate_instance(name, p, n).astype(np.uint64)
    if dtype == np.float64:
        return (u.astype(np.float64) - 2.0 ** 31) * 0.37
    return ((u << np.uint64(32)) | u).view(dtype)


def bits(x):
    """Keys (numpy or torch, any key dtype) as numpy unsigned words of
    their width, to compare bit for bit."""
    if isinstance(x, torch.Tensor):
        signed = {1: torch.int8, 4: torch.int32, 8: torch.int64}[
            x.element_size()]
        x = x.view(signed).numpy()
    x = np.asarray(x)
    return x.view({4: np.uint32, 8: np.uint64}[x.itemsize])


def port_shard(keys, vals, count):
    """The port's shard of a numpy state; ``vals`` a dict or the idx
    plane."""
    vals = vals if isinstance(vals, dict) else {"idx": vals}
    return tt.shard_from_numpy(keys, vals, count)


def run_sim(p, body, *arrays):
    """The reference's per-PE ``body`` over p PEs on numpy inputs."""
    out = jax.jit(jc.sim_map(body, AXIS, p))(*[jnp.asarray(a)
                                               for a in arrays])
    return [np.asarray(a) for a in out]


def assert_shard(port, keys, vals, count):
    """Keys and counts in full, each payload inside ``[0, count)``."""
    pk, pv, pc = tt.shard_to_numpy(port)
    assert np.array_equal(pc, count)
    assert np.array_equal(pk, keys)
    vals = vals if isinstance(vals, dict) else {"idx": vals}
    assert sorted(pv) == sorted(vals)
    for name, v in vals.items():
        for i, c in enumerate(count):
            assert np.array_equal(pv[name][i, :c], v[i, :c]), (name, i)


def compare_psort(x, p, algorithm, levels=None, **algo_kw):
    """``psort`` of the port on the CPU against the reference's kernel-off
    sim run: sorted keys, counts, overflow, perm, balance, n."""
    want, wi = j_psort(x, config=JConfig(p=p, algorithm=algorithm,
                                         backend="sim", levels=levels,
                                         algo_kw=algo_kw),
                       return_info=True)
    got, gi = psort(x, SortConfig(p=p, algorithm=algorithm, levels=levels,
                                  algo_kw=algo_kw),
                    return_info=True, device="cpu")
    want = np.asarray(want)
    assert want.dtype == np.asarray(x).dtype
    assert str(got.dtype) == f"torch.{want.dtype}"
    assert np.array_equal(bits(got), bits(want))
    assert np.array_equal(gi["counts"].numpy(), np.asarray(wi["counts"]))
    assert gi["overflow"] == wi["overflow"]
    assert np.array_equal(gi["perm"].numpy(),
                          np.asarray(wi["perm"]).astype(np.int64))
    assert gi["balance"] == float(wi["balance"])
    assert gi["n"] == wi["n"]
    assert gi["algorithm"] == wi["algorithm"] == algorithm
    return gi


@pytest.fixture
def kernels_off():
    """The reference with its Pallas kernels off (its CPU default)."""
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)
