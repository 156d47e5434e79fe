"""The port's threefry (``repro_torch.core.prng``) against ``jax.random``,
bit for bit, at the seeds, shapes and bounds of its call sites on the RAMS
path: the shuffle's destinations (``hypercube.alltoall_shuffle``) and the
level samples with a per-PE bound (``rams._rams_level``).

The reference runs with x64 on and ``jax_threefry_partitionable=True``;
the port reproduces exactly that layout, so the first test pins it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro_torch.core import prng

SEED = 0xA35                           # rams' default seed


def test_reference_uses_the_partitionable_x64_layout():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is True


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, SEED, SEED + 7919, SEED + 3 * 7919,
                                  2 ** 40 + 17, 2 ** 63 - 1])
def test_prngkey(seed):
    assert np.array_equal(prng.PRNGKey(seed).numpy(),
                          _np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 1, 5, 255, 2 ** 31 + 3, 2 ** 32 - 1])
def test_fold_in(data):
    k = jax.random.PRNGKey(SEED)
    assert np.array_equal(prng.fold_in(prng.PRNGKey(SEED), data).numpy(),
                          _np(jax.random.fold_in(k, data)))


def test_fold_in_batched_over_pes():
    p = 16
    got = prng.fold_in(prng.fold_in(prng.PRNGKey(SEED), torch.arange(p)), 1)
    for i in range(p):
        want = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(SEED), jnp.int32(i)), 1)
        assert np.array_equal(got[i].numpy(), _np(want))


@pytest.mark.parametrize("p,cap", [(4, 30), (8, 37), (64, 100), (256, 513)])
def test_randint_at_the_shuffle_call_site(p, cap):
    """dest = randint(fold_in(PRNGKey(seed), me), (cap,), 0, p)."""
    keys = prng.fold_in(prng.PRNGKey(SEED), torch.arange(p))
    got = prng.randint(keys, cap, 0, p).numpy()

    def one(me):
        k = jax.random.fold_in(jax.random.PRNGKey(SEED), me)
        return jax.random.randint(k, (cap,), 0, p)
    want = np.asarray(jax.vmap(one)(jnp.arange(p, dtype=jnp.int32)))
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("s_per", [1, 8, 33])
def test_randint_with_a_per_pe_bound(level, s_per):
    """pos = randint(fold_in(fold_in(PRNGKey(seed), me), 1), (s_per,), 0,
    max(count, 1)) — one bound per PE, including empty PEs."""
    p = 16
    count = np.array([0, 1, 2, 3, 7, 100, 1000, 2 ** 19, 2 ** 20 - 1, 5,
                      64, 65, 12345, 1, 0, 999_999], np.int64)
    seed = SEED + 7919 * (level + 1)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), torch.arange(p)), 1)
    got = prng.randint(keys, s_per, 0,
                       torch.clamp(torch.from_numpy(count), min=1)).numpy()

    def one(me, c):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                  me), 1)
        return jax.random.randint(k, (s_per,), 0, jnp.maximum(c, 1))
    want = np.asarray(jax.vmap(one)(jnp.arange(p, dtype=jnp.int32),
                                    jnp.asarray(count, jnp.int32)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 1), (3, 3), (5, 2), (-7, 9),
                                   (0, 2 ** 31 - 1)])
def test_randint_edge_bounds(lo, hi):
    k = jax.random.PRNGKey(11)
    got = prng.randint(prng.PRNGKey(11), 64, lo, hi).numpy()
    assert np.array_equal(got, np.asarray(jax.random.randint(k, (64,), lo,
                                                             hi)))


def test_randint_refuses_spans_it_cannot_reduce_exactly():
    with pytest.raises(ValueError, match="span"):
        prng.randint(prng.PRNGKey(0), 4, 0, 2 ** 31)


@pytest.mark.parametrize("p,cap,t", [(4, 30, 0), (16, 48, 3), (64, 1024, 5)])
def test_uniform_at_the_hypercube_shuffle_call_site(p, cap, t):
    """scores = uniform(fold_in(fold_in(PRNGKey(seed), t), me), (cap,)):
    float64 under x64, one row per PE."""
    seed = 0x5EED
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), t), torch.arange(p))
    got = prng.uniform(keys, cap).numpy()

    def one(me):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                  t), me)
        return jax.random.uniform(k, (cap,))
    want = np.asarray(jax.vmap(one)(jnp.arange(p, dtype=jnp.int32)))
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    assert 0.0 <= got.min() and got.max() < 1.0


@pytest.mark.parametrize("seed", [0, 7, 0x5EED])
def test_uniform_scalar_shape(seed):
    want = jax.random.uniform(jax.random.PRNGKey(seed))
    got = prng.uniform(prng.PRNGKey(seed))
    assert got.shape == () and np.asarray(want).shape == ()
    assert float(got) == float(want)


@pytest.mark.parametrize("it", range(0, 18, 3))
@pytest.mark.parametrize("seed", [0x5EED, 1, 2 ** 20 + 3])
def test_bernoulli_at_the_median_call_sites(seed, it):
    """The window coin bernoulli(PRNGKey(s)) and the splitter coin
    bernoulli(fold_in(PRNGKey(s), 1)), s = seed·1000003 + it (beyond
    2^32 for the default seed)."""
    s = seed * 1000003 + it
    k = jax.random.PRNGKey(s)
    assert bool(prng.bernoulli(prng.PRNGKey(s))) == bool(
        jax.random.bernoulli(k))
    assert bool(prng.bernoulli(prng.fold_in(prng.PRNGKey(s), 1))) == bool(
        jax.random.bernoulli(jax.random.fold_in(k, 1)))


def test_bernoulli_draws_from_the_float64_uniform():
    """200 seeds: the coin is the float64 draw's top bit, which the float32
    draw would not reproduce."""
    seeds = range(200)
    got = [bool(prng.bernoulli(prng.PRNGKey(s))) for s in seeds]
    want = [bool(jax.random.bernoulli(jax.random.PRNGKey(s))) for s in seeds]
    assert got == want
    assert 60 < sum(got) < 140
