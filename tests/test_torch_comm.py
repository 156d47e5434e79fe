"""The port's PE-batched collectives (``repro_torch.core.comm``) against the
reference's ``SimCollectives`` run through ``comm.sim_map``, on subcube
groups of size 1, 2, p/2 and p and on ungrouped calls.  Integer payloads,
so the results must be identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import comm as jc
from repro.core import hypercube as jh
from repro_torch.core import comm as tc
from repro_torch.core import hypercube as th

P = 8
AXIS = "pe"


def _groups(size):
    return None if size is None else jh.subcube_groups(P, size.bit_length()
                                                       - 1)


def _x(shape, seed, dtype=np.int64):
    g = np.random.default_rng(seed)
    return g.integers(-1000, 1000, size=(P,) + shape).astype(dtype)


GROUP_SIZES = [None, 1, 2, P // 2, P]


@pytest.mark.parametrize("gsize", GROUP_SIZES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_psum(gsize, dtype):
    x = _x((5,), 1, dtype)
    groups = _groups(gsize)
    want = jc.sim_map(lambda v: jc.psum(v, AXIS, axis_index_groups=groups),
                      AXIS, P)(jnp.asarray(x))
    got = tc.psum(torch.from_numpy(x), groups)
    assert got.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gsize", GROUP_SIZES)
@pytest.mark.parametrize("tiled", [True, False])
def test_all_gather(gsize, tiled):
    x = _x((3,), 2)
    groups = _groups(gsize)
    want = jc.sim_map(lambda v: jc.all_gather(v, AXIS,
                                              axis_index_groups=groups,
                                              tiled=tiled),
                      AXIS, P)(jnp.asarray(x))
    got = tc.all_gather(torch.from_numpy(x), groups, tiled=tiled)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gsize", GROUP_SIZES)
@pytest.mark.parametrize("trail", [(), (2,)])
def test_all_to_all(gsize, trail):
    g = P if gsize is None else gsize
    x = _x((g * 3,) + trail, 3)
    groups = _groups(gsize)
    want = jc.sim_map(lambda v: jc.all_to_all(v, AXIS, split_axis=0,
                                              concat_axis=0,
                                              axis_index_groups=groups,
                                              tiled=True),
                      AXIS, P)(jnp.asarray(x))
    got = tc.all_to_all(torch.from_numpy(x), groups)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("j", [0, 1, 2])
def test_xor_exchange(j):
    x = _x((4,), 4)
    want = jc.sim_map(lambda v: jh.hc_exchange(v, AXIS, P, j), AXIS,
                      P)(jnp.asarray(x))
    got = th.hc_exchange(torch.from_numpy(x), P, j)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the row swap is the reference's XOR permutation table
    assert torch.equal(got, tc.ppermute(torch.from_numpy(x),
                                        jh.xor_perm(P, j)))


def test_ppermute_rotation():
    x = _x((2,), 5)
    perm = [(i, (i + 3) % P) for i in range(P)]
    want = jc.sim_map(lambda v: jc.ppermute(v, AXIS, perm), AXIS,
                      P)(jnp.asarray(x))
    assert np.array_equal(tc.ppermute(torch.from_numpy(x), perm).numpy(),
                          np.asarray(want))


@pytest.mark.parametrize("dims", [[0], [0, 1], [0, 1, 2], [1, 2]])
def test_subcube_prefix_sum(dims):
    x = _x((6,), 6)
    want = jc.sim_map(lambda v: jh.subcube_prefix_sum(v, AXIS, P, dims),
                      AXIS, P)(jnp.asarray(x))
    prefix, total = th.subcube_prefix_sum(torch.from_numpy(x), P, dims)
    assert np.array_equal(prefix.numpy(), np.asarray(want[0]))
    assert np.array_equal(total.numpy(), np.asarray(want[1]))


def test_axis_index_and_groups():
    want = jc.sim_map(lambda v: jc.axis_index(AXIS) + 0 * v, AXIS,
                      P)(jnp.zeros(P, jnp.int32))
    assert np.array_equal(tc.axis_index(P).numpy(), np.asarray(want))
    assert th.subcube_groups(P, 2) == jh.subcube_groups(P, 2)


def test_bad_groups_are_refused():
    x = torch.zeros((P, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="equal-sized"):
        tc.psum(x, [[0, 1, 2], [3, 4], [5, 6, 7]])
    with pytest.raises(ValueError, match="partition"):
        tc.psum(x, [[0, 1, 2, 3], [0, 5, 6, 7]])
