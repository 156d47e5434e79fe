"""The port's GatherM and AllGatherM against the reference, bit for bit.

Stage tests feed the same shard state to both implementations:
``allgather_merge`` over subsets of the dims, on two seeds, with
pad-word keys, ``gather_merge`` and ``allgather_merge_sort``.  End-to-end
tests compare ``psort(algorithm="gatherm")`` and ``"allgatherm"`` with
the reference's kernel-off run (AllGatherM's ``perm`` holds p·n entries,
every PE's copy).  All integers, so the tolerance is 0.
"""
import numpy as np
import pytest

from repro.core import gatherm as jg
from repro.core import hypercube as jh
from repro.core import types as jt
from repro.data.distributions import generate_instance
from repro_torch.core import gatherm as tg
from repro_torch.core import hypercube as th
from torch_helpers import (assert_shard, compare_psort, instances,
                           kernels_off, port_shard, run_sim, sorted_state)

pytestmark = pytest.mark.usefixtures(kernels_off.__name__)


@pytest.mark.parametrize("dims", [(0, 1, 2), (1,), (0, 2), (2, 1, 0)])
@pytest.mark.parametrize("seed", [11, 13])
@pytest.mark.parametrize("pad_keys", [False, True])
def test_allgather_merge_matches_reference(dims, seed, pad_keys):
    p, cap = 8, 6
    state = sorted_state(p, cap, seed, hi=4, pad_keys=pad_keys)

    def body(k, v, c):
        sh = jh.allgather_merge(jt.SortShard(k, {"idx": v}, c), "pe", p,
                                dims=dims)
        return sh.keys, sh.vals["idx"], sh.count
    rk, rv, rc = run_sim(p, body, *state)
    got = th.allgather_merge(port_shard(*state), p, dims=dims)
    assert got.capacity == cap << len(dims)
    assert_shard(got, rk, rv, rc)
    if pad_keys:                # a valid pad-word key precedes every pad
        assert (rk == 0xFFFFFFFF).sum() > (
            np.arange(rk.shape[1])[None] >= rc[:, None]).sum()


@pytest.mark.parametrize("fn", ["gather_merge", "allgather_merge_sort"])
@pytest.mark.parametrize("dims", [None, (0, 1)])
def test_gather_stages_match_reference(fn, dims):
    """Unsorted shards with ragged counts (an empty PE, a full one)."""
    p, cap = 8, 5
    state = sorted_state(p, cap, 12, hi=6, sort=False)

    def body(k, v, c):
        sh, ovf = getattr(jg, fn)(jt.SortShard(k, {"idx": v}, c), "pe", p,
                                  dims=dims)
        return sh.keys, sh.vals["idx"], sh.count, ovf
    rk, rv, rc, ro = run_sim(p, body, *state)
    got, ovf = getattr(tg, fn)(port_shard(*state), p, dims=dims)
    assert_shard(got, rk, rv, rc)
    assert np.array_equal(ovf.numpy(), np.broadcast_to(ro, (p,)))


@pytest.mark.parametrize("algorithm", ["gatherm", "allgatherm"])
@pytest.mark.parametrize("name", instances())
@pytest.mark.parametrize("p", [2, 4, 8])
def test_gather_psort_matches_reference(algorithm, name, p):
    n = 37 * p - 3
    x = generate_instance(name, p, n).astype(np.uint32)
    info = compare_psort(x, p, algorithm)
    assert info["overflow"] == 0
    counts = info["counts"].numpy()
    if algorithm == "gatherm":
        assert counts[0] == n and not counts[1:].any()
    else:
        assert (counts == n).all() and info["perm"].shape == (p * n,)


def test_gatherm_keyword_dims_matches_reference():
    """Gather over the low dims only: each 4-PE subcube's data on its
    lowest PE."""
    x = generate_instance("Uniform", 8, 8 * 37).astype(np.uint32)
    info = compare_psort(x, 8, "gatherm", dims=(0, 1))
    assert info["counts"].numpy().nonzero()[0].tolist() == [0, 4]
