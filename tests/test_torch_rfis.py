"""The port's RFIS against the reference, bit for bit.

Stage tests: ``rfis_rank`` (the gathered row, every element's global rank
and the total) on duplicate-heavy keys, the key 0xFFFFFFFF among them,
where the port's one ``searchsorted`` on (key, origin row, local index)
composites replaces the reference's (Nr, Nc) compare matrix; and
``route_by_target``, with and without overflow.  End-to-end tests compare
``psort(algorithm="rfis")`` with the reference's kernel-off run.  All
integers, so the tolerance is 0.
"""
import numpy as np
import pytest
import torch

from repro.core import hypercube as jh
from repro.core import rfis as jf
from repro.core import types as jt
from repro.data.distributions import generate_instance
from repro_torch.core import hypercube as th
from repro_torch.core import rfis as tf
from repro_torch.core import types as tt
from torch_helpers import (assert_shard, compare_psort, instances,
                           kernels_off, port_shard, run_sim, sorted_state)

pytestmark = pytest.mark.usefixtures(kernels_off.__name__)


@pytest.mark.parametrize("p", [2, 8, 16])
@pytest.mark.parametrize("hi,pad_keys", [(1, False), (3, True),
                                         (2 ** 32 - 1, True)])
def test_rfis_rank_matches_reference(p, hi, pad_keys):
    """hi = 1: every key equal (Zero); hi = 3 with pad-word keys: a few
    values, each many times; the full range with pad-word keys."""
    cap = 6
    state = sorted_state(p, cap, 21 + p, hi=hi, pad_keys=pad_keys,
                         sort=False)

    def body(k, v, c):
        r = jf.rfis_rank(jt.SortShard(k, {"idx": v}, c), "pe", p)
        d = r.row_data
        return (d.keys, d.vals["idx"], d.vals["_orig"], d.vals["_lidx"],
                d.count, r.ranks, r.total)
    rk, rv, ro, rl, rc, rr, rt = run_sim(p, body, *state)
    got = tf.rfis_rank(port_shard(*state), p)
    assert_shard(got.row_data, rk, {"idx": rv, "_orig": ro, "_lidx": rl}, rc)
    assert np.array_equal(got.ranks.numpy(), rr)
    assert np.array_equal(got.total.numpy(), rt)
    # the ranks of a column's rows together are 0 … n − 1 once each
    n = int(state[2].sum())
    rb, cb = tf.grid_shape(p)
    valid = np.arange(rk.shape[1])[None] < rc[:, None]
    ranks = np.concatenate([rr[r << cb][valid[r << cb]]
                            for r in range(1 << rb)])
    assert np.array_equal(np.sort(ranks), np.arange(n))


def test_rfis_rank_refuses_composites_past_63_bits():
    """p = 4 (one row bit) with 2^31 slots per PE: 32 + 1 + 31 bits; the
    shapes are views, never filled."""
    p, cap = 4, 1 << 31
    big = tt.SortShard(torch.zeros(1, dtype=torch.int32).expand(p, cap), {},
                       torch.zeros(p, dtype=torch.int64))
    with pytest.raises(ValueError, match="63 bits"):
        tf.rfis_rank(big, p)


@pytest.mark.parametrize("cap_out", [None, 4])
@pytest.mark.parametrize("dims", [(1, 2, 3), (0, 2)])
def test_route_by_target_matches_reference(cap_out, dims):
    """Targets drawn over all PEs, so some elements need dims outside
    ``dims`` and stay put; capacity 4 overflows."""
    p, cap = 16, 8
    keys, idx, count = sorted_state(p, cap, 31, hi=5)
    g = np.random.default_rng(32)
    tgt = g.integers(0, p, size=(p, cap)).astype(np.uint32)

    def body(k, v, t, c):
        sh, ovf = jh.route_by_target(
            jt.SortShard(k, {"idx": v, "_tgt": t}, c), "pe", p, dims=dims,
            capacity=cap_out)
        return sh.keys, sh.vals["idx"], sh.vals["_tgt"], sh.count, ovf
    rk, rv, rt, rc, ro = run_sim(p, body, keys, idx, tgt, count)
    got, ovf = th.route_by_target(
        port_shard(keys, {"idx": idx, "_tgt": tgt}, count), p, dims=dims,
        capacity=cap_out)
    assert_shard(got, rk, {"idx": rv, "_tgt": rt}, rc)
    assert np.array_equal(ovf.numpy(), ro)
    if cap_out:
        assert ro.sum() > 0                       # the overflow path ran


@pytest.mark.parametrize("name", instances())
@pytest.mark.parametrize("p", [2, 4, 8])
def test_rfis_psort_matches_reference(name, p):
    x = generate_instance(name, p, 37 * p - 3).astype(np.uint32)
    info = compare_psort(x, p, "rfis")
    assert info["overflow"] == 0


@pytest.mark.parametrize("name", ["Zero", "DeterDupl"])
def test_rfis_psort_matches_reference_at_p64_sparse(name):
    """RFIS's band: n/p = 1 at p = 64 (an 8 × 8 grid), and the pad word."""
    x = generate_instance(name, 64, 64).astype(np.uint32)
    x[::5] = 0xFFFFFFFF
    compare_psort(x, 64, "rfis")


def test_rfis_capacity_keyword_matches_reference():
    x = generate_instance("Uniform", 8, 8 * 37).astype(np.uint32)
    compare_psort(x, 8, "rfis", capacity=40)
