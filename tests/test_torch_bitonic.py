"""The port's distributed bitonic sort against the reference, bit for bit.

The stage test holds ``_split_half`` (one half of a merged 2·cap shard per
PE, chosen by a per-PE flag) against the reference's; end-to-end tests
compare ``psort(algorithm="bitonic")`` with the reference's kernel-off
run.  All integers, so the tolerance is 0.
"""
import numpy as np
import pytest
import torch

from repro.core import bitonic as jb
from repro.core import comm as jc
from repro.core import types as jt
from repro.data.distributions import generate_instance
from repro_torch.core import bitonic as tb
from torch_helpers import (assert_shard, compare_psort, instances,
                           kernels_off, port_shard, run_sim, sorted_state)

pytestmark = pytest.mark.usefixtures(kernels_off.__name__)


@pytest.mark.parametrize("pad_keys", [False, True])
def test_split_half_matches_reference(pad_keys):
    """Merged counts from 0 to 2·cap, so both halves run empty, partly
    full and full; the flag alternates over the PEs."""
    p, cap = 8, 5
    counts = np.array([0, 1, cap - 1, cap, cap + 1, 2 * cap - 1, 2 * cap, 7])
    state = sorted_state(p, 2 * cap, 51, hi=9, pad_keys=pad_keys,
                         counts=counts)

    def body(k, v, c):
        keep_low = jc.axis_index("pe") % 2 == 0
        sh = jb._split_half(jt.SortShard(k, {"idx": v}, c), cap, keep_low)
        return sh.keys, sh.vals["idx"], sh.count
    rk, rv, rc = run_sim(p, body, *state)
    got = tb._split_half(port_shard(*state), cap, torch.arange(p) % 2 == 0)
    assert_shard(got, rk, rv, rc)


@pytest.mark.parametrize("name", instances())
@pytest.mark.parametrize("p", [2, 4, 8])
def test_bitonic_psort_matches_reference(name, p):
    x = generate_instance(name, p, 37 * p - 3).astype(np.uint32)
    info = compare_psort(x, p, "bitonic")
    assert info["overflow"] == 0


def test_bitonic_psort_matches_reference_at_p16():
    """Four stages, ten compare-split rounds, on duplicate-heavy keys."""
    x = generate_instance("RandDupl", 16, 16 * 50).astype(np.uint32)
    compare_psort(x, 16, "bitonic")
