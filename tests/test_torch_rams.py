"""The port's RAMS main path against the reference, bit for bit.

Stage tests feed the same shard state to both implementations through the
carry-across functions (``shard_from_numpy`` / ``shard_to_numpy``) and
compare the shard after the shuffle and after one RAMS level.  End-to-end
tests compare ``psort(backend="sim", algorithm="rams")`` with the
reference's kernel-off run on the paper's 11 instances: sorted keys,
per-PE counts, overflow and perm, all integers, so the tolerance is 0;
and NTB-AMS (``algorithm="ntb-ams"``, no tie-breaking) on the core
instances.  Keys are compared in full, payloads only inside
``[0, count)``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import comm as jc
from repro.core import hypercube as jh
from repro.core import rams as jr
from repro.core import types as jt
from repro.data.distributions import INSTANCES, generate_instance
from repro_torch.core import hypercube as th
from repro_torch.core import rams as tr
from repro_torch.core import types as tt
from torch_helpers import AXIS, assert_shard, compare_psort, kernels_off

pytestmark = pytest.mark.usefixtures(kernels_off.__name__)


def _initial_state(p, per, cap, name="Uniform", seed=0):
    """The reference's make_shard state of a psort input, as numpy."""
    x = generate_instance(name, p, p * per, seed).astype(np.uint32)
    keys = x.reshape(p, per)
    idx = np.arange(p * per, dtype=np.uint32).reshape(p, per)
    counts = np.full((p,), per, np.int32)
    counts[-1] = per - 3                          # a ragged last PE

    return [np.asarray(a) for a in _ref_make_shard(p, cap)(
        jnp.asarray(keys), jnp.asarray(idx), jnp.asarray(counts))]


# the reference stages, jitted once per static configuration


@functools.cache
def _ref_make_shard(p, cap):
    def body(k, v, c):
        sh = jt.make_shard(k, count=c, capacity=cap, vals={"idx": v})
        return sh.keys, sh.vals["idx"], sh.count
    return jax.jit(jc.sim_map(body, AXIS, p))


@functools.cache
def _ref_shuffle_fn(p, seed, slot_cap, new_cap):
    def body(k, v, c):
        sh, ovf = jh.alltoall_shuffle(jt.SortShard(k, {"idx": v}, c), AXIS, p,
                                      seed, slot_cap=slot_cap)
        sh = jt.local_sort(sh)
        sh, ovf2 = jt.resize(sh, min(sh.capacity, new_cap))
        return sh.keys, sh.vals["idx"], sh.count, ovf + ovf2
    return jax.jit(jc.sim_map(body, AXIS, p))


@functools.cache
def _ref_level_fn(p, h, b, seed):
    def body(k, v, c):
        out, ovf = jr._rams_level(jt.SortShard(k, {"idx": v}, c), AXIS, p, h,
                                  b, seed=seed, oversample=4, tie_break=True,
                                  slot_factor=2.0)
        return out.keys, out.vals["idx"], out.count, ovf
    return jax.jit(jc.sim_map(body, AXIS, p))


def _ref_shuffle(state, p, seed, slot_cap, new_cap):
    return [np.asarray(a) for a in _ref_shuffle_fn(p, seed, slot_cap, new_cap)(
        *[jnp.asarray(a) for a in state])]


def _port_shuffle(state, p, seed, slot_cap, new_cap):
    sh = tt.shard_from_numpy(state[0], {"idx": state[1]}, state[2])
    sh, ovf = th.alltoall_shuffle(sh, p, seed, slot_cap=slot_cap)
    sh = tt.local_sort(sh)
    sh, ovf2 = tt.resize(sh, min(sh.capacity, new_cap))
    return sh, ovf + ovf2


@pytest.mark.parametrize("p,per,slot_cap", [(8, 40, None), (16, 64, None),
                                            (8, 40, 7)])
def test_shuffle_stage_matches_reference(p, per, slot_cap):
    cap = 2 * per
    state = _initial_state(p, per, cap)
    tight = slot_cap is not None
    slot_cap = slot_cap or jr._slot_cap(cap, p, 2.0)
    rk, rv, rc, ro = _ref_shuffle(state, p, 0xA35, slot_cap, 2 * cap)
    got, ovf = _port_shuffle(state, p, 0xA35, slot_cap, 2 * cap)
    assert_shard(got, rk, rv, rc)
    assert np.array_equal(ovf.numpy(), ro)
    if tight:
        assert ro.sum() > 0                      # the overflow path ran


@pytest.mark.parametrize("name", ["Uniform", "Zero", "AllToOne"])
@pytest.mark.parametrize("p,h,b", [(16, 4, 2), (16, 2, 2), (16, 4, 4),
                                   (8, 3, 1)])
def test_one_rams_level_matches_reference(name, p, h, b):
    per = 48
    cap = 2 * per
    state = _initial_state(p, per, cap, name)
    slot_cap = jr._slot_cap(cap, p, 2.0)
    after = _ref_shuffle(state, p, 0xA35, slot_cap, 2 * cap)[:3]
    seed = 0xA35 + 7919
    rk, rv, rc, ro = [np.asarray(a) for a in _ref_level_fn(p, h, b, seed)(
        *[jnp.asarray(a) for a in after])]
    sh = tt.shard_from_numpy(after[0], {"idx": after[1]}, after[2])
    got, ovf = tr._rams_level(sh, p, h, b, seed=seed, oversample=4,
                              tie_break=True, slot_factor=2.0)
    assert_shard(got, rk, rv, rc)
    assert np.array_equal(ovf.numpy(), ro)


@pytest.mark.parametrize("name", sorted(INSTANCES))
@pytest.mark.parametrize("p", [4, 8])
def test_psort_matches_reference_on_every_instance(name, p):
    x = generate_instance(name, p, p * 100 - 3).astype(np.uint32)
    compare_psort(x, p, "rams")


@pytest.mark.parametrize("name", ["Uniform", "AllToOne"])
def test_psort_matches_reference_at_p64(name):
    x = generate_instance(name, 64, 64 * 64 + 5).astype(np.uint32)
    compare_psort(x, 64, "rams")


@pytest.mark.slow
def test_psort_matches_reference_where_level_one_overflows():
    """p = 64, n = 2^20 Uniform: the reference's second-level slots drop
    3442 keys; the port must drop the same ones."""
    x = generate_instance("Uniform", 64, 1 << 20).astype(np.uint32)
    info = compare_psort(x, 64, "rams")
    assert info["overflow"] == 3442


@pytest.mark.parametrize("name", ["Uniform", "Zero", "g-Group",
                                  "Staggered"])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_ntb_ams_psort_matches_reference(name, p):
    """NTB-AMS, RAMS without tie-breaking (``algorithm="ntb-ams"``); on
    Zero every key lands in one bucket and the slots overflow, as in the
    reference."""
    x = generate_instance(name, p, 37 * p - 3).astype(np.uint32)
    info = compare_psort(x, p, "ntb-ams")
    if name == "Zero" and p > 2:
        assert info["overflow"] > 0


def test_ntb_ams_levels_match_reference():
    x = generate_instance("DeterDupl", 8, 8 * 90).astype(np.uint32)
    compare_psort(x, 8, "ntb-ams", levels=3)
