"""The port's SSort and NS-SSort against the reference, bit for bit.

The stage test holds the destination map (the partition classify with
nb = p and no rank, on the port's (key, tie) planes) against the
reference's classify of the u64 (hi, lo) planes, with splitters equal to
keys, the key 0xFFFFFFFF, splitters at and above 2^32 and the all-ones
invalid sample.  End-to-end tests compare ``psort(algorithm="ssort")`` and
``"ns-ssort"`` with the reference's kernel-off run, ``oracle_splitters``
and the overflow on Zero included (the reference's own behaviour: its
slots overflow on heavy duplicates).  All integers, so the tolerance is 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.distributions import generate_instance
from repro.kernels.partition import partition_buckets as j_partition
from repro_torch import SortConfig
from repro_torch.core import samplesort as ts
from torch_helpers import (compare_psort, instances, kernels_off, port_shard,
                           sorted_state)

pytestmark = pytest.mark.usefixtures(kernels_off.__name__)
_HI64 = 2 ** 64 - 1


def _ref_destinations(keys, count, splitters):
    """The reference's classify (``samplesort.py``), one PE at a time."""
    s = jnp.asarray(splitters, jnp.uint64)
    out = []
    for k, c in zip(keys, count):
        k64 = jnp.asarray(k).astype(jnp.uint64)
        d, _, _ = j_partition(
            (k64 >> np.uint64(32)).astype(jnp.uint32), k64.astype(jnp.uint32),
            (s >> np.uint64(32)).astype(jnp.uint32), s.astype(jnp.uint32),
            n_buckets=len(splitters) + 1, count=int(c), want_pos=False)
        out.append(np.asarray(d))
    return np.stack(out)


@pytest.mark.parametrize("p", [4, 16])
@pytest.mark.parametrize("case", ["keys", "top", "invalid"])
def test_destinations_match_reference(p, case):
    """Splitters drawn from the keys (so keys meet them), with the pad
    word among the keys; "top": the last splitters 0xFFFFFFFF, 2^32 and
    2^40; "invalid": the all-ones word (no valid sample)."""
    cap = 40
    keys, idx, count = sorted_state(p, cap, 41 + p, hi=50, pad_keys=True)
    g = np.random.default_rng(42)
    spl = np.sort(g.choice(keys[keys != 0xFFFFFFFF], p - 1)).astype(
        np.uint64)
    if case == "top":
        spl[-3:] = [0xFFFFFFFF, 2 ** 32, 2 ** 40][-(p - 1):]
    elif case == "invalid":
        spl[:] = _HI64
    want = _ref_destinations(keys, count, spl)
    flipped = torch.from_numpy((spl ^ np.uint64(1 << 63)).view(np.int64))
    got = ts._destinations(port_shard(keys, idx, count),
                           flipped.expand(p, p - 1))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("algorithm", ["ssort", "ns-ssort"])
@pytest.mark.parametrize("name", instances())
@pytest.mark.parametrize("p", [2, 4, 8])
def test_samplesort_psort_matches_reference(algorithm, name, p):
    """Overflow (Zero, DeterDupl, RandDupl, Mirrored at small p) equal to
    the reference's, never asserted 0."""
    x = generate_instance(name, p, 37 * p - 3).astype(np.uint32)
    compare_psort(x, p, algorithm)


@pytest.mark.parametrize("algorithm", ["ssort", "ns-ssort"])
def test_samplesort_overflows_on_zero_as_the_reference(algorithm):
    x = generate_instance("Zero", 8, 8 * 37 - 3).astype(np.uint32)
    info = compare_psort(x, 8, algorithm)
    assert info["overflow"] > 0


@pytest.mark.parametrize("algorithm", ["ssort", "ns-ssort"])
def test_samplesort_oracle_splitters_match_reference(algorithm):
    """The exact 1/4, 1/2, 3/4 quantiles: a perfect split, no sampling."""
    p = 4
    x = generate_instance("Uniform", p, 400).astype(np.uint32)
    spl = tuple(np.sort(x)[[100, 200, 300]].astype(np.uint64))
    info = compare_psort(x, p, algorithm, oracle_splitters=spl)
    if algorithm == "ns-ssort":
        assert info["counts"].tolist() == [100] * p


def test_samplesort_keywords_match_reference():
    x = generate_instance("Staggered", 8, 8 * 37).astype(np.uint32)
    compare_psort(x, 8, "ssort", seed=7, sample_factor=2, slot_factor=1.0)


def test_oracle_splitters_must_number_p_minus_1():
    from repro_torch import psort
    cfg = SortConfig(p=4, algorithm="ssort",
                     algo_kw={"oracle_splitters": (1, 2)})
    with pytest.raises(ValueError, match="p - 1 = 3"):
        psort(np.arange(16, dtype=np.uint32), cfg, device="cpu")
