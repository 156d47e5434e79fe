"""The port's external (out-of-core) lane against the reference, bit for bit.

Stage tests hand the same seeded numpy state to ``repro.core.external``
and ``repro_torch.core.external`` (run formation, sketches, provisioning,
splitter fit, one exchange pass, both merge engines) and compare the host
planes.  End-to-end tests compare ``psort(..., external=ExternalPolicy)``
with the reference's kernel-off run: sorted keys, per-PE counts, overflow,
perm and ``info["external"]``, all integers, so the tolerance is 0.  The
non-core instances are ``slow``, as in ``tests/test_external.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import ExternalPolicy as JPolicy
from repro.core import SortConfig as JConfig
from repro.core import external as jext
from repro.core import psort as j_psort
from repro.core import types as jt
from repro.data.distributions import INSTANCES, generate_instance
from repro_torch import ExternalPolicy, SortConfig, psort
from repro_torch.core import external as text

P = 8
CORE_INSTANCES = ["Uniform", "Zero", "g-Group", "Staggered"]


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _host(t):
    """A port output tensor as numpy, in its own dtype."""
    if t.dtype in (torch.uint32, torch.uint64):
        signed = torch.int32 if t.dtype == torch.uint32 else torch.int64
        return t.view(signed).numpy().view(
            np.uint32 if t.dtype == torch.uint32 else np.uint64)
    return t.numpy()


def _same_as_reference(x, p, budget, algorithm="auto", **policy):
    want, wi = j_psort(x, config=JConfig(
        p=p, backend="sim", algorithm=algorithm,
        external=JPolicy(budget=budget, **policy)), return_info=True)
    got, gi = psort(x, SortConfig(
        p=p, algorithm="external" if algorithm == "external" else "rams",
        external=ExternalPolicy(budget=budget, **policy)),
        return_info=True, device="cpu")
    want, g = np.asarray(want), _host(got)
    assert g.dtype == want.dtype
    assert np.array_equal(g, want, equal_nan=True) or np.array_equal(
        g.view(np.uint8), want.view(np.uint8))
    assert gi["algorithm"] == wi["algorithm"]
    assert np.array_equal(gi["counts"].numpy(), np.asarray(wi["counts"]))
    assert gi["overflow"] == wi["overflow"]
    assert np.array_equal(gi["perm"].numpy(),
                          np.asarray(wi["perm"]).astype(np.int64))
    if wi["algorithm"] == "external":
        assert gi["external"] == wi["external"]
        assert gi["balance"] == pytest.approx(float(wi["balance"]), abs=0)
    return gi


def _cells():
    for instance in sorted(INSTANCES):
        for dtype in (np.int32, np.uint32, np.float32):
            marks = [] if instance in CORE_INSTANCES else [pytest.mark.slow]
            yield pytest.param(instance, dtype, marks=marks,
                               id=f"{instance}-{np.dtype(dtype).name}")


@pytest.mark.parametrize("instance,dtype", _cells())
def test_external_psort_matches_reference(instance, dtype):
    """~5 runs per PE (per = 37, budget = 8), the classifier engine."""
    x = generate_instance(instance, P, 37 * P).astype(dtype)
    info = _same_as_reference(x, P, 8)
    assert info["algorithm"] == "external" and info["overflow"] == 0
    assert np.array_equal(_host(psort(x, SortConfig(
        p=P, external=ExternalPolicy(budget=8)), device="cpu")),
        np.sort(x))


@pytest.mark.parametrize("runs", [2, 3, 5, 8])
def test_external_run_count_sweep_matches_reference(runs):
    x = generate_instance("Staggered", P, 40 * P).astype(np.int32)
    info = _same_as_reference(x, P, -(-40 // runs))
    assert info["external"]["runs"] == runs


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.float64])
def test_external_wide_keys_match_reference(dtype):
    """8-byte keys keep separate (key, tie) planes and sort by both."""
    rng = np.random.default_rng(7)
    if dtype == np.float64:
        x = rng.standard_normal(200) * 1e12
    else:
        x = rng.integers(-2 ** 62, 2 ** 62, size=200, dtype=np.int64)
    x = x.astype(dtype)
    x[:5] = x[5]                                   # duplicates
    _same_as_reference(x, 4, 8)


@pytest.mark.parametrize("n", [0, 3, 7, 37])
def test_external_degenerate_sizes_match_reference(n):
    """n = 0, n < p, n < budget and n/p > budget, forced onto the lane."""
    x = np.arange(n, dtype=np.int32)[::-1].copy()
    info = _same_as_reference(x, 4, 4, algorithm="external",
                              slot_factor=2.0)
    assert info["algorithm"] == "external"


def test_external_pad_word_keys_match_reference():
    """Keys equal to the pad word 0xFFFFFFFF still come out in full."""
    x = generate_instance("Uniform", 4, 4 * 30).astype(np.uint32)
    x[::3] = 0xFFFFFFFF
    info = _same_as_reference(x, 4, 8)
    assert info["overflow"] == 0


@pytest.mark.parametrize("merge", ["classifier", "losertree"])
def test_external_engines_and_double_buffer_match_reference(merge):
    x = generate_instance("g-Group", P, 37 * P).astype(np.int32)
    a = _same_as_reference(x, P, 8, merge=merge)
    out, b = psort(x, SortConfig(p=P, external=ExternalPolicy(
        budget=8, merge=merge, double_buffer=False)), return_info=True,
        device="cpu")
    assert torch.equal(a["perm"], b["perm"])
    assert torch.equal(a["counts"], b["counts"])


def test_external_with_the_pallas_kway_kernel_matches():
    """Where the reference runs its Pallas classifier (interpret mode)."""
    prev = jt.set_local_kernels(jt.LocalKernelPolicy(partition=True))
    try:
        x = generate_instance("Uniform", P, P * 20000).astype(np.uint32)
        info = _same_as_reference(x, P, 8192)
    finally:
        jt.set_local_kernels(prev)
    assert info["external"]["runs"] == 3


def test_external_lane_is_taken_when_the_reference_takes_it(monkeypatch):
    x = generate_instance("Uniform", 4, 4 * 20).astype(np.uint32)
    # n/p <= budget: both stay in core (RAMS)
    assert _same_as_reference(x, 4, 20, algorithm="rams")["algorithm"] \
        == "rams"
    monkeypatch.setenv("REPRO_EXTERNAL_BUDGET", "8")
    _, info = psort(x, SortConfig(p=4), return_info=True, device="cpu")
    _, wi = j_psort(x, config=JConfig(p=4, backend="sim"), return_info=True)
    assert info["algorithm"] == wi["algorithm"] == "external"
    assert info["external"] == wi["external"]
    assert np.array_equal(info["perm"].numpy(),
                          np.asarray(wi["perm"]).astype(np.int64))


def test_external_config_is_validated():
    with pytest.raises(ValueError, match="budget"):
        ExternalPolicy(budget=0)
    with pytest.raises(ValueError, match="merge"):
        ExternalPolicy(budget=4, merge="heapsort")
    with pytest.raises(ValueError, match="sketch_per_run"):
        ExternalPolicy(budget=4, sketch_per_run=0)
    with pytest.raises(TypeError, match="ExternalPolicy"):
        SortConfig(p=2, external=8)
    with pytest.raises(ValueError, match="external"):
        psort(np.arange(8, dtype=np.int32), SortConfig(
            p=2, algorithm="external"), device="cpu")
    pol = ExternalPolicy(budget=2)
    assert SortConfig(p=2, external=pol, overlap=True).overlap
    # the fault lane takes the external lane (item 8, ported)
    assert SortConfig(p=2, external=pol,
                      fault_policy=object()).external == pol
    with pytest.raises(ValueError, match="rams requires uint32"):  # in core
        psort(np.zeros(4, np.int64), SortConfig(p=2, algorithm="rams",
                                                external=pol),
              device="cpu")
    assert SortConfig(p=2, external=pol).replace(p=4).external == pol


# ---------------------------------------------------------------------------
# the passes, stage by stage
# ---------------------------------------------------------------------------


def _mk_runs(rng, lens, hi=1 << 20, dtype=np.uint32):
    """Sorted (key, tie, idx) runs with globally unique idx and tie =
    _mix32(idx), as the pipeline carries them (the reference's helper)."""
    ids = rng.permutation(sum(lens)).astype(np.uint32)
    runs, off = [], 0
    for n in lens:
        i = ids[off:off + n]
        off += n
        k = rng.integers(0, hi, size=n, dtype=np.int64).astype(dtype)
        t = np.asarray(jext._mix32(jnp.asarray(i)))
        order = np.lexsort((t, k))
        runs.append((k[order], t[order], i[order]))
    return runs


def _same_planes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("n,budget", [(0, 4), (3, 8), (8, 8), (37, 8),
                                      (65, 16)])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("double_buffer", [True, False])
def test_form_runs_matches_reference(n, budget, dtype, double_buffer):
    rng = np.random.default_rng(n * 31 + budget)
    keys = rng.integers(0, 50, size=n, dtype=np.int64).astype(dtype)
    keys[:2] = np.iinfo(dtype).max                 # the pad word as a key
    idx = rng.permutation(n).astype(np.uint32)
    want = jext.form_runs(keys, idx, budget=budget)
    seen = []
    got = text.form_runs(keys, idx, budget=budget, device="cpu",
                         double_buffer=double_buffer,
                         io=lambda d, b: seen.append((d, b)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_planes(g, w)
    assert {d for d, _ in seen} == {"ext:h2d", "ext:d2h"}
    per_key = 16 if dtype == np.uint64 else 12     # key + tie + idx out
    assert sum(b for d, b in seen if d == "ext:d2h") == per_key * n


@pytest.mark.parametrize("engine", ["classifier", "losertree"])
@pytest.mark.parametrize("lens,budget,hi", [
    ((0, 1, 17, 40, 3), 16, 1 << 20), ((30, 30, 30), 7, 4),
    ((50,), 8, 100), ((5, 6), 64, 1 << 20), ((0, 0), 8, 10)])
def test_merge_runs_matches_reference(engine, lens, budget, hi):
    rng = np.random.default_rng(sum(lens) + budget)
    runs = _mk_runs(rng, lens, hi=hi)
    want = jext.merge_runs(runs, budget=budget, merge=engine)
    got = text.merge_runs(runs, budget=budget, merge=engine, device="cpu")
    _same_planes(got, want)


def test_merge_runs_wide_keys_match_reference():
    rng = np.random.default_rng(5)
    runs = _mk_runs(rng, (20, 33, 9), hi=1 << 40, dtype=np.uint64)
    _same_planes(text.merge_runs(runs, budget=8, device="cpu"),
                 jext.merge_runs(runs, budget=8))


@pytest.mark.parametrize("trial", range(6))
def test_sketch_and_provision_match_reference(trial):
    rng = np.random.default_rng(100 + trial)
    n = int(rng.integers(1, 300))
    k, t, _ = _mk_runs(rng, (n,), hi=int(rng.integers(2, 1 << 16)))[0]
    s = int(rng.integers(1, 40))
    got, want = text.run_sketch(k, t, s), jext.run_sketch(k, t, s)
    _same_planes(got[:2], want[:2])
    assert got[2] == want[2]
    nb = int(rng.integers(2, 12))
    sp = rng.integers(0, 1 << 16, size=nb - 1).astype(np.uint32)
    st = rng.integers(0, 1 << 32, size=nb - 1, dtype=np.int64).astype(
        np.uint32)
    assert np.array_equal(text.np_bucket(k, t, sp, st),
                          jext.np_bucket(k, t, sp, st))
    assert np.array_equal(text.provision(*got, sp, st, nb),
                          jext.provision(*want, sp, st, nb))


@pytest.mark.parametrize("p,dtype", [(4, np.uint32), (8, np.uint32),
                                     (8, np.uint64), (1, np.uint32)])
def test_fit_splitters_matches_reference(p, dtype):
    rng = np.random.default_rng(p)
    S = 12
    sk = np.full((p, S), np.iinfo(dtype).max, dtype)
    st = np.full((p, S), 0xFFFFFFFF, np.uint32)
    for pe in range(p):
        m = int(rng.integers(0, S + 1))            # HI-padded tails
        sk[pe, :m] = np.sort(rng.integers(0, 20, size=m)).astype(dtype)
        st[pe, :m] = rng.integers(0, 1 << 32, size=m, dtype=np.int64)
    want = jext._fit_splitters(sk, st, axis="pe", p=p, impl=None)
    got = text._fit_splitters(sk, st, p=p, device="cpu")
    _same_planes(got, want)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_exchange_pass_matches_reference(dtype):
    p, cap = 4, 24
    rng = np.random.default_rng(11)
    counts = np.array([24, 0, 17, 5], np.int32)
    kr = np.full((p, cap), np.iinfo(dtype).max, dtype)
    ir = np.zeros((p, cap), np.uint32)
    ids = rng.permutation(p * cap).astype(np.uint32)
    for pe in range(p):
        c = counts[pe]
        kr[pe, :c] = np.sort(rng.integers(0, 9, size=c)).astype(dtype)
        ir[pe, :c] = ids[pe * cap:pe * cap + c]
    s_keys = np.array([2, 4, 6], dtype)
    s_ties = rng.integers(0, 1 << 32, size=3, dtype=np.int64).astype(
        np.uint32)
    want = jext._exchange_pass(kr, ir, counts, s_keys, s_ties, axis="pe",
                               p=p, slot_cap=16, impl=None, tag="ext:pass0",
                               use_kernel=False)
    got = text._exchange_pass(kr, ir, counts, s_keys, s_ties, p=p,
                              slot_cap=16, device="cpu")
    assert np.array_equal(got[3], want[3])         # received counts
    assert np.array_equal(got[4], want[4])         # overflow
    for pe in range(p):
        c = int(want[3][pe])
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(g[pe, :c], np.asarray(w)[pe, :c])
