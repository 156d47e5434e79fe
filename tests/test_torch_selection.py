"""The port's cost model and algorithm selection against the reference's.

``repro_torch.core.selection`` computes the reference's costs term for
term, so given the same :class:`CostModel` (a profile JSON loaded into
each package's class) every ``cost_*``, ``cost_select``,
``select_algorithm`` and ``regime_table`` must be equal: the same Python
float arithmetic, so the tolerance is 0.  Then ``psort(algorithm="auto")``
at cells that select each of the four regimes, the profile's JSON
round-trip and checks, the port's ``DEFAULT_MODEL`` (the card's profile,
never the reference's TPU priors), and ``tools/calibrate_torch.py``: its
fit recovers a known machine, and its phase 1 runs on the CPU at p = 8.
"""
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import SortConfig as JConfig
from repro.core import psort as j_psort
from repro.core import selection as js
from repro.core import types as jt
from repro.data.distributions import generate_instance
from repro_torch import ExternalPolicy, SortConfig, psort
from repro_torch.core import selection as ts

ROOT = Path(__file__).resolve().parents[1]
PROFILES = {
    "linux-x86_64-sim": ROOT / "profiles" / "linux-x86_64-sim.json",
    "ci-ubuntu-sim": ROOT / "profiles" / "ci-ubuntu-sim.json",
    "h100-sim": ts.DEFAULT_PROFILE,
}
PS = (2, 8, 64, 1 << 10, 1 << 18)
ES = range(-8, 24)
COSTS = ("cost_gatherm", "cost_allgatherm", "cost_rfis", "cost_rquick",
         "cost_rams", "cost_bitonic", "cost_ssort")


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _models(name):
    path = PROFILES[name]
    return ts.CostModel.load(path), js.CostModel.load(str(path))


def _cells(p):
    return [max(1, int(p * 2.0 ** e)) for e in ES]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_costs_equal_reference(name, p):
    tm, jm = _models(name)
    for n in _cells(p):
        for fn in COSTS:
            assert getattr(ts, fn)(n, p, model=tm) == \
                getattr(js, fn)(n, p, model=jm), (fn, n)
        for levels in (1, 2, 3):
            assert ts.cost_rams(n, p, levels=levels, model=tm) == \
                js.cost_rams(n, p, levels=levels, model=jm)
        if p >= 4:
            shape = (2, p // 2)
            assert ts.cost_rams(n, p, model=tm, mesh_shape=shape) == \
                js.cost_rams(n, p, model=jm, mesh_shape=shape)
            assert ts.cost_rams(n, p, levels=2, model=tm,
                                mesh_shape=(1, p)) == \
                js.cost_rams(n, p, levels=2, model=jm, mesh_shape=(1, p))
        for budget in (1, 64, 1 << 20):
            assert ts.cost_external(n, p, budget, model=tm) == \
                js.cost_external(n, p, budget, model=jm)
        for query in ("percentile", "top_k", "rank_of_key", "range_query"):
            assert ts.cost_select(n, p, query=query, batch=4, k=8,
                                  model=tm) == \
                js.cost_select(n, p, query=query, batch=4, k=8, model=jm)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_selection_equals_reference(name, p):
    tm, jm = _models(name)
    kw = [{}, {"levels": 1}, {"levels": 3}, {"budget": 16},
          {"budget": 1 << 12}, {"query": "top_k", "k": 5},
          {"query": "percentile", "batch": 8},
          {"query": "rank_of_key", "budget": 64},
          {"query": "range_query", "bits": 64}, {"query": "sort"}]
    if p >= 4:
        kw += [{"mesh_shape": (2, p // 2)},
               {"mesh_shape": (p // 2, 2), "levels": 2}]
    for n in _cells(p):
        for k in kw:
            assert ts.select_algorithm(n, p, model=tm, **k) == \
                js.select_algorithm(n, p, model=jm, **k), (n, k)
    for k in ({}, {"levels": 2}, {"budget": 256}):
        assert ts.regime_table(p, ES, model=tm, **k) == \
            js.regime_table(p, ES, model=jm, **k)


def test_select_algorithm_reads_a_config():
    tm, jm = _models("ci-ubuntu-sim")
    got = ts.select_algorithm(1 << 12, config=SortConfig(
        p=64, cost_model=tm, external=ExternalPolicy(budget=16)))
    want = js.select_algorithm(1 << 12, config=JConfig(
        p=64, backend="sim", cost_model=jm,
        external=repro.core.ExternalPolicy(budget=16)))
    assert got == want == "external"
    with pytest.raises(TypeError, match="needs p"):
        ts.select_algorithm(64, model=tm)
    with pytest.raises(ValueError, match="unknown query kind"):
        ts.select_algorithm(64, 8, model=tm, query="median")
    with pytest.raises(ValueError, match="unknown query kind"):
        ts.cost_select(64, 8, query="median", model=tm)


# (p, n, algorithm the linux-x86_64-sim profile selects there)
AUTO_CELLS = [(16, 2, "gatherm"), (16, 16, "rfis"), (16, 32, "rquick"),
              (16, 128, "rams"), (64, 4, "gatherm"), (64, 32, "rfis"),
              (64, 256, "rquick"), (64, 1024, "rams")]


@pytest.mark.parametrize("p,n,algorithm", AUTO_CELLS)
def test_auto_psort_equals_reference(p, n, algorithm):
    """``psort(algorithm="auto", cost_model=M)`` picks what the reference
    picks with the same M, and sorts bit for bit as it does."""
    tm, jm = _models("linux-x86_64-sim")
    x = generate_instance("Staggered", p, n, seed=5).astype(np.uint32)
    want, wi = j_psort(x, config=JConfig(p=p, backend="sim",
                                         cost_model=jm), return_info=True)
    got, gi = psort(x, SortConfig(p=p, cost_model=tm), return_info=True,
                    device="cpu")
    assert gi["algorithm"] == wi["algorithm"] == algorithm
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                          np.asarray(want))
    assert np.array_equal(gi["counts"].numpy(), np.asarray(wi["counts"]))
    assert gi["overflow"] == wi["overflow"]
    assert np.array_equal(gi["perm"].numpy(),
                          np.asarray(wi["perm"]).astype(np.int64))


def test_auto_takes_levels_and_the_external_budget():
    tm, jm = _models("linux-x86_64-sim")
    x = generate_instance("Uniform", 8, 8 * 40, seed=2).astype(np.uint32)
    for levels in (1, 3):
        want, wi = j_psort(x, config=JConfig(
            p=8, backend="sim", cost_model=jm, levels=levels),
            return_info=True)
        got, gi = psort(x, SortConfig(p=8, cost_model=tm, levels=levels),
                        return_info=True, device="cpu")
        assert gi["algorithm"] == wi["algorithm"] == "rams"
        assert np.array_equal(gi["perm"].numpy(),
                              np.asarray(wi["perm"]).astype(np.int64))
    _, gi = psort(x, SortConfig(p=8, cost_model=tm, external=ExternalPolicy(
        budget=8)), return_info=True, device="cpu")
    assert gi["algorithm"] == "external"


# ---------------------------------------------------------------------------
# the profile


def test_cost_model_json_roundtrip(tmp_path):
    m = ts.CostModel(name="unit", alpha=3e-6, alpha_c=7e-6, alpha_hop=2e-6,
                     beta=9e-11, local_rate=1.5e9, partition_rate=8e9,
                     slot_overhead=2.0, io_beta=1e-10, overlap=0.25,
                     meta={"fit": {"r2": 0.97}})
    loaded = ts.CostModel.load(m.save(str(tmp_path / "sub" / "unit.json")))
    assert loaded == m and loaded.meta["fit"]["r2"] == 0.97
    assert loaded.part_rate == 8e9 and loaded.io_b == 1e-10
    assert json.loads(m.to_json()) == json.loads(
        js.CostModel.from_json(m.to_json()).to_json())


def test_cost_model_checks_its_fields():
    with pytest.raises(ValueError, match="unknown CostModel fields"):
        ts.CostModel.from_json('{"name": "x", "gamma": 1.0}')
    base = dict(name="x", alpha=1e-6, alpha_c=1e-6, alpha_hop=1e-9,
                beta=1e-9, local_rate=1e9)
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match="overlap must be in"):
            ts.CostModel(**base, overlap=bad)
    # no machine constant has a default: a profile states its machine
    with pytest.raises(TypeError):
        ts.CostModel(name="x")
    with pytest.raises(TypeError):
        ts.CostModel.from_json('{"name": "pre-partition", "local_rate": 3e9}')
    m = ts.CostModel(**base)
    assert m.partition_rate is None and m.part_rate == 1e9
    assert m.io_b == js.CostModel(**base).io_b           # the same fallback
    assert m.slot_overhead == js.CostModel(**base).slot_overhead
    assert m.a_inner == m.alpha and m.b_inner == m.beta
    assert m.coll_inner(64) == m.alpha_c


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_profiles_load_into_both_packages(name):
    tm, jm = _models(name)
    assert json.loads(tm.to_json()) == json.loads(jm.to_json())


def test_default_model_is_the_committed_card_profile():
    m = ts.DEFAULT_MODEL
    assert m == ts.CostModel.load(ts.DEFAULT_PROFILE)
    assert m.name == "h100-sim" and "H100" in m.meta["card"]
    assert m.meta["microbench"]["p"] and m.meta["grid"]
    prior = js.CostModel()                  # the reference's TPU priors
    for field in ("alpha", "alpha_c", "alpha_hop", "beta", "local_rate"):
        v = getattr(m, field)
        assert math.isfinite(v) and v > 0 and v != getattr(prior, field)
    assert 0.0 <= m.overlap <= 1.0
    assert ts.cost_rquick(1 << 20, 256) == ts.cost_rquick(1 << 20, 256,
                                                          model=m)


def test_a_missing_profile_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no fallback"):
        ts.load_default(tmp_path / "h100-sim.json")


# ---------------------------------------------------------------------------
# tools/calibrate_torch.py


def _tool():
    spec = importlib.util.spec_from_file_location(
        "calibrate_torch", ROOT / "tools" / "calibrate_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fit_profile_recovers_known_machine():
    cal = _tool()
    rng = np.random.default_rng(5)
    theta = np.array([2.5e-6, 6e-6, 1.2e-6, 9e-11, 4e-10])
    cells = []
    for _ in range(40):
        f = {"p2p": int(rng.integers(1, 200)),
             "fused": int(rng.integers(1, 30)),
             "hops": float(rng.uniform(1, 100)),
             "wire_words": float(rng.uniform(1e3, 1e7)),
             "local_words": float(rng.uniform(1e3, 1e7))}
        feats = np.array([f[k] for k in cal._FEATURES])
        cells.append({**f, "seconds": float(feats @ theta)})
    model = cal.fit_profile(cells, "synthetic", floor=ts.DEFAULT_MODEL)
    got = np.array([model.alpha, model.alpha_c, model.alpha_hop, model.beta,
                    1.0 / model.local_rate])
    np.testing.assert_allclose(got, theta, rtol=1e-4)
    assert model.meta["fit"]["r2"] > 0.999 and model.name == "synthetic"
    assert ts.select_algorithm(2 ** 20 * 2 ** 18, 2 ** 18,
                               model=model) == "rams"


def test_fit_profile_floors_unidentified_parameters():
    cal = _tool()
    cells = [{"p2p": k, "fused": 0, "hops": 0.0, "wire_words": 100.0 * k,
              "local_words": 10.0 * k, "seconds": 2e-6 * k + 8e-9 * k}
             for k in range(1, 30)]
    model = cal.fit_profile(cells, "degenerate", floor=ts.DEFAULT_MODEL)
    assert model.alpha_c > 0 and model.alpha_hop > 0
    assert model.alpha > 0 and model.local_rate > 0


def test_measure_profile_microbench_smoke():
    """Phase 1 of the tool on the CPU at p = 8: plumbing only (a CPU run
    says nothing of the card's constants)."""
    cal = _tool()
    m = cal.measure_profile([8], "micro-smoke", device="cpu")
    for field in ("alpha", "alpha_c", "alpha_hop", "beta", "local_rate",
                  "partition_rate", "io_beta"):
        v = getattr(m, field)
        assert math.isfinite(v) and v > 0, field
    assert 0.0 <= m.overlap <= 1.0
    assert m.meta["microbench"]["p"] == [8] and m.meta["device"] == "cpu"
    assert ts.CostModel.from_json(m.to_json()) == m
    assert ts.select_algorithm(8, 8, model=m) in ts.COSTS


def test_reckoned_bytes_and_windows():
    cal = _tool()
    # the measured cells the per-slot constants come from stay under them
    assert cal.reckon_bytes("rfis", 1 << 18, 1 << 18) >= 48379482112
    assert cal.reckon_bytes("gatherm", 1 << 9, 1 << 12) >= 1972152832
    assert cal.reckon_bytes("rams", 1 << 26, 256) >= 31831669248
    # RAMS and GatherM cannot run at p = 2^16 on one card; RQuick can
    assert cal.reckon_bytes("rams", 1 << 16, 1 << 16) > cal.PEAK_LIMIT
    assert cal.reckon_bytes("gatherm", 1 << 8, 1 << 16) > cal.PEAK_LIMIT
    assert cal.reckon_bytes("rquick", 1 << 22, 1 << 16) < cal.PEAK_LIMIT
    assert not cal.eligible("gatherm", 1, 256)
    assert not cal.eligible("rams", -1, 256)
    assert cal.eligible("rfis", 6, 256) and not cal.eligible("rfis", 6, 4096)
    assert (256, 10) in cal.grid(cal.PS) and (4096, 10) not in cal.grid(
        cal.PS)
    with pytest.raises(NotImplementedError, match="item 5"):
        cal.main(["--nested", "2", "4", "--profile", "unused.json"])
