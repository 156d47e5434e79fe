"""Batched (d, n) keys in the port: ``psort`` on 2-D keys is d independent
sorts, row r of each within its own p PEs (the reference's subgroup
contract, ``repro/core/api.py``).

Every case is held against the reference's kernel-off sim run of the same
2-D keys, and row by row against the port's 1-D sort of that row: keys,
``perm``, ``counts`` and ``overflow``, exact equality (tolerance 0).  The
reference's outputs are cached per module, so each of its sorts is traced
once."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import SortConfig as JConfig
from repro.core import psort as j_psort
from repro.core import types as jt
from repro.core.api import trace_collectives as j_trace
from repro.data.distributions import generate_instance
from repro_torch import ExternalPolicy, SortConfig, psort, trace_collectives
from torch_helpers import bits, keys64

ROOT = Path(__file__).resolve().parents[1]
PROFILE = ROOT / "profiles" / "linux-x86_64-sim.json"
ALGOS = ["rams", "ntb-ams", "rquick", "ntb-quick", "rfis", "ssort",
         "ns-ssort", "bitonic", "gatherm", "allgatherm"]
D, P = 3, 8


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def rows(names, p, n, seed=3, dtype=np.uint32):
    """One instance per row, each of its own seed."""
    if isinstance(names, str):
        names = [names] * D
    return np.stack([generate_instance(name, p, n, seed=seed + r).astype(
        dtype) for r, name in enumerate(names)])


def models():
    """The reference's CPU profile in each package's CostModel."""
    from repro.core.selection import CostModel as JModel
    from repro_torch.core.selection import CostModel
    return CostModel.load(PROFILE), JModel.load(str(PROFILE))


_REF = {}


def reference(x, key, **cfg):
    """The reference's psort of ``x`` with ``cfg`` (cached under ``key``)."""
    if key not in _REF:
        out, info = j_psort(x, config=JConfig(backend="sim", **cfg),
                            return_info=True)
        _REF[key] = (np.asarray(out), info)
    return _REF[key]


def same(got, gi, want, wi):
    """The port's result and info against the reference's, bit for bit,
    info keys included."""
    assert set(gi) == set(wi)
    assert np.array_equal(bits(got), bits(want))
    assert np.array_equal(np.asarray(gi["counts"]), np.asarray(wi["counts"]))
    assert gi["overflow"] == wi["overflow"]
    assert np.array_equal(gi["perm"].numpy(),
                          np.asarray(wi["perm"]).astype(np.int64))
    assert gi["balance"] == float(wi["balance"])
    for k in ("n", "d", "mesh_shape", "algorithm", "backend"):
        assert gi[k] == wi[k], k


def rows_match_1d(x, cfg, got, gi):
    """Row r of a batched result ≡ the port's 1-D sort of row r."""
    for r in range(x.shape[0]):
        one, oi = psort(x[r], cfg, return_info=True, device="cpu")
        assert torch.equal(got[r], one), r
        assert torch.equal(gi["perm"][r], oi["perm"]), r
        assert torch.equal(gi["counts"][r], oi["counts"]), r


@pytest.mark.parametrize("algorithm", ALGOS + ["auto"])
def test_batched_rows_match_reference_and_1d(algorithm):
    x = rows("Uniform", P, 24 * P)
    kw = {}
    if algorithm == "auto":
        kw["cost_model"], ref_model = models()
        want, wi = reference(x, ("auto", D, P), p=P, algorithm="auto",
                             cost_model=ref_model)
    else:
        want, wi = reference(x, (algorithm, D, P), p=P, algorithm=algorithm)
    cfg = SortConfig(p=P, algorithm=algorithm, **kw)
    got, gi = psort(x, cfg, return_info=True, device="cpu")
    assert got.shape == (D, 24 * P) and gi["counts"].shape == (D, P)
    assert gi["d"] == D and gi["mesh_shape"] is None
    same(got, gi, want, wi)
    rows_match_1d(x, cfg, got, gi)


@pytest.mark.parametrize("algorithm", ["rams", "rquick"])
def test_batched_4x64(algorithm):
    """The reference's sim 4 × 64 cell (``tests/test_subaxis.py``)."""
    x = np.stack([generate_instance("Uniform", 64, 24 * 64, seed=3 + r)
                  .astype(np.int32) for r in range(4)])
    want, wi = reference(x, (algorithm, 4, 64), p=64, algorithm=algorithm)
    cfg = SortConfig(p=64, algorithm=algorithm)
    got, gi = psort(x, cfg, return_info=True, device="cpu")
    same(got, gi, want, wi)
    assert gi["overflow"] == 0
    rows_match_1d(x, cfg, got, gi)


@pytest.mark.parametrize("algorithm", ["rams", "rquick", "ssort"])
def test_batch_of_mixed_instances(algorithm):
    """Uniform, Zero and AllToOne rows in one batch: each row sorts as it
    does alone, whatever its neighbours hold, and as the reference's 1-D
    run of it.  SSort drops keys of the Zero row (as the reference does),
    so its rows differ in length: the reference's batched run raises and
    the port's result is the list of the rows."""
    x = rows(["Uniform", "Zero", "AllToOne"], P, 24 * P, seed=11)
    cfg = SortConfig(p=P, algorithm=algorithm)
    got, gi = psort(x, cfg, return_info=True, device="cpu")
    rows_match_1d(x, cfg, got, gi)
    for r in range(len(x)):
        want, wi = reference(x[r], (algorithm, "mixed", r), p=P,
                             algorithm=algorithm)
        assert np.array_equal(bits(got[r]), bits(want))
        assert np.array_equal(gi["perm"][r].numpy(),
                              np.asarray(wi["perm"]).astype(np.int64))
        assert np.array_equal(gi["counts"][r].numpy(), wi["counts"])
    if algorithm == "ssort":
        assert isinstance(got, list) and gi["overflow"] > 0
        with pytest.raises(ValueError):
            j_psort(x, config=JConfig(p=P, algorithm=algorithm,
                                      backend="sim"))
    else:
        want, wi = reference(x, (algorithm, "mixed"), p=P,
                             algorithm=algorithm)
        same(got, gi, want, wi)


@pytest.mark.parametrize("algorithm", ["rquick", "ssort"])
def test_batched_int64_keys(algorithm):
    x = np.stack([keys64("Uniform", P, 24 * P, np.int64) + r
                  for r in range(D)])
    want, wi = reference(x, (algorithm, "int64"), p=P, algorithm=algorithm)
    cfg = SortConfig(p=P, algorithm=algorithm)
    got, gi = psort(x, cfg, return_info=True, device="cpu")
    assert got.dtype == torch.int64
    same(got, gi, want, wi)
    rows_match_1d(x, cfg, got, gi)


@pytest.mark.parametrize("algorithm", ["rams", "ssort"])
def test_batched_overlap(algorithm):
    """``overlap=True`` on a batch: the streamed ring runs within each
    sort, bit for bit the reference's and the barrier path's."""
    x = rows("Staggered", P, 24 * P, seed=5)
    want, wi = reference(x, (algorithm, "overlap"), p=P, algorithm=algorithm,
                         overlap=True)
    cfg = SortConfig(p=P, algorithm=algorithm, overlap=True)
    got, gi = psort(x, cfg, return_info=True, device="cpu")
    same(got, gi, want, wi)
    barrier, bi = psort(x, cfg.replace(overlap=False), return_info=True,
                        device="cpu")
    assert torch.equal(got, barrier) and torch.equal(gi["perm"], bi["perm"])
    rows_match_1d(x, cfg, got, gi)


@pytest.mark.parametrize("shape", ["1-D", "2-D"])
def test_info_keys_and_values_match_reference(shape):
    """The in-core ``info`` holds the reference's keys, ``mesh_shape`` and
    ``d`` among them, with its values, on 1-D keys too."""
    x = rows("DeterDupl", P, 24 * P, seed=2)
    if shape == "1-D":
        x = x[0]
    want, wi = reference(x, ("info", shape), p=P, algorithm="rams")
    got, gi = psort(x, SortConfig(p=P, algorithm="rams"), return_info=True,
                    device="cpu")
    assert list(gi) == list(wi)
    assert gi["mesh_shape"] is None and gi["d"] == (1 if shape == "1-D"
                                                    else D)
    same(got, gi, want, wi)


@pytest.mark.parametrize("n", [0, 1, 5])
def test_batched_tiny_rows_match_reference(n):
    """Rows of 0, 1 and 5 keys (fewer than the PEs): the reference's
    shapes, (d, n) keys and perm and (d, p) counts."""
    x = rows("Uniform", P, 64)[:, :n].copy()
    want, wi = reference(x, ("tiny", n), p=P, algorithm="rquick")
    got, gi = psort(x, SortConfig(p=P, algorithm="rquick"), return_info=True,
                    device="cpu")
    assert got.shape == (D, n) == np.asarray(want).shape
    same(got, gi, want, wi)


def test_rows_of_unequal_length_come_back_as_a_list():
    """Rows that drop different numbers of keys (a tiny ``slot_factor``)
    cannot stack: the port returns the list of the d rows, each its 1-D
    sort, where the reference's ``np.stack`` raises."""
    x = rows(["Uniform", "Zero", "AllToOne"], P, 1000 * P, seed=1)
    cfg = SortConfig(p=P, algorithm="rams", algo_kw={"slot_factor": 0.2})
    got, gi = psort(x, cfg, return_info=True, device="cpu")
    assert isinstance(got, list) and isinstance(gi["perm"], list)
    assert len({len(r) for r in got}) > 1
    dropped = [x.shape[1] - int(c.sum()) for c in gi["counts"]]
    assert sum(dropped) == gi["overflow"] > 0
    rows_match_1d(x, cfg, got, gi)
    with pytest.raises(ValueError):
        j_psort(x, config=JConfig(p=P, algorithm="rams", backend="sim",
                                  algo_kw={"slot_factor": 0.2}))


@pytest.mark.parametrize("algorithm", ["rams", "bitonic", "ssort"])
def test_trace_is_independent_of_d_and_equals_the_reference(algorithm):
    cfg = SortConfig(p=16, algorithm=algorithm)
    t1 = trace_collectives(32 * 16, cfg, device="cpu")
    t4 = trace_collectives(32 * 16, cfg, d=4, device="cpu")
    assert t1.events == t4.events
    jax.clear_caches()
    want = j_trace(32 * 16, JConfig(p=16, algorithm=algorithm), d=4)
    assert [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
            for e in t4.events] == [
        (e.primitive, e.bytes, e.group_size, e.axis, e.tag)
        for e in want.events]
    assert t4.summary(16) == want.summary(16)


@pytest.mark.parametrize("case", ["3-D keys", "external", "no p"])
def test_batched_errors_are_the_reference_errors(case):
    """Each error of the reference on batched keys, raised by the port
    with the reference's message."""
    from repro.core import ExternalPolicy as JPolicy
    x = rows("Uniform", 4, 16)
    keys, cfg, ref_cfg, match = {
        "3-D keys": (x[None], {"p": 4}, {"p": 4}, "1-D .* or 2-D"),
        "external": (x, {"p": 4, "external": ExternalPolicy(budget=4)},
                     {"p": 4, "external": JPolicy(budget=4)},
                     "1-D keys only"),
        "no p": (x, {"algorithm": "rquick"}, {"algorithm": "rquick"},
                 "explicit p")}[case]
    with pytest.raises(ValueError, match=match):
        psort(keys, SortConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match=match):
        j_psort(keys, config=JConfig(backend="sim", **ref_cfg))
    if case == "external":
        with pytest.raises(ValueError, match="external tracing"):
            trace_collectives(64, SortConfig(**cfg), d=2, device="cpu")
