"""The port's collective trace against the reference's, event for event.

``repro.core.api.trace_collectives`` counts the collectives of one sort at
trace time, from the static shapes of each PE's leaves;
``repro_torch.trace_collectives`` runs the sort on the CPU inside a
``comm.counting`` scope.  For every ported algorithm at p = 8 and p = 64,
and for the external lane, the two ordered event lists must be equal,
``(primitive, bytes, group_size, axis, tag)`` each, and so must
``summary(p)``, ``by_tag()`` and ``io_bytes()``: all integers, so the
tolerance is 0.  8-byte keys compare a ``counting()`` scope around
``psort`` in both packages (the reference's ``trace_collectives`` traces
uint32 keys only); the reference records only when it traces, so its
compilation caches are cleared first.
"""
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import ExternalPolicy as JPolicy
from repro.core import SortConfig as JConfig
from repro.core import comm as jc
from repro.core import psort as j_psort
from repro.core import types as jt
from repro.core.api import trace_collectives as j_trace
from repro_torch import ExternalPolicy, SortConfig, psort, trace_collectives
from repro_torch.core import comm as tc

# (algorithm, p, n): each algorithm at p = 8 and p = 64 in its regime; the
# first cells are those of tests/test_comm.py (rquick and rams at 64·8,
# gatherm at 8 / 2 on p = 8)
CELLS = [
    ("rams", 8, 64 * 8), ("rams", 64, 64 * 64), ("rams", 64, 5000),
    ("ntb-ams", 8, 64 * 8), ("ntb-ams", 64, 64 * 64),
    ("rquick", 8, 64 * 8), ("rquick", 8, 100), ("rquick", 64, 64 * 64),
    ("ntb-quick", 8, 64 * 8), ("ntb-quick", 64, 3000),
    ("rfis", 8, 8), ("rfis", 8, 20), ("rfis", 64, 64), ("rfis", 64, 150),
    ("ssort", 8, 64 * 8), ("ssort", 64, 64 * 64), ("ssort", 64, 2500),
    ("ns-ssort", 8, 64 * 8), ("ns-ssort", 64, 64 * 64),
    ("bitonic", 8, 64 * 8), ("bitonic", 64, 64 * 16), ("bitonic", 64, 999),
    ("gatherm", 8, 8 // 2), ("gatherm", 64, 32), ("gatherm", 64, 7),
    ("allgatherm", 8, 8 // 2), ("allgatherm", 64, 32),
]


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _events(trace):
    return [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
            for e in trace.events]


def _same(got, want, p):
    assert _events(got) == _events(want)
    assert got.summary(p) == want.summary(p)
    assert got.by_tag() == want.by_tag()
    assert got.by_axis() == want.by_axis()
    assert got.io_bytes() == want.io_bytes()


@pytest.mark.parametrize("algorithm,p,n", CELLS)
def test_trace_collectives_equals_reference(algorithm, p, n):
    got = trace_collectives(n, SortConfig(p=p, algorithm=algorithm),
                            device="cpu")
    want = j_trace(n, JConfig(p=p, algorithm=algorithm))
    assert got.launches > 0
    _same(got, want, p)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_rams_trace_tags_every_level(levels):
    """RAMS tags its shuffle and each level; the per-tag summaries
    partition the whole."""
    p, n = 64, 64 * 40
    got = trace_collectives(n, SortConfig(p=p, algorithm="rams",
                                          levels=levels), device="cpu")
    want = j_trace(n, JConfig(p=p, algorithm="rams", levels=levels))
    _same(got, want, p)
    assert got.tags() == sorted(["shuffle"]
                                + [f"level{i}" for i in range(levels)])
    assert sum(s["launches"] for s in got.by_tag().values()) == got.launches
    assert sum(s["wire_bytes"] for s in got.by_tag().values()) \
        == got.wire_bytes()


@pytest.mark.parametrize("algorithm,p", [("rquick", 8), ("bitonic", 8),
                                         ("gatherm", 8)])
def test_hypercube_algorithms_are_point_to_point(algorithm, p):
    """Table I's structure, as the reference's test_comm checks it."""
    n = p // 2 if algorithm == "gatherm" else 64 * p
    t = trace_collectives(n, SortConfig(p=p, algorithm=algorithm),
                          device="cpu")
    assert t.p2p_launches == t.launches > 0 and t.fused_launches == 0


@pytest.mark.parametrize("double_buffer", [True, False])
@pytest.mark.parametrize("n,merge", [(256, "classifier"), (250, "classifier"),
                                     (300, "losertree")])
def test_external_trace_equals_reference(double_buffer, n, merge):
    """The lane at p = 4, budget 16: its gathers, per-run exchanges and
    merge barrier under the reference's tags, and its host-device copies
    at the reference's sizes, pass A's in the reference's PE order."""
    p = 4
    got = trace_collectives(n, SortConfig(p=p, external=ExternalPolicy(
        budget=16, double_buffer=double_buffer, merge=merge)), device="cpu")
    want = j_trace(n, JConfig(p=p, external=JPolicy(
        budget=16, double_buffer=double_buffer, merge=merge)))
    _same(got, want, p)
    runs = -(-(-(-n // p)) // 16)
    assert [t for t in got.tags() if t.startswith("ext:pass")] \
        == [f"ext:pass{r}" for r in range(runs)]
    assert got.io_bytes() > 0
    assert got.io_bytes() == (got.filter(tag="ext:runs").io_bytes()
                              + got.filter(tag="ext:merge").io_bytes())


@pytest.mark.parametrize("algorithm", ["rquick", "ntb-quick", "rfis",
                                       "ssort", "ns-ssort", "bitonic",
                                       "gatherm", "allgatherm"])
def test_psort_trace_on_int64_keys(algorithm):
    """A counting() scope around psort of 8-byte keys records what the
    reference's records."""
    p = 8
    n = 5 if algorithm in ("gatherm", "allgatherm") else 301
    x = np.random.default_rng(17).integers(-2 ** 63, 2 ** 63 - 1, size=n,
                                           dtype=np.int64)
    with tc.counting() as got:
        psort(x, SortConfig(p=p, algorithm=algorithm), device="cpu")
    jax.clear_caches()                  # a cache hit would record nothing
    with jc.counting() as want:
        j_psort(x, config=JConfig(p=p, algorithm=algorithm, backend="sim"))
    assert len(want.events) > 0
    _same(got, want, p)


def test_psort_records_nothing_outside_a_scope():
    x = np.random.default_rng(3).integers(0, 2 ** 32, size=500,
                                          dtype=np.int64).astype(np.uint32)
    with tc.counting() as closed:
        pass
    out = psort(x, SortConfig(p=8, algorithm="rquick"), device="cpu")
    assert closed.events == []
    assert np.array_equal(out.numpy().view(np.uint32), np.sort(x))
    with tc.counting() as t:
        psort(x, SortConfig(p=8, algorithm="rquick"), device="cpu")
    assert t.launches == t.p2p_launches > 0


def test_nested_scopes_record_into_both():
    x = np.arange(64, dtype=np.uint32)[::-1].copy()
    with tc.counting() as outer:
        with tc.counting() as inner:
            psort(x, SortConfig(p=8, algorithm="bitonic"), device="cpu")
        n_inner = len(outer.events)
        psort(x, SortConfig(p=8, algorithm="bitonic"), device="cpu")
    assert _events(inner) == _events(outer)[:n_inner]
    assert len(outer.events) == 2 * len(inner.events) > 0


def test_tagged_nesting_and_current_tag():
    assert tc.current_tag() is None
    with tc.tagged("a"):
        assert tc.current_tag() == "a"
        with tc.tagged("b"):
            assert tc.current_tag() == "b"
        with tc.tagged(None):
            assert tc.current_tag() is None
        assert tc.current_tag() == "a"
    assert tc.current_tag() is None
    with pytest.raises(RuntimeError):
        with tc.tagged("c"):
            raise RuntimeError("the scope resets its tag on the way out")
    assert tc.current_tag() is None


def test_record_takes_the_open_tag_and_filter_selects_unset_fields():
    with tc.counting() as t:
        tc.record("ppermute", 8)
        with tc.tagged("x"):
            tc.record("all_to_all", 16, 4)
        io = tc.io_recorder("ext:runs")
        io("ext:h2d", 32)
    assert tc.io_recorder("ext:runs") is None
    assert _events(t) == [("ppermute", 8, None, "sort", None),
                          ("all_to_all", 16, 4, "sort", "x"),
                          ("ext:h2d", 32, 1, None, "ext:runs")]
    assert _events(t.filter(tag="")) == [("ppermute", 8, None, "sort",
                                          None)]
    assert _events(t.filter(axis="")) == [("ext:h2d", 32, 1, None,
                                           "ext:runs")]
    assert _events(t.filter(primitive="all_to_all", tag="x")) \
        == [("all_to_all", 16, 4, "sort", "x")]
    assert t.tags() == ["", "ext:runs", "x"] and t.axes() == ["", "sort"]
    assert t.launches == 2 and t.p2p_launches == 1 and t.fused_launches == 1
    assert t.wire_bytes() == 24 and t.io_bytes() == 32
    assert [e.primitive for e in t.injected()] == ["ext:h2d"]
    assert t.fused_hops(64) == pytest.approx(4 ** (1 / 3))
    assert t.summary(8)["counts"] == {"ppermute": 1, "all_to_all": 1,
                                      "ext:h2d": 1}


def test_trace_collectives_refuses_what_is_not_ported():
    """``d`` and ``mesh_shape``, refused until they were ported, trace as
    the reference does (the batched trace per PE is the 1-D one; the
    nested one names its real axes); a p that is not a power of two, or
    that the mesh contradicts, raises the reference's error."""
    jax.clear_caches()
    for d, cfg, jcfg in ((2, SortConfig(p=8, algorithm="rams"),
                          JConfig(p=8, algorithm="rams")),
                         (1, SortConfig(mesh_shape=(2, 4), algorithm="rams"),
                          JConfig(mesh_shape=(2, 4), algorithm="rams"))):
        _same(trace_collectives(64 * 8, cfg, d=d, device="cpu"),
              j_trace(64 * 8, jcfg, d=d), 8)
    with pytest.raises(ValueError, match="power of two"):
        trace_collectives(64, SortConfig(p=6), device="cpu")
    with pytest.raises(ValueError, match="inconsistent"):
        trace_collectives(64, SortConfig(p=4, mesh_shape=(2, 4)),
                          device="cpu")


@pytest.mark.parametrize("knob", ["auto", "overlap"])
def test_trace_collectives_takes_auto_and_overlap(knob):
    """``"auto"`` with a cost model and ``overlap=True``, refused until
    they were ported, trace as the reference does (the same CostModel:
    the reference's CPU profile, loaded into each package's class)."""
    from repro.core.selection import CostModel as JModel
    from repro_torch.core.selection import CostModel
    path = Path(__file__).resolve().parents[1] / "profiles" / \
        "linux-x86_64-sim.json"
    if knob == "auto":
        got_cfg = SortConfig(p=8, cost_model=CostModel.load(path))
        want_cfg = JConfig(p=8, cost_model=JModel.load(str(path)))
    else:
        got_cfg = SortConfig(p=8, algorithm="rams", overlap=True)
        want_cfg = JConfig(p=8, algorithm="rams", overlap=True)
    jax.clear_caches()
    _same(trace_collectives(64 * 8, got_cfg, device="cpu"),
          j_trace(64 * 8, want_cfg), 8)
