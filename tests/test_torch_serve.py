"""The port's sort service (``repro_torch.launch.sort_serve``) against the
reference's (``repro.launch.sort_serve``): the same streams through both
services, every answer, path and batch size equal, the latency stats'
guards, routing under one shared ``CostModel``, the fullsort cache,
validation and the CLI.

Answers compare bit for bit (key arrays with their dtype; counts as
integers: the reference's fullsort counts come from ``jax.Array
.searchsorted``, int32, the port's from ``torch.searchsorted``).  The
reference compiles one program per batch shape; the streams are shared
through module-scoped fixtures.
"""
import itertools
from pathlib import Path

import numpy as np
import pytest

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import SortConfig as JConfig
from repro.core.selection import CostModel as JCostModel
from repro.launch import sort_serve as JS
from repro_torch import SortConfig
from repro_torch.core.selection import CostModel as TCostModel
from repro_torch.launch import sort_serve as TS

P = 8
MIX = "top_k=4,percentile=2,rank_of_key=2,range_query=1,sort=1"
PROFILE = Path(__file__).resolve().parent.parent / "profiles" \
    / "linux-x86_64-sim.json"


def _value(v):
    """An answer in a comparable form: key arrays and key scalars as
    (dtype, bytes), counts as Python ints."""
    if isinstance(v, tuple):
        return tuple(int(x) for x in v)
    a = np.asarray(v)
    if a.ndim == 0 and a.dtype.kind == "i":
        return int(a)
    return a.dtype.str, a.shape, a.tobytes()


def _stream(mod, keys, policy, queries=60, seed=3, cfg=None, **kw):
    """The CLI's stream generator over ``keys`` through one service of
    ``mod``; returns (service, results)."""
    svc = mod.SortService(keys, P, config=cfg, policy=policy, **kw)
    rng = np.random.default_rng(seed)
    pool = keys[rng.integers(0, len(keys), size=256)]
    for kind, arg in mod._gen_stream(rng, len(keys), queries,
                                     mod.parse_mix(MIX), pool):
        svc.submit(kind, arg)
    return svc, svc.drain()


@pytest.fixture(scope="module")
def keys64():
    return np.random.default_rng(7).integers(0, 1 << 20, size=2048).astype(
        np.int64)


@pytest.fixture(scope="module", params=["selection", "fullsort"])
def both_streams(request, keys64):
    """One stream through both services under a policy (the fullsort copy
    is RQuick's in both)."""
    policy = request.param
    _, want = _stream(JS, keys64, policy, cfg=JConfig(
        p=P, algorithm="rquick", backend="sim"))
    _, got = _stream(TS, keys64, policy, cfg=SortConfig(
        p=P, algorithm="rquick"), device="cpu")
    return policy, got, want


# -- latency_stats ----------------------------------------------------------


@pytest.mark.parametrize("lat,kw", [
    ([0.5, 0.010, 0.010, 0.010], {"warmup": 1, "rate_scale": 8}),
    ([0.5, 0.03, 0.011, 0.2, 0.07], {"warmup": 2}),
    ([0.020], {"warmup": 0}),
])
def test_latency_stats_equals_reference(lat, kw):
    assert TS.latency_stats(lat, **kw) == JS.latency_stats(lat, **kw)


@pytest.mark.parametrize("lat", [[], [0.5], [0.5, 0.2]])
def test_latency_stats_guards_tiny_samples(lat):
    """A run with no sample past the warm-up reports None with a note, as
    the reference does."""
    got = TS.latency_stats(lat, warmup=len(lat), note_ctx="request")
    assert got == JS.latency_stats(lat, warmup=len(lat), note_ctx="request")
    assert got["p50_ms"] is None and got["per_s"] is None
    assert "warmup" in got["note"] and got["n"] == len(lat)


# -- the service --------------------------------------------------------------


def test_micro_batches_by_head_kind(keys64):
    """One step answers every queued request of the head kind (FIFO) and
    leaves the rest queued; every request of a batch shares its time."""
    svc = TS.SortService(keys64, P, policy="selection", device="cpu")
    for kind, arg in (("top_k", 3), ("top_k", 5), ("percentile", 50.0),
                      ("top_k", 7)):
        svc.submit(kind, arg)
    done = svc.step()
    assert [r.request.arg for r in done] == [3, 5, 7]
    assert len({r.step_s for r in done}) == 1
    assert all(r.batch == 3 and r.path == "selection" for r in done)
    assert [r.kind for r in svc.queue] == ["percentile"]
    assert [r.request.kind for r in svc.step()] == ["percentile"]
    assert svc.step() == []


def test_same_stream_equals_reference(both_streams):
    """Every answer, path and batch size of the stream equal the
    reference's, under ``selection`` and ``fullsort``."""
    policy, got, want = both_streams
    assert len(got) == len(want) == 60
    assert [(r.request.kind, r.path, r.batch) for r in got] == [
        (r.request.kind, r.path, r.batch) for r in want]
    assert {r.path for r in got if r.request.kind != "sort"} == {policy}
    for g, w in zip(got, want):
        assert _value(g.value) == _value(w.value), g.request


def test_answers_match_the_oracle(both_streams, keys64):
    """The port's answers are those of ``np.sort`` of the keys."""
    _, got, _ = both_streams
    srt, n = np.sort(keys64), len(keys64)
    for r in got:
        kind, arg, v = r.request.kind, r.request.arg, r.value
        if kind == "top_k":
            assert np.array_equal(v, srt[n - arg:])
        elif kind == "percentile":
            assert v == srt[int(np.floor(arg / 100.0 * (n - 1)))]
        elif kind == "rank_of_key":
            assert v == (np.searchsorted(srt, arg, "left"),
                         np.searchsorted(srt, arg, "right"))
        elif kind == "range_query":
            assert v == max(np.searchsorted(srt, arg[1], "left")
                            - np.searchsorted(srt, arg[0], "left"), 0)
        else:
            assert np.array_equal(v.numpy(), srt)


def test_sort_requests_and_the_fullsort_cache(keys64):
    """``sort`` requests return the cached sorted copy, built once on the
    service's device."""
    svc = TS.SortService(keys64, P, policy="selection", device="cpu")
    assert svc._sorted is None
    svc.submit("sort")
    svc.submit("sort")
    done = svc.drain()
    assert all(r.path == "sort" for r in done)
    assert done[0].value is done[1].value is svc._sorted
    assert np.array_equal(svc._sorted.numpy(), np.sort(keys64))
    svc.submit("top_k", 4)
    (r,) = svc.drain()
    assert r.path == "selection"            # the policy, cache or not


@pytest.mark.parametrize("max_batch", [64, 2])
def test_auto_routes_equal_reference(max_batch):
    """``policy="auto"`` with one measured profile given to both packages:
    the same route for every batch.  With ``max_batch=2`` top-k requests
    stay queued behind a batch, and the k the route weighs is theirs, as
    in the reference (it reads the queue after the batch left it)."""
    keys = np.random.default_rng(5).integers(0, 1 << 32, size=4096).astype(
        np.uint32)
    kw = dict(max_batch=max_batch, queries=40, seed=9)
    _, want = _stream(JS, keys, "auto", backend="sim",
                      model=JCostModel.load(PROFILE), **kw)
    _, got = _stream(TS, keys, "auto", device="cpu",
                     model=TCostModel.load(PROFILE), **kw)
    assert [(r.request.kind, r.path, r.batch) for r in got] == [
        (r.request.kind, r.path, r.batch) for r in want]
    assert {"selection", "fullsort"} <= {r.path for r in got}
    for g, w in zip(got, want):
        assert _value(g.value) == _value(w.value), g.request


def test_stats_equal_reference_under_one_clock(keys64):
    """With the same clock, the stats equal the reference's, queries/s
    counting each batch once by (kind, step time to the nanosecond): two
    batches of one kind with equal times count once, as there."""
    def clock():
        ticks = itertools.count()
        return lambda: float(next(ticks))

    out = []
    for mod, kw in ((TS, {"device": "cpu"}), (JS, {"backend": "sim"})):
        svc = mod.SortService(keys64, P, policy="selection", max_batch=2,
                              clock=clock(), **kw)
        assert svc.stats() == {}
        for k in (2, 3, 4, 5, 6):
            svc.submit("top_k", k)
        svc.submit("percentile", 40.0)
        svc.drain()
        out.append(svc.stats())
    assert out[0] == out[1]
    assert out[0]["top_k"]["p50_ms"] is not None


def test_validation_equals_reference():
    keys = np.arange(64, dtype=np.int32)
    svc_t = TS.SortService(keys, P, device="cpu")
    svc_j = JS.SortService(keys, P, backend="sim")
    cases = [
        lambda M, s, C, kw: s.submit("argmax"),
        lambda M, s, C, kw: M.SortService(keys, P, policy="always", **kw),
        lambda M, s, C, kw: M.SortService(keys, **kw),
        lambda M, s, C, kw: M.SortService(keys, 4, config=C(p=8), **kw),
        lambda M, s, C, kw: M.parse_mix("top_k=1,bogus=2"),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(JS, svc_j, JConfig, {"backend": "sim"})
        with pytest.raises(ValueError) as got:
            case(TS, svc_t, SortConfig, {"device": "cpu"})
        assert str(got.value) == str(want.value)
    assert TS.parse_mix("top_k=4,sort") == JS.parse_mix("top_k=4,sort") \
        == {"top_k": 4, "sort": 1}
    # on the distributed backend a service builds as the reference's does
    # (its resident data is the same); without a process group its first
    # selection batch raises the reference's default-mesh error, the one
    # it gives where the mesh cannot hold p, which points at the sim
    # backend.  Services on ranks: tests/test_torch_dist_queries.py
    svc = TS.SortService(keys, 16, backend="shard_map", device="cpu",
                         policy="selection")
    ref = JS.SortService(keys, 16, backend="shard_map", policy="selection")
    assert svc.backend == ref.backend == "shard_map"
    tail = r"requested p=16 > available devices \d+ \(use backend='sim' " \
        r"for emulated PE counts\)"
    for s in (svc, ref):
        s.submit("top_k", 3)
        with pytest.raises(ValueError, match=tail):
            s.drain()


def test_cli_smoke(capsys):
    svc = TS.main(["--smoke", "--device", "cpu", "--queries", "12",
                   "--seed", "1"])
    out = capsys.readouterr().out
    assert "[sort_serve]" in out and "12 queries" in out
    assert str(svc.device) == "cpu" and len(svc.completed) == 12


def test_cli_smoke_default_queries(capsys):
    TS.main(["--smoke", "--device", "cpu", "--policy", "selection"])
    out = capsys.readouterr().out
    assert "24 queries" in out and "policy=selection" in out


def test_negative_zero_splits_the_two_paths():
    """Selection counts in word order (−0.0 < 0.0), the fullsort path in
    the float order (−0.0 == 0.0), in the reference and so in the port."""
    x = np.array([-0.0, 0.0, 1.0, -1.0, 2.0, 0.0, -0.0, 3.0])
    out = []
    for mod, cfg, kw in ((JS, JConfig(p=4, algorithm="rquick",
                                      backend="sim"), {}),
                         (TS, SortConfig(p=4, algorithm="rquick"),
                          {"device": "cpu"})):
        got = []
        for policy in ("selection", "fullsort"):
            svc = mod.SortService(x, config=cfg, policy=policy, **kw)
            for arg in (0.0, -0.0):
                svc.submit("rank_of_key", arg)
            svc.submit("range_query", (-0.0, 0.0))
            got.append([_value(r.value) for r in svc.drain()])
        out.append(got)
    assert out[0] == out[1]
    assert out[1] == [[(3, 5), (1, 3), 2], [(1, 5), (1, 5), 0]]
