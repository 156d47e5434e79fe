"""The query paths on the distributed backend: every query kind over
resident data with ``backend="shard_map"``, each rank one PE of a pool of
eight gloo ranks, against the reference's shard_map runners on conftest's
eight emulated CPU devices and against the port's sim backend, bit for
bit, the trace of a selection included (``test_queries.py:57, 109``); and
the serving frontend on the ranks."""
import numpy as np
import pytest

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import queries as JQ
from repro.data.distributions import INSTANCES, generate_instance
from repro.launch import sort_serve as JS

from torch_dist_helpers import RankPool, cli_job, query_job, service_job

P = 8


@pytest.fixture(scope="module")
def pool():
    ranks = RankPool(8)
    yield ranks
    ranks.close()


def _args(x):
    """The arguments of the reference's ``_oracle_queries``: order
    statistics at the edges, middle and around duplicates, percentiles,
    top-k sizes, probe keys and intervals."""
    srt = np.sort(x)
    n = len(x)
    ranks = np.unique(np.clip(np.array([1, 2, n // 3, n // 2, n - 1, n]),
                              1, n))
    qs = np.array([0.0, 10.0, 50.0, 90.0, 99.0, 100.0])
    ks = np.array([1, 3, min(40, n)])
    probes = np.concatenate([x[:3], srt[:1], srt[-1:], srt[-1:] - 1])
    lo = np.array([min(x[1], x[5]), srt[0]])
    hi = np.array([max(x[1], x[5]), srt[-1]])
    return ranks, qs, ks, probes, lo, hi


def _reference(x, args):
    """The reference's shard_map runners on conftest's eight devices."""
    ranks, qs, ks, probes, lo, hi = args
    data = JQ.shard_data(x, P)
    kw = {"backend": "shard_map"}
    return {"select": [np.asarray(a) for a in JQ.select_rank(data, ranks,
                                                             **kw)],
            "percentile": np.asarray(JQ.percentile(data, qs, **kw)),
            "top_k": [np.asarray(a) for a in JQ.top_k(data, ks, **kw)],
            "rank_of_key": [np.asarray(a) for a in JQ.rank_of_key(
                data, probes, **kw)],
            "range_query": np.asarray(JQ.range_query(data, lo, hi, **kw))}


def _same(got, want):
    for k, w in want.items():
        g = got[k]
        pairs = zip(g, w) if isinstance(w, list) else [(g, w)]
        for a, b in pairs:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, k
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def _check(pool, x, args=None):
    """Every kind on the ranks equals the reference's shard_map runners
    and the port's sim backend; rank 0's selection trace the sim's."""
    args = _args(x) if args is None else args
    want = _reference(x, args)
    sim = query_job(x, P, "sim", *args)
    _same(sim, want)
    for got in pool.run(query_job, x, P, "shard_map", *args):
        _same(got, want)
        assert got["events"] == sim["events"]


@pytest.mark.parametrize("instance", sorted(INSTANCES))
def test_queries_on_ranks_all_instances(pool, instance):
    """64-bit keys (grid and sketch only), as the reference's test."""
    _check(pool, generate_instance(instance, P, 64 * P).astype(np.int64))


@pytest.mark.parametrize("instance", ["Uniform", "Zero", "Staggered"])
def test_queries_on_ranks_u32_window_path(pool, instance):
    """32-bit keys add round 0's butterfly rank window, whose exchanges
    run between partner ranks."""
    _check(pool, (generate_instance(instance, P, 64 * P)
                  % (1 << 31)).astype(np.int32))


def test_backends_bitwise_identical(pool):
    """The reference's batch of ranks and of top-k sizes: the ranks, the
    port's sim backend and the reference's shard_map runners agree."""
    x = generate_instance("Staggered", P, 64 * P).astype(np.int64)
    args = _args(x)
    _check(pool, x, (np.array([1, 100, 512]),) + args[1:2]
           + (np.array([5, 9]),) + args[3:])


def test_sort_service_on_ranks(pool):
    """The serving frontend with ``backend="shard_map"``: every rank
    drains the same stream and answers as the reference's service."""
    keys = generate_instance("Uniform", P, 64 * P).astype(np.int64)
    srt = np.sort(keys)
    stream = [("top_k", 3), ("percentile", 50.0), ("rank_of_key",
                                                   int(keys[7])),
              ("range_query", (int(srt[10]), int(srt[300]))),
              ("top_k", 17), ("percentile", 99.0)]
    ref = JS.SortService(keys, P, backend="sim", policy="selection")
    for kind, arg in stream:
        ref.submit(kind, arg)
    want = [np.asarray(r.value).tolist()
            for r in sorted(ref.drain(), key=lambda r: r.request.id)]
    assert all(got == want for got in pool.run(service_job, keys, P,
                                               stream))


def test_serve_cli_on_ranks(pool):
    """``sort_serve --backend shard_map`` on the ranks (the group already
    up, as under ``torchrun``): every rank answers the smoke stream as
    the sim backend does."""
    argv = ["--smoke", "--device", "cpu", "--queries", "12", "--seed", "3",
            "--policy", "selection"]
    want = cli_job(argv)
    assert len(want) == 12
    got = pool.run(cli_job, argv + ["--backend", "shard_map"])
    assert all(g == want for g in got)
