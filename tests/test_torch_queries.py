"""The port's query paths (``repro_torch.core.queries`` and the rank
windows of ``repro_torch.core.median``) against the reference's, bit for
bit.

The same inputs, made with numpy from a seed, go through
``repro.core.queries`` (its sim backend, Pallas kernels off as on every
CPU) and through the port on the CPU.  Every comparison is exact: key
values with their dtype, ``n_lt``/``n_le``, the top-k arrays and the
collective traces event for event (tolerance 0).  The reference compiles
one program per batch shape, so the batches keep their shapes across
instances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import SortConfig as JConfig
from repro.core import median as jm
from repro.core import queries as JQ
from repro.core import selection as jsel
from repro.core import types as jt
from repro.core.api import trace_collectives as j_trace
from repro.data.distributions import INSTANCES, generate_instance
from repro_torch import SortConfig, trace_collectives
from repro_torch.core import median as tm
from repro_torch.core import queries as TQ
from repro_torch.core import selection as tsel
from repro_torch.core import types as tt
from torch_helpers import AXIS, bits, run_sim, sorted_state

P = 8
ALL_INSTANCES = sorted(INSTANCES)
U64_MAX = 2 ** 64 - 1


def _words(u):
    """numpy unsigned words (the reference's) → the port's int words."""
    return tt.key_to_int(torch.from_numpy(np.ascontiguousarray(u)))


def _unsigned(w):
    """The port's int words → numpy unsigned words."""
    return bits(tt.int_to_key(w, {torch.int32: torch.uint32,
                                  torch.int64: torch.uint64}[w.dtype])
                .view(w.dtype))


def _same(a, b):
    """Keys or counts bit for bit, dtype included."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _keys(instance, dtype, n=64 * P):
    """An instance as keys of ``dtype``: uint32 words, int64 words
    ``u << 32 | u`` (negative where u ≥ 2^31), or float64 ``(u − 2^31) ·
    0.37`` with both zeros among them."""
    u = generate_instance(instance, P, n)
    if dtype == np.uint32:
        return u.astype(np.uint32)
    if dtype == np.int64:
        w = u.astype(np.uint64)
        return ((w << np.uint64(32)) | w).view(np.int64)
    x = (u.astype(np.float64) - 2.0 ** 31) * 0.37
    x[[3, 100, 257, 400]] = [0.0, -0.0, -0.0, 0.0]
    return x


# ---------------------------------------------------------------------------
# Rank windows (median.py)
# ---------------------------------------------------------------------------

K = 16
FRACS = [np.array([0.0, 0.515625, 1.0]),          # 0.515625·32 = 16.5
         np.array([0.25, 0.5, 0.984375]),          # 0.984375·32 = 31.5
         np.array([1 / 3, 0.1, 0.7])]


def _state(dtype, seed):
    keys, _, counts = sorted_state(P, 40, seed, hi=50, pad_keys=True,
                                   dtype=dtype)
    return keys, counts


def _port_shard(keys, counts):
    return tt.SortShard(_words(keys), {}, torch.as_tensor(
        counts.astype(np.int64)))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("fi", range(len(FRACS)))
def test_local_rank_window_equals_reference(dtype, fi):
    keys, counts = _state(dtype, 10 + fi)
    fracs = FRACS[fi]

    def body(k, c, f):
        sh = jt.SortShard(keys=k, vals={}, count=c)
        return (jax.vmap(lambda x: jm.local_rank_window(sh, K, x))(f),)

    want, = run_sim(P, body, keys, counts, np.tile(fracs, (P, 1)))
    got = tm.local_rank_window(_port_shard(keys, counts), K,
                               torch.from_numpy(fracs))
    assert np.array_equal(_unsigned(got), want)


@pytest.mark.parametrize("fi", range(len(FRACS)))
def test_merge_rank_windows_equals_reference(fi):
    """Lifted windows with both fillers, merged at each fraction (the
    start rounds half to even, as ``jnp.round``)."""
    g = np.random.default_rng(20 + fi)
    a = np.sort(g.integers(0, 60, size=(P, 3, K)).astype(np.uint64), axis=2)
    b = np.sort(g.integers(0, 60, size=(P, 3, K)).astype(np.uint64), axis=2)
    a[:, :, :3] = 0
    b[:, :, -4:] = U64_MAX
    fracs = FRACS[fi]

    def body(x, y, f):
        return (jax.vmap(jm.merge_rank_windows)(x, y, f),)

    want, = run_sim(P, body, a, b, np.tile(fracs, (P, 1)))
    got = tm.merge_rank_windows(_words(a), _words(b),
                                torch.from_numpy(fracs))
    assert np.array_equal(_unsigned(got), want)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("fi", range(len(FRACS)))
def test_butterfly_rank_window_equals_reference(dtype, fi):
    """The windows after every butterfly step agree on all PEs, and equal
    the reference's at p = 8, B = 3."""
    keys, counts = _state(dtype, 30 + fi)
    fracs = FRACS[fi]
    dims = [0, 1, 2]

    def body(k, c, f):
        sh = jt.SortShard(keys=k, vals={}, count=c)
        return (jm.butterfly_rank_window(sh, AXIS, P, dims, K, f),)

    want, = run_sim(P, body, keys, counts, np.tile(fracs, (P, 1)))
    got = _unsigned(tm.butterfly_rank_window(
        _port_shard(keys, counts), P, dims, K, torch.from_numpy(fracs)))
    assert np.array_equal(got, want)
    assert (got == got[:1]).all()


def test_rank_window_fracs_stay_float64():
    """The leaf start is floor(frac·(m − 1)) in float64: fractions whose
    float32 product floors elsewhere pick the reference's window."""
    n, m = 3001, 1001
    ranks = np.arange(1, n + 1)
    fracs = (ranks - 1) / (n - 1)
    f64 = np.floor(fracs * (m - 1))
    f32 = np.floor(fracs.astype(np.float32) * np.float32(m - 1))
    picked = fracs[f64 != f32][:3]
    assert len(picked) == 3
    keys = np.sort(np.random.default_rng(5).integers(0, 2 ** 32, size=(
        P, m)).astype(np.uint32), axis=1)
    counts = np.full(P, m, np.int32)

    def body(k, c, f):
        sh = jt.SortShard(keys=k, vals={}, count=c)
        return (jax.vmap(lambda x: jm.local_rank_window(sh, K, x))(f),)

    want, = run_sim(P, body, keys, counts, np.tile(picked, (P, 1)))
    got = tm.local_rank_window(_port_shard(keys, counts), K,
                               torch.from_numpy(picked))
    assert np.array_equal(_unsigned(got), want)


# ---------------------------------------------------------------------------
# The candidate generators
# ---------------------------------------------------------------------------

GRID_EDGES = {
    np.uint64: [(0, U64_MAX), (0, 0), (U64_MAX, U64_MAX), (7, 7)]
    + [(2 ** 63 - 3, 2 ** 63 - 3 + s) for s in range(0, 18)]
    + [(U64_MAX - 20, U64_MAX), (1, U64_MAX - 1), (2 ** 63, U64_MAX),
       (100, 50), (U64_MAX, 0)],
    np.uint32: [(0, 2 ** 32 - 1), (0, 0), (2 ** 32 - 1, 2 ** 32 - 1)]
    + [(2 ** 31 - 3, 2 ** 31 - 3 + s) for s in range(0, 18)]
    + [(2 ** 32 - 21, 2 ** 32 - 1), (100, 50), (2 ** 32 - 1, 0)],
}


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_grid_candidates_at_the_unsigned_edges(dtype):
    """The grid's unsigned span and its division by 17, for the whole key
    space, spans below 17, hi = lo, and hi < lo (where the reference's
    unsigned arithmetic wraps): written out in int64 halves (8-byte) or
    int64 (4-byte), equal to the reference's."""
    lo = np.array([a for a, _ in GRID_EDGES[dtype]], dtype)
    hi = np.array([b for _, b in GRID_EDGES[dtype]], dtype)
    want = np.asarray(JQ._grid_candidates(jnp.asarray(lo), jnp.asarray(hi)))
    got = TQ._grid_candidates(_words(lo)[None], _words(hi)[None])[0]
    assert np.array_equal(_unsigned(got), want)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_sketch_candidates_with_pad_word_keys(dtype):
    """The pooled sketch with real keys equal to the pad word and empty
    windows: ``quantile_splitters`` gets the key width's pad word as its
    invalid entry, as the reference's."""
    keys, _, counts = sorted_state(P, 40, 7, hi=30, pad_keys=True,
                                   dtype=dtype)
    pad = np.iinfo(dtype).max
    lo = np.array([0, 3, 20, pad, 0], dtype)
    hi = np.array([pad, 9, 20, pad, 0], dtype)

    def body(k, c, a, b):
        return (JQ._sketch_candidates(k, c, a, b, AXIS),)

    want, = run_sim(P, body, keys, counts, np.tile(lo, (P, 1)),
                    np.tile(hi, (P, 1)))
    got = TQ._sketch_candidates(
        _words(keys), torch.as_tensor(counts.astype(np.int64)),
        _words(np.tile(lo, (P, 1))), _words(np.tile(hi, (P, 1))))
    assert np.array_equal(_unsigned(got), want)


def test_window_fillers_map_to_key_1():
    """Round-0 window candidates: the window's keys, and key 1 (not 0, as
    the reference's docstring says) for every ±inf filler; PEs with no or
    few keys give fillers."""
    keys, _, counts = sorted_state(P, 12, 9, hi=2 ** 32, dtype=np.uint32)
    counts[:4] = [0, 0, 1, 2]
    fracs = np.array([0.0, 0.5, 1.0])

    def body(k, c, f):
        return (JQ._window_candidates(k, c, f, AXIS, P),)

    want, = run_sim(P, body, keys, counts, np.tile(fracs, (P, 1)))
    got = _unsigned(TQ._window_candidates(
        _words(keys), torch.as_tensor(counts.astype(np.int64)),
        torch.from_numpy(fracs), P))
    assert np.array_equal(got, want)
    assert (want == 1).any()


# ---------------------------------------------------------------------------
# shard_data and every query against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.int64,
                                   np.float64, np.uint64])
@pytest.mark.parametrize("n", [64 * P, 64 * P + 5, P - 3, 0])
def test_shard_data_equals_reference(dtype, n):
    """Rows (the reference's unsigned words), counts, n and dtype, for n a
    multiple of p, not a multiple, below p, and empty."""
    x = (np.random.default_rng(n).integers(0, 2 ** 32, size=n) - 2 ** 31
         ).astype(dtype)
    want = JQ.shard_data(x, P)
    got = TQ.shard_data(x, P, device="cpu")
    assert np.array_equal(_unsigned(got.keys), np.asarray(want.keys))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert got.counts.dtype == torch.int32
    assert (got.n, got.orig_dtype, got.p, got.cap, got.bits) == (
        want.n, want.orig_dtype, want.p, want.cap, want.bits)


def _batches(x):
    """Fixed-shape batches over keys ``x``: 8 ranks with the ends, 6
    percentiles with 0 and 100, 4 k, and 8 probe keys / 4 intervals with
    the minimum, the maximum, a key between two keys, both zeros for
    floats, an empty and an inverted interval."""
    srt = np.sort(x)
    n = len(x)
    g = np.random.default_rng(n)
    probe = np.concatenate([x[:3], srt[:1], srt[-1:], srt[n // 2:n // 2 + 1],
                            np.zeros(2, x.dtype)]).astype(x.dtype)
    if x.dtype.kind == "f":
        probe[-1] = -0.0
    return {"ranks": np.array([1, 2, n // 3, n // 2, n - 1, n, 7, 300]),
            "q": np.array([0.0, 10.0, 50.0, 90.0, 99.0, 100.0]),
            "k": np.array([1, 3, 40, 5]),
            "probe": probe,
            "lo": np.array([x[1], srt[0], x[5], srt[-1]], x.dtype),
            "hi": np.array([x[5], srt[-1], x[5], srt[0]], x.dtype),
            "g": g}


def _answers(Q, data, b, window, **kw):
    return [*Q.select_rank(data, b["ranks"], window=window),
            Q.percentile(data, b["q"]), *Q.top_k(data, b["k"]),
            *Q.rank_of_key(data, b["probe"]),
            Q.range_query(data, b["lo"], b["hi"])]


@pytest.mark.parametrize("dtype", [np.uint32, np.int64, np.float64])
@pytest.mark.parametrize("instance", ALL_INSTANCES)
def test_queries_equal_reference(instance, dtype):
    """Every host function on every instance at p = 8, n = 64·8: 4-byte
    keys with the butterfly window on and off, int64 (grid and sketch
    only) and float64 with negative keys and both zeros."""
    x = _keys(instance, dtype)
    jd, td = JQ.shard_data(x, P), TQ.shard_data(x, P, device="cpu")
    b = _batches(x)
    for window in (True, False) if dtype == np.uint32 else (True,):
        want = _answers(JQ, jd, b, window)
        got = _answers(TQ, td, b, window)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert _same(g, w), (i, g, w)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64, np.int64])
def test_select_at_the_ends_of_the_key_space(dtype):
    """Keys 0 and the all-ones word (the unsigned zero and the pad word as
    real keys), and the signed extremes: the masked max starts from the
    flipped 0, ``cands ± 1`` never overflows a word."""
    g = np.random.default_rng(11)
    info = np.iinfo(dtype)
    x = g.integers(info.min, info.max, size=64 * P, dtype=dtype,
                   endpoint=True)
    x[[0, 9, 77]] = info.min
    x[[5, 300, 301]] = info.max
    n = len(x)
    ranks = np.array([1, 2, 3, 4, n - 3, n - 2, n - 1, n])
    jd, td = JQ.shard_data(x, P), TQ.shard_data(x, P, device="cpu")
    for g_, w in zip(TQ.select_rank(td, ranks), JQ.select_rank(jd, ranks)):
        assert _same(g_, w)
    for g_, w in zip(TQ.top_k(td, np.array([1, 3, 4])),
                     JQ.top_k(jd, np.array([1, 3, 4]))):
        assert _same(g_, w)
    probe = np.array([info.min, info.max, 0, 1], dtype)
    for g_, w in zip(TQ.rank_of_key(td, probe), JQ.rank_of_key(jd, probe)):
        assert _same(g_, w)


def test_top_k_tie_completion():
    """θ repeated across PEs: the tails above θ are compacted and the
    deficit filled with copies of θ on the device, as the reference's host
    loop does."""
    x = np.full(64 * P, 7, np.uint32)
    x[np.random.default_rng(2).integers(0, 64 * P, 20)] = 9
    x[[1, 200]] = [11, 12]
    ks = np.array([1, 2, 3, 10, 25, 400, 64 * P])
    jd, td = JQ.shard_data(x, P), TQ.shard_data(x, P, device="cpu")
    for g, w in zip(TQ.top_k(td, ks), JQ.top_k(jd, ks)):
        assert _same(g, w)
        assert _same(g, np.sort(x)[-len(g):])


def test_scalar_and_batch_api():
    """Scalars in give numpy scalars out (the reference's types); batches
    give arrays, and ``top_k`` a list of them."""
    x = np.arange(100, dtype=np.int64)
    jd, td = JQ.shard_data(x, 4), TQ.shard_data(x, 4, device="cpu")
    pairs = [
        (TQ.top_k(td, 3), JQ.top_k(jd, 3)),
        (TQ.percentile(td, 0.0), JQ.percentile(jd, 0.0)),
        (TQ.percentile(td, 37.5), JQ.percentile(jd, 37.5)),
        (TQ.range_query(td, 10, 20), JQ.range_query(jd, 10, 20)),
        (TQ.range_query(td, 20, 10), JQ.range_query(jd, 20, 10)),
        (TQ.select_rank(td, 50)[0], JQ.select_rank(jd, 50)[0]),
    ]
    pairs += list(zip(TQ.rank_of_key(td, 50), JQ.rank_of_key(jd, 50)))
    pairs += list(zip(TQ.select_rank(td, np.array([1, 100])),
                      JQ.select_rank(jd, np.array([1, 100]))))
    for g, w in pairs:
        assert type(g) is type(w) and _same(g, w), (g, w)
    assert TQ.rank_of_key(td, 50) == (50, 51)
    assert [a.tolist() for a in TQ.top_k(td, np.array([2, 1]))] == [
        [98, 99], [99]]


def _error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def test_validation_errors_equal_reference():
    """Each misuse raises the reference's exception type and message;
    on ``backend="shard_map"`` without a process group every kind raises
    the reference's default-mesh error (its error where the mesh cannot
    hold p), which points at the sim backend."""
    x = np.arange(16, dtype=np.int32)
    jd, td = JQ.shard_data(x, 4), TQ.shard_data(x, 4, device="cpu")
    jempty, tempty = JQ.shard_data(x[:0], 4), TQ.shard_data(
        x[:0], 4, device="cpu")
    cases = [
        (lambda M: M.shard_data(np.arange(9), 3, **M.kw)),
        (lambda M: M.shard_data(np.zeros((2, 2)), 2, **M.kw)),
        (lambda M: M.select_rank(M.d, 0)),
        (lambda M: M.select_rank(M.d, 17)),
        (lambda M: M.select_rank(M.d, np.array([3, 0]))),
        (lambda M: M.select_rank(M.e, 1)),
        (lambda M: M.top_k(M.d, 0)),
        (lambda M: M.top_k(M.d, 17)),
        (lambda M: M.percentile(M.d, 101.0)),
        (lambda M: M.percentile(M.d, -1.0)),
        (lambda M: M.range_query(M.d, [1, 2], [3])),
        (lambda M: M.top_k(M.d, 1, backend="mpi")),
        (lambda M: M.rank_of_key(M.d, 1, backend="mpi")),
        (lambda M: M.trace_query("median", 64, 8)),
        (lambda M: M.trace_query("top_k", 64, 6)),
    ]

    class J:
        shard_data, select_rank, top_k = (JQ.shard_data, JQ.select_rank,
                                          JQ.top_k)
        percentile, range_query, rank_of_key = (JQ.percentile,
                                                JQ.range_query,
                                                JQ.rank_of_key)
        trace_query, d, e, kw = JQ.trace_query, jd, jempty, {}

    class T:
        shard_data, select_rank, top_k = (TQ.shard_data, TQ.select_rank,
                                          TQ.top_k)
        percentile, range_query, rank_of_key = (TQ.percentile,
                                                TQ.range_query,
                                                TQ.rank_of_key)
        trace_query, d, e, kw = TQ.trace_query, td, tempty, {
            "device": "cpu"}

    for case in cases:
        assert _error(lambda: case(T)) == _error(lambda: case(J))
    x16 = np.arange(64, dtype=np.int32)
    j16, t16 = JQ.shard_data(x16, 16), TQ.shard_data(x16, 16, device="cpu")
    tail = r"requested p=16 > available devices \d+ \(use backend='sim' " \
        r"for emulated PE counts\)"
    for M, d in ((JQ, j16), (TQ, t16)):
        for fn in (M.select_rank, M.top_k, M.rank_of_key):
            with pytest.raises(ValueError, match=tail):
                fn(d, 1, backend="shard_map")
        with pytest.raises(ValueError, match=tail):
            M.range_query(d, 1, 2, backend="shard_map")
        with pytest.raises(ValueError, match=tail):
            M.percentile(d, 5.0, backend="shard_map")


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the default device where no GPU is")
def test_default_device_needs_cuda():
    """The entry points run on the card unless the caller passes the CPU:
    without CUDA, ``shard_data`` with no device raises (so no query runs
    on the CPU by default)."""
    x = np.arange(64, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.shard_data(x, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.select_rank(TQ.shard_data(x, 8), 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.trace_query("top_k", 64, 8)


# ---------------------------------------------------------------------------
# Traces and constants
# ---------------------------------------------------------------------------


def _events(trace):
    return [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
            for e in trace.events]


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("p", [8, 64])
@pytest.mark.parametrize("kind", ["top_k", "rank_of_key", "percentile",
                                  "range_query"])
def test_trace_query_equals_reference(kind, p, dtype):
    """Event for event: the window's ppermutes (4-byte keys), a gather and
    a psum per round, the verify psum; one psum for the counting kinds."""
    n = 1 << 12
    got = TQ.trace_query(kind, n, p, batch=4, dtype=dtype, k=8,
                         device="cpu")
    want = JQ.trace_query(kind, n, p, batch=4, dtype=dtype, k=8)
    assert got.launches > 0
    assert _events(got) == _events(want)
    assert got.summary(p) == want.summary(p)
    assert got.by_tag() == want.by_tag()


@pytest.mark.parametrize("p", [8, 64])
def test_trace_query_sort_is_the_sort_trace(p):
    """``kind="sort"`` is the port's ``trace_collectives`` of
    ``SortConfig(p=p)``, and the reference's trace of the algorithm the
    port's cost profile picks."""
    n = 1 << 12
    got = TQ.trace_query("sort", n, p, device="cpu")
    own = trace_collectives(n, SortConfig(p=p), device="cpu")
    algo = tsel.select_algorithm(n, p)
    want = j_trace(n, JConfig(p=p, algorithm=algo))
    assert _events(got) == _events(own) == _events(want)


def test_query_kinds_constant_in_sync():
    assert TQ.QUERY_KINDS == tsel.QUERY_KINDS == JQ.QUERY_KINDS \
        == jsel.QUERY_KINDS
    assert (TQ.GRID, TQ.SKETCH, TQ.WINDOW_K) == (JQ.GRID, JQ.SKETCH,
                                                 JQ.WINDOW_K)
    assert [TQ.n_rounds(b) for b in (8, 32, 64)] == [
        JQ.n_rounds(b) for b in (8, 32, 64)]
