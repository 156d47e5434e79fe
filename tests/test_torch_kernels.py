"""The plain versions of the port's kernels (what the wrappers run on a CPU
tensor, and what the CUDA kernels are held against on the card) against
the reference: the kernel-off JAX ``local_sort`` (a stable argsort), the
Pallas ``sort_tile`` / ``merge_tiles`` in interpret mode (keys only: the
bitonic network is not stable), ``partition_ref`` plus the Pallas
``partition_tile`` in interpret mode for the partition, and
``kway_classify_ref`` plus the Pallas ``kway_classify`` in interpret mode
for the k-way classifier.  Integers throughout, so everything must be
identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import types as jt
from repro.kernels.bitonic import merge_tiles, sort_tile
from repro.kernels.partition import partition_buckets as j_partition
from repro.kernels.kway.ops import kway_classify as j_kway
from repro.kernels.kway.ref import kway_classify_ref as j_kway_ref
from repro.kernels.partition import partition_ref as j_partition_ref
from repro_torch.kernels import bitonic as bt
from repro_torch.kernels import kway as kw
from repro_torch.kernels import partition as pt
from repro_torch.kernels.bitonic import ref as bref
from repro_torch.kernels.partition import ref as pref

FLIP = np.uint32(0x80000000)


@pytest.fixture
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _u32(g, shape, hi):
    return g.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


def _port(u):
    """Reference u32 words -> the port's sign-flipped int32 words."""
    return torch.from_numpy((u ^ FLIP).view(np.int32))


def _ref_u32(s):
    return s.numpy().view(np.uint32) ^ FLIP


@pytest.mark.parametrize("hi", [4, 1000, 2 ** 32])
@pytest.mark.parametrize("C", [1, 130, 4096, 5000, bt.TILE - 1, bt.TILE,
                               bt.TILE + 1])
def test_plain_sort_matches_kernel_off_local_sort(kernels_off, hi, C):
    g = np.random.default_rng(C + hi % 97)
    keys = _u32(g, (4, C), hi)
    keys[0, : min(C, 3)] = 0xFFFFFFFF            # real keys equal to the pad
    idx = np.arange(4 * C, dtype=np.uint32).reshape(4, C)
    counts = np.array([C, 0, C // 2, 1], np.int32)

    def one(k, v, c):
        sh = jt.local_sort(jt.SortShard(k, {"idx": v}, c))
        return sh.keys, sh.vals["idx"]
    rk, rv = jax.vmap(one)(jnp.asarray(keys), jnp.asarray(idx),
                           jnp.asarray(counts))
    # the port's local_sort pads the tail first, then sorts stably
    pad = np.arange(C)[None, :] >= counts[:, None]
    k = _port(np.where(pad, np.uint32(0xFFFFFFFF), keys))
    ks, vs = bt.local_sort_fast(k, torch.from_numpy(idx.view(np.int32)))
    assert np.array_equal(_ref_u32(ks), np.asarray(rk))
    assert np.array_equal(vs.numpy().view(np.uint32), np.asarray(rv))


def _counts(kind, rows, C, g):
    if kind == "edges":
        return np.array([0, 1, C, C // 2][:rows], np.int64)
    cnt = g.integers(0, C + 1, size=rows)
    cnt[0] = C
    return cnt.astype(np.int64)


@pytest.mark.parametrize("hi", [1, 4, 2 ** 32])      # 1: all keys equal
@pytest.mark.parametrize("C", [1, 300, bt.TILE - 1, bt.TILE, bt.TILE + 1])
@pytest.mark.parametrize("counts", ["edges", "ragged"])
def test_count_aware_plain_sort_matches_kernel_off_local_sort(
        kernels_off, hi, C, counts):
    """The count-aware sort of the padded rows is the reference's
    kernel-off ``local_sort`` and the full-row stable sort; on rows whose
    tail is not padded it sorts the prefix and leaves the tail in place."""
    g = np.random.default_rng(C + hi % 89 + len(counts))
    keys = _u32(g, (4, C), hi)
    keys[:, : min(C, 3)] = 0xFFFFFFFF            # real keys equal to the pad
    idx = np.arange(4 * C, dtype=np.uint32).reshape(4, C)
    cnt = _counts(counts, 4, C, g)

    def one(k, v, c):
        sh = jt.local_sort(jt.SortShard(k, {"idx": v}, c))
        return sh.keys, sh.vals["idx"]
    rk, rv = jax.vmap(one)(jnp.asarray(keys), jnp.asarray(idx),
                           jnp.asarray(cnt.astype(np.int32)))
    pad = np.arange(C)[None, :] >= cnt[:, None]
    k = _port(np.where(pad, np.uint32(0xFFFFFFFF), keys))
    v = torch.from_numpy(idx.view(np.int32))
    count = torch.from_numpy(cnt)
    ks, vs = bt.local_sort_fast(k, v, count)
    assert np.array_equal(_ref_u32(ks), np.asarray(rk))
    assert np.array_equal(vs.numpy().view(np.uint32), np.asarray(rv))
    fk, fv = bref.sort_ref(k, v)
    assert torch.equal(ks, fk) and torch.equal(vs, fv)
    # a tail that is not padding stays where it is
    raw = _port(keys)
    ks, vs = bt.local_sort_fast(raw, v, count)
    for r in range(4):
        c = int(cnt[r])
        want, order = torch.sort(raw[r, :c], stable=True)
        assert torch.equal(ks[r, :c], want)
        assert torch.equal(vs[r, :c], v[r, :c][order])
        assert torch.equal(ks[r, c:], raw[r, c:])
        assert torch.equal(vs[r, c:], v[r, c:])


@pytest.mark.parametrize("width", [64, 100])
@pytest.mark.parametrize("counts", ["edges", "ragged"])
def test_count_aware_plain_tiles_and_merge(width, counts):
    """Tile sort and run merge with a count: each segment of the valid
    prefix sorted (merged) on its own, the tail untouched."""
    g = np.random.default_rng(width + len(counts))
    C = 5 * width + 7
    keys = _port(_u32(g, (4, C), 6))
    vals = torch.arange(4 * C, dtype=torch.int32).reshape(4, C)
    cnt = torch.from_numpy(_counts(counts, 4, C, g))
    tk, tv = bref.sort_tiles_ref(keys, vals, width, cnt)
    mk, mv = bref.merge_runs_ref(tk, tv, width, cnt)
    for seg, (ok, ov) in ((width, (tk, tv)), (2 * width, (mk, mv))):
        for r in range(4):
            c = int(cnt[r])
            for a in range(0, c, seg):
                b = min(a + seg, c)
                want, order = torch.sort(keys[r, a:b], stable=True)
                assert torch.equal(ok[r, a:b], want)
                assert torch.equal(ov[r, a:b], vals[r, a:b][order])
            assert torch.equal(ok[r, c:], keys[r, c:])
            assert torch.equal(ov[r, c:], vals[r, c:])


@pytest.mark.parametrize("hi", [3, 2 ** 32])
def test_plain_tile_sort_keys_match_pallas_sort_tile(hi):
    g = np.random.default_rng(hi % 1009)
    tile, tiles = 256, 3
    keys = _u32(g, (2, tile * tiles), hi)
    got, _ = bref.sort_tiles_ref(_port(keys), None, tile)
    for r in range(2):
        for t in range(tiles):
            seg = jnp.asarray(keys[r, t * tile:(t + 1) * tile])
            want = np.asarray(sort_tile(seg, interpret=True))
            assert np.array_equal(_ref_u32(got[r, t * tile:(t + 1) * tile]),
                                  want)


@pytest.mark.parametrize("hi", [3, 2 ** 32])
def test_plain_run_merge_keys_match_pallas_merge_tiles(hi):
    g = np.random.default_rng(hi % 1013)
    w = 256
    keys = np.sort(_u32(g, (2, 2, w), hi), axis=2).reshape(2, 2 * w)
    got, _ = bref.merge_runs_ref(_port(keys), None, w)
    for r in range(2):
        want = np.asarray(merge_tiles(jnp.asarray(keys[r, :w]),
                                      jnp.asarray(keys[r, w:]),
                                      interpret=True))
        assert np.array_equal(_ref_u32(got[r]), want)


def test_plain_run_merge_is_stable_and_keeps_left_ties_first():
    g = np.random.default_rng(7)
    w, C = 100, 350                              # ragged: last run unpaired
    keys = _port(_u32(g, (3, C), 5))
    vals = torch.arange(3 * C, dtype=torch.int32).reshape(3, C)
    rk, rv = bref._segment_sort(keys, vals, w)
    mk, mv = bref.merge_runs_ref(rk, rv, w)
    sk, sv = bref._segment_sort(keys, vals, 2 * w)
    assert torch.equal(mk, sk) and torch.equal(mv, sv)


def _partition_case(nb, C, seed, hi):
    g = np.random.default_rng(seed)
    keys = np.sort(_u32(g, (C,), hi))
    ties = _u32(g, (C,), 2 ** 32)
    comp = np.sort((_u32(g, (nb - 1,), hi).astype(np.uint64) << np.uint64(32))
                   | _u32(g, (nb - 1,), 2 ** 32).astype(np.uint64))
    s_keys = (comp >> np.uint64(32)).astype(np.uint32)
    s_ties = (comp & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return keys, ties, s_keys, s_ties


COUNT_CASES = ["zero", "one", "half", "all"]


def _count(case, C):
    return {"zero": 0, "one": 1, "half": C // 2, "all": C}[case]


@pytest.mark.parametrize("nb", [2, 16, 64])
@pytest.mark.parametrize("hi", [7, 2 ** 32])
@pytest.mark.parametrize("inclusive", [True, False])
def test_plain_partition_matches_reference(nb, hi, inclusive):
    C = 300
    rows = [_partition_case(nb, C, nb * 31 + r, hi) for r in range(4)]
    counts = [_count(c, C) for c in COUNT_CASES]
    stack = [np.stack([r[i] for r in rows]) for i in range(4)]
    keys, ties, s_keys, s_ties = stack
    got_b, got_q, got_h = pt.partition_buckets(
        _port(keys), torch.from_numpy(ties.view(np.int32)), _port(s_keys),
        torch.from_numpy(s_ties.view(np.int32)), n_buckets=nb,
        count=torch.as_tensor(counts), inclusive=inclusive)
    for r in range(4):
        b, q, h = j_partition_ref(
            jnp.asarray(keys[r]), jnp.asarray(ties[r]),
            jnp.asarray(s_keys[r]), jnp.asarray(s_ties[r]), n_buckets=nb,
            count=counts[r], inclusive=inclusive)
        assert np.array_equal(got_b[r].numpy(), np.asarray(b))
        assert np.array_equal(got_q[r].numpy(), np.asarray(q))
        assert np.array_equal(got_h[r].numpy(), np.asarray(h))
        assert int(got_h[r].sum()) == counts[r]


@pytest.mark.parametrize("nb", [2, 16, 64])
@pytest.mark.parametrize("count", COUNT_CASES)
def test_plain_partition_matches_pallas_partition_tile(nb, count):
    C = 1000                                     # several Pallas tiles
    keys, ties, s_keys, s_ties = _partition_case(nb, C, nb + 5, 2 ** 32)
    cnt = _count(count, C)
    b, q, h = j_partition(jnp.asarray(keys), jnp.asarray(ties),
                          jnp.asarray(s_keys), jnp.asarray(s_ties),
                          n_buckets=nb, count=cnt, use_kernel=True,
                          interpret=True)
    gb, gq, gh = pt.partition_buckets(
        _port(keys[None]), torch.from_numpy(ties[None].view(np.int32)),
        _port(s_keys[None]), torch.from_numpy(s_ties[None].view(np.int32)),
        n_buckets=nb, count=torch.tensor([cnt]))
    assert np.array_equal(gb[0].numpy(), np.asarray(b))
    assert np.array_equal(gq[0].numpy(), np.asarray(q))
    assert np.array_equal(gh[0].numpy(), np.asarray(h))


@pytest.mark.parametrize("nb", [2, 16, 64])
def test_plain_classify_then_rank_equals_the_fused_partition(nb):
    """The two CUDA launches' plain versions, chained through the per-tile
    offsets as the wrapper chains the kernels, give partition_ref."""
    C = 3 * pt.PTILE + 77
    rows = [_partition_case(nb, C, nb * 7 + r, 50) for r in range(3)]
    keys, ties, s_keys, s_ties = [np.stack([r[i] for r in rows])
                                  for i in range(4)]
    args = (_port(keys), torch.from_numpy(ties.view(np.int32)),
            _port(s_keys), torch.from_numpy(s_ties.view(np.int32)))
    count = torch.tensor([C, 0, 2 * pt.PTILE + 5])
    bucket, th = pref.classify_ref(*args, count, n_buckets=nb, tile=pt.PTILE)
    off = torch.cumsum(th, 1, dtype=torch.int32) - th
    pos = pref.rank_ref(bucket, off, n_buckets=nb, tile=pt.PTILE)
    rb, rq, rh = pref.partition_ref(*args, n_buckets=nb, count=count)
    assert torch.equal(bucket, rb) and torch.equal(pos, rq)
    assert torch.equal(th.sum(1, dtype=torch.int32)[:, :nb], rh)


# the classify launches without the rank, by partition_buckets' flags
_NO_RANK = {"bucket_hist": (True, True), "bucket": (True, False),
            "hist": (False, True)}


def _no_rank_outputs(args, count, nb, want, inclusive=True):
    """One variant's outputs through the wrapper and through the launch:
    (bucket or None, hist or None) twice."""
    wb, wh = _NO_RANK[want]
    b, q, h = pt.partition_buckets(*args, n_buckets=nb, count=count,
                                   inclusive=inclusive, want_pos=False,
                                   want_bucket=wb, want_hist=wh)
    assert q is None
    launch = pt.classify(*args, count, n_buckets=nb, inclusive=inclusive,
                         want=want)
    assert len(launch) == wb + wh
    lb = launch[0] if wb else None
    lh = launch[-1] if wh else None
    return (b, h), (lb, lh)


@pytest.mark.parametrize("want", list(_NO_RANK))
@pytest.mark.parametrize("nb", [2, 16, 256])
@pytest.mark.parametrize("inclusive", [True, False])
def test_plain_partition_variants_match_reference(want, nb, inclusive):
    """SSort's (buckets only), RQuick's (histogram only) and the buckets
    with the histogram, each as what its launch's plain version returns,
    against the reference's ``partition_ref`` with ``want_pos=False``;
    ties over their whole range, counts 0, 1, C/2 and C."""
    C = 300
    rows = [_partition_case(nb, C, nb * 37 + r, 2 ** 32) for r in range(4)]
    counts = [_count(c, C) for c in COUNT_CASES]
    keys, ties, s_keys, s_ties = [np.stack([r[i] for r in rows])
                                  for i in range(4)]
    args = (_port(keys), torch.from_numpy(ties.view(np.int32)),
            _port(s_keys), torch.from_numpy(s_ties.view(np.int32)))
    wb, wh = _NO_RANK[want]
    for b, h in _no_rank_outputs(args, torch.as_tensor(counts), nb, want,
                                 inclusive):
        assert (b is None) == (not wb) and (h is None) == (not wh)
        for r in range(4):
            rb, rq, rh = j_partition_ref(
                jnp.asarray(keys[r]), jnp.asarray(ties[r]),
                jnp.asarray(s_keys[r]), jnp.asarray(s_ties[r]),
                n_buckets=nb, count=counts[r], inclusive=inclusive,
                want_pos=False)
            assert rq is None
            assert b is None or np.array_equal(b[r].numpy(), np.asarray(rb))
            assert h is None or np.array_equal(h[r].numpy(), np.asarray(rh))


@pytest.mark.parametrize("want", list(_NO_RANK))
@pytest.mark.parametrize("nb", [2, 64])
@pytest.mark.parametrize("count", ["one", "half"])
def test_plain_partition_variants_match_pallas_partition_tile(want, nb,
                                                              count):
    C = 1000                                     # several Pallas tiles
    keys, ties, s_keys, s_ties = _partition_case(nb, C, nb + 9, 2 ** 32)
    cnt = _count(count, C)
    jb, jq, jh = j_partition(jnp.asarray(keys), jnp.asarray(ties),
                             jnp.asarray(s_keys), jnp.asarray(s_ties),
                             n_buckets=nb, count=cnt, want_pos=False,
                             use_kernel=True, interpret=True)
    assert jq is None
    args = (_port(keys[None]), torch.from_numpy(ties[None].view(np.int32)),
            _port(s_keys[None]), torch.from_numpy(s_ties[None].view(
                np.int32)))
    for b, h in _no_rank_outputs(args, torch.tensor([cnt]), nb, want):
        assert b is None or np.array_equal(b[0].numpy(), np.asarray(jb))
        assert h is None or np.array_equal(h[0].numpy(), np.asarray(jh))


def test_plain_classify_refuses_an_unknown_variant():
    k = torch.zeros((1, 4), dtype=torch.int32)
    count = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="want"):
        pt.classify(k, k, k[:, :1], k[:, :1], count, n_buckets=2,
                    want="pos")
    m = k.to("meta")                     # past the CPU's plain version
    with pytest.raises(ValueError, match="no output"):
        pt.partition_buckets(m, m, m[:, :1], m[:, :1], n_buckets=2,
                             count=count.to("meta"), want_pos=False,
                             want_bucket=False, want_hist=False)


def _kway_port(keys, ties, sk, st, nb):
    return kw.kway_classify(_port(keys), torch.from_numpy(ties.view(np.int32)),
                            _port(sk), torch.from_numpy(st.view(np.int32)),
                            n_buckets=nb)


def _kway_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("nb", [2, 8, 64, 128])
@pytest.mark.parametrize("C", [8192, 8192 + 7, 16384])
def test_plain_kway_matches_pallas_kway_and_its_reference(nb, C):
    """The splitters of tests/test_kernels.py: sorted keys, unordered ties
    (so not in lex order: a search over them would answer otherwise)."""
    g = np.random.default_rng(nb * 7 + C)
    keys = g.integers(0, 1000, size=C).astype(np.uint32)
    ties = g.integers(0, 2 ** 20, size=C).astype(np.uint32)
    sk = np.sort(g.integers(0, 1000, size=nb - 1)).astype(np.uint32)
    st = g.integers(0, 2 ** 20, size=nb - 1).astype(np.uint32)
    args = [jnp.asarray(a) for a in (keys, ties, sk, st)]
    got = _kway_port(keys, ties, sk, st, nb)
    _kway_same(got, j_kway(*args, n_buckets=nb, interpret=True,
                           use_kernel=True))
    _kway_same(got, j_kway_ref(*args, n_buckets=nb))
    assert int(got[1].sum()) == C


def test_plain_kway_splits_equal_keys_by_tie():
    """All-equal keys split by the tie alone (the reference's App. G test),
    with full-range uint32 ties, which compare unsigned."""
    C, nb = 8192, 8
    keys = np.zeros(C, np.uint32)
    ties = (np.arange(C, dtype=np.uint64) * 524_287 % 2 ** 32).astype(
        np.uint32)
    qs = np.sort(ties)[np.linspace(0, C, nb, endpoint=False)[1:].astype(int)]
    sk = np.zeros(nb - 1, np.uint32)
    got = _kway_port(keys, ties, sk, qs, nb)
    _kway_same(got, j_kway(*[jnp.asarray(a) for a in (keys, ties, sk, qs)],
                           n_buckets=nb, interpret=True, use_kernel=True))
    h = got[1].numpy()
    assert h.max() - h.min() <= 1


def test_plain_kway_counts_past_n_buckets_like_the_reference():
    """More splitters than n_buckets − 1, and none: bucket ids count every
    splitter, the histogram keeps the first n_buckets."""
    g = np.random.default_rng(3)
    keys = g.integers(0, 2 ** 32, size=300, dtype=np.int64).astype(np.uint32)
    ties = g.integers(0, 2 ** 32, size=300, dtype=np.int64).astype(np.uint32)
    for S, nb in ((9, 4), (0, 1), (0, 3)):
        sk = g.integers(0, 2 ** 32, size=S, dtype=np.int64).astype(np.uint32)
        st = g.integers(0, 2 ** 32, size=S, dtype=np.int64).astype(np.uint32)
        _kway_same(_kway_port(keys, ties, sk, st, nb),
                   j_kway_ref(*[jnp.asarray(a) for a in (keys, ties, sk, st)],
                              n_buckets=nb))


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    k = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bt.sort_tiles(k)
    with pytest.raises(ValueError, match="CUDA"):
        bt.merge_runs(k, None, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pt.classify(k, k, k[:, :1], k[:, :1],
                    torch.zeros(2, dtype=torch.int64, device="meta"),
                    n_buckets=2)
    with pytest.raises(ValueError, match="CUDA"):
        kw.kway_classify(k[0], k[0], k[0, :1], k[0, :1], n_buckets=2)


def test_build_log_is_kept_beside_a_reused_library(tmp_path, monkeypatch):
    """A library built earlier is reused without nvcc, and its ptxas log is
    read back from beside it, so the register report survives a cached
    build."""
    from repro_torch.kernels import _build
    lib = tmp_path / "libbitonic_0123456789abcdef.so"
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info    : Used 64 registers")
    monkeypatch.setattr(_build, "_target", lambda name: lib)
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("rebuilt"))
    _build.build_all(["bitonic"])
    assert _build.BUILD_LOG == {"bitonic": "ptxas info    : Used 64 registers"}
