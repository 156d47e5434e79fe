"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels are
built with nvcc on first use); each carries the ``cuda`` marker and skips
where no GPU is present.  Run them on the GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports torch and numpy only (no jax), so it runs where JAX is
not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch import ExternalPolicy, SortConfig, psort
from repro_torch.data import INSTANCES, generate_instance
from repro_torch.kernels import _build
from repro_torch.kernels import bitonic as bt
from repro_torch.kernels import kway as kw
from repro_torch.kernels import partition as pt
from repro_torch.kernels.bitonic import ref as bref
from repro_torch.kernels.kway import ref as kref
from repro_torch.kernels.partition import ref as pref

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels are built with nvcc there)")
    _build.build_all()
    for name, log in _build.BUILD_LOG.items():
        print(f"--- nvcc {name}\n{log}")
    return torch.device("cuda")


def _keys(rows, C, hi, seed, device):
    g = np.random.default_rng(seed)
    k = g.integers(-hi, hi, size=(rows, C), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(k).to(device)


def _payload(rows, C, device):
    return torch.arange(rows * C, dtype=torch.int32,
                        device=device).reshape(rows, C)


T = bt.TILE
# shapes: C below, at and just above a multiple of the tile; 256 rows (the
# main path's p)
SORT_SHAPES = [(1, 1), (4, T - 1), (4, T), (3, T + 1), (2, 5 * T),
               (2, 5 * T + 3), (256, 2 * T + 100)]


def _sort_inputs(rows, C, keys, counts, with_vals, device, seed=0):
    """Keys all equal (the Zero instance), of 3-20 distinct values (the
    diagonals fall inside long tie runs) or over the whole int32 range,
    with the pad word as a real key; counts full (None), at the edges (0,
    1, C) or ragged."""
    g = np.random.default_rng(seed + rows + C)
    if keys == "equal":
        k = np.zeros((rows, C), np.int32)
    elif keys == "few":
        k = g.integers(0, int(g.integers(3, 21)), size=(rows, C)) * 1000
    else:
        k = g.integers(-2 ** 31, 2 ** 31, size=(rows, C))
        k[0, :min(C, 10)] = 2 ** 31 - 1
    k = torch.from_numpy(np.asarray(k, np.int64).astype(np.int32)).to(device)
    if counts is None:
        cnt = None
    elif counts == "edges":
        cnt = np.array([0, 1, C][:rows] + [C] * max(0, rows - 3))
    else:
        cnt = g.integers(0, C + 1, size=rows)
        cnt[0] = C
    if cnt is not None:
        cnt = torch.from_numpy(np.asarray(cnt, np.int64)).to(device)
    v = _payload(rows, C, device) if with_vals else None
    return k, v, cnt


def _same(got, want):
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("rows,C", SORT_SHAPES)
@pytest.mark.parametrize("keys", ["equal", "few", "wide"])
@pytest.mark.parametrize("counts", [None, "edges", "ragged"])
@pytest.mark.parametrize("with_vals", [True, False])
def test_tile_sort_matches_plain(dev, rows, C, keys, counts, with_vals):
    k, v, cnt = _sort_inputs(rows, C, keys, counts, with_vals, dev)
    _same(bt.sort_tiles(k, v, cnt), bref.sort_tiles_ref(k, v, T, cnt))


@pytest.mark.parametrize("rows,C,width", [
    (2, 2 * T, T), (3, 3 * T - 1, T), (256, 3 * T + 7, T),
    (2, 9 * T + 1, 4 * T), (2, (1 << 21) + 5, 1 << 20)])
@pytest.mark.parametrize("keys", ["equal", "few", "wide"])
@pytest.mark.parametrize("counts", [None, "edges", "ragged"])
@pytest.mark.parametrize("with_vals", [True, False])
def test_run_merge_matches_plain(dev, rows, C, width, keys, counts,
                                 with_vals):
    k, v, cnt = _sort_inputs(rows, C, keys, counts, with_vals, dev)
    k, v = bref._segment_sort(k, v, width, cnt)  # sorted runs of width
    _same(bt.merge_runs(k, v, width, cnt),
          bref.merge_runs_ref(k, v, width, cnt))


@pytest.mark.parametrize("rows,C", [*SORT_SHAPES, (256, (1 << 18) + 3),
                                    (2, (1 << 20) + 1)])
@pytest.mark.parametrize("keys", ["equal", "few", "wide"])
@pytest.mark.parametrize("counts", [None, "edges", "ragged"])
@pytest.mark.parametrize("with_vals", [True, False])
def test_local_sort_fast_matches_stable_sort(dev, rows, C, keys, counts,
                                             with_vals):
    k, v, cnt = _sort_inputs(rows, C, keys, counts, with_vals, dev)
    before = dict(bt.LAUNCHES)
    got = bt.local_sort_fast(k, v, cnt)
    cmax = C if cnt is None else int(cnt.max())
    assert bt.LAUNCHES["tile_sort"] == before["tile_sort"] + 1
    assert bt.LAUNCHES["run_merge"] == (before["run_merge"]
                                        + bt.ops.merge_passes(cmax))
    _same(got, bref.sort_ref(k, v, cnt))


@pytest.mark.parametrize("rows,C", [(70_001, 1024), (1 << 18, 1024),
                                    (65_537, 2 * T + 3)])
@pytest.mark.parametrize("keys", ["few", "wide"])
@pytest.mark.parametrize("counts", [None, "ragged"])
def test_local_sort_fast_on_more_than_65535_rows(dev, rows, C, keys, counts):
    """The kernels' grids are one-dimensional, so the row count is not
    capped at gridDim.y's 65 535 (RQuick's p = 2^18 rows); odd row counts
    and a merge pass included."""
    k, v, cnt = _sort_inputs(rows, C, keys, counts, True, dev)
    before = dict(bt.LAUNCHES)
    got = bt.local_sort_fast(k, v, cnt)
    assert bt.LAUNCHES["tile_sort"] == before["tile_sort"] + 1
    _same(got, bref.sort_ref(k, v, cnt))


def _partition_inputs(rows, C, nb, seed, device, hi=50, sort=True):
    g = np.random.default_rng(seed)
    keys = g.integers(-hi, hi, size=(rows, C))
    keys = np.sort(keys, axis=1) if sort else keys
    ties = g.integers(0, 2 ** 32, size=(rows, C), dtype=np.uint64)
    sk = np.sort(g.integers(-hi, hi, size=(rows, nb - 1)), axis=1)
    st = g.integers(0, 2 ** 32, size=(rows, nb - 1), dtype=np.uint64)
    comp = (sk.astype(np.int64) << 32) | st.astype(np.int64)
    comp = np.sort(comp, axis=1)             # nondecreasing (key, tie)
    sk, st = comp >> 32, comp & 0xFFFFFFFF

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int64).astype(np.uint32)
                                .view(np.int32)).to(device)

    counts = np.linspace(0, C, rows).astype(np.int64)
    return (i32(keys), i32(ties), i32(sk).contiguous(), i32(st).contiguous(),
            torch.from_numpy(counts).to(device))


@pytest.mark.parametrize("nb", [2, 16, 64, 512])
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("C", [1, 1000, 5000, 70_000])
def test_partition_matches_plain(dev, nb, inclusive, C):
    keys, ties, sk, st, cnt = _partition_inputs(4, C, nb, nb + C, dev)
    b, q, h = pt.partition_buckets(keys, ties, sk, st, n_buckets=nb,
                                   count=cnt, inclusive=inclusive)
    rb, rq, rh = pref.partition_ref(keys, ties, sk, st, n_buckets=nb,
                                    count=cnt, inclusive=inclusive)
    torch.cuda.synchronize()
    assert torch.equal(b, rb) and torch.equal(q, rq) and torch.equal(h, rh)
    assert torch.equal(h.sum(1, dtype=torch.int64), cnt)
    bk, th = pt.classify(keys, ties, sk, st, cnt, n_buckets=nb,
                         inclusive=inclusive)
    rbk, rth = pref.classify_ref(keys, ties, sk, st, cnt, n_buckets=nb,
                                 tile=pt.PTILE, inclusive=inclusive)
    off = torch.cumsum(th, 1, dtype=torch.int32) - th
    assert torch.equal(bk, rbk) and torch.equal(th, rth)
    assert torch.equal(pt.rank(bk, off, n_buckets=nb),
                       pref.rank_ref(bk, off, n_buckets=nb, tile=pt.PTILE))


@pytest.mark.parametrize("nb", [2, 16])
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("rows,C", [(70_001, 1024), (1 << 18, 1024),
                                    (65_537, 3000)])
def test_partition_on_more_than_65535_rows(dev, nb, inclusive, rows, C):
    keys, ties, sk, st, cnt = _partition_inputs(rows, C, nb, rows + nb, dev)
    for want_pos in (True, False):
        got = pt.partition_buckets(keys, ties, sk, st, n_buckets=nb,
                                   count=cnt, inclusive=inclusive,
                                   want_pos=want_pos)
        want = pref.partition_ref(keys, ties, sk, st, n_buckets=nb,
                                  count=cnt, inclusive=inclusive,
                                  want_pos=want_pos)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("algorithm,name,p,per", [
    ("rquick", "Uniform", 64, 1024), ("rquick", "Zero", 64, 1024),
    ("rquick", "AllToOne", 64, 1000), ("ntb-quick", "Uniform", 64, 1024),
    ("ntb-quick", "Zero", 64, 1024), ("rquick", "Uniform", 1 << 17, 4),
    ("rquick", "DeterDupl", 1 << 17, 3)])
def test_rquick_psort_cuda_equals_cpu(dev, algorithm, name, p, per):
    """RQuick and NTB-Quick on the card equal the CPU run bit for bit,
    also at more than 65 535 PEs (p = 2^17)."""
    x = generate_instance(name, p, p * per).astype(np.uint32)
    cfg = SortConfig(p=p, algorithm=algorithm)
    go, gi = psort(x, cfg, return_info=True, device="cuda")
    co, ci = psort(x, cfg, return_info=True, device="cpu")
    assert gi["algorithm"] == algorithm
    assert torch.equal(go.view(torch.int32).cpu(), co.view(torch.int32))
    assert torch.equal(gi["perm"].cpu(), ci["perm"])
    assert torch.equal(gi["counts"].cpu(), ci["counts"])
    assert gi["overflow"] == ci["overflow"]


@pytest.mark.parametrize("name,p,per", [
    *[(name, 8, 3000) for name in sorted(INSTANCES)],
    *[(name, 64, 20_000) for name in ("Uniform", "Zero", "AllToOne",
                                      "Mirrored")],
    ("Uniform", 256, 4099), ("DeterDupl", 256, 4099)])
def test_psort_cuda_equals_cpu(dev, name, p, per):
    x = generate_instance(name, p, p * per).astype(np.uint32)
    cfg = SortConfig(p=p, algorithm="rams")
    go, gi = psort(x, cfg, return_info=True, device="cuda")
    co, ci = psort(x, cfg, return_info=True, device="cpu")
    assert torch.equal(go.view(torch.int32).cpu(), co.view(torch.int32))
    assert torch.equal(gi["perm"].cpu(), ci["perm"])
    assert torch.equal(gi["counts"].cpu(), ci["counts"])
    assert gi["overflow"] == ci["overflow"]


@pytest.mark.parametrize("C,nb,ordered", [
    (1, 2, True), (1000, 8, False), (1024, 16, True), (8192 + 7, 16, True),
    (100_003, 2, False), (100_003, 128, False), (300_000, 2048, False),
    (50_000, 20_000, False), (5000, 1, True), (0, 4, True)])
def test_kway_matches_plain(dev, C, nb, ordered):
    """Ragged C (no multiple of the block), splitters in and out of lex
    order, more splitters than one shared-memory tree holds (nb = 20 000:
    the chunked search) and a histogram counted in device memory
    (nb > 2048)."""
    g = np.random.default_rng(C + nb)
    keys = np.sort(g.integers(-2 ** 31, 2 ** 31, size=C)).astype(np.int32)
    ties = g.integers(-2 ** 31, 2 ** 31, size=C).astype(np.int32)
    sk = np.sort(g.integers(-2 ** 31, 2 ** 31, size=nb - 1)).astype(np.int32)
    if C:
        sk[: (nb - 1) // 2] = g.choice(keys, size=(nb - 1) // 2)  # equal keys
        sk = np.sort(sk)
    st = g.integers(-2 ** 31, 2 ** 31, size=nb - 1).astype(np.int32)
    if ordered:                                  # lex order, ties unsigned
        comp = np.sort((sk.astype(np.int64) << 32)
                       | (st.astype(np.int64) & 0xFFFFFFFF))
        sk = (comp >> 32).astype(np.int32)
        st = (comp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (keys, ties, sk, st)]
    b, h = kw.kway_classify(*args, n_buckets=nb)
    rb, rh = kref.kway_classify_ref(*args, n_buckets=nb)
    torch.cuda.synchronize()
    assert torch.equal(b, rb) and torch.equal(h, rh)
    assert int(h.sum()) == C


@pytest.mark.parametrize("name,dtype,budget", [
    ("Uniform", np.uint32, 1000), ("Zero", np.int32, 1000),
    ("Staggered", np.float32, 333), ("Uniform", np.int64, 1000)])
def test_external_psort_cuda_equals_cpu(dev, name, dtype, budget):
    p = 16
    x = generate_instance(name, p, p * 5000).astype(dtype)
    for double_buffer in (True, False):
        cfg = SortConfig(p=p, external=ExternalPolicy(
            budget=budget, double_buffer=double_buffer))
        go, gi = psort(x, cfg, return_info=True, device="cuda")
        co, ci = psort(x, cfg, return_info=True, device="cpu")
        assert gi["algorithm"] == "external"
        assert gi["overflow"] == ci["overflow"] == 0
        assert torch.equal(go.cpu().view(torch.uint8), co.view(torch.uint8))
        assert torch.equal(gi["perm"].cpu(), ci["perm"])
        assert torch.equal(gi["counts"].cpu(), ci["counts"])


@pytest.mark.parametrize("nb", [256, 1024, 2048])
@pytest.mark.parametrize("C", [1000, 70_000])
def test_partition_classify_without_rank_at_many_buckets(dev, nb, C):
    """SSort's classify: nb = p buckets, ``want_pos=False`` (the classify
    kernel alone), with more splitters than one tile has elements."""
    keys, ties, sk, st, cnt = _partition_inputs(8, C, nb, nb + C + 1, dev)
    got = pt.partition_buckets(keys, ties, sk, st, n_buckets=nb, count=cnt,
                               want_pos=False)
    want = pref.partition_ref(keys, ties, sk, st, n_buckets=nb, count=cnt,
                              want_pos=False)
    torch.cuda.synchronize()
    assert got[1] is None and want[1] is None
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[2].sum(1, dtype=torch.int64), cnt)


@pytest.mark.parametrize("keys", ["equal", "few", "wide"])
@pytest.mark.parametrize("counts", [None, "ragged"])
def test_local_sort_fast_on_rfis_rows(dev, keys, counts):
    """RFIS's first local sort at p = 2^18, n/p = 1: (2^18, 4) rows."""
    k, v, cnt = _sort_inputs(1 << 18, 4, keys, counts, True, dev)
    _same(bt.local_sort_fast(k, v, cnt), bref.sort_ref(k, v, cnt))


@pytest.mark.parametrize("algorithm,name,p,n", [
    ("rfis", "Uniform", 1 << 10, 1 << 12), ("rfis", "DeterDupl", 1 << 10,
                                            1 << 12),
    ("rfis", "Zero", 1 << 14, 1 << 14),
    ("gatherm", "Uniform", 1 << 8, 1 << 5), ("gatherm", "Zero", 64, 3000),
    ("allgatherm", "Uniform", 1 << 8, 1 << 5),
    ("allgatherm", "RandDupl", 64, 1000),
    ("ssort", "Uniform", 64, 1 << 18), ("ssort", "Zero", 64, 1 << 16),
    ("ns-ssort", "Staggered", 64, 1 << 18), ("ns-ssort", "Zero", 64, 1 << 16),
    ("ssort", "Uniform", 2048, 1 << 20),
    ("bitonic", "Uniform", 64, 1 << 18), ("bitonic", "DeterDupl", 16, 50_000),
    ("ntb-ams", "Uniform", 64, 1 << 18), ("ntb-ams", "Zero", 64, 1 << 16)])
def test_other_algorithms_cuda_equal_cpu(dev, algorithm, name, p, n):
    """Every algorithm ported after RAMS and RQuick, on the card against
    its CPU run bit for bit; Zero overflows SSort, NS-SSort and NTB-AMS in
    both."""
    x = generate_instance(name, p, n).astype(np.uint32)
    cfg = SortConfig(p=p, algorithm=algorithm)
    go, gi = psort(x, cfg, return_info=True, device="cuda")
    co, ci = psort(x, cfg, return_info=True, device="cpu")
    assert gi["algorithm"] == algorithm
    assert torch.equal(go.view(torch.int32).cpu(), co.view(torch.int32))
    assert torch.equal(gi["perm"].cpu(), ci["perm"])
    assert torch.equal(gi["counts"].cpu(), ci["counts"])
    assert gi["overflow"] == ci["overflow"]


# the classify variants without the rank, by partition_buckets' flags
_NO_RANK = {"bucket_hist": (True, True), "bucket": (True, False),
            "hist": (False, True)}


@pytest.mark.parametrize("want", pt.WANTS)
@pytest.mark.parametrize("nb", [1, 2, 64, 256, 2048])
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("C,sort", [(1, True), (1003, True), (4096, True),
                                    (4096, False), (70_001, True)])
def test_partition_launch_variants_match_plain(dev, want, nb, inclusive, C,
                                               sort):
    """Every classify launch against its plain version: ragged counts (0
    to C, so whole tiles past the count), C not a multiple of 4 (no
    16-byte access) or of the tile, rows not sorted (no warp of one
    bucket), keys and ties over their whole range (the all-ones word
    meets the tree's +inf pads), and partition_buckets with each set of
    flags."""
    keys, ties, sk, st, cnt = _partition_inputs(5, C, nb, nb + C, dev,
                                                hi=2 ** 31, sort=sort)
    keys[:, -1], ties[:, -1] = 2 ** 31 - 1, -1       # the all-ones word
    before = dict(pt.LAUNCHES)
    got = pt.classify(keys, ties, sk, st, cnt, n_buckets=nb,
                      inclusive=inclusive, want=want)
    plain = pref.classify_ref(keys, ties, sk, st, cnt, n_buckets=nb,
                              tile=pt.PTILE, inclusive=inclusive, want=want)
    torch.cuda.synchronize()
    for key in ("partition_classify", f"partition_classify:{want}"):
        assert pt.LAUNCHES[key] == before[key] + 1
    assert len(got) == len(plain)
    for a, b in zip(got, plain):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    if want in _NO_RANK:
        wb, wh = _NO_RANK[want]
        b, q, h = pt.partition_buckets(keys, ties, sk, st, n_buckets=nb,
                                       count=cnt, inclusive=inclusive,
                                       want_pos=False, want_bucket=wb,
                                       want_hist=wh)
        rb, _, rh = pref.partition_ref(keys, ties, sk, st, n_buckets=nb,
                                       count=cnt, inclusive=inclusive,
                                       want_pos=False)
        assert q is None and (b is None) == (not wb) and (h is None) == (
            not wh)
        assert b is None or torch.equal(b, rb)
        assert h is None or (torch.equal(h, rh) and torch.equal(
            h.sum(1, dtype=torch.int64), cnt))


@pytest.mark.parametrize("want", pt.WANTS)
@pytest.mark.parametrize("rows,C,nb", [(70_001, 1024, 2), (1 << 18, 1024, 2),
                                       (65_537, 3000, 16)])
def test_partition_launch_variants_on_more_than_65535_rows(dev, want, rows,
                                                           C, nb):
    keys, ties, sk, st, cnt = _partition_inputs(rows, C, nb, rows + nb, dev)
    got = pt.classify(keys, ties, sk, st, cnt, n_buckets=nb, want=want)
    plain = pref.classify_ref(keys, ties, sk, st, cnt, n_buckets=nb,
                              tile=pt.PTILE, want=want)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algorithm", ["rquick", "ntb-quick", "rfis", "ssort",
                                       "ns-ssort", "bitonic", "gatherm",
                                       "allgatherm"])
@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.float64])
def test_keys64_psort_cuda_equals_cpu(dev, algorithm, dtype):
    """8-byte keys on the card equal the CPU run bit for bit, the largest
    key among them (RQuick returns it out of order on both, as the
    reference does)."""
    p = 16
    u = generate_instance("RandDupl", p, p * 300).astype(np.uint64)
    x = ((u << np.uint64(32)) | u).view(np.int64).astype(dtype) \
        if dtype != np.uint64 else (u << np.uint64(32)) | u
    x[7] = np.iinfo(dtype).max if dtype != np.float64 else np.inf
    cfg = SortConfig(p=p, algorithm=algorithm)
    go, gi = psort(x, cfg, return_info=True, device="cuda")
    co, ci = psort(x, cfg, return_info=True, device="cpu")
    assert go.dtype == co.dtype
    assert torch.equal(go.cpu().view(torch.int64), co.view(torch.int64))
    assert torch.equal(gi["perm"].cpu(), ci["perm"])
    assert torch.equal(gi["counts"].cpu(), ci["counts"])
    assert gi["overflow"] == ci["overflow"]


def _kway_inputs(C, nb, case, seed):
    """Sorted (key, tie) runs of 2^13 keys and nb − 1 splitters for one
    case: "unordered" (sorted keys, ties in no order), "shuffled" (the
    same in random order), "equal" (every key and splitter key one value,
    so the ties decide), "elements" (the splitters are elements, tie
    included, so equality decides)."""
    g = np.random.default_rng(seed)
    hi = 1 if case == "equal" else 2 ** 31
    keys = g.integers(-hi, hi, size=C).astype(np.int32)
    keys = np.concatenate([np.sort(keys[i:i + 8192])
                           for i in range(0, C, 8192)]) if C else keys
    ties = g.integers(-2 ** 31, 2 ** 31, size=C).astype(np.int32)
    S = nb - 1
    if case == "elements" and C:
        pick = g.integers(0, C, size=S)
        sk, st = keys[pick], ties[pick]
    else:
        sk = np.sort(g.integers(-hi, hi, size=S)).astype(np.int32)
        st = g.integers(-2 ** 31, 2 ** 31, size=S).astype(np.int32)
    if case == "shuffled":
        perm = g.permutation(S)
        sk, st = sk[perm], st[perm]
    return keys, ties, sk, st


@pytest.mark.parametrize("nb", [1, 2, 8, 16, 2048, 1 << 16])
@pytest.mark.parametrize("C", [0, 5, 2048, 2048 * 7 + 3, 1 << 20])
@pytest.mark.parametrize("case", ["unordered", "shuffled", "equal",
                                  "elements"])
def test_kway_search_tree_matches_plain(dev, nb, C, case):
    """The search over splitters sorted inside the launch, bit for bit
    against the plain version: empty, ragged and tile-multiple C, one
    bucket, splitters past one shared-memory tree (nb = 2^16), splitters
    in order and in none, all-equal keys and splitters that are
    elements."""
    if C == 1 << 20 and nb == 1 << 16:
        C = 50_001                    # the chunked search costs C · 16
    keys, ties, sk, st = (torch.from_numpy(a).to(dev)
                          for a in _kway_inputs(C, nb, case, C + nb))
    b, h = kw.kway_classify(keys, ties, sk, st, n_buckets=nb)
    rb, rh = kref.kway_classify_ref(keys, ties, sk, st, n_buckets=nb)
    torch.cuda.synchronize()
    assert torch.equal(b, rb) and torch.equal(h, rh)
    assert int(rh.sum()) == int((rb < nb).sum())


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("nb", [8, 2048])
def test_kway_on_views_at_an_offset(dev, offset, nb):
    """Views that start off a 16-byte boundary, keys and ties apart, take
    4-byte accesses and give the same buckets; repeated calls on one
    stream leave the kernel's histogram accumulator zero."""
    C = 100_003
    keys, ties, sk, st = (torch.from_numpy(a).to(dev) for a in
                          _kway_inputs(C + 8, nb, "unordered", offset + nb))
    k, t = keys[offset:offset + C], ties[8 - offset:8 - offset + C]
    rb, rh = kref.kway_classify_ref(k, t, sk, st, n_buckets=nb)
    for _ in range(3):
        b, h = kw.kway_classify(k, t, sk, st, n_buckets=nb)
        torch.cuda.synchronize()
        assert torch.equal(b, rb) and torch.equal(h, rh)
    b, h = kw.kway_classify(keys, ties, sk, st, n_buckets=nb)   # aligned
    rb, rh = kref.kway_classify_ref(keys, ties, sk, st, n_buckets=nb)
    torch.cuda.synchronize()
    assert torch.equal(b, rb) and torch.equal(h, rh)


def _same_result(a, b):
    """Two psort results (tensors, or lists of rows) bit for bit."""
    if torch.is_tensor(a):
        return torch.equal(a.view(torch.int32).cpu(), b.view(torch.int32))
    return len(a) == len(b) and all(_same_result(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("algorithm", ["rams", "rquick", "ssort"])
@pytest.mark.parametrize("layout", ["batched", "nested", "batched-nested"])
def test_batched_and_nested_cuda_equal_cpu(dev, algorithm, layout):
    """Batched keys (d = 3 rows of one instance each), a nested mesh
    (4, 16) and both at once, on the card against the CPU bit for bit."""
    p, n = 64, 1 << 16
    names = ("Uniform", "Zero", "Staggered")
    x = generate_instance("Uniform", p, n).astype(np.uint32)
    if layout != "nested":
        x = np.stack([generate_instance(name, p, n, seed=r).astype(np.uint32)
                      for r, name in enumerate(names)])
    kw = {"p": p} if layout == "batched" else {"mesh_shape": (4, 16)}
    cfg = SortConfig(algorithm=algorithm, **kw)
    go, gi = psort(x, cfg, return_info=True, device="cuda")
    co, ci = psort(x, cfg, return_info=True, device="cpu")
    assert _same_result(go, co)
    assert _same_result(gi["perm"], ci["perm"])
    assert torch.equal(gi["counts"].cpu(), ci["counts"])
    assert gi["overflow"] == ci["overflow"]
    assert (gi["d"], gi["mesh_shape"]) == (ci["d"], ci["mesh_shape"])


def _query_keys(dtype, p, n, name="Uniform"):
    """An instance as keys of ``dtype``: uint32 words, the 8-byte words
    ``u << 32 | u`` (int64 and uint64 view them), or float64 with both
    zeros."""
    u = generate_instance(name, p, n).astype(np.uint64)
    if dtype == np.uint32:
        return u.astype(np.uint32)
    if dtype == np.float64:
        x = (u.astype(np.float64) - 2.0 ** 31) * 0.37
        x[:4] = [0.0, -0.0, -0.0, 0.0]
        return x
    return ((u << np.uint64(32)) | u).view(dtype)


def _same_keys(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", [np.uint32, np.int64, np.uint64,
                                   np.float64])
@pytest.mark.parametrize("name", ["Uniform", "Zero", "Staggered"])
def test_shard_data_cuda_equals_cpu(dev, dtype, name):
    """The resident rows (the ingest's local sort) on the card equal the
    CPU's, for n a multiple of p and not."""
    from repro_torch.core.queries import shard_data
    for p, n in ((64, 1 << 16), (16, 100_003)):
        x = _query_keys(dtype, p, n, name)
        g, c = shard_data(x, p, device=dev), shard_data(x, p, device="cpu")
        assert torch.equal(g.keys.cpu(), c.keys)
        assert torch.equal(g.counts.cpu(), c.counts)
        assert (g.n, g.orig_dtype) == (c.n, c.orig_dtype)


@pytest.mark.parametrize("dtype", [np.uint32, np.int64, np.uint64,
                                   np.float64])
@pytest.mark.parametrize("kind", ["select_rank", "select_rank_no_window",
                                  "percentile", "top_k", "rank_of_key",
                                  "range_query"])
def test_queries_cuda_equal_cpu(dev, dtype, kind):
    """Each query kind on the card against the CPU, bit for bit, at
    p = 64, n = 2^16 over a batch of 16 (scalar forms too)."""
    from repro_torch.core import queries as Q
    p, n = 64, 1 << 16
    x = _query_keys(dtype, p, n)
    g, c = Q.shard_data(x, p, device=dev), Q.shard_data(x, p, device="cpu")
    rng = np.random.default_rng((20, 1))
    ranks = np.concatenate([[1, 2, n // 2, n], rng.integers(1, n, 12)])
    keys = np.concatenate([x[:12], [x.min(), x.max()], x[-2:]]).astype(
        x.dtype)
    calls = {
        "select_rank": lambda d: Q.select_rank(d, ranks),
        "select_rank_no_window": lambda d: Q.select_rank(d, ranks,
                                                         window=False),
        "percentile": lambda d: (Q.percentile(d, np.linspace(0, 100, 16)),
                                 Q.percentile(d, 50.0)),
        "top_k": lambda d: Q.top_k(d, np.arange(1, 17) * 7) + [
            Q.top_k(d, 4096)],
        "rank_of_key": lambda d: Q.rank_of_key(d, keys) + Q.rank_of_key(
            d, keys[0]),
        "range_query": lambda d: (Q.range_query(d, keys[:8], keys[8:]),
                                  Q.range_query(d, keys[3], keys[2])),
    }
    got, want = calls[kind](g), calls[kind](c)
    assert len(got) == len(want)
    assert all(_same_keys(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("policy", ["selection", "fullsort"])
def test_sort_service_cuda_equals_cpu(dev, policy):
    """The CLI's stream through ``SortService`` on the card and on the
    CPU: the same answers, paths and batches."""
    from repro_torch.launch.sort_serve import (SortService, _gen_stream,
                                               parse_mix)
    p, n = 16, 1 << 14
    keys = np.random.default_rng(3).integers(0, 1 << 32, n).astype(
        np.uint32)
    runs = []
    for d in (dev, "cpu"):
        svc = SortService(keys, config=SortConfig(p=p, algorithm="rquick"),
                          policy=policy, device=d)
        rng = np.random.default_rng(4)
        pool = keys[rng.integers(0, n, 256)]
        for kind, arg in _gen_stream(rng, n, 80, parse_mix(
                "top_k=4,percentile=2,rank_of_key=2,range_query=1,sort=1"),
                pool):
            svc.submit(kind, arg)
        runs.append(svc.drain())
    assert [(r.request.kind, r.path, r.batch) for r in runs[0]] == [
        (r.request.kind, r.path, r.batch) for r in runs[1]]
    for a, b in zip(*runs):
        va, vb = a.value, b.value
        if torch.is_tensor(va):
            va, vb = va.cpu().numpy(), vb.numpy()
        assert _same_keys(va, vb), a.request


def _fault_run(x, cfg_kw, device):
    """psort under one kill and one straggler: (out, info, policy)."""
    from repro_torch.core import comm
    from repro_torch.runtime import FaultPolicy
    pol = FaultPolicy(plan=comm.FaultPlan((comm.kill_pe(2),
                                           comm.delay_pe(1, factor=8.0))))
    out, info = psort(x, SortConfig(fault_policy=pol, **cfg_kw),
                      return_info=True, device=device)
    return out, info, pol


@pytest.mark.parametrize("algorithm", ["gatherm", "allgatherm", "rfis",
                                       "rquick", "rams", "bitonic", "ssort"])
def test_fault_lane_cuda_equals_cpu(dev, algorithm):
    """The fault lane on the card at p = 8 (attempts 8 → 4 → 2) equals
    its CPU run: output, counts, perm, overflow, the fault record and every
    trace event."""
    x = generate_instance("Uniform", 8, 8 * 256).astype(np.int32)
    kw = {"p": 8, "algorithm": algorithm}
    go, gi, gp = _fault_run(x, kw, dev)
    co, ci, cp = _fault_run(x, kw, "cpu")
    assert _same_result(go, co)
    assert torch.equal(gi["perm"].cpu(), ci["perm"])
    assert torch.equal(gi["counts"].cpu(), ci["counts"])
    assert gi["overflow"] == ci["overflow"] and gi["fault"] == ci["fault"]
    assert [a["p"] for a in gp.attempts] == [8, 4, 2]
    assert [(e.primitive, e.bytes, e.group_size, e.axis, e.tag, e.pe)
            for e in gp.trace.events] == [
        (e.primitive, e.bytes, e.group_size, e.axis, e.tag, e.pe)
        for e in cp.trace.events]


@pytest.mark.parametrize("off", ["sort", "partition"])
def test_kernels_switched_off_raise_on_the_card(dev, off):
    """With a kernel family turned off (``set_local_kernels``) a sort on
    the card raises rather than run the plain versions there, and
    launches nothing of that family; with the policy restored the same
    sort launches both families."""
    from repro_torch.core import LocalKernelPolicy, set_local_kernels
    from repro_torch.kernels import launch_counts, reset_launch_counts
    x = generate_instance("Uniform", 64, 1 << 16).astype(np.uint32)
    cfg = SortConfig(p=64, algorithm="rams")
    gated = {"sort": ("tile_sort", "run_merge"),
             "partition": ("partition_classify", "partition_rank")}[off]
    prev = set_local_kernels(LocalKernelPolicy(**{
        "sort": off != "sort", "partition": off != "partition"}))
    try:
        reset_launch_counts()
        with pytest.raises(RuntimeError, match=f"{off!r} kernels are "
                                               f"switched off"):
            psort(x, cfg, device=dev)
        assert not any(launch_counts()[k] for k in gated), launch_counts()
    finally:
        set_local_kernels(prev)
    reset_launch_counts()
    out = psort(x, cfg, device=dev)
    assert launch_counts()["tile_sort"] > 0
    assert launch_counts()["partition_classify"] > 0
    assert _same_result(out, torch.from_numpy(np.sort(x)))


# --- the model-serving stack (no kernel of its own: the card against the
# port's CPU run, and length-balanced batching through the sort kernels) --


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama3.2-1b",
                                  "rwkv6-1.6b", "zamba2-2.7b",
                                  "musicgen-large"])
def test_model_decode_cuda_equals_cpu(dev, arch):
    """Smoke variants in float32 (float32 caches): forward and four
    decode steps on the card within 1e-4/1e-5 of the CPU's, tokens
    equal."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              dtype="float32")
    cpu = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    gpu = copy.deepcopy(cpu).to(dev)
    r = np.random.default_rng(2)
    if cfg.family == "audio":
        x = {"embeds": torch.from_numpy(r.normal(size=(2, 256, cfg.d_model))
                                        .astype(np.float32))}
    else:
        x = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab, (2, 256)))}
    with torch.inference_mode():
        lc, _ = T.forward(cpu, x, cfg)
        lg, _ = T.forward(gpu, {k: v.to(dev) for k, v in x.items()}, cfg)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-5)
        sc = T.init_decode_state(cfg, 2, 8, torch.float32, device="cpu")
        sg = T.init_decode_state(cfg, 2, 8, torch.float32, device=dev)
        inp = {k: v[:, :1] for k, v in x.items()}
        for _ in range(4):
            lc, sc = T.decode_step(cpu, sc, inp, cfg)
            lg, sg = T.decode_step(gpu, sg, {k: v.to(dev)
                                             for k, v in inp.items()}, cfg)
            torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-5)
            if cfg.family != "audio":
                assert torch.equal(lg.cpu().argmax(-1), lc.argmax(-1))
                inp = {"tokens": lc[:, -1].argmax(-1)[:, None]}


def test_moe_ep_sim_on_the_card_is_deterministic(dev):
    """The expert-parallel dispatch adds each token's items in a fixed
    order (no atomics): two runs on the card are equal bit for bit, and
    within 1e-4/1e-5 of the CPU's in float32."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.moe import MoE, moe_ep_sim
    cfg = dataclasses.replace(smoke_variant(get_config(
        "granite-moe-1b-a400m")), dtype="float32")
    p = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, torch.float32, "cpu",
            torch.Generator().manual_seed(3))
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4))
    want, _ = moe_ep_sim(x, p, cfg, d=2, ep=2)
    pg = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, torch.float32, dev)
    for name, t in p.named_parameters():
        dict(pg.named_parameters())[name].data.copy_(t.data)
    a, _ = moe_ep_sim(x.to(dev), pg, cfg, d=2, ep=2)
    b, _ = moe_ep_sim(x.to(dev), pg, cfg, d=2, ep=2)
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), want, rtol=1e-4, atol=1e-5)


def test_length_balanced_batches_cuda_equals_cpu(dev):
    """The batching's sort on the card launches the RAMS kernels and gives
    the CPU's batches and waste bit for bit."""
    from repro_torch.data.pipeline import length_balanced_batches
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(3)
    lengths = np.minimum(32 + (rng.zipf(1.5, size=1 << 16) % 992), 1024)
    reset_launch_counts()
    got = length_balanced_batches(lengths, 64, p=16, algorithm="rams",
                                  device=dev)
    assert launch_counts()["tile_sort"] > 0
    assert launch_counts()["partition_rank"] > 0
    want = length_balanced_batches(lengths, 64, p=16, algorithm="rams",
                                   device="cpu")
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
