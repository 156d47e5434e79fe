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


@pytest.mark.parametrize("rows,C,hi", [(1, 1, 5), (3, 4096, 50),
                                       (2, 5000, 2 ** 31), (4, 12345, 7),
                                       (16, 300_000, 2 ** 31)])
@pytest.mark.parametrize("with_vals", [True, False])
def test_tile_sort_matches_plain(dev, rows, C, hi, with_vals):
    k = _keys(rows, C, hi, 1, dev)
    k[0, :min(C, 10)] = 2 ** 31 - 1          # the pad word as a real key
    v = _payload(rows, C, dev) if with_vals else None
    ks, vs = bt.sort_tiles(k, v)
    rk, rv = bref.sort_tiles_ref(k, v, bt.TILE)
    torch.cuda.synchronize()
    assert torch.equal(ks, rk)
    if with_vals:
        assert torch.equal(vs, rv)


@pytest.mark.parametrize("rows,C,width", [(2, 8192, 4096), (3, 9000, 4096),
                                          (2, 70_001, 16384),
                                          (8, 300_000, 4096)])
def test_run_merge_matches_plain(dev, rows, C, width):
    k = _keys(rows, C, 20, 2, dev)
    v = _payload(rows, C, dev)
    k, v = bref._segment_sort(k, v, width)   # sorted runs of ``width``
    ks, vs = bt.merge_runs(k.contiguous(), v.contiguous(), width)
    rk, rv = bref.merge_runs_ref(k, v, width)
    torch.cuda.synchronize()
    assert torch.equal(ks, rk) and torch.equal(vs, rv)


@pytest.mark.parametrize("rows,C", [(1, 1), (5, 4095), (4, 100_000)])
def test_local_sort_fast_matches_stable_sort(dev, rows, C):
    k = _keys(rows, C, 1000, 3, dev)
    v = _payload(rows, C, dev)
    ks, vs = bt.local_sort_fast(k, v)
    rk, rv = bref.sort_ref(k, v)
    torch.cuda.synchronize()
    assert torch.equal(ks, rk) and torch.equal(vs, rv)


def _partition_inputs(rows, C, nb, seed, device):
    g = np.random.default_rng(seed)
    keys = np.sort(g.integers(-50, 50, size=(rows, C)), axis=1)
    ties = g.integers(0, 2 ** 32, size=(rows, C), dtype=np.uint64)
    sk = np.sort(g.integers(-50, 50, size=(rows, nb - 1)), axis=1)
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


@pytest.mark.parametrize("name,p,per", [
    *[(name, 8, 3000) for name in sorted(INSTANCES)],
    *[(name, 64, 20_000) for name in ("Uniform", "Zero", "AllToOne",
                                      "Mirrored")],
    ("Uniform", 256, 4099), ("DeterDupl", 256, 4099)])
def test_psort_cuda_equals_cpu(dev, name, p, per):
    x = generate_instance(name, p, p * per).astype(np.uint32)
    cfg = SortConfig(p=p)
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
    order, more than one staged chunk (nb > 1024) and a histogram too
    large for shared memory (nb > 8192)."""
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
