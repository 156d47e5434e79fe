"""The streamed exchange (``SortConfig(overlap=True)``) against the
reference's and against the port's own barrier path, bit for bit.

The cells are those of ``tests/test_overlap.py``, through both packages:
for each algorithm with a slotted exchange (``_OVERLAP_ALGOS``) the port's
streamed sort must equal the reference's streamed sort and the port's
barrier sort on keys, ``counts``, ``overflow`` and ``perm``; the external
lane's streamed pass C likewise; ``trace_collectives(overlap=True)`` must
equal the reference's event for event, its ``ovl:<phase>`` chunk events
included.  Then the stages: ``merge_sorted_shards`` on keys equal to the
pad word, the ring's delivery order, and the streamed route against the
barrier route followed by ``local_sort``.  All integers: tolerance 0.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
import jax.numpy as jnp
from repro.core import ExternalPolicy as JPolicy
from repro.core import SortConfig as JConfig
from repro.core import psort as j_psort
from repro.core import types as jt
from repro.core.api import _OVERLAP_ALGOS as J_OVERLAP_ALGOS
from repro.core.api import trace_collectives as j_trace
from repro.data.distributions import INSTANCES, generate_instance
from repro_torch import ExternalPolicy, SortConfig, psort, trace_collectives
from repro_torch.core import api as tapi
from repro_torch.core import comm as tc
from repro_torch.core import hypercube as thc
from repro_torch.core import types as tt

P = 8
CORE = ("Uniform", "Zero", "Staggered", "DeterDupl")


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _out(t):
    return t.view(torch.int32).numpy().view(np.uint32) \
        if t.dtype == torch.uint32 else t.numpy()


def _same_info(a, b):
    assert np.array_equal(np.asarray(a["counts"]), np.asarray(b["counts"]))
    assert a["overflow"] == b["overflow"]
    assert np.array_equal(np.asarray(a["perm"]).astype(np.int64),
                          np.asarray(b["perm"]).astype(np.int64))


def _three_way(x, algorithm, p=P, **kw):
    """The port's streamed sort against the reference's streamed sort and
    the port's barrier sort; returns the port's streamed info."""
    cfg = SortConfig(p=p, algorithm=algorithm, **kw)
    got, gi = psort(x, cfg.replace(overlap=True), return_info=True,
                    device="cpu")
    bar, bi = psort(x, cfg, return_info=True, device="cpu")
    jkw = dict(kw)
    if "external" in jkw:
        jkw["external"] = JPolicy(budget=kw["external"].budget)
    want, wi = j_psort(x, config=JConfig(p=p, algorithm=algorithm,
                                         backend="sim", overlap=True, **jkw),
                       return_info=True)
    assert np.array_equal(_out(got), np.asarray(want))
    assert np.array_equal(_out(got), _out(bar))
    assert gi["algorithm"] == wi["algorithm"] == bi["algorithm"]
    _same_info(gi, wi)
    _same_info(gi, bi)
    return gi


def test_overlap_algos_registry_equals_reference():
    assert tapi._OVERLAP_ALGOS == tuple(J_OVERLAP_ALGOS)


def _instances():
    for inst in sorted(INSTANCES):
        marks = [] if inst in CORE else [pytest.mark.slow]
        yield pytest.param(inst, marks=marks, id=inst)


@pytest.mark.parametrize("instance", _instances())
@pytest.mark.parametrize("algorithm", tapi._OVERLAP_ALGOS)
def test_overlap_equals_reference_and_barrier(algorithm, instance):
    x = generate_instance(instance, P, 37 * P, seed=3).astype(np.int32)
    _three_way(x, algorithm)


@pytest.mark.parametrize("algorithm", ["rquick", "rfis", "bitonic",
                                       "gatherm", "allgatherm"])
def test_overlap_leaves_unslotted_algorithms_alone(algorithm):
    x = generate_instance("Staggered", P, 53 * P, seed=7).astype(np.int32)
    _three_way(x, algorithm)


def test_overlap_preserves_ssort_overflow():
    """SSort drops keys on Zero by design; its overflow is counted on the
    sender's side, so the streamed path counts the same."""
    x = generate_instance("Zero", P, 64 * P).astype(np.int32)
    info = _three_way(x, "ssort")
    assert info["overflow"] > 0


@pytest.mark.parametrize("n", [0, 1, 5, P - 1])
@pytest.mark.parametrize("algorithm", ["rams", "ssort"])
def test_overlap_degenerate_chunks(algorithm, n):
    """n < p: most streamed blocks hold nothing."""
    _three_way(np.arange(n, dtype=np.int32)[::-1].copy(), algorithm)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("algorithm", ["rams", "ssort"])
def test_overlap_with_pad_valued_keys(algorithm, dtype):
    """Keys equal to the pad word (0xFFFFFFFF, or INT32_MAX of int32
    keys) among the pads of every staged run: a-before-b at each level."""
    top = np.iinfo(dtype).max
    x = generate_instance("Staggered", P, 40 * P, seed=1).astype(dtype)
    x[::3] = top
    _three_way(x, algorithm)
    _three_way(np.full(24 * P, top, dtype), algorithm)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_overlap_external_pass(dtype):
    """The lane's streamed pass C and its running merge per PE."""
    x = generate_instance("Staggered", P, 37 * P, seed=9).astype(dtype)
    info = _three_way(x, "external", external=ExternalPolicy(budget=8))
    assert info["overflow"] == 0


def test_overlap_external_losertree_and_single_run():
    x = generate_instance("Uniform", P, 20 * P, seed=4).astype(np.uint32)
    for policy in (ExternalPolicy(budget=6, merge="losertree"),
                   ExternalPolicy(budget=32)):
        cfg = SortConfig(p=P, algorithm="external", external=policy)
        a, ai = psort(x, cfg, return_info=True, device="cpu")
        b, bi = psort(x, cfg.replace(overlap=True), return_info=True,
                      device="cpu")
        assert torch.equal(a, b)
        _same_info(ai, bi)


# ---------------------------------------------------------------------------
# the trace


def _events(trace):
    return [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
            for e in trace.events]


@pytest.mark.parametrize("algorithm,p,n", [
    ("rams", 8, 64 * 8), ("rams", 64, 64 * 64), ("ntb-ams", 8, 64 * 8),
    ("ssort", 8, 48 * 8), ("ssort", 64, 2500), ("ns-ssort", 8, 64 * 8),
    ("rquick", 8, 64 * 8)])
def test_overlap_trace_equals_reference(algorithm, p, n):
    jax.clear_caches()
    cfg = SortConfig(p=p, algorithm=algorithm, overlap=True)
    got = trace_collectives(n, cfg, device="cpu")
    want = j_trace(n, JConfig(p=p, algorithm=algorithm, overlap=True))
    assert _events(got) == _events(want)
    assert got.summary(p) == want.summary(p)
    assert got.by_tag() == want.by_tag()
    barrier = trace_collectives(n, cfg.replace(overlap=False), device="cpu")
    assert got.wire_bytes() == barrier.wire_bytes()
    ovl = [t for t in got.tags() if t.startswith("ovl:")]
    assert bool(ovl) == (algorithm != "rquick")
    for tag in ovl:
        chunks = got.filter(primitive="all_to_all", tag=tag).events
        # one event per source block of each streamed exchange
        assert chunks and len(chunks) % (chunks[0].group_size or p) == 0


def test_overlap_trace_of_the_lane_equals_reference():
    jax.clear_caches()
    for double_buffer in (True, False):
        got = trace_collectives(250, SortConfig(
            p=4, overlap=True, external=ExternalPolicy(
                budget=16, double_buffer=double_buffer)), device="cpu")
        want = j_trace(250, JConfig(p=4, overlap=True, external=JPolicy(
            budget=16, double_buffer=double_buffer)))
        assert _events(got) == _events(want)
        assert got.io_bytes() == want.io_bytes()
        assert any(t.startswith("ovl:ext:pass") for t in got.tags())


# ---------------------------------------------------------------------------
# the stages


def _shard_pair(rng, rows, ca, cb):
    """Two sorted padded (rows, C) shards whose valid keys include the pad
    word, as numpy (keys u32, {"idx": u32}, counts)."""
    def one(cap):
        k = np.full((rows, cap), 0xFFFFFFFF, np.uint32)
        cnt = rng.integers(0, cap + 1, size=rows)
        for r in range(rows):
            v = rng.choice([0, 7, 0xFFFFFFFE, 0xFFFFFFFF], size=cnt[r])
            k[r, :cnt[r]] = np.sort(v)
        i = rng.integers(0, 2 ** 32, size=(rows, cap)).astype(np.uint32)
        return k, {"idx": i}, cnt
    return one(ca), one(cb)


@pytest.mark.parametrize("capacity", [None, 5, 24])
def test_merge_sorted_shards_equals_reference(capacity):
    rng = np.random.default_rng(11)
    a, b = _shard_pair(rng, 6, 12, 9)
    got, gov = tt.merge_sorted_shards(tt.shard_from_numpy(*a),
                                      tt.shard_from_numpy(*b), capacity)
    gk, gv, gc = tt.shard_to_numpy(got)
    for r in range(6):
        ja = jt.SortShard(jnp.asarray(a[0][r]), {"idx": jnp.asarray(
            a[1]["idx"][r])}, jnp.int32(a[2][r]))
        jb = jt.SortShard(jnp.asarray(b[0][r]), {"idx": jnp.asarray(
            b[1]["idx"][r])}, jnp.int32(b[2][r]))
        want, wov = jt.merge_sorted_shards(ja, jb, capacity)
        c = int(want.count)
        assert gc[r] == c and int(gov[r]) == int(wov)
        assert np.array_equal(gk[r], np.asarray(want.keys))
        assert np.array_equal(gv["idx"][r, :c],
                              np.asarray(want.vals["idx"])[:c])


@pytest.mark.parametrize("groups", [None, [[0, 1, 2, 3], [4, 5, 6, 7]],
                                    [[0, 2, 4, 6], [1, 3, 5, 7]]])
def test_alltoall_stream_delivery_and_trace(groups):
    """PE i folds, at step t, the block of group member (rank + t) mod g
    (the reference's ring); the blocks are those of ``all_to_all``; the
    trace holds g ``ovl:`` chunk events summing to its bytes."""
    g = 8 if groups is None else 4
    x = torch.arange(8 * g * 3, dtype=torch.int32).reshape(8, g * 3)
    members, rank = tc._group_tables(groups, 8)
    seen = []

    def fold(acc, chunks, src):
        seen.append(src.clone())
        acc[torch.arange(8), src] = chunks[0]
        return acc

    with tc.counting() as trace, tc.tagged("shuffle"):
        got = tc.alltoall_stream([x], fold, torch.zeros(8, g, 3,
                                                        dtype=torch.int32),
                                 g, groups)
    want = tc.all_to_all(x, groups).reshape(8, g, 3)
    assert torch.equal(got, want)
    for t, src in enumerate(seen):
        assert src.tolist() == [(int(rank[i]) + t) % g for i in range(8)]
    assert [e.tag for e in trace.events] == ["ovl:shuffle"] * g
    assert sum(e.bytes for e in trace.events) == tc.pe_bytes(x)
    assert {e.group_size for e in trace.events} == {
        None if groups is None else 4}


def test_streamed_route_equals_barrier_route_then_sort():
    rng = np.random.default_rng(2)
    p, C = 8, 40
    keys = torch.from_numpy(rng.choice([-5, 3, 2 ** 31 - 1], size=(p, C))
                            .astype(np.int32))
    count = torch.from_numpy(rng.integers(0, C + 1, size=p))
    shard = tt.local_sort(tt.SortShard(keys, {"idx": torch.arange(
        p * C, dtype=torch.int32).reshape(p, C)}, count))
    dest = torch.from_numpy(rng.integers(0, p, size=(p, C)))
    dest = torch.where(shard.valid_mask(), dest, p)
    for slot_cap in (3, 12):
        bar, bov = thc._alltoall_route(shard, dest, p, slot_cap)
        bar = tt.local_sort(bar)
        st, sov = thc._alltoall_route(shard, dest, p, slot_cap, stream=True)
        assert torch.equal(bov, sov) and torch.equal(bar.count, st.count)
        assert torch.equal(bar.keys, st.keys)
        assert torch.equal(bar.vals["idx"][bar.valid_mask()],
                           st.vals["idx"][st.valid_mask()])
