"""The distributed backend on meshes of more than one axis, and on
streamed exchanges: nested (2, 4) meshes, batched keys on (data, sort)
meshes, ``overlap=True``, meshes with excluded ranks and the reference's
mesh errors, on a pool of eight gloo ranks, each against the reference's
shard_map backend on conftest's eight emulated CPU devices and the port's
sim backend, bit for bit (``test_nested.py:59``, ``test_overlap.py:56``,
``test_subaxis.py:54,76``, ``test_faults.py:188``)."""
import numpy as np
import pytest

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import SortConfig as JConfig
from repro.core import psort as j_psort
from repro.core import types as jt
from repro.core.rams import nested_level_bits
from repro.data.distributions import generate_instance
from repro_torch.core import api as tapi

from torch_dist_helpers import (RankPool, as_reference, error_job, mesh_job,
                                on_ranks, same, sim_job, sort_job)

# the reference's shard_map lists (test_overlap.py, test_subaxis.py,
# test_nested.py)
SEVEN = ("rquick", "rfis", "rams", "bitonic", "ssort", "gatherm",
         "allgatherm")

@pytest.fixture(scope="module")
def pool():
    ranks = RankPool(8)
    yield ranks
    ranks.close()


@pytest.fixture(autouse=True)
def kernels_off():
    """The reference with its Pallas kernels off (its CPU default)."""
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


# ---------------------------------------------------------------------------
# Nested (2, 4) meshes (test_nested.py:59)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", SEVEN)
def test_nested_2x4_equals_reference_and_flat(pool, algorithm):
    """On the mesh's two real axes, bit for bit the reference's nested
    shard_map run, the sim's nested run (trace included: each stage on
    its real axis) and the flat sort on the nested schedule."""
    x = generate_instance("Uniform", 8, 37 * 8, seed=3).astype(np.int32)
    cfg = dict(mesh_shape=(2, 4), algorithm=algorithm)
    out, info = j_psort(x, config=JConfig(backend="shard_map", **cfg),
                        return_info=True)
    got = on_ranks(pool.run(sort_job, x, cfg), sim_job(x, cfg))
    kw = {"level_bits": tuple(nested_level_bits(2, 4))} \
        if algorithm == "rams" else {}
    flat = sim_job(x, dict(p=8, algorithm=algorithm, algo_kw=kw))
    for r in got:
        as_reference(r, out, info)
        assert all(np.array_equal(r[k], flat[k])
                   for k in ("out", "perm", "counts"))
    assert {e[3] for e in got[0]["events"]} <= {"inter", "intra"}


# ---------------------------------------------------------------------------
# overlap=True (test_overlap.py:56)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", SEVEN)
def test_overlap_equals_barrier_and_reference(pool, algorithm):
    """The streamed exchange on the ranks (one point-to-point step per
    source, the reference's ring order) equals the reference's shard_map
    run with ``overlap=True``, the sim's streamed run and the barrier
    path."""
    x = generate_instance("Staggered", 8, 53 * 8, seed=7).astype(np.int32)
    cfg = dict(p=8, algorithm=algorithm, overlap=True)
    out, info = j_psort(x, config=JConfig(backend="shard_map", **cfg),
                        return_info=True)
    barrier = sim_job(x, dict(p=8, algorithm=algorithm))
    for r in on_ranks(pool.run(sort_job, x, cfg), sim_job(x, cfg)):
        as_reference(r, out, info)
        assert all(np.array_equal(r[k], barrier[k])
                   for k in ("out", "perm", "counts"))
    if algorithm in tapi._OVERLAP_ALGOS:
        assert any((e[4] or "").startswith("ovl:") for e in r["events"])


@pytest.mark.parametrize("algorithm", ("rams", "ssort"))
def test_overlap_on_subcube_groups(pool, algorithm):
    """RAMS in two levels at p = 8 streams its second level within
    subcubes of two ranks (a grouped ring), SSort at p = 4 on a mesh of
    half the ranks: each equals the reference's shard_map run."""
    p, kw = (8, {"levels": 2}) if algorithm == "rams" else (4, {})
    x = generate_instance("Staggered", p, 53 * p, seed=5).astype(np.int32)
    cfg = dict(p=p, algorithm=algorithm, overlap=True, **kw)
    out, info = j_psort(x, config=JConfig(backend="shard_map", **cfg),
                        return_info=True)
    got = on_ranks(pool.run(sort_job, x, cfg), sim_job(x, cfg))
    for r in got:
        as_reference(r, out, info)
    groups = {e[2] for e in got[0]["events"] if (e[4] or "") == "ovl:level1"}
    assert groups == ({2} if algorithm == "rams" else set())


# ---------------------------------------------------------------------------
# Batched keys on a (data, sort) mesh (test_subaxis.py:54, 76)
# ---------------------------------------------------------------------------


def _rows(d, p, n_per, seed=0):
    return np.stack([generate_instance("Uniform", p, n_per, seed=seed + r)
                     .astype(np.int32) for r in range(d)])


@pytest.mark.parametrize("algorithm", SEVEN)
def test_batched_2x4_equals_reference_and_rows(pool, algorithm):
    """A rank sorts its data slice's row on its sort-axis group; every
    rank gets both rows, each bit for bit its 1-D sort."""
    d, p = 2, 4
    xs = _rows(d, p, 37 * p)
    cfg = dict(p=p, algorithm=algorithm)
    out, info = j_psort(xs, config=JConfig(backend="shard_map", **cfg),
                        return_info=True)
    got = on_ranks(pool.run(sort_job, xs, cfg, {"p": p, "d": d}),
                    sim_job(xs, cfg))
    assert len(got) == d * p
    for r in got:
        as_reference(r, out, info)
        for row in range(d):
            one = sim_job(xs[row], cfg)
            assert np.array_equal(r["out"][row], one["out"])
            assert np.array_equal(r["perm"][row], one["perm"])


def test_explicit_mesh_and_defaults(pool):
    """An explicit sort_mesh and the default mesh agree bit for bit."""
    d, p = 2, 4
    xs = _rows(d, p, 11 * p)
    cfg = dict(algorithm="rquick")
    explicit = pool.run(sort_job, xs, cfg, {"p": p, "d": d})
    default = pool.run(sort_job, xs, dict(cfg, p=p), None)
    # the default batched mesh is sort_mesh(p, d): the same ranks
    assert all(same(a, b) for a, b in zip(explicit, default))
    assert np.array_equal(explicit[0]["out"], np.sort(xs, axis=-1))


def test_mesh_errors_equal_reference(pool):
    """2-D keys on a 1-D mesh, and a nested mesh of the wrong shape, raise
    the reference's errors."""
    from repro.core.api import default_mesh
    from repro.dist.sharding import sort_mesh
    xs = _rows(2, 4, 16)
    for kw, jmesh, mesh_kw in (({"p": 8}, default_mesh(8), {"p": 8}),
                               ({"mesh_shape": (2, 4)},
                                sort_mesh(shape=(4, 2)), {"shape": (4, 2)})):
        with pytest.raises(ValueError) as want:
            j_psort(xs, config=JConfig(algorithm="rquick", mesh=jmesh,
                                       **kw))
        got = pool.run(error_job, xs, dict(kw, algorithm="rquick",
                                           backend="shard_map"), mesh_kw)
        assert all(g == ("ValueError", str(want.value)) for g in got)


# ---------------------------------------------------------------------------
# sort_mesh and the elastic rescale (test_faults.py:188)
# ---------------------------------------------------------------------------


def test_sort_mesh_exclude_rederives_reduced_mesh(pool):
    """Failed rank positions are excluded and the survivors renumber into
    the reduced mesh; the excluded ranks only join its making, and the
    survivors sort bit for bit as the reference's mesh without those
    devices."""
    import jax
    from repro.dist.sharding import sort_mesh as j_mesh
    got = pool.run(mesh_job, [
        {"p": 4, "devices": range(5), "exclude": (2,)},
        {"shape": (2, 2), "devices": range(6), "exclude": (1, 3)},
        {"p": 2, "devices": range(2), "exclude": (7,)}])
    devs = jax.devices()
    want = [j_mesh(p=4, devices=devs[:5], exclude=(2,)),
            j_mesh(shape=(2, 2), devices=devs[:6], exclude=(1, 3))]
    for g in got:
        assert g[0] == ({"data": 1, "sort": 4}, [0, 1, 3, 4])
        assert g[1] == ({"inter": 2, "intra": 2}, [0, 2, 4, 5])
        for (sizes, ranks), m in zip(g[:2], want):
            assert sizes == dict(m.shape)
            assert ranks == [devs.index(dv) for dv in m.devices.ravel()]
        assert g[2][0] == "ValueError" and "exclude" in g[2][1]
    x = generate_instance("Uniform", 4, 37 * 4, seed=3).astype(np.int32)
    res = pool.run(sort_job, x, dict(algorithm="rquick"),
                   {"p": 4, "exclude": (3, 5, 6, 7)})
    assert [r is None for r in res] == [False, False, False, True, False,
                                        True, True, True]
    out, info = j_psort(x, config=JConfig(
        algorithm="rquick", mesh=j_mesh(p=4, devices=[
            dv for i, dv in enumerate(devs) if i not in (3, 5, 6, 7)])),
        return_info=True)
    for r in on_ranks(res, sim_job(x, dict(p=4, algorithm="rquick"))):
        as_reference(r, out, info)


