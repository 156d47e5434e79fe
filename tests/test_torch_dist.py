"""The distributed backend (``backend="shard_map"`` on ``torch.distributed``)
against the reference's shard_map backend on the eight emulated CPU
devices of conftest and against the port's sim backend, bit for bit:
keys, perm, counts, overflow and rank 0's collective trace event for
event.  The ranks are one pool of eight gloo processes for the module
(``torch_dist_helpers.RankPool``); a rank is one PE, and every rank gets
the whole sorted result.  The reference's shard_map tests mirrored here:
``test_differential.py:71``, ``test_faults.py:165`` and
``test_config.py:57``; the meshes of more than one axis and the streamed
exchange are ``test_torch_dist_mesh.py``'s, the queries
``test_torch_dist_queries.py``'s."""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import SortConfig as JConfig
from repro.core import psort as j_psort
from repro.core.api import trace_collectives as j_trace
from repro.core import types as jt
from repro.data.distributions import generate_instance
from repro_torch import SortConfig, psort
from repro_torch.core import api as tapi
from repro_torch.core import comm

from torch_dist_helpers import (RankPool, as_reference, collectives,
                                collectives_job, error_job, on_ranks,
                                sim_job, sort_job, trace_job)

ALGORITHMS = ("rams", "ntb-ams", "rquick", "ntb-quick", "rfis", "ssort",
              "ns-ssort", "bitonic", "gatherm", "allgatherm")


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
# The ten algorithms at p = 2, 4, 8 (test_differential.py:71)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("p", [2, 4, 8])
def test_algorithms_equal_reference_shard_map_and_sim(pool, p, algorithm):
    x = generate_instance("Uniform", p, 53 * p, seed=11).astype(np.int32)
    cfg = dict(p=p, algorithm=algorithm)
    want = sim_job(x, cfg)
    out, info = j_psort(x, config=JConfig(backend="shard_map", **cfg),
                        return_info=True)
    for r in on_ranks(pool.run(sort_job, x, cfg), want):
        as_reference(r, out, info)
    assert info["overflow"] == 0


@pytest.mark.parametrize("algorithm", ("rquick", "ssort", "rfis", "bitonic"))
def test_eight_byte_keys_equal_reference(pool, algorithm):
    x = generate_instance("Staggered", 8, 37 * 8, seed=3).astype(np.int64)
    cfg = dict(p=8, algorithm=algorithm)
    out, info = j_psort(x, config=JConfig(backend="shard_map", **cfg),
                        return_info=True)
    for r in on_ranks(pool.run(sort_job, x, cfg), sim_job(x, cfg)):
        as_reference(r, out, info)


# ---------------------------------------------------------------------------
# Guards and errors (test_faults.py:165, test_config.py:57)
# ---------------------------------------------------------------------------


def test_fault_policy_and_external_raise_reference_value_error(pool):
    from repro.core.external import ExternalPolicy as JExternal
    from repro.runtime.failures import FaultPolicy as JPolicy
    from repro_torch import ExternalPolicy
    from repro_torch.runtime import FaultPolicy
    x = np.arange(64, dtype=np.int32)
    for jkw, tkw in (({"fault_policy": JPolicy()},
                      {"fault_policy": FaultPolicy()}),
                     ({"external": JExternal(budget=4)},
                      {"external": ExternalPolicy(budget=4)})):
        with pytest.raises(ValueError, match="sim") as want:
            j_psort(x, config=JConfig(p=8, algorithm="rquick",
                                      backend="shard_map", **jkw))
        got = pool.run(error_job, x, dict(p=8, algorithm="rquick",
                                          backend="shard_map", **tkw))
        assert all(g == ("ValueError", str(want.value)) for g in got)


def test_shard_map_without_a_process_group_raises_and_never_sorts(
        monkeypatch):
    """No process group: the reference's default-mesh error, which points
    at the sim backend; the sim backend never runs in its place."""
    def no_sim(*a, **k):
        raise AssertionError("the sim backend ran")
    monkeypatch.setattr(tapi, "_psort_incore", no_sim)
    monkeypatch.setattr(tapi, "_sort_body", no_sim)
    x = np.arange(64, dtype=np.int32)
    for cfg in (SortConfig(p=4, backend="shard_map"),
                SortConfig(backend="shard_map", algorithm="rquick")):
        with pytest.raises(ValueError, match=r"use backend='sim'"):
            psort(x, cfg, device="cpu")
    # a nested or batched sort's default mesh: the reference's sort_mesh
    # error, with no rank to hold it
    with pytest.raises(ValueError, match="needs 4 devices; have 0"):
        psort(x, SortConfig(mesh_shape=(2, 2), backend="shard_map"),
              device="cpu")
    with pytest.raises(ValueError, match="needs 8 devices; have 0"):
        psort(x.reshape(2, 32), SortConfig(p=4, backend="shard_map"),
              device="cpu")
    with pytest.raises(ValueError, match=r"use backend='sim'"):
        tapi.trace_collectives(64, SortConfig(p=4, backend="shard_map"),
                               device="cpu")


def test_config_takes_both_backends_and_rejects_others():
    for backend in ("sim", "shard_map"):
        assert SortConfig(backend=backend).backend == backend
        assert JConfig(backend=backend).backend == backend
    for C in (SortConfig, JConfig):
        with pytest.raises(ValueError, match="backend") as e:
            C(backend="nope")
    assert str(e.value) == "unknown backend 'nope'; expected " \
        "('shard_map', 'sim')"
    mesh = object()
    assert SortConfig(mesh=mesh, axis="x") == SortConfig(axis="x")


# ---------------------------------------------------------------------------
# The trace (trace_collectives on the ranks)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ("rams", "rquick", "rfis", "ssort"))
def test_trace_collectives_on_ranks(pool, algorithm):
    """Each rank records what an emulated PE records: the port's sim
    trace and the reference's, event for event."""
    cfg = dict(p=8, algorithm=algorithm)
    want = [tuple(e.__dict__.values())
            for e in j_trace(512, JConfig(**cfg)).events]
    sim = [tuple(e.__dict__.values()) for e in tapi.trace_collectives(
        512, SortConfig(**cfg), device="cpu").events]
    assert sim == want
    assert all(r == want for r in pool.run(trace_job, 512, cfg))


@pytest.mark.parametrize("where", ["world", "reversed mesh"])
def test_collectives_per_rank_equal_emulated_pes(pool, where):
    """Each collective on a rank equals the emulated PEs' row for that
    PE, bit for bit: float sums in group order, bools, groups listed out
    of order and strided, a partial ppermute's zeros, the hypercube swap
    and the streamed ring's delivery; on the default group and on a mesh
    whose axis order runs against the group's rank order."""
    g = np.random.default_rng(7)
    rows = g.integers(-1000, 1000, size=(8, 16)).astype(np.int64)
    groups = [[6, 0, 2, 4], [1, 7, 5, 3]]           # strided, out of order
    perm = [(0, 3), (3, 5), (5, 0), (6, 7)]          # partial: zeros
    want = collectives(comm, torch.from_numpy(rows), groups, perm)
    ranks = None if where == "world" else list(range(7, -1, -1))
    for rank, (pe, got) in enumerate(pool.run(collectives_job, rows, groups,
                                              perm, ranks)):
        assert pe == (rank if ranks is None else 7 - rank)
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            assert np.array_equal(got[k][0].view(np.uint8),
                                  w[pe].view(np.uint8)), (k, pe)


def test_comm_scope_outside_a_group_raises():
    with pytest.raises(RuntimeError, match="process group"):
        with comm.distributed(None):
            pass
    assert torch.distributed.is_available()
