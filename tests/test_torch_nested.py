"""Nested (outer × inner) meshes in the port: ``psort(SortConfig(
mesh_shape=(p_o, p_i)))``, ``comm.nested`` and the nested trace, against
the reference (``repro/core/comm.py`` ``NestedCollectives``,
``tests/test_nested.py``).

A nested run must equal the reference's nested run and the port's flat run
on the same level schedule bit for bit (keys, ``perm``, ``counts``,
``overflow``); its trace must equal the reference's event for event, each
event with the real axis it targets.  The reference's outputs are cached
(``test_torch_batched.reference``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import ExternalPolicy as JPolicy
from repro.core import SortConfig as JConfig
from repro.core import comm as jc
from repro.core import psort as j_psort
from repro.core import types as jt
from repro.core.api import trace_collectives as j_trace
from repro.core.rams import nested_level_bits as j_bits
from repro.data.distributions import generate_instance
from repro_torch import ExternalPolicy, SortConfig, psort, trace_collectives
from repro_torch.core import comm as tc
from repro_torch.core.rams import nested_level_bits
from test_torch_batched import models, reference, same
from torch_helpers import bits

ALGOS = ["rams", "ntb-ams", "rquick", "ntb-quick", "rfis", "ssort",
         "ns-ssort", "bitonic", "gatherm", "allgatherm"]


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def nested_vs_reference_and_flat(x, mesh, algorithm, key, levels=None,
                                 **kw):
    """The port's nested run ≡ the reference's nested run ≡ the port's
    flat run with the same level schedule."""
    p_o, p_i = mesh
    want, wi = reference(x, ("nested", key), mesh_shape=mesh,
                         algorithm=algorithm, levels=levels,
                         **kw.get("ref", {}))
    cfg = SortConfig(mesh_shape=mesh, algorithm=algorithm, levels=levels,
                     **kw.get("port", {}))
    got, gi = psort(x, cfg, return_info=True, device="cpu")
    assert gi["mesh_shape"] == wi["mesh_shape"] == tuple(mesh)
    same(got, gi, want, wi)
    flat_kw, picked = {}, gi["algorithm"]          # "auto": its pick
    if picked in ("rams", "ntb-ams"):
        flat_kw["level_bits"] = tuple(nested_level_bits(p_o, p_i, levels))
    port_kw = {k: v for k, v in kw.get("port", {}).items()
               if k != "cost_model"}
    flat, fi = psort(x, SortConfig(p=p_o * p_i, algorithm=picked,
                                   algo_kw=flat_kw, **port_kw),
                     return_info=True, device="cpu")
    assert torch.equal(flat, got) if torch.is_tensor(got) else all(
        torch.equal(a, b) for a, b in zip(flat, got))
    for k in ("counts", "overflow", "balance"):
        assert np.array_equal(np.asarray(fi[k]), np.asarray(gi[k])), k
    assert np.array_equal(np.asarray(fi["perm"]), np.asarray(gi["perm"]))
    return gi


@pytest.mark.parametrize("mesh,levels", [((16, 64), None), ((16, 64), 2),
                                         ((4, 16), 1), ((1, 8), None),
                                         ((8, 1), None), ((2, 4), 3)])
def test_nested_level_bits_is_the_reference_schedule(mesh, levels):
    assert nested_level_bits(*mesh, levels) == list(j_bits(*mesh, levels))


@pytest.mark.parametrize("dist", ["Uniform", "Zero", "Staggered",
                                  "DeterDupl"])
def test_rams_4x16_matches_reference_and_flat(dist):
    x = generate_instance(dist, 64, 24 * 64, seed=5).astype(np.int32)
    nested_vs_reference_and_flat(x, (4, 16), "rams", ("rams416", dist))


def test_rquick_8x8_matches_reference_and_flat():
    x = generate_instance("Staggered", 64, 16 * 64, seed=9).astype(np.int32)
    nested_vs_reference_and_flat(x, (8, 8), "rquick", "rquick88")


@pytest.mark.parametrize("algorithm", [a for a in ALGOS if a != "rams"]
                         + ["auto"])
def test_other_algorithms_2x4_match_reference_and_flat(algorithm):
    x = generate_instance("Uniform", 8, 37 * 8, seed=3).astype(np.uint32)
    kw = {}
    if algorithm == "auto":
        model, ref_model = models()
        kw = {"port": {"cost_model": model},
              "ref": {"cost_model": ref_model}}
    nested_vs_reference_and_flat(x, (2, 4), algorithm, (algorithm, 24), **kw)


@pytest.mark.parametrize("algorithm", ["rams", "rquick", "ssort"])
def test_batched_nested_2x2(algorithm):
    """2-D keys on a nested mesh: the reference's batched nested run, and
    row r ≡ the port's 1-D nested run of row r."""
    xs = np.stack([generate_instance("Uniform", 4, 11 * 4, seed=13 + r)
                   .astype(np.int32) for r in range(2)])
    cfg = SortConfig(mesh_shape=(2, 2), algorithm=algorithm)
    want, wi = reference(xs, (algorithm, "batched22"), mesh_shape=(2, 2),
                         algorithm=algorithm)
    got, gi = psort(xs, cfg, return_info=True, device="cpu")
    same(got, gi, want, wi)
    for r in range(2):
        one, oi = psort(xs[r], cfg, return_info=True, device="cpu")
        assert torch.equal(got[r], one)
        assert torch.equal(gi["perm"][r], oi["perm"])


@pytest.mark.parametrize("mesh,levels", [((1, 16), None), ((4, 4), 1),
                                         ((4, 4), 2)])
def test_single_member_outer_axis_and_levels(mesh, levels):
    """mesh_shape=(1, p) and ``levels`` through psort: the reference's
    runs, and the flat runs on its schedules; a single-member outer axis
    carries no level after the first."""
    x = generate_instance("Uniform", 16, 20 * 16, seed=17).astype(np.int32)
    nested_vs_reference_and_flat(x, mesh, "rams", ("levels", mesh, levels),
                                 levels=levels)
    if mesh[0] == 1:
        t = trace_collectives(20 * 16, SortConfig(mesh_shape=mesh,
                                                  algorithm="rams"),
                              device="cpu")
        assert t.by_axis()["intra"]["wire_bytes"] > 0
        for tag in t.tags():
            if tag.startswith("level") and tag != "level0":
                assert "inter" not in t.filter(tag=tag).axes()


@pytest.mark.parametrize("algorithm", ["rams", "ssort"])
def test_overlap_on_a_nested_mesh_is_the_barrier_path(algorithm):
    """The reference's view has no streamed exchange: ``overlap=True`` on a
    nested mesh is its barrier fallback, the same result and a trace with
    decomposed ``all_to_all`` events and no ``ovl:`` events."""
    x = generate_instance("Uniform", 8, 37 * 8, seed=3).astype(np.uint32)
    nested_vs_reference_and_flat(x, (2, 4), algorithm, (algorithm, "ovl"),
                                 port={"overlap": True},
                                 ref={"overlap": True})
    cfg = SortConfig(mesh_shape=(2, 4), algorithm=algorithm, overlap=True)
    got = trace_collectives(64 * 8, cfg, device="cpu")
    jax.clear_caches()
    want = j_trace(64 * 8, JConfig(mesh_shape=(2, 4), algorithm=algorithm,
                                   overlap=True))
    assert events(got) == events(want)
    assert not [t for t in got.tags() if t.startswith("ovl:")]


# ---------------------------------------------------------------------------
# comm.nested: each collective element for element the flat one
# ---------------------------------------------------------------------------

PO, PI = 4, 4
P = PO * PI
AXES = (("inter", PO), ("intra", PI))
GROUPS = {
    "strided_inner": [[s * PI + i for i in g] for s in range(PO)
                      for g in ([0, 2], [1, 3])],
    "singles": [[i] for i in range(P)],
    "inner_slices": [[s * PI + i for i in range(PI)] for s in range(PO)],
    "outer_pairs": [[s * PI + i for s in ss for i in range(PI)]
                    for ss in ([0, 1], [2, 3])],
    "outer_strided": [[s * PI + i for s in ss for i in range(PI)]
                      for ss in ([0, 2], [1, 3])],
    "whole": None,
}


def _collectives(x, groups):
    size = P if groups is None else len(groups[0])
    return (tc.all_gather(x, groups, tiled=True),
            tc.all_gather(x, groups),
            tc.psum(x, groups),
            tc.all_to_all(x.repeat(1, size), groups))


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_nested_collectives_equal_the_flat_ones(gname, d):
    """Under ``comm.nested`` each collective equals the flat one element
    for element, in a batch of d sorts too, and the reference's view."""
    groups = GROUPS[gname]
    x = torch.arange(d * P * 3, dtype=torch.int64).reshape(d * P, 3) * 5 + 2
    with tc.batched(d):
        flat = _collectives(x, groups)
        with tc.nested("sort", AXES):
            nest = _collectives(x, groups)
    for a, b in zip(nest, flat):
        assert torch.equal(a, b)
    # each sort of a batch as that sort alone
    for r in range(d):
        alone = _collectives(x[r * P:(r + 1) * P], groups)
        for a, b in zip(flat, alone):
            assert torch.equal(a[r * P:(r + 1) * P], b)
    # and the reference's view of the same groups (d = 1)
    if d == 1:
        def body(v):
            gs = groups
            size = P if gs is None else len(gs[0])
            return (jc.all_gather(v, "sort", axis_index_groups=gs,
                                  tiled=True),
                    jc.all_gather(v, "sort", axis_index_groups=gs),
                    jc.psum(v, "sort", axis_index_groups=gs),
                    jc.all_to_all(jnp.tile(v, (size,)), "sort",
                                  split_axis=0, concat_axis=0,
                                  axis_index_groups=gs, tiled=True))
        want = jc.sim_map(body, "sort", nested=AXES)(
            jnp.asarray(x.numpy()).reshape(PO, PI, 3))
        for a, b in zip(nest, want):
            assert np.array_equal(a.numpy(), np.asarray(b).reshape(a.shape))


def test_nested_ppermute_and_traces_equal_the_reference():
    """A hypercube perm on each axis, and the events a nested trace holds
    for each collective: the reference's counting view's."""
    x = torch.arange(P * 2, dtype=torch.int32).reshape(P, 2)
    perms = [[(i, i ^ (1 << j)) for i in range(P)] for j in range(4)]
    groups = GROUPS["outer_pairs"]
    with tc.counting() as t, tc.nested("sort", AXES):
        outs = [tc.ppermute(x, perm) for perm in perms]
        tc.all_gather(x, groups, tiled=True)
        tc.psum(x, GROUPS["strided_inner"])
        tc.all_to_all(x.repeat(1, 8), groups)
        tc.note("all_gather", x)
    for perm, out in zip(perms, outs):
        assert torch.equal(out, tc.ppermute(x, perm))
    trace = jc.CommTrace()

    def body(v):
        for perm in perms:
            jc.ppermute(v, "sort", perm)
        jc.all_gather(v, "sort", axis_index_groups=groups, tiled=True)
        jc.psum(v, "sort", axis_index_groups=GROUPS["strided_inner"])
        jc.all_to_all(jnp.tile(v, (8,)), "sort", split_axis=0,
                      concat_axis=0, axis_index_groups=groups, tiled=True)
        jc.all_gather(v, "sort")
        return v
    jax.eval_shape(jc.sim_map(body, "sort", nested=AXES,
                              impl=jc.CountingCollectives(jc.SIM, trace)),
                   jax.ShapeDtypeStruct((PO, PI, 2), jnp.int32))
    assert events(t) == events(trace)
    assert [e.axis for e in t.events[:4]] == ["intra", "intra", "inter",
                                              "inter"]


def test_misaligned_groups_and_perms_raise():
    x = torch.zeros((P, 4), dtype=torch.int64)
    with tc.nested("sort", AXES) as view:
        with pytest.raises(NotImplementedError):
            view.classify_groups([[0, 1, 2, 3, 4, 5], [6, 7]
                                  + list(range(8, 12)), list(range(12, 16))])
        with pytest.raises(NotImplementedError):
            tc.psum(x, [[0, 1, 2, 3, 4, 5], [6, 7] + list(range(8, 12)),
                        list(range(12, 16))])
        with pytest.raises(NotImplementedError):
            tc.ppermute(x, [(i, (i + 1) % P) for i in range(P)])
    with pytest.raises(NotImplementedError):
        with tc.nested("sort", (("a", 2),)):
            pass
    with pytest.raises(ValueError, match="axis"):
        tc.psum(x, axis="intra")


# ---------------------------------------------------------------------------
# The nested trace against the reference's
# ---------------------------------------------------------------------------


def events(trace):
    return [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
            for e in trace.events]


@pytest.mark.parametrize("algorithm,mesh,n", [
    (a, (2, 4), 64 * 8) for a in ALGOS] + [("rams", (4, 16), 32 * 64),
                                           ("gatherm", (2, 4), 4),
                                           ("rfis", (2, 4), 8)])
def test_nested_trace_equals_the_reference(algorithm, mesh, n):
    got = trace_collectives(n, SortConfig(mesh_shape=mesh,
                                          algorithm=algorithm),
                            device="cpu")
    jax.clear_caches()
    want = j_trace(n, JConfig(mesh_shape=mesh, algorithm=algorithm))
    assert events(got) == events(want)
    assert got.by_axis() == want.by_axis()
    assert got.summary(mesh[0] * mesh[1]) == want.summary(mesh[0] * mesh[1])


def test_nested_trace_attribution():
    """The reference's invariants: only the shuffle and level 0 cross the
    outer axis, with one slotted exchange (3 all_to_all) at level 0; the
    tags and the axes partition the totals; d adds nothing per PE."""
    cfg = SortConfig(mesh_shape=(4, 16), algorithm="rams")
    t = trace_collectives(32 * 64, cfg, device="cpu")
    inter = t.filter(primitive="all_to_all", axis="inter")
    assert inter.tags() == ["level0", "shuffle"]
    assert len(inter.filter(tag="level0").events) == 3
    assert t.filter(tag="level1").axes() == ["intra"]
    tot = t.summary()
    for split in (t.by_tag(), t.by_axis()):
        assert sum(s["wire_bytes"] for s in split.values()) == \
            tot["wire_bytes"]
    t3 = trace_collectives(32 * 64, cfg, d=3, device="cpu")
    assert events(t3) == events(t)


@pytest.mark.parametrize("case", ["not a power of two", "p mismatch",
                                  "external", "levels"])
def test_nested_errors_are_the_reference_errors(case):
    x = np.arange(64, dtype=np.uint32)[::-1].copy()
    port, ref, match = {
        "not a power of two": ({"mesh_shape": (3, 4)},
                               {"mesh_shape": (3, 4)}, "powers of two"),
        "p mismatch": ({"p": 16, "mesh_shape": (2, 4)},
                       {"p": 16, "mesh_shape": (2, 4)}, "inconsistent"),
        "external": ({"mesh_shape": (2, 2),
                      "external": ExternalPolicy(budget=4)},
                     {"mesh_shape": (2, 2), "external": JPolicy(budget=4)},
                     "one flat axis"),
        "levels": ({"mesh_shape": (2, 2), "levels": 2,
                    "algorithm": "rquick"},
                   {"mesh_shape": (2, 2), "levels": 2,
                    "algorithm": "rquick"}, "levels= applies")}[case]
    with pytest.raises(ValueError, match=match):
        psort(x, SortConfig(**port), device="cpu")
    with pytest.raises(ValueError, match=match):
        j_psort(x, config=JConfig(backend="sim", **ref))
    if case in ("not a power of two", "p mismatch"):
        with pytest.raises(ValueError, match=match):
            trace_collectives(64, SortConfig(**port), device="cpu")
    if case == "external":
        with pytest.raises(ValueError, match="external tracing"):
            trace_collectives(64, SortConfig(**port), device="cpu")
    assert bits(psort(x, SortConfig(mesh_shape=(2, 2), algorithm="rquick"),
                      device="cpu")).tolist() == list(range(64))
