"""The port's sharding rules (``repro_torch.dist.sharding``) against the
reference's (``repro.dist.sharding``), in one process.

The rules read only a mesh's axis names and sizes, and a rank's
coordinate for its own block, so the port's side runs on
``MeshLayout`` stand-ins; the reference's on ``jax.sharding.Mesh`` over
the eight emulated CPU devices, built directly (its ``Auto`` axes; see
ROADMAP §3 for ``make_mesh_shape``).

- ``make_shardings``: the placement tree equals the reference's
  ``PartitionSpec`` tree leaf by leaf, for all ten architectures at
  smoke size on the (2, 4), (4, 2), (1, 8) and (8, 1) meshes, with
  ``ddp`` off and on;
- each rank's slice of every leaf equals the reference sharding's
  ``devices_indices_map`` on (2, 4);
- ``data_axes_of``/``batch_axes_of`` with and without a ``pod`` axis,
  under ``ddp``, for batches that do and do not divide;
- ``shard_act``'s block equals the index map of the reference's
  constrained activation.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import ARCHS as JARCHS
from repro.dist import sharding as JS
from repro.models import transformer as JT
from repro_torch import dist as tdist_pkg
from repro_torch.dist import sharding as S
from repro_torch.models.transformer import Transformer
from repro_torch.optim.tree import param_tree
from torch_model_helpers import configs

ARCH_NAMES = sorted(JARCHS)
SHAPES = [(2, 4), (4, 2), (1, 8), (8, 1)]
NAMES = ("data", "model")


def _jmesh(shape, names=NAMES):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                names)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference leaves by path, with their shapes; the port's
    ``param_tree`` of a model on the meta device) of the smoke config."""
    jc, tc = configs(arch, "float32")
    abstract = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                     jc))
    flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
    ref = {tuple(k.key for k in path): leaf for path, leaf in flat}
    return jc, tc, ref, param_tree(Transformer(tc, torch.device("meta")))


def _ref_spec(spec, ndim):
    """A ``PartitionSpec`` as the axes of each of ``ndim`` dimensions."""
    out = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return out


def test_the_exports():
    for name in ("make_shardings", "shard_act", "data_axes_of",
                 "batch_axes_of", "sort_mesh"):
        assert callable(getattr(tdist_pkg, name)), name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_make_shardings_equals_the_reference(arch, shape):
    jc, tc, ref, port = _trees(arch)
    assert set(ref) == set(port)
    layout = S.MeshLayout(NAMES, shape)
    for ddp in (False, True):
        want = JS.make_shardings(ref, dataclasses.replace(jc, ddp=ddp),
                                 _jmesh(shape))
        got = S.make_shardings(port, dataclasses.replace(tc, ddp=ddp),
                               layout)
        assert list(got) == sorted(ref)
        for path, leaf in ref.items():
            assert tuple(port[path].shape) == tuple(leaf.shape), path
            assert len(got[path]) == 2
            assert S.placement_spec(got[path], layout, leaf.ndim) == \
                _ref_spec(want[path].spec, leaf.ndim), (path, ddp)


def test_make_shardings_rule_details():
    """Stacked norm scales split over D, the unstacked ``norm_f`` and the
    embedding's vocab dimension never; a tie goes to the first dimension;
    no mesh gives None; a module stands for its ``param_tree``."""
    _, tc, _, port = _trees("llama3.2-1b")
    layout = S.MeshLayout(NAMES, (2, 4))
    got = S.make_shardings(port, tc, layout)
    spec = {k: S.placement_spec(v, layout, port[k].ndim)
            for k, v in got.items()}
    assert spec[("blocks", "ln1")] == [(), ("model",)]          # (L, D)
    assert spec[("norm_f",)] == [()]
    assert spec[("embed",)] == [(), ("model",)]                 # (V, D)
    assert spec[("blocks", "attn", "wq")] == [(), ("model",), ()]  # tie
    assert all(v is None for v in S.make_shardings(port, tc, None).values())
    model = Transformer(tc, torch.device("meta"))
    assert S.make_shardings(model, tc, layout) == got
    one = S.make_shardings(port, tc, S.MeshLayout(("data",), (8,)))
    assert all(not pl.is_shard() for v in one.values() for pl in v)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_each_rank_holds_the_reference_shard(arch):
    jc, tc, ref, port = _trees(arch)
    jmesh = _jmesh((2, 4))
    want = JS.make_shardings(ref, jc, jmesh)
    got = S.make_shardings(port, tc, S.MeshLayout(NAMES, (2, 4)))
    devices = jax.devices()
    for r in range(8):
        layout = S.MeshLayout.of_rank(NAMES, (2, 4), r)
        for path, leaf in ref.items():
            idx = want[path].devices_indices_map(tuple(leaf.shape))[
                devices[r]]
            mine = S.leaf_slices(tuple(leaf.shape), got[path], layout)
            full = [slice(*s.indices(n)) for s, n in zip(idx, leaf.shape)]
            assert [slice(*s.indices(n)) for s, n in zip(mine, leaf.shape)] \
                == full, (path, r)


MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((4, 2), ("pod", "data")), ((8,), ("model",)),
          ((2, 4), ("data", "sort"))]


@pytest.mark.parametrize("shape,names", MESHES,
                         ids=lambda v: "-".join(map(str, v)))
def test_data_and_batch_axes_equal_the_reference(shape, names):
    jmesh = _jmesh(shape, names)
    layout = S.MeshLayout(names, shape)
    assert S.data_axes_of(layout) == JS.data_axes_of(jmesh)
    assert S.data_axes_of(None) == JS.data_axes_of(None) == ()
    for ddp in (False, True):
        cfg = SimpleNamespace(ddp=ddp)
        for batch in (None, 1, 2, 3, 4, 6, 8, 16):
            assert S.batch_axes_of(layout, cfg, batch) == \
                JS.batch_axes_of(jmesh, cfg, batch), (ddp, batch)
        assert S.batch_axes_of(layout) == JS.batch_axes_of(jmesh)
    assert S.batch_axes_of(None, cfg, 8) == ()


ACTS = [((8, 4, 16), {}), ((3, 4, 16), {}), ((16, 8, 16),
                                             {"axes": ("data", "model")}),
        ((8, 8, 16), {"seq_axis": "model"}), ((8, 4, 16), {"d_axis": "model"}),
        ((8, 16), {}), ((6, 4, 16), {"axes": ()})]


def _uses_model(kw):
    return "model" in kw.values() or "model" in kw.get("axes", ())


@pytest.mark.parametrize("shape,names,xshape,kw", [
    m + a for m in MESHES[:3] for a in ACTS
    if "model" in m[1] or not _uses_model(a[1])], ids=str)
def test_shard_act_rows_equal_the_reference(shape, names, xshape, kw):
    jmesh = _jmesh(shape, names)
    x = np.arange(int(np.prod(xshape)), dtype=np.float32).reshape(xshape)
    y = JS.shard_act(jax.numpy.asarray(x), jmesh, **kw)
    idx = y.sharding.devices_indices_map(xshape)
    devices = jax.devices()
    for r in range(int(np.prod(shape))):
        layout = S.MeshLayout.of_rank(names, shape, r)
        got = S.shard_act(torch.from_numpy(x), layout, **kw)
        np.testing.assert_array_equal(got.numpy(), x[idx[devices[r]]])
    assert S.shard_act(torch.from_numpy(x), None) is not None


def test_mesh_layout_answers_as_a_device_mesh():
    m = S.MeshLayout.of_rank(NAMES, (2, 4), 6)
    assert S.mesh_sizes(m) == {"data": 2, "model": 4}
    assert m.get_coordinate() == [1, 2]
    assert m.mesh.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="not in the mesh"):
        S.shard_act(torch.zeros(4, 2), S.MeshLayout(NAMES, (2, 4)))
    with pytest.raises(ValueError, match="does not split"):
        S.block_slices((3, 2), [("data",), ()], m)
