"""Device meshes and the model stack's sharding rules (counterpart of
``repro/dist/sharding.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group: each rank is one PE (one device in the
reference).  Building one creates the process groups of its dimensions,
a collective over the whole default group, so every rank calls
:func:`sort_mesh` with the same arguments, ranks the mesh leaves out
included.  Meshes are cached per layout, so repeated calls (``psort``'s
default meshes among them) reuse their groups.

Axis roles, as the reference's: ``pod``/``data`` carry the batch,
``model`` splits the weights, ``sort`` is the sorting meshes'.  The rules
read only a mesh's axis names and sizes and, for a rank's own block, its
coordinate, so a :class:`MeshLayout` (names, sizes, coordinate) stands
for a ``DeviceMesh`` wherever no transport is needed: any rank's slices
can be reckoned in one process.

``make_shardings`` gives every leaf of a parameter tree its placements,
one per mesh dimension (``Shard(i)`` or ``Replicate()`` of
``torch.distributed.tensor``), by the reference's rule: the largest
non-leading dimension that ``model`` divides, the first on a tie, over
``model``; a ``Stacked`` leaf's dimension 0 is the layer stack, never
split; ``cfg.ddp``, or no ``model`` > 1, replicates.
``named_shardings`` pairs each leaf's placements with the mesh (the
reference's ``NamedSharding``), which cuts a whole leaf to a rank's slice
and puts the slices back together.  ``shard_act`` is the rule for which
block of an activation a rank holds: its rows over the data axes when
the batch divides them (every row otherwise), and ``gather_blocks`` puts
the blocks of every rank back together.

A mesh also changes what is computed.  The ranks along ``model`` split
the products of a tensor-parallel block (``models.layers.tp_project``):
each multiplies its slice of an activation or its slice of a weight, and
the partial products are added up over ``model`` in rank order, so every
rank holds the same bits (:func:`sum_partials`, an all-reduce, or
:func:`scatter_partials`, a reduce-scatter onto a dimension such as the
heads).  A rank's results therefore agree with one device's within
float tolerance, not bit for bit.  :func:`recut` moves a leaf split on
one dimension to the same leaf split on another (one all-to-all),
:func:`relay_heads` an activation between a rank's block of whole heads
and every head's slice of its channels (where a recurrent state split by
:func:`cache_split_dim` lies), and :func:`max_over` takes a maximum over
the ranks.  The gathers still only
concatenate.

Gradients pass every collective as its transpose.  Along ``model`` each
rank holds a share of the gradient of an activation that every rank of
``model`` holds alike (``launch.steps.loss_and_grads`` backpropagates
one over ``model`` of the loss on each), and the whole gradient is the
sum of the shares.  So the backward of a gather is a reduce-scatter (the
shares of each block summed onto its owner, in rank order), that of
:func:`sum_partials` the same all-reduce (each partial needs the whole
gradient of the sum), and that of :func:`scatter_partials` an all-gather
(each partial needs the gradient of every block); a rank's slice of a
replicated activation passes its gradient back as its share, with no
transfer.  Tensors that take no gradient move as bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

_MESHES: Dict[tuple, object] = {}


def world_ranks() -> int:
    """The ranks of the default process group; 0 where none is
    initialised."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return 0
    return tdist.get_world_size()


def mesh_sizes(mesh) -> Dict[str, int]:
    """A mesh's axis sizes by name, in order (the reference's
    ``Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def check_world(mesh) -> None:
    """A model mesh must hold every rank of the process group (no mesh:
    nothing to check)."""
    if mesh is None:
        return
    ranks = int(np.prod(list(mesh_sizes(mesh).values())))
    if ranks != world_ranks():
        raise ValueError(f"a mesh of {ranks} ranks in a process group of "
                         f"{world_ranks()}")


def make_mesh(layout: np.ndarray, names: Tuple[str, ...]):
    """The ``DeviceMesh`` of the global ranks ``layout`` with axis
    ``names``, made once per (default group, layout, names); its device
    type follows the default group's backend (``cuda`` for NCCL)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not world_ranks():
        raise RuntimeError("a device mesh needs an initialised "
                           "torch.distributed process group")
    default = tdist.distributed_c10d._get_default_group()
    layout = np.asarray(layout, np.int64)
    key = (id(default), layout.shape, tuple(layout.reshape(-1).tolist()),
           tuple(names))
    if key not in _MESHES:
        device_type = "cuda" if tdist.get_backend() == "nccl" else "cpu"
        _MESHES[key] = DeviceMesh(device_type, torch.from_numpy(layout),
                                  mesh_dim_names=tuple(names))
    return _MESHES[key]


def sort_mesh(p: Optional[int] = None, d: int = 1, *, axis: str = "sort",
              data_axis: str = "data",
              shape: Optional[Tuple[int, int]] = None,
              mesh_axes: Tuple[str, str] = ("inter", "intra"),
              devices=None, exclude: Tuple[int, ...] = ()):
    """A device mesh for ``psort``: flat (d, p) or hierarchical nested.

    Flat form (default): a (d, p) mesh with axes (``data_axis``, ``axis``)
    — row r of a (d, n) key batch lives on the r-th data-axis slice and is
    sorted by the p ranks of its sort-axis subgroup.  ``p`` defaults to
    ``len(devices) // d``.

    Hierarchical form — ``shape=(p_outer, p_inner)`` builds the nested
    (``data_axis``?, *inter*, *intra*) mesh that hierarchy-aware ``psort``
    sorts over; the data axis leads only when ``d > 1``.  Flat PE index =
    ``outer · p_inner + inner``.

    ``devices`` are global ranks of the default process group (default:
    all of them, in order).  ``exclude`` drops ranks by their *position*
    in that list before the mesh is laid out — the elastic rescale path
    (``repro_torch.runtime.elastic.plan_sort_rescale``): the survivors
    renumber contiguously into the reduced mesh (pass the plan's
    ``p_new``/``mesh_shape`` as ``p``/``shape``).  The excluded ranks call
    this too: making the mesh is collective."""
    devs = list(devices) if devices is not None else list(
        range(world_ranks()))
    if exclude:
        bad = {int(i) for i in exclude}
        out_of_range = bad - set(range(len(devs)))
        if out_of_range:
            raise ValueError(f"exclude={sorted(bad)} names device positions "
                             f"outside 0..{len(devs) - 1}")
        devs = [dv for i, dv in enumerate(devs) if i not in bad]
    if d < 1:
        raise ValueError(f"d={d} must be >= 1")
    if shape is not None:
        if p is not None and p != int(np.prod(shape)):
            raise ValueError(f"p={p} inconsistent with shape={tuple(shape)}")
        p_o, p_i = (int(v) for v in shape)
        if p_o < 1 or p_i < 1 or d * p_o * p_i > len(devs):
            raise ValueError(f"requested mesh ({d}, {p_o}, {p_i}) needs "
                             f"{d * p_o * p_i} devices; have {len(devs)}")
        dims = (d, p_o, p_i) if d > 1 else (p_o, p_i)
        names = ((data_axis,) if d > 1 else ()) + tuple(mesh_axes)
        return make_mesh(np.array(devs[:d * p_o * p_i]).reshape(dims), names)
    p = p if p is not None else len(devs) // d
    if p < 1 or d * p > len(devs):
        raise ValueError(f"requested mesh ({d}, {p}) needs {d * p} devices; "
                         f"have {len(devs)}")
    return make_mesh(np.array(devs[:d * p]).reshape(d, p), (data_axis, axis))


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh as the sharding rules read it: its axis ``names``, their
    ``sizes`` and one rank's ``coord`` (None: a rank outside it).  It
    answers ``mesh_dim_names``, ``mesh`` and ``get_coordinate()`` as a
    ``DeviceMesh`` does, and carries no process group."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coord: Optional[Tuple[int, ...]] = None

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return tuple(self.names)

    @property
    def mesh(self) -> torch.Tensor:
        return torch.arange(int(np.prod(self.sizes))).reshape(self.sizes)

    def get_coordinate(self) -> Optional[List[int]]:
        return None if self.coord is None else list(self.coord)

    @classmethod
    def of_rank(cls, names, sizes, rank: int) -> "MeshLayout":
        """Rank ``rank`` of the row-major layout ``sizes``."""
        return cls(tuple(names), tuple(int(v) for v in sizes), tuple(
            int(v) for v in np.unravel_index(rank, tuple(sizes))))


def data_axes_of(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry batch parallelism, outermost first."""
    if mesh is None:
        return ()
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _size(sizes: Dict[str, int], axes) -> int:
    return int(np.prod([sizes[a] for a in axes])) if axes else 1


def batch_axes_of(mesh, cfg=None, batch: Optional[int] = None
                  ) -> Tuple[str, ...]:
    """Axes the batch dimension shards over.  Under ``cfg.ddp`` the model
    axis joins the batch axes (weights are replicated, so every rank can
    take a batch slice).  Axes are dropped innermost-first until ``batch``
    divides the axis product."""
    if mesh is None:
        return ()
    sizes = mesh_sizes(mesh)
    axes = list(data_axes_of(mesh))
    if cfg is not None and getattr(cfg, "ddp", False) and "model" in sizes:
        axes.append("model")
    if batch is not None:
        while axes and batch % _size(sizes, axes) != 0:
            axes.pop()
    return tuple(axes)


def act_axes(mesh, batch: int, axes: Optional[Sequence[str]] = None
             ) -> Tuple[str, ...]:
    """The axes :func:`shard_act` splits a batch of ``batch`` rows over:
    ``axes`` as given, by default the data axes when the batch divides
    them, else none."""
    if mesh is None:
        return ()
    if axes is None:
        axes = data_axes_of(mesh)
        if batch % _size(mesh_sizes(mesh), axes):
            axes = ()
    return tuple(axes)


def act_spec(shape, mesh, seq_axis: Optional[str] = None,
             d_axis: Optional[str] = None,
             axes: Optional[Sequence[str]] = None) -> List[Tuple[str, ...]]:
    """The reference's ``PartitionSpec`` of a constrained activation
    (``shard_act``), as the axes of each dimension (() where whole)."""
    spec: List[Tuple[str, ...]] = [act_axes(mesh, shape[0], axes)] + [
        ()] * (len(shape) - 1)
    if seq_axis is not None and len(shape) >= 3:
        spec[1] = (seq_axis,)
    if d_axis is not None:
        spec[-1] = (d_axis,)
    return spec


def local_rows(batch: int, mesh, axes: Optional[Sequence[str]] = None
               ) -> slice:
    """The rows of a batch of ``batch`` this rank holds under
    :func:`shard_act` (every row without a mesh)."""
    if mesh is None:
        return slice(0, batch)
    return block_slices((batch,), [act_axes(mesh, batch, axes)], mesh)[0]


def gather_rows(t: torch.Tensor, mesh, batch: int,
                axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The whole batch of ``batch`` rows from every rank's rows ``t`` (as
    :func:`local_rows` cuts them), on every rank; ``t`` without a
    mesh."""
    if mesh is None:
        return t
    return gather_blocks(t, mesh, act_axes(mesh, batch, axes))


def cache_split_dim(shape, mesh) -> Optional[int]:
    """The dimension of a layer's decode-state leaf that the reference's
    rule (``repro/launch/steps.py`` ``cache_specs``) splits over
    ``model``: of a 4-D leaf (a KV cache ``(B, S, KV, hd)``, rwkv6's
    ``wkv`` ``(B, H, hd_k, hd_v)``, mamba2's ``ssm`` ``(B, H, P, N)``)
    dimension 2 (the KV heads, hd_k, P) when ``model`` divides it, else
    dimension 1 (the length, the heads) when it divides that; of a 3-D
    leaf (mamba2's conv window ``(B, 3, C)``) dimension 1 when it
    divides; else none (None: rwkv6's ``last`` ``(B, D)``, or a mesh
    without ``model``)."""
    m = mesh_sizes(mesh).get("model") if mesh is not None else None
    if m is None:
        return None
    if len(shape) == 4 and shape[2] % m == 0:
        return 2
    if len(shape) in (3, 4) and shape[1] % m == 0:
        return 1
    return None


def cache_slice_shape(shape, mesh) -> Tuple[int, ...]:
    """The shape of this rank's slice of a layer's decode-state leaf of
    the whole shape ``shape`` (its rows already cut) by
    :func:`cache_split_dim`."""
    dim = cache_split_dim(shape, mesh)
    if dim is None:
        return tuple(shape)
    m = mesh_sizes(mesh)["model"]
    return tuple(shape[:dim]) + (shape[dim] // m,) + tuple(shape[dim + 1:])


def mesh_coord(mesh) -> Dict[str, int]:
    """This rank's index along each axis of ``mesh``, by name."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"this rank is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in coord)))


def block_slices(shape, spec, mesh) -> Tuple[slice, ...]:
    """This rank's block of an array of ``shape`` laid out as ``spec``
    (the axes of each dimension, the first major): dimension i cut into
    the product of its axes' sizes, the block at this rank's coordinate
    along them.  Each split dimension must divide."""
    sizes, coord = mesh_sizes(mesh), mesh_coord(mesh)
    out = []
    for n, axes in zip(shape, spec):
        parts, at = 1, 0
        for a in axes:
            parts, at = parts * sizes[a], at * sizes[a] + coord[a]
        if n % parts:
            raise ValueError(f"dimension {n} of {tuple(shape)} does not "
                             f"split over {tuple(axes)} ({parts} blocks)")
        out.append(slice(at * (n // parts), (at + 1) * (n // parts)))
    return tuple(out)


def shard_act(x: torch.Tensor, mesh, seq_axis: Optional[str] = None,
              d_axis: Optional[str] = None,
              axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """This rank's block of an activation ``(B, S, ..., D)`` in the
    reference's layout: its rows over ``axes`` (default: the data axes
    when the batch divides them, else every row); ``seq_axis``/``d_axis``
    split dims 1 / -1.  No mesh, or fewer than two dimensions: ``x``."""
    if mesh is None or x.ndim < 2:
        return x
    return x[block_slices(x.shape, act_spec(x.shape, mesh, seq_axis, d_axis,
                                            axes), mesh)]


def _rule(shape, model: int, ddp: bool) -> Optional[int]:
    """The dimension the reference's ``make_shardings`` splits over
    ``model``, or None."""
    if model > 1 and not ddp and len(shape) >= 2:
        cands = [i for i in range(1, len(shape))
                 if shape[i] >= model and shape[i] % model == 0]
        if cands:
            return max(cands, key=lambda i: shape[i])
    return None


def _placer(cfg, mesh):
    """The rule as a function of a leaf: its placements on ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_sizes(mesh)
    ddp = bool(getattr(cfg, "ddp", False)) if cfg is not None else False

    def rule(leaf):
        dim = _rule(tuple(getattr(leaf, "shape", np.shape(leaf))),
                    sizes.get("model", 1), ddp)
        return tuple(Shard(dim) if a == "model" and dim is not None
                     else Replicate() for a in sizes)
    return rule


def make_shardings(tree, cfg, mesh):
    """The placements of every leaf of a parameter or optimizer tree on
    ``mesh``: a tuple with one ``Shard(i)``/``Replicate()`` per mesh
    dimension, ``i`` a dimension of the leaf's reference shape ((L, …) for
    a ``Stacked`` leaf).  ``tree`` is a module (its ``param_tree``) or a
    tree of anything with a shape; no mesh gives a tree of None."""
    from torch import nn
    from repro_torch.optim.tree import map_leaves, param_tree
    if isinstance(tree, nn.Module):
        tree = param_tree(tree)
    if mesh is None:
        return map_leaves(lambda _: None, tree)
    return map_leaves(_placer(cfg, mesh), tree)


def split_dims(model, cfg, mesh) -> Dict[str, int]:
    """For each weight of ``model`` (by its name) that ``make_shardings``
    splits over ``model`` on ``mesh``, the dimension of the weight that
    it splits (a ``Stacked`` leaf's dimension i is i − 1 of a layer)."""
    from repro_torch.optim.tree import Stacked, layers, param_tree
    params = param_tree(model)
    placements = make_shardings(params, cfg, mesh)
    names = {id(t): n for n, t in model.named_parameters()}
    dims = {}
    for path, leaf in params.items():
        split = [pl.dim for pl in placements[path] if pl.is_shard()]
        for t in layers(leaf) if split else ():
            dims[names[id(t)]] = split[0] - isinstance(leaf, Stacked)
    return dims


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's placements on a mesh (the reference's ``NamedSharding``):
    which slice of the whole leaf each rank holds, and how the slices go
    back together.  A leaf is a tensor, a ``Stacked`` (its dimension 0
    the layers, never split) or a number (always whole)."""
    mesh: object
    placements: tuple

    def spec(self, ndim: int) -> List[Tuple[str, ...]]:
        return placement_spec(self.placements, self.mesh, ndim)

    def split_axes(self) -> Tuple[str, ...]:
        """The mesh axes the leaf is split over."""
        return tuple(a for a, pl in zip(self.mesh.mesh_dim_names,
                                        self.placements) if pl.is_shard())

    def replicated_axes(self) -> Tuple[str, ...]:
        """The mesh axes of more than one rank that hold the same slice."""
        sizes = mesh_sizes(self.mesh)
        return tuple(a for a in sizes
                     if sizes[a] > 1 and a not in self.split_axes())

    def slices(self, shape) -> Tuple[slice, ...]:
        """This rank's slice of a whole leaf of ``shape``."""
        return leaf_slices(tuple(shape), self.placements, self.mesh)

    def cut(self, leaf):
        """This rank's slice of a whole ``leaf`` (views)."""
        from repro_torch.optim.tree import Stacked
        if isinstance(leaf, (int, float)):
            return leaf
        cut = self.slices(leaf.shape)
        if isinstance(leaf, Stacked):
            return Stacked(t[cut[1:]] for t in leaf)
        return leaf[cut]

    def whole(self, leaf):
        """The whole leaf of this rank's slice ``leaf``, put together from
        every rank's (collective over the split axes; bytes, no
        gradient)."""
        from repro_torch.optim.tree import Stacked
        if isinstance(leaf, (int, float)) or not self.split_axes():
            return leaf
        stacked = isinstance(leaf, Stacked)
        spec = self.spec(leaf.ndim)[1:] if stacked else self.spec(leaf.ndim)

        def one(t):
            t = t.detach()
            for dim, axes in enumerate(spec):
                if axes:
                    t = gather_blocks(t, self.mesh, axes, dim=dim)
            return t
        return Stacked(one(t) for t in leaf) if stacked else one(leaf)


def named_shardings(tree, cfg, mesh):
    """:func:`make_shardings` with each leaf's placements and the mesh in
    one :class:`Sharding` (no mesh: a tree of None)."""
    from torch import nn
    from repro_torch.optim.tree import map_leaves, param_tree
    if isinstance(tree, nn.Module):
        tree = param_tree(tree)
    if mesh is None:
        return map_leaves(lambda _: None, tree)
    rule = _placer(cfg, mesh)
    return map_leaves(lambda leaf: Sharding(mesh, rule(leaf)), tree)


def placement_spec(placements, mesh, ndim: int) -> List[Tuple[str, ...]]:
    """Placements as the axes of each of ``ndim`` dimensions (the
    reference's ``PartitionSpec``, () where whole)."""
    spec: List[Tuple[str, ...]] = [()] * ndim
    for a, pl in zip(mesh_sizes(mesh), placements):
        if pl.is_shard():
            spec[pl.dim] = spec[pl.dim] + (a,)
    return spec


def leaf_slices(shape, placements, mesh) -> Tuple[slice, ...]:
    """This rank's slice of a leaf of ``shape`` under ``placements``."""
    return block_slices(shape, placement_spec(placements, mesh, len(shape)),
                        mesh)


def mesh_barrier(mesh) -> None:
    """Wait until every rank of ``mesh`` is here (a barrier on each
    axis's group in turn: passing the last, a rank knows every rank
    reached the first)."""
    for name in mesh.mesh_dim_names:
        if mesh_sizes(mesh)[name] > 1:
            tdist.barrier(group=mesh.get_group(name))


# ---------------------------------------------------------------------------
# Transport: gathers, and their transposes
# ---------------------------------------------------------------------------


def _all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(size of ``axis``,) + t.shape: every rank's ``t`` along ``axis``
    (equal shapes), in axis order, carried as bytes by the port's
    transport (``comm.gather_pes``, unrecorded)."""
    from repro_torch.core import comm
    buf = t.contiguous().view(torch.uint8).reshape(1, -1)
    with comm.distributed(mesh, axis=axis):
        out = comm.gather_pes(buf)
    return out.view(t.dtype).reshape((out.shape[0],) + tuple(t.shape))


def _exchange(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Block j of ``t`` (n, …) to the rank at position j along ``axis``;
    returns (n, …), block j the one position j sent here (bytes,
    unrecorded)."""
    from repro_torch.core import comm
    buf = t.contiguous().view(torch.uint8).reshape(t.shape[0], -1)
    with comm.distributed(mesh, axis=axis) as d:
        ax = d.axis(axis)
        out = comm._d_alltoall(ax, list(range(ax.size)), buf)
    return out.view(t.dtype).reshape(t.shape)


def sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """``rows[0] + rows[1] + …`` in that order, accumulated in float32,
    in the rows' dtype."""
    acc = rows[0].to(torch.float32, copy=True)
    for r in rows[1:]:
        acc += r
    return acc.to(rows.dtype)


def _reduce_scatter(g: torch.Tensor, mesh, axis: str, dim: int
                    ) -> torch.Tensor:
    """Block i of ``g`` along ``dim`` (cut into the size of ``axis``)
    summed over the ranks of ``axis``, on the rank at position i: the
    transpose of a gather along ``dim``."""
    from repro_torch.core import comm
    n = mesh_sizes(mesh)[axis]
    parts = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0)
    b = g.numel() * g.element_size()
    with comm.carried_as("reduce-scatter", axis, b, b // n):
        return sum_rows(_exchange(parts, mesh, axis))


def gather_blocks(t: torch.Tensor, mesh, axes: Sequence[str],
                  dim: int = 0) -> torch.Tensor:
    """Every rank's block ``t`` across ``axes`` (the first major, as in a
    spec) concatenated along ``dim``: the whole of what :func:`shard_act`
    or :func:`leaf_slices` cut, on every rank.  Exact: it only copies.
    Its backward sums each rank's gradient of the whole into the blocks'
    owners (a reduce-scatter over ``axes``)."""
    from repro_torch.core import comm
    axes = tuple(a for a in axes if mesh_sizes(mesh)[a] > 1)
    if not axes:
        return t

    def gather(xs):
        x = xs[0]
        for a in reversed(axes):
            g = _all_gather(x, mesh, a)              # (n,) + x.shape
            x = g.movedim(0, dim).flatten(dim, dim + 1)
        return (x,)

    def scatter(gs):
        g = gs[0]
        for a in axes:
            g = _reduce_scatter(g, mesh, a, dim)
        return (g,)
    return comm.collective(gather, scatter, t)[0]


def _packed(ts: Sequence[torch.Tensor], rows: int):
    """The bytes of each (rows, …) tensor of ``ts`` side by side in one
    (rows, total) uint8 buffer, each padded to 16 bytes; and each one's
    (offset, bytes)."""
    nbytes = [t[0].numel() * t.element_size() for t in ts]
    pads = [-(-n // 16) * 16 for n in nbytes]
    buf = ts[0].new_empty((rows, sum(pads)), dtype=torch.uint8)
    at, off = [], 0
    for t, n, pad in zip(ts, nbytes, pads):
        buf[:, off:off + n] = t.contiguous().view(torch.uint8).reshape(
            rows, -1)
        at.append((off, n))
        off += pad
    return buf, at


def gather_model(shards: Sequence[torch.Tensor], dims: Sequence[int],
                 mesh, axis: str = "model") -> List[torch.Tensor]:
    """Each of ``shards`` whole: every rank's shard along ``axis``
    concatenated along its dimension in ``dims``, all of them in one
    gather of their bytes (each padded to 16 bytes).  Its backward
    reduce-scatters the gradients of the wholes in one exchange."""
    from repro_torch.core import comm
    if not shards:
        return []
    shapes = [tuple(t.shape) for t in shards]

    def gather(xs):
        buf, at = _packed([t.reshape(1, -1) for t in xs], 1)
        g = _all_gather(buf[0], mesh, axis)          # (m, total bytes)
        del buf
        out = []
        for t, (off, n), d in zip(xs, at, dims):
            part = g[:, off:off + n].view(t.dtype).reshape(
                (g.shape[0],) + tuple(t.shape))
            out.append(part.movedim(0, d).flatten(d, d + 1))
        return tuple(out)

    def scatter(gs):
        m = mesh_sizes(mesh)[axis]
        parts = [g.unflatten(d, (m, g.shape[d] // m)).movedim(d, 0).reshape(
            m, -1) for g, d in zip(gs, dims)]
        buf, at = _packed(parts, m)
        del parts
        with comm.carried_as("reduce-scatter", axis, buf.numel(),
                             buf.numel() // m):
            got = _exchange(buf, mesh, axis)         # (m, total bytes)
        del buf
        return tuple(sum_rows(got[:, off:off + n].view(g.dtype).reshape(
            (m,) + shape)) for g, (off, n), shape in zip(gs, at, shapes))
    return list(comm.collective(gather, scatter, *shards))


def sum_over(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The float32 scalar ``x`` summed over the ranks of ``axes`` (the
    first major) in rank order, the same bits on every rank: each axis's
    values gathered (one all-reduce of 4 bytes an axis), then summed.
    Each rank's ``x`` is one term of the sum, so the backward hands each
    rank the sum's gradient as its own term's."""
    from repro_torch.core import comm
    axes = tuple(a for a in axes if mesh_sizes(mesh)[a] > 1)
    if not axes:
        return x

    def gather(xs):
        t = xs[0].reshape(1)
        for a in reversed(axes):
            b = t.numel() * t.element_size()
            with comm.carried_as("all-reduce", a, b, b):
                t = _all_gather(t, mesh, a).reshape(-1)
        return (sum_rows(t[:, None])[0],)
    return comm.collective(gather, lambda gs: gs, x)[0]


_BUCKET_BYTES = 1 << 26        # the most one reduction exchanges at a time


def _all_reduce(flat: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The 1-D ``flat`` summed over the ranks of ``axis``: each rank sums
    one block in rank order (a reduce-scatter), then every rank gathers
    the sums, so every rank holds the same bits."""
    from repro_torch.core import comm
    n = mesh_sizes(mesh)[axis]
    size = flat.numel()
    b = size * flat.element_size()
    with comm.carried_as("all-reduce", axis, b, b):
        pad = -size % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        mine = sum_rows(_exchange(flat.view(n, -1), mesh, axis))
        return _all_gather(mine, mesh, axis).reshape(-1)[:size]


def reduce_replicas(tensors: Sequence[torch.Tensor],
                    shardings: Sequence[Sharding]) -> List[torch.Tensor]:
    """Each of ``tensors`` (this rank's slice of a leaf under its
    sharding) summed over the axes along which the leaf is replicated,
    one axis after another, each element in rank order: every rank
    holding a slice ends with the same bits.  Tensors of one dtype and
    one set of axes go together, up to 64 MiB an exchange."""
    out = list(tensors)
    groups: Dict[tuple, List[List[int]]] = {}
    for k, sh in enumerate(shardings):
        if sh is None or not sh.replicated_axes():
            continue
        buckets = groups.setdefault((sh.replicated_axes(), out[k].dtype),
                                    [[]])
        size = sum(out[j].numel() * out[j].element_size()
                   for j in buckets[-1])
        if buckets[-1] and size + out[k].numel() * out[k].element_size() \
                > _BUCKET_BYTES:
            buckets.append([])
        buckets[-1].append(k)
    for (axes, _), buckets in groups.items():
        mesh = shardings[buckets[0][0]].mesh
        for ks in buckets:
            flat = torch.cat([out[k].reshape(-1) for k in ks])
            for a in axes:
                flat = _all_reduce(flat, mesh, a)
            for k, part in zip(ks, flat.split([out[k].numel()
                                               for k in ks])):
                out[k] = part.view(out[k].shape)
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel collectives: partial products over ``model``
# ---------------------------------------------------------------------------


def sum_partials(x: torch.Tensor, mesh, axis: str = "model"
                 ) -> torch.Tensor:
    """The partial products ``x`` of the ranks along ``axis`` added up in
    rank order (in float32, back in ``x``'s dtype): the same bits on
    every rank, one all-reduce.  Its backward is the same all-reduce:
    each rank holds a share of the sum's gradient, and each partial needs
    the whole of it.  One rank along ``axis``: ``x``."""
    from repro_torch.core import comm
    if mesh_sizes(mesh).get(axis, 1) == 1:
        return x
    shape = x.shape

    def total(xs):
        return (_all_reduce(xs[0].reshape(-1), mesh, axis).view(shape),)
    return comm.collective(total, total, x)[0]


def scatter_partials(x: torch.Tensor, mesh, dim: int = -1,
                     axis: str = "model") -> torch.Tensor:
    """Block i of ``x``'s dimension ``dim`` (cut into the size of
    ``axis``) summed over the ranks along ``axis`` in rank order, on the
    rank at position i: a reduce-scatter of partial products onto, say,
    a rank's heads.  Its backward gathers the blocks' gradients: each
    partial needs the gradient of every block."""
    from repro_torch.core import comm
    if mesh_sizes(mesh).get(axis, 1) == 1:
        return x
    dim = dim % x.ndim

    def scatter(xs):
        return (_reduce_scatter(xs[0], mesh, axis, dim),)

    def gather(gs):
        g = _all_gather(gs[0], mesh, axis)
        return (g.movedim(0, dim).flatten(dim, dim + 1),)
    return comm.collective(scatter, gather, x)[0]


def max_over(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks along ``axis``, the
    same bits on every rank (one all-reduce; no gradient)."""
    from repro_torch.core import comm
    if mesh_sizes(mesh).get(axis, 1) == 1:
        return x.detach()
    b = x.numel() * x.element_size()
    with comm.carried_as("all-reduce", axis, b, b):
        return _all_gather(x.detach(), mesh, axis).amax(dim=0)


def relay_heads(ts: Sequence[torch.Tensor], mesh, heads: int,
                to_slices: bool, axis: str = "model") -> List[torch.Tensor]:
    """Each of ``ts``, an activation whose last dimension holds ``heads``
    heads of ``c`` channels each, moved between its two layouts over
    ``axis``: this rank's block of whole heads ``(…, heads / m · c)``,
    contiguous as the weights' slices lie, and every head's slice of its
    channels ``(…, heads · c / m)``, as a recurrent state split on a
    head's dimension lies (``to_slices`` from the first to the second,
    else back).  One all-to-all for all of them (:func:`recut_many`); its
    backward is the inverse move."""
    m = mesh_sizes(mesh).get(axis, 1)
    if m == 1 or not ts:
        return list(ts)
    views = [t.unflatten(-1, (heads // m, -1) if to_slices else (heads, -1))
             for t in ts]
    nd = views[0].ndim
    src, dst = (nd - 2, nd - 1) if to_slices else (nd - 1, nd - 2)
    return [v.flatten(-2) for v in recut_many(
        views, mesh, [src] * len(views), [dst] * len(views), axis)]


def recut(t: torch.Tensor, mesh, src: int, dst: int,
          axis: str = "model") -> torch.Tensor:
    """This rank's slice of a leaf split over ``axis`` on dimension
    ``src`` (``t``) as its slice of the same leaf split on dimension
    ``dst``: each rank sends the others their blocks of ``dst``, one
    all-to-all.  It only moves bytes, and its backward is the inverse
    move."""
    return recut_many([t], mesh, [src], [dst], axis)[0]


def recut_many(ts: Sequence[torch.Tensor], mesh, srcs: Sequence[int],
               dsts: Sequence[int], axis: str = "model"
               ) -> List[torch.Tensor]:
    """:func:`recut` of each of ``ts`` from its dimension in ``srcs`` to
    its dimension in ``dsts``: each rank sends the others their blocks of
    the new dimension, all of them in one all-to-all of their bytes (each
    rank's block of each padded to 16 bytes).  Its backward is the
    inverse move, in one all-to-all too."""
    from repro_torch.core import comm
    n = mesh_sizes(mesh).get(axis, 1)
    if n == 1 or not ts:
        return list(ts)

    def move(xs, froms, tos):
        parts = [x.unflatten(b, (n, x.shape[b] // n)).movedim(b, 0)
                 for x, b in zip(xs, tos)]
        buf, at = _packed([p.reshape(n, -1) for p in parts], n)
        got = _exchange(buf, mesh, axis)
        del buf
        return tuple(got[:, off:off + nb].view(p.dtype).reshape(
            p.shape).movedim(0, a).flatten(a, a + 1)
            for p, (off, nb), a in zip(parts, at, froms))
    return list(comm.collective(lambda xs: move(xs, srcs, dsts),
                                lambda gs: move(gs, dsts, srcs), *ts))
