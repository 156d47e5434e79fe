"""The port's dry-run layer (``repro_torch.launch.{mesh, steps, op_cost,
dryrun, roofline}``) against the reference's (``repro.launch``), on the
CPU: the reference on its eight emulated devices, the port on the meta
device, where nothing is allocated.

- (i) ``abstract_state``, ``sharded_specs``, ``input_specs`` and
  ``cache_specs`` against the reference's on a (2, 4) mesh (a
  ``jax.sharding.Mesh`` built directly; a ``MeshLayout`` in the port):
  leaf shapes, dtypes and placements, for each family's smoke variant
  and each shape (token ids are int64 in the port, int32 in the
  reference); every decode-state leaf (KV caches, rwkv6's and mamba2's
  recurrent states) placed as the reference's, and
  ``init_decode_state`` on the mesh holding that slice, on (2, 4) and,
  where the rule splits mamba2's conv window, on (1, 3);
- (ii) ``op_cost``'s ``dot_flops`` of the train, prefill and decode
  steps against the dot FLOPs of the reference's compiled steps (its
  ``hlo_cost`` walk, counting only ``dot`` instructions through
  ``while``, fusion and call) within 2 %, at smoke depth and widths where
  the matmuls dominate, and ``model_flops_global`` equal exactly; on
  rank 0 of (2, 4) at most 1.15× the dots of one device's program of
  the reference's step compiled on the (2, 4) ``Mesh``; and no weight of
  an attention block, a dense MLP or the head on the wire of a dense
  model's steps on that mesh;
- (iii) the reference's two cost tests, ported: a matmul ten times and
  an all-reduce of 8 × 8 float32 (512 wire bytes); the int8 compressed
  mean on a 4-rank ``MeshLayout`` moves less than 0.45× the wire bytes
  of a float32 ``psum``;
- (iv) the dry-run of phase 22a's configuration (granite-moe-1b-a400m,
  full width, 2 layers, bf16, remat ``full``, AdamW, batch 4 × 2048,
  (data 2, model 2)) on each of the four ranks: the bytes sent and
  received a step and the resident weights and moments that the card's
  ranks measure (932 694 520: the logits and the loss on a rank's rows,
  attention split over ``model`` in place, its partial products summed,
  the MoE layer on a rank's rows with its experts re-cut to the
  dispatch's; 157 432 832 and 629 444 608 bytes);
- (v) ``remat="dots"``: loss and gradients equal the reference's
  ``"dots"`` within the model tests' 1e-4/1e-5, and the dry-run's FLOPs
  order ``"none"`` < ``"dots"`` < ``"full"``;
- (vi) a ``run_cell`` record's keys, a skipped cell, and the reference's
  ``roofline.fmt_row`` of a port record equal to the port's.
"""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import SHAPES as JSHAPES, ShapeConfig as JShape
from repro.launch import hlo_cost
from repro.launch import roofline as JR
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs
from repro_torch.core import comm
from repro_torch.dist.sharding import MeshLayout
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import roofline as TR
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (make_mesh_shape, make_production_mesh,
                                     make_sort_mesh)
from repro_torch.models import transformer as T
from repro_torch.models.attention import KVCache
from repro_torch.models.convert import shard_params
from repro_torch.optim import tree as tr
from torch_model_helpers import F32, assert_f32, configs, model_pair
from torch_train_helpers import port_grads, ref_value_and_grad, train_batch

FAMILIES = {"dense": "llama3.2-1b", "moe": "granite-moe-1b-a400m",
            "ssm": "rwkv6-1.6b", "hybrid": "zamba2-2.7b",
            "vlm": "chameleon-34b", "audio": "musicgen-large"}
NAMES = ("data", "model")


def _jmesh(shape=(2, 4)):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                NAMES)


def _ref_spec(sharding, ndim):
    spec = sharding.spec
    out = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return out


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _same_leaf(port, psh, ref, rsh, what):
    """A port leaf (tensor or ``Stacked``) and its ``Sharding`` against a
    reference ``ShapeDtypeStruct`` and its ``NamedSharding``: shape,
    dtype, placement, and the cut slice's shape."""
    assert tuple(port.shape) == tuple(ref.shape), what
    assert _dtype_name(port) == str(ref.dtype), what
    assert psh.spec(port.ndim) == _ref_spec(rsh, port.ndim), what
    cut = S.sharded_specs(port, psh)
    assert tuple(cut.shape) == tuple(rsh.shard_shape(ref.shape)), what
    assert all(t.device.type == "meta" for t in tr.layers(cut)), what


# ---------------------------------------------------------------------------
# (i) the specs against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_specs_equal_the_reference(family, shape_name):
    jc, tc = configs(FAMILIES[family], "bfloat16")
    jmesh, layout = _jmesh(), MeshLayout.of_rank(NAMES, (2, 4), 5)
    kind = SHAPES[shape_name].kind
    # the weights (and, training, the optimizer state)
    if kind == "train":
        (jp, jo), (jps, jos) = JS.abstract_state(jc, jmesh)
        (model, opt), (ps, os_) = S.abstract_state(tc, layout)
        jol, jos_l = jax.tree.leaves(jo), jax.tree.leaves(jos)
        ol, os_l = tr.leaves(opt), tr.leaves(os_)
        assert len(ol) == len(jol)
        for k, (a, sh, b, rsh) in enumerate(zip(ol, os_l, jol, jos_l)):
            if isinstance(a, int):        # the step count: a Python int
                assert b.shape == () and sh.spec(0) == []
                continue
            _same_leaf(a, sh, b, rsh, ("opt", k))
    else:
        jp, jps = JS.abstract_state(jc, jmesh, with_opt=False)
        model, ps = S.abstract_state(tc, layout, with_opt=False)
    assert next(model.parameters()).device.type == "meta"
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    ref = {tuple(k.key for k in path): leaf for path, leaf in flat}
    rsh = {tuple(k.key for k in path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(jps)[0]}
    params = tr.param_tree(model)
    assert set(params) == set(ref)
    for path, leaf in params.items():
        _same_leaf(leaf, ps[path], ref[path], rsh[path], path)
    # a model cut to the rank's slices, sharded at rest
    cut = shard_params(model, tc, layout)
    assert cut.at_rest["mesh"] == {"data": 2, "model": 4}
    for path, leaf in tr.param_tree(cut).items():
        assert tuple(leaf.shape) == tuple(rsh[path].shard_shape(
            ref[path].shape)), path
    # the inputs
    shape = SHAPES[shape_name]
    jin = JS.input_specs(jc, JSHAPES[shape_name], jmesh)
    tin, tsh = S.input_specs(tc, shape, layout)
    assert set(tin) == set(jin)
    for k, v in jin.items():
        t = tin[k]
        assert tuple(t.shape) == tuple(v.shape) and t.device.type == "meta"
        if v.dtype == jnp.int32:          # token ids and labels: int64
            assert t.dtype == torch.int64, k
        else:
            assert _dtype_name(t) == str(v.dtype), k
        assert tsh[k].spec(t.ndim) == _ref_spec(v.sharding, t.ndim), k
    # the decode state: a layer's leaf against the reference's stacked
    # (L, …) leaf, every leaf placed as the reference places it (the
    # batch over the data axes; over ``model`` a KV cache's heads, else
    # its length, rwkv6's ``wkv`` on hd_k and mamba2's ``ssm`` on P, else
    # their heads), and ``init_decode_state`` on the mesh holding that
    # slice
    if kind == "decode":
        _same_decode_state(jc, tc, JSHAPES[shape_name], shape, jmesh,
                           layout)


def _same_decode_state(jc, tc, jshape, shape, jmesh, layout):
    """The port's ``cache_specs`` and ``init_decode_state`` on ``layout``
    against the reference's ``cache_specs`` on ``jmesh``, leaf by leaf:
    shape, dtype, placement (the reference's rule), the cut slice's shape
    and the held slice's, and a KV cache's ``split``."""
    model = dict(zip(layout.names, layout.sizes))["model"]
    jst = JS.cache_specs(jc, jshape, jmesh)
    st, sh = S.cache_specs(tc, shape, layout)
    held = T.init_decode_state(tc, shape.global_batch, shape.seq_len,
                               torch.bfloat16, device="meta", mesh=layout)
    for group in ("caches", "shared_caches"):
        ref_g = getattr(jst, group)
        if ref_g is None:
            assert getattr(st, group) is None
            continue
        mine, mine_sh = getattr(st, group), getattr(sh, group)
        kv = isinstance(mine[0], KVCache)
        for field in type(ref_g)._fields:
            r = getattr(ref_g, field)
            if field == "pos":            # the port's position is an int
                continue
            assert len(mine) == r.shape[0], (group, field)
            rspec = _ref_spec(r.sharding, r.ndim)
            assert rspec[0] == (), (group, field)
            assert rspec[2:] == _reference_cache_rule(r.shape[1:], model), (
                group, field)
            shard = tuple(r.sharding.shard_shape(r.shape)[1:])
            for layer, layer_sh, own in zip(mine, mine_sh,
                                            getattr(held, group)):
                t, tsh_ = getattr(layer, field), getattr(layer_sh, field)
                assert tuple(t.shape) == tuple(r.shape[1:]), (group, field)
                assert _dtype_name(t) == str(r.dtype), (group, field)
                assert tsh_.spec(t.ndim) == rspec[1:], (group, field)
                assert tuple(S.sharded_specs(t, tsh_).shape) == shard, (
                    group, field)
                assert tuple(getattr(own, field).shape) == shard, (
                    group, field)
                if kv:
                    split = 2 if rspec[3] else 1 if rspec[2] else None
                    assert own.split == layer.split == split, (group,
                                                               field)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_recurrent_states_on_model_3(family):
    """On a (1, 3) mesh the rule splits mamba2's conv window on its 3
    slots (and rwkv6's and mamba2's states, whose dimensions 3 does not
    divide, stay whole): the port's decode state against the reference's
    on a (1, 3) ``Mesh``, and a decode step reckoned on it (the window
    gathered for the step, the rank's slot kept)."""
    jc, tc = configs(FAMILIES[family], "bfloat16")
    jmesh = _jmesh((1, 3))
    shape = ShapeConfig("decode", 8, 2, "decode")
    for rank in range(3):
        layout = MeshLayout.of_rank(NAMES, (1, 3), rank)
        _same_decode_state(jc, tc, JShape("decode", 8, 2, "decode"), shape,
                           jmesh, layout)
    held = T.init_decode_state(tc, 2, 8, torch.bfloat16, device="meta",
                               mesh=layout)
    rec = dryrun.reckon(tc, shape, layout)
    assert rec["flops_per_device"] > 0
    if family == "hybrid":
        assert tuple(held.caches[0].conv.shape) == (2, 1, 160)
        assert rec["collective_bytes_by_axis"]["model"] > 0


def _reference_cache_rule(shape, model):
    """The reference's placement of a decode-state leaf's dimensions
    after the batch (``repro/launch/steps.py``'s ``cache_specs``, on a
    layer's ``shape``): a 4-D leaf splits its dimension 2 (KV heads,
    hd_k, P) over ``model`` when it divides, else its dimension 1
    (length, heads); a 3-D leaf dimension 1."""
    spec = [()] * (len(shape) - 1)
    if len(shape) == 4 and shape[2] % model == 0:
        spec[1] = ("model",)
    elif len(shape) in (3, 4) and shape[1] % model == 0:
        spec[0] = ("model",)
    return spec


def test_meshes_without_a_process_group():
    """One rank's layout of each production mesh; a ``DeviceMesh`` needs
    the ranks, as the reference's needs the devices."""
    m = make_production_mesh(rank=17)
    assert (m.names, m.sizes, m.coord) == (NAMES, (16, 16), (1, 1))
    m = make_production_mesh(multi_pod=True, rank=511)
    assert m.sizes == (2, 16, 16) and m.coord == (1, 15, 15)
    with pytest.raises(ValueError, match="not in a mesh"):
        make_production_mesh(rank=256)
    for build in (lambda: make_production_mesh(),
                  lambda: make_mesh_shape((2, 2), NAMES),
                  lambda: make_sort_mesh(8)):
        with pytest.raises(RuntimeError, match="ranks"):
            build()


# ---------------------------------------------------------------------------
# (ii) FLOPs against the reference's compiled steps
# ---------------------------------------------------------------------------

WIDE = dict(d_model=256, d_ff=512, n_heads=4, head_dim=64, vocab=512)
FLOP_B, FLOP_S = 2, 256


class DotsOnly(hlo_cost.HloModule):
    """The reference's trip-count-aware walk, counting ``dot`` FLOPs and
    ``bytes_min`` only (through ``while``, fusion, call and conditional),
    each dot kept."""

    def _instr_cost(self, opcode, type_str, rest, shapes):
        op = opcode.replace("-start", "")
        if op not in ("dot", "while", "fusion", "call", "conditional"):
            return hlo_cost.Cost()
        c = super()._instr_cost(opcode, type_str, rest, shapes)
        if op == "dot":
            self.dots.append((type_str.strip(), c.flops))
        return hlo_cost.Cost(flops=c.flops, bytes_min=c.bytes_min)


def _reference_hlo(jc, shape, mesh=None):
    """The optimized HLO text of the reference's step of ``shape``,
    compiled without a mesh or, SPMD, for one device of ``mesh`` (the
    state placed by its ``abstract_state``, as its dry-run lowers a
    cell)."""
    if shape.kind == "train":
        (p, o), (ps, os_) = JS.abstract_state(jc, mesh)
        fn, _ = JS.make_train_step(jc, mesh)
        state = JS.TrainState(JS.sharded_specs(p, ps),
                              JS.sharded_specs(o, os_),
                              jax.ShapeDtypeStruct((), jnp.int32))
        args = (state, JS.input_specs(jc, shape, mesh))
    else:
        p, ps = JS.abstract_state(jc, mesh, with_opt=False)
        p = JS.sharded_specs(p, ps)
        if shape.kind == "prefill":
            fn = JS.make_prefill_step(jc, mesh)
            args = (p, JS.input_specs(jc, shape, mesh))
        else:
            fn = JS.make_serve_step(jc, mesh)
            args = (p, JS.cache_specs(jc, shape, mesh),
                    JS.input_specs(jc, shape, mesh))
    if mesh is None:
        return jax.jit(fn).lower(*args).compile().as_text()
    with mesh:
        return jax.jit(fn).lower(*args).compile().as_text()


def _dots(text):
    """(the dots' cost, each dot's (type, FLOPs)) of an HLO text."""
    mod = DotsOnly(text)
    mod.dots = []
    return mod.entry_cost(), mod.dots


def _reference_model_flops(jc, shape):
    """``repro.launch.dryrun._model_flops``; importing that module sets
    the 512-device flag for its own process, so the flag is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        mod = importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod._model_flops(jc, shape)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m"])
def test_dot_flops_equal_the_reference(arch, kind):
    jc, tc = configs(arch, "bfloat16")
    jc, tc = (dataclasses.replace(c, **WIDE) for c in (jc, tc))
    jshape = JShape(kind, FLOP_S, FLOP_B, kind)
    cost, dots = _dots(_reference_hlo(jc, jshape))
    want = cost.flops
    rec = dryrun.reckon(tc, ShapeConfig(kind, FLOP_S, FLOP_B, kind), None)
    got = rec["dot_flops_per_device"]
    assert abs(got - want) <= 0.02 * want, (
        f"port {got} against the reference's {want}; the reference's "
        f"dots: {dots}")
    assert rec["flops_per_device"] >= got
    assert rec["model_flops_global"] == _reference_model_flops(jc, jshape)
    assert rec["unknown_trip_counts"] == 0


MESH_FLOP_B = 8


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dot_flops_on_a_mesh_against_the_reference(kind):
    """Rank 0 of (data 2, model 4) at the ``WIDE`` width: the port splits
    the attention's, the MLP's and the head's products over ``model``,
    so its dot FLOPs per rank are at most 1.15× the dots of one device's
    program of the reference's step compiled SPMD on the (2, 4) ``Mesh``
    (its state placed by ``abstract_state``), where gathering whole
    weights at use made them 3.2–3.5×; and at least 0.75× (the port
    drops no product: GSPMD divides some by less than the 8 ranks)."""
    jc, tc = configs("llama3.2-1b", "bfloat16")
    jc, tc = (dataclasses.replace(c, **WIDE) for c in (jc, tc))
    jshape = JShape(kind, FLOP_S, MESH_FLOP_B, kind)
    cost, dots = _dots(_reference_hlo(jc, jshape, _jmesh()))
    want = cost.flops
    rec = dryrun.reckon(tc, ShapeConfig(kind, FLOP_S, MESH_FLOP_B, kind),
                        MeshLayout.of_rank(NAMES, (2, 4), 0))
    got = rec["dot_flops_per_device"]
    print(f"[dot flops] llama3.2-1b WIDE {kind}, rank 0 of (2, 4): port "
          f"{got:.0f}, reference {want:.0f} per device, ratio "
          f"{got / want:.4f}")
    assert 0.75 * want <= got <= 1.15 * want, (
        f"port {got} against the reference's {want} per device; the "
        f"reference's dots: {dots}")


# the weights a tensor-parallel block multiplies where they lie, and the
# head's and the embedding's: no collective may carry them on a mesh with
# ``model`` > 1 (a tied embedding is re-cut by one all-to-all)
SPLIT_WEIGHTS = ("wq", "wk", "wv", "wo", "up", "gate", "down", "head",
                 "embed")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "chameleon-34b"])
def test_no_weight_of_a_split_block_on_the_wire(arch, monkeypatch):
    """A dense smoke model (llama3.2-1b: a tied embedding whose vocabulary
    ``model`` divides; chameleon-34b: an untied head, qk-norm) sharded at
    rest on rank 0 of (data 2, model 4): its prefill, its loss with the
    gradients and a decode step under ``comm.dry()``.  The weights a
    block gathers at use (``gather_model``) are the norms alone, and no
    tensor that the transport carries has the shape of an attention,
    MLP, head or embedding weight, whole or a rank's slice."""
    from repro_torch.dist import sharding as SH
    cfg = configs(arch, "float32")[1]
    layout = MeshLayout.of_rank(NAMES, (2, 4), 0)
    model = shard_params(T.Transformer(cfg, torch.device("meta")), cfg,
                         layout)
    weights = {tuple(t.shape) for m in (model, T.Transformer(
        cfg, torch.device("meta"))) for n, t in m.named_parameters()
        if n.rsplit(".", 1)[-1] in SPLIT_WEIGHTS}
    norms = {tuple(t.shape) for n, t in model.named_parameters()
             if "norm" in n or n.rsplit(".", 1)[-1] in ("ln1", "ln2")}
    carried, gathered = [], []
    for name in ("_all_gather", "_exchange"):
        real = getattr(SH, name)

        def spy(t, *a, _real=real, **k):
            carried.append(tuple(t.shape))
            return _real(t, *a, **k)
        monkeypatch.setattr(SH, name, spy)
    real_gather = T.gather_model

    def gather(shards, dims, mesh, **k):
        gathered.extend(tuple(t.shape) for t in shards)
        return real_gather(shards, dims, mesh, **k)
    monkeypatch.setattr(T, "gather_model", gather)
    B, Sq = 4, 16
    tok = torch.empty(B, Sq, dtype=torch.int64, device="meta")
    with comm.dry():
        T.forward(model, {"tokens": tok}, cfg, layout)
        model.requires_grad_(True)
        S.loss_and_grads(model, {"tokens": tok, "labels": tok}, cfg,
                         layout)
        model.requires_grad_(False)
        st = T.init_decode_state(cfg, B, 8, torch.float32, device="meta",
                                 mesh=layout)
        T.decode_step(model, st, {"tokens": tok[:, :1]}, cfg, layout)
    assert carried and gathered
    assert set(gathered) <= norms, (set(gathered), norms)
    assert not weights & set(carried), (weights & set(carried))


# the architectures with a KV cache: all but rwkv6
KV_ARCHS = [a for a in list_archs() if get_config(a).family != "ssm"]


@pytest.mark.parametrize("arch", KV_ARCHS)
def test_ddp_decode_is_reckoned(arch):
    """The ``ddp`` decode of each architecture with a KV cache at smoke
    width on rank 1 of (data 2, model 2): the caches split on their KV
    heads over ``model`` (2 divides the smoke variants' 2 or 4), the
    weights whole, so the rank attends with its heads and gathers their
    outputs over ``model`` before ``wo``; the step is reckoned, the
    gather on the wire."""
    cfg = dataclasses.replace(configs(arch, "bfloat16")[1], ddp=True)
    layout = MeshLayout.of_rank(NAMES, (2, 2), 1)
    shape = ShapeConfig("decode", 16, 4, "decode")
    assert dryrun.cache_layout(cfg, shape, layout) == "heads"
    rec = dryrun.reckon(cfg, shape, layout)
    assert rec["flops_per_device"] > 0
    assert rec["collective_bytes_by_axis"].get("model", 0) > 0


GQA = dict(WIDE, n_heads=8)               # 8 query heads over 2 KV heads
MATMULS = ("aten.mm.default", "aten.addmm.default", "aten.bmm.default",
           "aten.baddbmm.default")


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_bytes_min_against_the_reference(kind):
    """``bytes_min`` of a grouped-query step against the reference's
    ``hlo_cost`` in float32 (XLA on the CPU computes a bf16 dot in
    float32, and the reference's decode needs a bf16 cache; float32
    train and prefill compare like with like).  The matmuls' operands and
    results are the reference's dots' to 2 %, and make at least 90 % of
    the port's ``bytes_min``: a broadcast (the KV heads repeated to the
    query heads) and a copy fused with its producer count in neither.
    The whole is within 0.6–1.25 of the reference's; the rest is layout
    copies, which each program makes where it must (the reference's
    training step copies transposed weights and activations out before
    its dots, about a third of its ``bytes_min`` here; the port's
    matmuls read them in place)."""
    jc, tc = configs("llama3.2-1b", "float32")
    jc, tc = (dataclasses.replace(c, **GQA) for c in (jc, tc))
    text = _reference_hlo(jc, JShape(kind, FLOP_S, FLOP_B, kind))
    want = hlo_cost.analyze(text)["bytes_min"]
    want_dots = _dots(text)[0].bytes_min
    rec = dryrun.reckon(tc, ShapeConfig(kind, FLOP_S, FLOP_B, kind), None)
    got = rec["bytes_per_device"]
    by_op = rec["bytes_min_by_operator"]
    got_dots = sum(by_op.get(op, 0) for op in MATMULS)
    assert abs(got_dots - want_dots) <= 0.02 * want_dots, (got_dots,
                                                           want_dots)
    assert got_dots >= 0.9 * got, by_op
    assert 0.6 * want <= got <= 1.25 * want, (got, want, by_op)


def test_bytes_min_counts_copies_not_fusions():
    """A copy out of a view that repeats elements (the GQA repeat of a KV
    cache) is a broadcast, and a copy of what an elementwise operator of
    the step made is fused with it, as XLA fuses both: in ``bytes`` only.
    A write into part of a buffer counts in ``bytes_min``, as XLA's
    ``dynamic-update-slice``, and a layout copy of an argument or of a
    matmul's result, as XLA's ``copy``."""
    k = torch.empty(2, 64, 2, 32, device="meta", dtype=torch.bfloat16)
    n = k.numel() * k.element_size()
    r = op_cost.analyze(lambda: k.repeat_interleave(4, dim=2))
    assert r["bytes_min"] == 0 and r["bytes"] == n + 4 * n
    assert r["flops"] == 4 * k.numel()
    r = op_cost.analyze(
        lambda: k.repeat_interleave(4, dim=2).transpose(1, 3).contiguous())
    assert r["bytes_min"] == 0
    r = op_cost.analyze(lambda: (k * 2).transpose(1, 2).contiguous())
    assert r["bytes_min"] == 0 and r["bytes"] == 4 * n
    r = op_cost.analyze(lambda: k.transpose(1, 2).contiguous())
    assert r["bytes_min"] == r["bytes"] == 2 * n
    def write_slot(cache):
        cache[:, 3] = k[:, 0] * 2
        return cache
    r = op_cost.analyze(write_slot, torch.empty(2, 8, 2, 32, device="meta",
                                                dtype=torch.bfloat16))
    assert r["bytes_min"] == 2 * (2 * 2 * 32 * 2)
    a = torch.empty(64, 32, device="meta")
    r = op_cost.analyze(lambda: (a @ a.t()).t().contiguous())
    mm = (2 * 64 * 32 + 64 * 64) * 4
    assert r["bytes_min"] == mm + 2 * 64 * 64 * 4
    assert r["bytes_min_by_op"] == {"aten.mm.default": mm,
                                    "aten.clone.default": 2 * 64 * 64 * 4}


# ---------------------------------------------------------------------------
# (iii) the reference's two cost tests, ported
# ---------------------------------------------------------------------------


def test_op_cost_on_a_synthetic_step():
    """An 8 × 8 matmul ten times, and an all-reduce of 8 × 8 float32 over
    the dry transport: 2·64·8 FLOPs a matmul, 2 × 256 wire bytes."""
    layout = MeshLayout.of_rank(("sort",), (4,), 1)

    def step(a):
        for _ in range(10):
            a = a @ a
        with comm.distributed(layout):
            s = comm.psum(a[None])[0]
        return a, s

    a = torch.empty(8, 8, device="meta")
    with comm.dry():
        r = op_cost.analyze(step, a)
    assert 10 * 1024 <= r["flops"] < 10 * 1024 + 500
    assert r["dot_flops"] == 10 * 1024
    assert r["collective_bytes"] == {"all-reduce": 2 * 256}
    assert r["collective_counts"] == {"all-reduce": 1}
    assert r["unknown_trip_counts"] == 0
    assert r["sent_bytes"] == r["received_bytes"] == 256 * 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64])
def test_dry_transport_carries_meta_only(dtype):
    """Under ``comm.dry()`` a collective on a tensor that is not a meta
    stand-in raises: the dry transport would return garbage for it."""
    layout = MeshLayout.of_rank(("sort",), (4,), 1)
    with comm.dry(), comm.distributed(layout):
        with pytest.raises(RuntimeError, match="meta stand-ins"):
            comm.psum(torch.ones((1, 8), dtype=dtype))
        assert comm.psum(torch.ones((1, 8), dtype=dtype,
                                    device="meta")).device.type == "meta"


def test_grad_compression_reduces_wire_bytes():
    """The int8 compressed mean on 4 ranks moves under 0.45× the wire
    bytes of a float32 ``psum`` of the same gradient."""
    from repro_torch.optim.grad_compress import compressed_psum_mean
    p = 4
    layout = MeshLayout.of_rank(("data",), (p,), 2)
    g = torch.empty((1, 1 << 16), device="meta")
    e = torch.empty((1, 1 << 16), device="meta")

    def comp():
        with comm.distributed(layout, axis="data"):
            return compressed_psum_mean(g, e, "data", p)

    def exact():
        with comm.distributed(layout, axis="data"):
            return comm.psum(g) / p, e

    def wire(fn):
        with comm.dry():
            return sum(op_cost.analyze(fn)["collective_bytes"].values())

    assert wire(comp) < 0.45 * wire(exact)


# ---------------------------------------------------------------------------
# (iv) phase 22a's transport and resident bytes, reckoned on meta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", range(4))
def test_mesh_training_bytes_equal_the_cards(rank):
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              n_layers=2)
    rec = dryrun.reckon(cfg, ShapeConfig("mesh_train", 2048, 4, "train"),
                        MeshLayout.of_rank(NAMES, (2, 2), rank))
    assert rec["sent_bytes_per_device"] == 932_694_520
    assert rec["received_bytes_per_device"] == 932_694_520
    assert rec["resident_bytes"] == {"weights": 157_432_832,
                                     "opt": 629_444_608}
    assert rec["links"] == {"data": "nvlink", "model": "nvlink"}
    assert rec["memory"]["temp_size_in_bytes"] > 0


# ---------------------------------------------------------------------------
# (v) remat "dots"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m"])
def test_remat_dots_equals_the_reference(arch):
    jc, tc, jp, model = model_pair(arch, "float32", seed=3)
    jc, tc = (dataclasses.replace(c, remat="dots") for c in (jc, tc))
    jb, tb = train_batch(jc, 2, 32, seed=4)
    loss, grads = ref_value_and_grad(JT.loss_fn, jp, jb, jc)
    model.requires_grad_(True).zero_grad(set_to_none=True)
    got = T.loss_fn(model, tb, tc)
    got.backward()
    assert_f32(got, loss)
    mine = port_grads(model)
    for path, g in grads.items():
        np.testing.assert_allclose(mine[path].numpy(), np.asarray(g), **F32,
                                   err_msg=str(path))


def test_remat_flops_order():
    """Recomputing nothing < recomputing all but the matmuls < all."""
    cfg = dataclasses.replace(
        configs("llama3.2-1b", "bfloat16")[1], **WIDE)
    shape = ShapeConfig("train", FLOP_S, FLOP_B, "train")
    flops = {m: dryrun.reckon(dataclasses.replace(cfg, remat=m), shape,
                              None)["flops_per_device"]
             for m in ("none", "dots", "full")}
    assert flops["none"] < flops["dots"] < flops["full"], flops
    dots = {m: dryrun.reckon(dataclasses.replace(cfg, remat=m), shape,
                             None)["dot_flops_per_device"]
            for m in ("none", "dots")}
    # "dots" recomputes the attention's batched products, not the mm's
    assert dots["dots"] > dots["none"]


# ---------------------------------------------------------------------------
# (vi) records and rows
# ---------------------------------------------------------------------------

RECORD_KEYS = {"status", "arch", "shape", "roofline", "dominant",
               "useful_flops_ratio", "params", "active_params", "mesh",
               "n_chips", "model_flops_global", "memory",
               "flops_per_device", "dot_flops_per_device",
               "bytes_per_device", "bytes_upper_per_device",
               "bytes_min_by_operator",
               "collective_bytes_per_device", "collective_counts",
               "unknown_trip_counts", "sent_bytes_per_device",
               "received_bytes_per_device"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    ok = dryrun.run_cell("llama3.2-1b", "decode_32k", False, out)
    skipped = dryrun.run_cell("llama3.2-1b", "long_500k", False, out)
    return out, ok, skipped


def test_run_cell_record(records):
    out, ok, _ = records
    assert ok["status"] == "ok", ok.get("error")
    assert RECORD_KEYS <= set(ok)
    assert set(ok["memory"]) == {"argument_size_in_bytes",
                                 "output_size_in_bytes",
                                 "temp_size_in_bytes"}
    assert ok["mesh"] == {"data": 16, "model": 16} and ok["n_chips"] == 256
    assert set(ok["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert ok["dominant"] in ok["roofline"]
    assert not any(k.startswith("hlo_") for k in ok)
    by_op = sum(ok["bytes_min_by_operator"].values())
    assert 0 < by_op <= ok["bytes_per_device"]
    cfg = get_config("llama3.2-1b")
    assert ok["model_flops_global"] == 2 * cfg.active_param_count() * 128
    assert (out / "llama3.2-1b__decode_32k__pod1.json").exists()


def test_long_context_on_full_attention_is_skipped(records):
    _, _, skipped = records
    assert skipped["status"] == "skipped"
    assert "full-attention" in skipped["reason"]
    assert "roofline" not in skipped


def test_roofline_rows_equal_the_reference(records):
    out, ok, skipped = records
    err = dict(ok, status="error", error="RuntimeError: x")
    for rec in (ok, skipped, err):
        assert TR.fmt_row(rec) == JR.fmt_row(rec)
    assert [r["shape"] for r in TR.load(out)] == ["decode_32k", "long_500k"]
