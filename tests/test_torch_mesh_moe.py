"""The MoE layer on a mesh: the port on gloo CPU ranks, a (data, model)
``DeviceMesh``, against the reference under GSPMD on a
``jax.sharding.Mesh`` of the same shape over the emulated devices (built
directly: its ``Auto`` axes; ROADMAP §3 for ``make_mesh_shape``).

Each rank holds its slices of the weights (``params_from_jax(...,
mesh=...)``) and its rows of the batch; the MoE layer takes the rank's
rows and returns them, with the experts where each layout of the
reference holds them: the expert-parallel dispatch (``model`` divides
the experts and the sequence) the rank's ``E / model`` experts, re-cut
from where ``make_shardings`` puts them; ``moe_tp_fused`` their slices
of the hidden width; ``moe_local`` (decode, or ``model`` not dividing
the experts) multiplies the slices in place.  Every case runs at the
smoke width (d 64, f 128: the rule splits the experts on f) and at a
width with d > f (d 128, f 64: on d, as at granite's published width).
Float32 within ``F32`` (``tests/torch_model_helpers.py``): each rank's
logits against the reference's rows, loss, aux and every gradient leaf
put together whole; the aux of ``moe_local`` sums the rank's router
means over the data axes in rank order, where the reference's takes
one mean over the batch, so it is held within ``F32`` too, not bit for
bit.  On every rank a step gathers no expert weight whole or sliced
(``gather_model`` takes the norms, the router and the tied embedding),
and the bytes its transport counts equal ``launch.dryrun.reckon``'s on
its ``MeshLayout``.

A ``ddp`` decode on a (2, 2) mesh (the KV caches split on their heads,
the weights whole) gives each rank's rows of the reference's serve step
and ``serve`` runs on it (ROADMAP §3, fault 5).

One pool of eight ranks serves the whole module (its jobs import no JAX).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.dist.sharding import data_axes_of, make_shardings
from repro.models import transformer as JT
from torch_dist_helpers import RankPool, mesh_moe_job
from torch_model_helpers import F32, assert_f32, configs, npt
from torch_train_helpers import by_path

ARCH = "granite-moe-1b-a400m"
# the rule's split of the experts (L, E, d, f) / (L, E, f, d) over model
WIDTHS = {"f-split": {}, "d-split": {"d_model": 128, "d_ff": 64}}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(world=8)
    yield p
    p.close()


@functools.lru_cache(maxsize=None)
def _weights(jc):
    """The reference's weights of ``jc`` (drawn once for the cases that
    share them) and as numpy."""
    params = JT.init_params(jax.random.PRNGKey(1), jc)
    return params, npt(params)


def _ref(arch, layout, kw):
    """(reference cfg, its mesh, the weights as numpy, placed on the mesh
    by its ``make_shardings``)."""
    jc, _ = configs(arch, "float32")
    jc = dataclasses.replace(jc, **kw)
    jmesh = Mesh(np.array(jax.devices()[:layout[0] * layout[1]]).reshape(
        layout), ("data", "model"))
    params, tree = _weights(dataclasses.replace(
        jc, remat="none", moe_tp_fused=False))
    placed = jax.tree.map(jax.device_put, params, make_shardings(
        jax.eval_shape(lambda: params), jc, jmesh))
    return jc, jmesh, tree, placed


def _batch(jc, B, S, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, jc.vocab, size=(B, S)).astype(np.int32),
            "labels": r.integers(0, jc.vocab, size=(B, S)).astype(np.int32)}


def _expert_shapes(jc, m):
    """Every shape an expert weight has whole or split on one dimension
    over ``m`` ranks."""
    out = set()
    for shape in ((jc.n_experts, jc.d_model, jc.d_ff),
                  (jc.n_experts, jc.d_ff, jc.d_model)):
        out.add(shape)
        for i, n in enumerate(shape):
            if n % m == 0:
                out.add(shape[:i] + (n // m,) + shape[i + 1:])
    return out


def _prefill(jc, jmesh, placed, tokens):
    with jmesh:
        logits, aux = jax.jit(lambda p, t: JT.forward(
            p, {"tokens": t}, jc, jmesh, data_axes_of(jmesh)))(
            placed, jnp.asarray(tokens))
    return np.asarray(logits), float(aux)


def _grads(jc, jmesh, placed, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(
        p, b, jc, jmesh, data_axes_of(jmesh))))
    with jmesh:
        loss, grads = fn(placed, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    return float(loss), {"/".join(k): np.asarray(v)
                         for k, v in by_path(grads).items()}


def _decode(jc, jmesh, placed, tokens, cache_len, steps):
    """The reference's serve step (``decode_step`` and the argmax) jitted
    on the mesh, greedy from ``tokens``: each step's logits and tokens."""
    @jax.jit
    def step(p, st, t):
        logits, st = JT.decode_step(p, st, {"tokens": t}, jc, jmesh,
                                    data_axes_of(jmesh))
        return logits, jnp.argmax(logits[:, -1], axis=-1).astype(
            jnp.int32), st

    st = JT.init_decode_state(jc, tokens.shape[0], cache_len, jnp.float32)
    t, want = jnp.asarray(tokens, jnp.int32), []
    with jmesh:
        for _ in range(steps):
            logits, nxt, st = step(placed, st, t)
            want.append((np.asarray(logits), np.asarray(nxt)))
            t = nxt[:, None]
    return want


def _check_prefill(got, want):
    logits, aux = want
    for (lo, hi), gl, ga in got:
        assert gl.shape == logits[lo:hi].shape
        assert_f32(gl, logits[lo:hi])
        assert ga == got[0][2]
        np.testing.assert_allclose(ga, aux, **F32)


def _check_train(got, want, experts):
    """The loss the same on every rank and every gradient leaf within
    F32 of the reference's; no expert weight through ``gather_model``;
    the step's bytes the dry-run's."""
    loss, grads = want
    for g_loss, g_grads, gathered, wire, reckoned in got:
        assert g_loss == got[0][0]
        np.testing.assert_allclose(g_loss, loss, **F32)
        assert sorted(g_grads) == sorted(grads)
        for name, g in g_grads.items():
            assert g.shape == grads[name].shape
            np.testing.assert_allclose(g, grads[name], err_msg=name, **F32)
        assert not experts & set(gathered), experts & set(gathered)
        assert wire == reckoned


def _check_decode(got, want):
    for (lo, hi), steps, wire, reckoned in got:
        assert len(steps) == len(want)
        for (gl, gt), (wl, wt) in zip(steps, want):
            assert gl.shape == wl[lo:hi].shape
            assert_f32(gl, wl[lo:hi])
            np.testing.assert_array_equal(gt, wt)
        assert wire == reckoned


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_expert_parallel_prefill_and_training(pool, width):
    """(2, 4), S = 16 and 4 experts: the dispatch on each rank's rows and
    its expert; prefill's logits and aux, and the loss and gradients
    under remat ``"full"`` (each block's re-cut of the experts runs
    again in its recompute)."""
    kw = dict(WIDTHS[width], remat="full")
    jc, jmesh, tree, placed = _ref(ARCH, (2, 4), kw)
    batch = _batch(jc, 4, 16)
    pool.submit(mesh_moe_job, ARCH, kw, tree, (2, 4),
                [("prefill", batch), ("train", batch)])
    want = _prefill(jc, jmesh, placed, batch["tokens"]), \
        _grads(jc, jmesh, placed, batch)
    results = pool.collect(mesh_moe_job)
    _check_prefill([r[0] for r in results], want[0])
    _check_train([r[1] for r in results], want[1], _expert_shapes(jc, 4))


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_local_layout_in_decode(pool, width):
    """Greedy decode (S = 1: ``moe_local``) on (2, 4): every step's
    logits of each rank's rows and the tokens, and the first step's
    bytes the dry-run's."""
    jc, jmesh, tree, placed = _ref(ARCH, (2, 4), WIDTHS[width])
    tok = np.random.default_rng(7).integers(0, jc.vocab, size=(4, 1))
    feed = {"tokens": tok, "cache_len": 8, "steps": 3}
    pool.submit(mesh_moe_job, ARCH, WIDTHS[width], tree, (2, 4),
                [("decode", feed)])
    want = _decode(jc, jmesh, placed, tok, 8, 3)
    _check_decode([r[0] for r in pool.collect(mesh_moe_job)], want)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_local_layout_where_model_does_not_divide_the_experts(pool, width):
    """6 experts on (2, 4): ``moe_local`` in training at S = 16, the aux
    loss over the whole batch from each rank's rows (its router means
    summed over ``data``, the sum's backward an all-reduce)."""
    kw = dict(WIDTHS[width], n_experts=6)
    jc, jmesh, tree, placed = _ref(ARCH, (2, 4), kw)
    batch = _batch(jc, 4, 16, seed=2)
    pool.submit(mesh_moe_job, ARCH, kw, tree, (2, 4), [("train", batch)])
    want = _grads(jc, jmesh, placed, batch)
    _check_train([r[0] for r in pool.collect(mesh_moe_job)], want,
                 _expert_shapes(jc, 4))


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_tensor_parallel_layout(pool, width):
    """``moe_tp_fused`` at S = 18, which ``model`` 4 does not divide (so
    the layer takes the tensor-parallel layout): the loss and gradients
    under remat ``"full"``, the experts' slices of the hidden width taken
    where the rule puts them (re-cut from d at the d-split width)."""
    kw = dict(WIDTHS[width], moe_tp_fused=True, remat="full")
    jc, jmesh, tree, placed = _ref(ARCH, (2, 4), kw)
    batch = _batch(jc, 4, 18, seed=3)
    pool.submit(mesh_moe_job, ARCH, kw, tree, (2, 4), [("train", batch)])
    want = _grads(jc, jmesh, placed, batch)
    _check_train([r[0] for r in pool.collect(mesh_moe_job)], want,
                 _expert_shapes(jc, 4))


@pytest.mark.parametrize("arch", ["llama3.2-1b", ARCH])
def test_ddp_decode_on_a_mesh(pool, arch):
    """``ddp`` on (2, 2) of four of the ranks, batch 4, 2 tokens, 16
    slots: each rank attends with its KV heads, gathers the heads'
    outputs over ``model`` and multiplies the whole ``wo``; its logits
    are the reference's rows, the tokens equal, and ``serve``'s step in
    bfloat16 gives every rank the same tokens."""
    jc, jmesh, tree, placed = _ref(arch, (2, 2), {"ddp": True})
    tok = np.random.default_rng(5).integers(0, jc.vocab, size=(4, 1))
    feed = {"tokens": tok, "cache_len": 16, "steps": 2}
    pool.submit(mesh_moe_job, arch, {"ddp": True}, tree, (2, 2),
                [("decode", feed), ("serve", feed)])
    want = _decode(jc, jmesh, placed, tok, 16, 2)
    results = pool.collect(mesh_moe_job)
    assert results[4:] == [None] * 4
    _check_decode([r[0] for r in results[:4]], want)
    for r in results[:4]:
        assert r[1].shape == (2, 4)
        np.testing.assert_array_equal(r[1], results[0][1])
