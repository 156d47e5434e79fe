"""rwkv6's and mamba2's blocks on a mesh: the port on gloo CPU ranks, a
(data, model) ``DeviceMesh``, against the reference under GSPMD on a
``jax.sharding.Mesh`` of the same shape over the emulated devices (built
directly: its ``Auto`` axes; ROADMAP §3 for ``make_mesh_shape``).

Each rank holds its slices of the weights (``params_from_jax(...,
mesh=...)``), its rows of the batch and its slice of the decode state,
split over ``model`` by the reference's rule (``cache_specs``): rwkv6's
``wkv`` on hd_k, zamba2's ``ssm`` on P, its conv window whole.  Where
``model`` divides the heads the blocks run on a rank's block of heads
with its slices of the weights, and the decode steps on the state's
slices (``models.ssm``).  On (1, 8) rwkv6's 4 heads do not divide
``model``, but its hd_k of 16 does: the forward gathers the time mix
whole, and the decode runs on the key split.  rwkv6 and zamba2 at the
smoke width, float32 within ``F32`` (``tests/torch_model_helpers.py``),
on (2, 2), (1, 4) and (1, 8):

- each rank's prefill logits against the reference's rows;
- three greedy decode steps: the tokens equal, each rank's logits
  within ``F32``, and after the last step each rank's slice of every
  recurrent state leaf within ``F32`` of the reference's shard on that
  rank's device; zamba2's conv window the same bits on every rank along
  ``model``;
- where ``model`` divides the heads, no split projection weight
  (``time.{wr,wk,wv,wg,wo}``, ``chan.{wk,wv}``,
  ``mamba.{in_proj,conv,out_proj}``) through ``gather_model``, whole or
  sliced;
- the bytes a rank's transport counts in the prefill step and in a
  decode step equal ``launch.dryrun.reckon``'s on its ``MeshLayout``.

One pool of eight ranks serves the whole module (its jobs import no JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.configs import ShapeConfig as JShape
from repro.dist.sharding import data_axes_of, make_shardings
from repro.launch import steps as JS
from repro.models import transformer as JT
from torch_dist_helpers import RankPool, mesh_ssm_job
from torch_model_helpers import F32, assert_f32, configs, npt

ARCHS = ["rwkv6-1.6b", "zamba2-2.7b"]
LAYOUTS = [(2, 2), (1, 4), (1, 8)]
B, S, CACHE, STEPS = 4, 16, 8, 3


@pytest.fixture(scope="module")
def pool():
    p = RankPool(world=8)
    yield p
    p.close()


def _ref(arch, layout):
    """(reference cfg, its mesh, the weights as numpy, placed on the mesh
    by its ``make_shardings``)."""
    jc, _ = configs(arch, "float32")
    jmesh = Mesh(np.array(jax.devices()[:layout[0] * layout[1]]).reshape(
        layout), ("data", "model"))
    params = JT.init_params(jax.random.PRNGKey(1), jc)
    placed = jax.tree.map(jax.device_put, params, make_shardings(
        jax.eval_shape(lambda: params), jc, jmesh))
    return jc, jmesh, npt(params), placed


def _prefill(jc, jmesh, placed, tokens):
    with jmesh:
        logits, _ = jax.jit(lambda p, t: JT.forward(
            p, {"tokens": t}, jc, jmesh, data_axes_of(jmesh)))(
            placed, jnp.asarray(tokens, jnp.int32))
    return np.asarray(logits)


def _decode(jc, jmesh, placed, tokens):
    """The reference's serve step jitted on the mesh, greedy from
    ``tokens``: each step's (logits, tokens), and the last state as
    numpy."""
    @jax.jit
    def step(p, st, t):
        logits, st = JT.decode_step(p, st, {"tokens": t}, jc, jmesh,
                                    data_axes_of(jmesh))
        return logits, jnp.argmax(logits[:, -1], axis=-1).astype(
            jnp.int32), st

    st = JT.init_decode_state(jc, B, CACHE, jnp.float32)
    t, want = jnp.asarray(tokens, jnp.int32), []
    with jmesh:
        for _ in range(STEPS):
            logits, nxt, st = step(placed, st, t)
            want.append((np.asarray(logits), np.asarray(nxt)))
            t = nxt[:, None]
    return want, jax.tree.map(np.asarray, st.caches)


def _projection_shapes(jc, m):
    """Every shape a split projection weight of ``jc`` has, whole or
    split on one dimension over ``m`` ranks."""
    d = jc.d_model
    if jc.family == "ssm":
        shapes = [(d, d), (d, jc.d_ff), (jc.d_ff, d)]
    else:
        di, N, H = 2 * d, jc.ssm_state, jc.ssm_heads
        shapes = [(d, 2 * di + 2 * N + H), (4, di + 2 * N), (di, d)]
    out = set()
    for shape in shapes:
        out.add(shape)
        for i, n in enumerate(shape):
            if n % m == 0:
                out.add(shape[:i] + (n // m,) + shape[i + 1:])
    return out


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_and_recurrent_states_on_a_mesh(pool, arch, layout):
    jc, jmesh, tree, placed = _ref(arch, layout)
    r = np.random.default_rng(5)
    tokens = r.integers(0, jc.vocab, size=(B, S))
    first = r.integers(0, jc.vocab, size=(B, 1))
    pool.submit(mesh_ssm_job, arch, tree, layout, {"tokens": tokens},
                {"tokens": first, "cache_len": CACHE, "steps": STEPS})
    logits = _prefill(jc, jmesh, placed, tokens)
    want, state = _decode(jc, jmesh, placed, first)
    specs = JS.cache_specs(jc, JShape("decode", CACHE, B, "decode"),
                           jmesh).caches
    results = pool.collect(mesh_ssm_job)
    n, m = layout[0] * layout[1], layout[1]
    assert results[n:] == [None] * (8 - n)
    heads = jc.n_heads if jc.family == "ssm" else jc.ssm_heads
    projections = _projection_shapes(jc, m)
    for rank, res in enumerate(results[:n]):
        (lo, hi), got, gathered, wire, reckoned = res["prefill"]
        assert got.shape == logits[lo:hi].shape
        assert_f32(got, logits[lo:hi])
        assert wire == reckoned, (rank, wire, reckoned)
        if heads % m == 0:
            assert not projections & set(gathered), gathered
        steps, states, gathered, wire, reckoned = res["decode"]
        assert len(steps) == len(want)
        for (gl, gt), (wl, wt) in zip(steps, want):
            assert gl.shape == wl[lo:hi].shape
            assert_f32(gl, wl[lo:hi])
            np.testing.assert_array_equal(gt, wt)
        assert wire == reckoned, (rank, wire, reckoned)
        if heads % m == 0:
            assert not projections & set(gathered), gathered
        device = jmesh.devices.reshape(-1)[rank]
        for field in type(specs)._fields:
            whole = getattr(state, field)
            at = getattr(specs, field).sharding.devices_indices_map(
                whole.shape)[device]
            mine = np.stack([layer[field] for layer in states])
            assert mine.shape == whole[at].shape, (field, mine.shape)
            np.testing.assert_allclose(mine, whole[at], err_msg=field,
                                       **F32)
    if jc.family == "hybrid":            # the window: whole, the same bits
        for rank in range(n):
            along = rank - rank % m
            for a, b in zip(results[rank]["decode"][1],
                            results[along]["decode"][1]):
                np.testing.assert_array_equal(a["conv"], b["conv"])
