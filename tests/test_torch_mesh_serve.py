"""Serving on a mesh: the port on eight gloo CPU ranks, a (data 2,
model 4) ``DeviceMesh``, against the reference under GSPMD on the same
(2, 4) ``jax.sharding.Mesh`` over the eight emulated devices (built
directly: its ``Auto`` axes; ROADMAP §3 for ``make_mesh_shape``).

Each rank holds its slices of the weights (``params_from_jax(...,
mesh=...)``, as ``make_shardings`` places them) and its rows of the
batch and the decode state; a block's weights are gathered whole at use
and the MoE layer runs on the whole batch.  Float32 results are held to
the reference within ``F32`` (``tests/torch_model_helpers.py``), tokens
exactly:

- greedy decode of a dense, an MoE and an SSM architecture;
- context-parallel prefill (qwen3-14b, S > block, with the query blocks
  split over ``model`` and not) and granite's prefill through the
  expert-parallel dispatch;
- ``serve(cfg, mesh)`` and ``serve --mesh 2,4`` give every rank the
  tokens of the port's one-device ``serve`` at the same seed;
- each rank's weights after ``params_from_jax`` are its shard of the
  reference's ``device_put`` arrays.

One pool of eight ranks serves the whole module (its jobs import no JAX).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.dist.sharding import data_axes_of, make_shardings
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve as SV
from repro_torch.models.transformer import Transformer
from torch_dist_helpers import (RankPool, mesh_decode_job, mesh_errors_job,
                                mesh_prefill_job, mesh_serve_job,
                                resident_job, serve_cli_job)
from torch_model_helpers import F32, assert_f32, configs, npt

STEPS = 3


@pytest.fixture(scope="module")
def pool():
    p = RankPool(world=8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))


def _ref(arch, jmesh, dtype="float32", **kw):
    """(reference cfg, its weights as numpy, the weights placed on the
    mesh by its ``make_shardings``)."""
    jc, _ = configs(arch, dtype)
    jc = dataclasses.replace(jc, **kw)
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    placed = jax.tree.map(jax.device_put, params, make_shardings(
        jax.eval_shape(lambda: params), jc, jmesh))
    return jc, npt(params), placed


def _same_on_every_rank(results):
    for r in results[1:]:
        for a, b in zip(jax.tree.leaves(r), jax.tree.leaves(results[0])):
            np.testing.assert_array_equal(a, b)
    return results[0]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "rwkv6-1.6b"])
def test_decode_on_a_mesh_equals_the_reference(pool, jmesh, arch):
    """The reference's serve step (``decode_step`` and the argmax of its
    ``make_serve_step``) jitted on the mesh, greedy from the same first
    tokens, against the port's decode on the ranks: every step's tokens
    equal, logits within F32.  At decode S = 1, so granite's MoE layer
    takes ``moe_local`` over the whole batch in both."""
    jc, tree, placed = _ref(arch, jmesh)
    B, cache_len = 4, 8
    tok = np.random.default_rng(7).integers(0, jc.vocab, size=(B, 1))
    dax = data_axes_of(jmesh)

    @jax.jit
    def step(p, st, t):
        logits, st = JT.decode_step(p, st, {"tokens": t}, jc, jmesh, dax)
        return logits, jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32), \
            st

    st = JT.init_decode_state(jc, B, cache_len, jnp.float32)
    t = jnp.asarray(tok, jnp.int32)
    want = []
    with jmesh:
        for _ in range(STEPS):
            logits, nxt, st = step(placed, st, t)
            want.append((logits, np.asarray(nxt)))
            t = nxt[:, None]
    got = _same_on_every_rank(pool.run(mesh_decode_job, arch, tree, tok,
                                       STEPS, cache_len))
    for (gl, gt), (wl, wt) in zip(got, want):
        assert gl.shape == wl.shape
        assert_f32(gl, wl)
        np.testing.assert_array_equal(gt, wt)


@pytest.mark.parametrize("arch,S,kw", [
    ("qwen3-14b", 4096, {"attn_context_parallel": True,
                         "prefill_last_only": True}),      # 4 blocks: split
    ("qwen3-14b", 2048, {"attn_context_parallel": True}),  # 2 blocks: whole
    ("granite-moe-1b-a400m", 16, {}),                      # the EP dispatch
], ids=["cp-split", "cp-whole", "granite-ep"])
def test_prefill_on_a_mesh_equals_the_reference(pool, jmesh, arch, S, kw):
    """``forward`` on the mesh: qwen3-14b with context-parallel attention
    (1024-key blocks, the batch over ``data``, the query blocks over
    ``model`` where 4 divides them), granite with S divisible by
    ``model`` (``moe_ep_shardmap``); logits and aux within F32, the
    prefill step's tokens equal."""
    jc, tree, placed = _ref(arch, jmesh, **kw)
    B = 2 if S > 1024 else 4
    tok = np.random.default_rng(3).integers(0, jc.vocab, size=(B, S))
    dax = data_axes_of(jmesh)
    fwd = jax.jit(lambda p, t: JT.forward(p, {"tokens": t}, jc, jmesh, dax,
                                          last_only=jc.prefill_last_only))
    with jmesh:
        logits, aux = fwd(placed, jnp.asarray(tok, jnp.int32))
    got = _same_on_every_rank(pool.run(mesh_prefill_job, arch, kw, tree,
                                       tok))
    assert got[0].shape == logits.shape
    assert_f32(got[0], logits)
    np.testing.assert_allclose(got[1], float(aux), **F32)
    np.testing.assert_array_equal(got[2], np.asarray(
        jnp.argmax(logits[:, -1], axis=-1)))


@pytest.mark.parametrize("arch,dtype", [("rwkv6-1.6b", "float32"),
                                        ("granite-moe-1b-a400m", "bfloat16")])
def test_serve_on_a_mesh_gives_the_tokens_of_one_device(pool, arch, dtype):
    """``serve(cfg, mesh)`` on every rank: the same tokens everywhere,
    equal to the port's one-device ``serve`` at the same seed, and each
    rank holding its slices of the weights (less than the whole)."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype)
    want, _ = SV.serve(cfg, None, batch=4, tokens=4, cache_len=16,
                       logger=lambda s: None, device="cpu")
    results = pool.run(mesh_serve_job, arch, dtype, 4, 4, 16)
    for toks, n, held in results:
        np.testing.assert_array_equal(toks, want)
        assert n == 3
    whole = sum(t.numel() * t.element_size() for t in Transformer(
        cfg, torch.device("meta")).parameters())
    assert all(held < whole for _, _, held in results)


def test_serve_cli_on_a_mesh(pool):
    """``serve --mesh 2,4 --device cpu`` on the ranks (the group is up, as
    ``torchrun`` leaves it) gives the function's tokens; ``--mesh 1,1``
    without a group gives the tokens of no mesh."""
    argv = ["--arch", "granite-moe-1b-a400m", "--smoke", "--tokens", "3",
            "--batch", "4", "--device", "cpu"]
    want, _ = SV.main(argv)
    for toks in pool.run(serve_cli_job, argv + ["--mesh", "2,4"]):
        np.testing.assert_array_equal(toks, want)
    one, _ = SV.main(argv + ["--mesh", "1,1"])
    np.testing.assert_array_equal(one, want)


@pytest.mark.parametrize("arch,dtype", [("granite-moe-1b-a400m", "bfloat16"),
                                        ("zamba2-2.7b", "float32"),
                                        ("musicgen-large", "float32")])
def test_resident_weights_are_the_reference_shards(pool, jmesh, arch, dtype):
    jc, tree, placed = _ref(arch, jmesh, dtype)
    results = pool.run(resident_job, arch, dtype, tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(placed)
    devices = jax.devices()
    for path, arr in flat:
        name = "/".join(k.key for k in path)
        shards = {s.device: np.asarray(s.data.astype(jnp.float32))
                  for s in arr.addressable_shards}
        for r, held in enumerate(results):
            np.testing.assert_array_equal(held[name], shards[devices[r]],
                                          err_msg=f"{name} on rank {r}")


def test_a_mesh_that_leaves_ranks_out_raises(pool):
    for r, out in enumerate(pool.run(mesh_errors_job)):
        assert "a mesh of 4 ranks in a process group of 8" in out["serve"]
        if r < 4:
            assert out["rows"] == slice(2 * (r // 2), 2 * (r // 2) + 2)
        else:
            assert "not in the mesh" in out["rows"]
