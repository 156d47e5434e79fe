"""Serving on a mesh: the port on eight gloo CPU ranks, a (data 2,
model 4) ``DeviceMesh``, against the reference under GSPMD on the same
(2, 4) ``jax.sharding.Mesh`` over the eight emulated devices (built
directly: its ``Auto`` axes; ROADMAP §3 for ``make_mesh_shape``).

Each rank holds its slices of the weights (``params_from_jax(...,
mesh=...)``, as ``make_shardings`` places them), its rows of the batch
and of the logits, and its slice of the decode state (its rows, and of
each KV cache its heads, else its slots, over ``model``); a block's
weights are gathered whole at use and the MoE layer runs on the whole
batch.  Float32 results are held to the reference within ``F32``
(``tests/torch_model_helpers.py``), each rank's logits against the
reference's rows of that rank, tokens exactly:

- greedy decode of a dense, an MoE and an SSM architecture;
- teacher-forced decode of each attention family's smoke variant (2 KV
  heads) with the reference's decode state placed by its
  ``cache_specs``: on the (2, 4) ``Mesh`` the caches split their length
  (mixtral's 32-slot window ring wraps), on a (4, 2) ``Mesh`` of the same
  devices their heads, and zamba2's shared caches (4 KV heads) their
  heads on (2, 4); each rank's cache is the reference's shard;
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

from repro.configs import ShapeConfig as JShape
from repro.dist.sharding import data_axes_of, make_shardings
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve as SV
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import Transformer
from torch_dist_helpers import (RankPool, mesh_decode_job, mesh_errors_job,
                                mesh_forced_decode_job, mesh_prefill_job,
                                mesh_rest_vs_whole_job, mesh_serve_job,
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
    for (lo, hi), got in pool.run(mesh_decode_job, arch, tree, tok, STEPS,
                                  cache_len):
        for (gl, gt), (wl, wt) in zip(got, want):
            assert gl.shape == wl[lo:hi].shape
            assert_f32(gl, wl[lo:hi])
            np.testing.assert_array_equal(gt, wt)


DECODE_CASES = [(arch, layout) for layout in ((2, 4), (4, 2)) for arch in (
    "llama3.2-1b", "chameleon-34b", "musicgen-large",
    "granite-moe-1b-a400m", "mixtral-8x22b")] + [("zamba2-2.7b", (2, 4))]


@pytest.mark.parametrize("arch,layout", DECODE_CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in DECODE_CASES])
def test_decode_splits_the_cache_as_the_reference(pool, arch, layout):
    """Teacher-forced decode on a ``layout`` mesh, the reference's decode
    state placed by its ``cache_specs`` (the port's made on the mesh by
    ``init_decode_state``): every step's logits of each rank's rows
    within F32, and each rank's KV cache the reference's shard of it,
    split as its rule says (the length where 2 KV heads do not divide
    ``model`` 4, the heads on ``model`` 2 and zamba2's 4 on 4).  Eight
    steps over 8 slots write every rank's block (past the end the
    reference's program on a split length leaves its own one-device
    program, which the port follows: ROADMAP §3); mixtral's window of 32
    is a ring: 36 steps wrap it, so its writes move from the last rank's
    block back to the first's."""
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(layout),
                 ("data", "model"))
    jc, tree, placed = _ref(arch, jmesh)
    B, cache_len = 4, 8
    steps = cache_len
    if jc.sliding_window:
        cache_len, steps = 64, jc.sliding_window + 4
    r = np.random.default_rng(11)
    if jc.family == "audio":
        feeds = [{"embeds": r.normal(size=(B, 1, jc.d_model)).astype(
            np.float32)} for _ in range(steps)]
    else:
        feeds = [{"tokens": r.integers(0, jc.vocab, size=(B, 1))}
                 for _ in range(steps)]
    pool.submit(mesh_forced_decode_job, arch, tree, feeds, cache_len,
                layout)
    specs = JS.cache_specs(jc, JShape("decode", cache_len, B, "decode"),
                           jmesh)
    st = jax.tree.map(lambda a, sp: jax.device_put(a, sp.sharding),
                      JT.init_decode_state(jc, B, cache_len, jnp.float32),
                      specs)
    step = jax.jit(lambda p, s, i: JT.decode_step(p, s, i, jc, jmesh,
                                                  data_axes_of(jmesh)))
    want = []
    with jmesh:
        for feed in feeds:
            logits, st = step(placed, st, {k: jnp.asarray(
                v, jnp.int32 if k == "tokens" else jnp.float32)
                for k, v in feed.items()})
            want.append(np.asarray(logits))
    kv = specs.shared_caches if jc.family == "hybrid" else specs.caches
    spec = kv.k.sharding.spec
    split = 2 if spec[3] == "model" else 1 if spec[2] == "model" else None
    assert split == (2 if layout[1] == 2 or jc.family == "hybrid" else 1)
    shard = tuple(kv.k.sharding.shard_shape(kv.k.shape)[1:])
    for (lo, hi), got, caches in pool.collect(mesh_forced_decode_job):
        assert len(caches) == kv.k.shape[0]
        assert all(c == (shard, shard, split) for c in caches), caches
        for gl, wl in zip(got, want):
            assert gl.shape == wl[lo:hi].shape
            assert_f32(gl, wl[lo:hi])


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
    tokens = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
    results = pool.run(mesh_prefill_job, arch, kw, tree, tok)
    for (lo, hi), got, got_aux, nxt in results:
        assert got.shape == logits[lo:hi].shape
        assert_f32(got, logits[lo:hi])
        assert got_aux == results[0][2]
        np.testing.assert_allclose(got_aux, float(aux), **F32)
        np.testing.assert_array_equal(nxt, tokens[lo:hi])


def _serve_with_ties(cfg, monkeypatch, batch, tokens, cache_len):
    """The port's one-device ``serve`` of ``cfg`` at seed 0: its tokens
    (steps, rows), and for each step and row the words that hold its
    largest logit (steps, rows, vocab)."""
    decode, tops = TT.decode_step, []

    def step(*a, **k):
        logits, st = decode(*a, **k)
        last = logits[:, -1].float()
        tops.append(last == last.amax(-1, keepdim=True))
        return logits, st
    monkeypatch.setattr(TT, "decode_step", step)
    want, _ = SV.serve(cfg, None, batch=batch, tokens=tokens,
                       cache_len=cache_len, logger=lambda s: None,
                       device="cpu")
    monkeypatch.setattr(TT, "decode_step", decode)
    return want.reshape(tokens, batch), torch.stack(tops).numpy()


@pytest.mark.parametrize("arch,dtype", [("rwkv6-1.6b", "float32"),
                                        ("granite-moe-1b-a400m", "bfloat16")])
def test_serve_on_a_mesh_gives_the_tokens_of_one_device(pool, arch, dtype,
                                                        monkeypatch):
    """``serve(cfg, mesh)`` on every rank: the same tokens everywhere,
    equal to the port's one-device ``serve`` at the same seed, and each
    rank holding its slices of the weights (less than the whole).  The
    mesh sums partial products over ``model`` in another order than one
    device's matmuls, so where one device's largest logits tie exactly
    (bf16: granite's fourth step gives its second row two words at
    0.380859375) the mesh may take either: there it must take one of the
    tied words, and that row's later tokens follow from its choice."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype)
    want, tops = _serve_with_ties(cfg, monkeypatch, 4, 4, 16)
    ties = tops.sum(-1) > 1
    results = pool.run(mesh_serve_job, arch, dtype, 4, 4, 16)
    for toks, n, held in results:
        np.testing.assert_array_equal(toks, results[0][0])
        got = toks.reshape(want.shape)
        for row in range(want.shape[1]):
            for t in range(want.shape[0]):
                assert tops[t, row, got[t, row]], (t, row)
                if ties[t, row]:
                    break
                assert got[t, row] == want[t, row], (t, row)
        assert n == 3
    assert dtype == "bfloat16" or not ties.any()
    whole = sum(t.numel() * t.element_size() for t in Transformer(
        cfg, torch.device("meta")).parameters())
    assert all(held < whole for _, _, held in results)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "chameleon-34b",
                                  "musicgen-large"])
def test_weights_at_rest_and_whole_give_the_same_bits(pool, jmesh, arch):
    """The same mesh gives the same bits whether the weights are sharded
    at rest or whole (cut to the same slices at use): ``forward``'s
    logits, the loss and two decode steps, on every rank; and the logits
    within F32 of the reference's on the mesh.  llama3.2-1b's tied
    embedding is re-cut to a slice of the vocabulary by an all-to-all at
    rest and sliced from the whole otherwise; chameleon-34b has an untied
    head and qk-norm; musicgen-large's smoke heads split their
    vocabulary."""
    jc, tree, placed = _ref(arch, jmesh)
    r = np.random.default_rng(9)
    if jc.family == "audio":
        feed = {"embeds": r.normal(size=(4, 8, jc.d_model)).astype(
            np.float32), "labels": r.integers(0, jc.vocab, size=(
                4, 8, jc.n_codebooks))}
    else:
        feed = {"tokens": r.integers(0, jc.vocab, size=(4, 8))}
    key = "embeds" if "embeds" in feed else "tokens"
    with jmesh:
        logits, _ = jax.jit(lambda p, x: JT.forward(
            p, {key: x}, jc, jmesh, data_axes_of(jmesh)))(
            placed, jnp.asarray(feed[key], jnp.int32 if key == "tokens"
                                else jnp.float32))
    logits = np.asarray(logits)
    for (lo, hi), rest, whole in pool.run(mesh_rest_vs_whole_job, arch,
                                          tree, feed):
        assert len(rest) == len(whole) == 4
        for a, b in zip(rest, whole):
            np.testing.assert_array_equal(a, b)
        assert_f32(rest[0], logits[lo:hi])


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
