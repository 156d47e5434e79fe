"""Training on a mesh: the port on eight gloo CPU ranks, a (data 2,
model 4) ``DeviceMesh``, against the reference under GSPMD on the same
(2, 4) ``jax.sharding.Mesh`` over the eight emulated devices (built
directly: its ``Auto`` axes; ROADMAP §3 for ``make_mesh_shape``).
Everything is float32 at smoke size and within ``F32``
(``tests/torch_model_helpers.py``); checkpoints bit for bit.

- Each rank's logits are those of its rows only (the data axes, and
  ``model`` under ``ddp``), equal to the reference's rows, and the loss
  is the global one, the same bits on every rank.
- The loss and every gradient leaf, put together whole from the ranks'
  slices, against the reference's ``value_and_grad(loss_fn)`` on the
  mesh: dense, the expert-parallel MoE dispatch (granite, recomputed
  under remat ``full``; mixtral, Adafactor's model), zamba2's mamba2
  blocks on a rank's heads and its shared block, rwkv6's time and
  channel mixes on a rank's heads, ``ddp``,
  context-parallel attention at S > block, and granite with
  ``moe_tp_fused`` at a sequence ``model`` does not divide (so the layer
  takes the tensor-parallel layout, not the expert-parallel one).  On a
  mesh the MoE layer drops other items than on one device, as the
  reference's does, so it is held to the reference on the same mesh.
- One ``make_train_step`` (granite with AdamW, mixtral with Adafactor):
  each rank's slices of the weights and of the optimizer state against
  the slices of the reference's new state that its ``make_shardings``
  places on that device, and ``loss``/``lr``/``grad_norm``, the same on
  every rank.
- ``train(cfg, mesh)`` through a crash at step 3 and a restart from the
  step-2 checkpoint against the reference's ``train(cfg, Mesh(...))``.
- Checkpoints across the packages: the reference's mesh checkpoint
  restored by ``rescale_state`` onto the ranks' (2, 4) and (4, 2)
  meshes, each rank's slices those the reference's ``make_shardings``
  gives its device; the port's mesh checkpoint restored by the
  reference's ``rescale_state`` onto ``Mesh`` (4, 2), equal to the
  ranks' state put together whole.
- ``train --mesh 2,4 --device cpu`` gives the function's losses, and a
  mesh that is not the group's size raises ``ValueError``.

One pool of eight ranks serves the whole module (its jobs import no JAX).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.data.pipeline import TokenPipeline as JPipeline
from repro.dist.sharding import data_axes_of, make_shardings
from repro.launch import steps as JS
from repro.launch import train as JTR
from repro.models import transformer as JT
from repro.runtime import CheckpointManager as JCheckpointManager
from repro.runtime import elastic as JE
from repro.models.layers import cross_entropy as jcross_entropy
from torch_dist_helpers import (RankPool, mesh_ce_job, mesh_grad_job,
                                mesh_loss_job, mesh_restore_job,
                                mesh_step_job, mesh_train_errors_job,
                                mesh_train_job, train_cli_job)
from torch_model_helpers import F32, configs, npt
from torch_train_helpers import by_path


@pytest.fixture(scope="module")
def pool():
    p = RankPool(world=8)
    yield p
    p.close()


def _mesh(shape=(2, 4)):
    return Mesh(np.array(jax.devices()[:8]).reshape(shape),
                ("data", "model"))


def _placed(tree, jc, jmesh):
    return jax.tree.map(jax.device_put, tree, make_shardings(
        jax.eval_shape(lambda: tree), jc, jmesh))


def _batch(jc, B, S, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, jc.vocab, size=(B, S)).astype(np.int32),
            "labels": r.integers(0, jc.vocab, size=(B, S)).astype(np.int32)}


def _slices_of(arr, sharding, device):
    """The slice of the whole ``arr`` that ``sharding`` places on
    ``device``."""
    return np.asarray(arr)[sharding.devices_indices_map(
        np.shape(arr))[device]]


def _same_on_every_rank(values):
    for v in values[1:]:
        assert v == values[0]
    return values[0]


@pytest.mark.parametrize("arch,kw,B,rows", [
    ("llama3.2-1b", {}, 4, 2),
    ("granite-moe-1b-a400m", {}, 4, 2),
    ("llama3.2-1b", {"ddp": True}, 8, 1),
], ids=["dense", "moe", "ddp"])
def test_logits_on_a_rank_rows_and_one_global_loss(pool, arch, kw, B, rows):
    """``forward`` on the mesh returns the logits of the rank's ``rows``
    rows only (B / 2 over ``data``; under ``ddp`` B / 8 over ``data`` and
    ``model``), the reference's rows within F32, and ``loss_fn`` the
    reference's global loss (granite's with its MoE aux) within F32, the
    same float32 bits on every rank."""
    jc, _ = configs(arch, "float32")
    jc = dataclasses.replace(jc, **kw)
    jmesh = _mesh()
    params = JT.init_params(jax.random.PRNGKey(1), jc)
    batch = _batch(jc, B, 16)
    pool.submit(mesh_loss_job, arch, kw, npt(params), batch)
    dax = data_axes_of(jmesh)
    placed = _placed(params, jc, jmesh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jmesh:
        logits = jax.jit(lambda p, b: JT.forward(p, b, jc, jmesh, dax)[0])(
            placed, jb)
        loss = jax.jit(lambda p, b: JT.loss_fn(p, b, jc, jmesh, dax))(
            placed, jb)
    results = pool.collect(mesh_loss_job)
    logits = np.asarray(logits)
    assert len({r[0] for r in results}) == B // rows
    for (lo, hi), got, got_loss, bits in results:
        assert hi - lo == rows and got.shape == logits[lo:hi].shape
        np.testing.assert_allclose(got, logits[lo:hi], **F32)
        assert bits == results[0][3]
        np.testing.assert_allclose(got_loss, float(loss), **F32)


@pytest.mark.parametrize("V", [256, 250], ids=["vocab-split",
                                             "vocab-whole"])
def test_vocab_parallel_loss_equals_the_reference(pool, V):
    """The loss over a rank's slice of the vocabulary (``model`` 4 divides
    256: its largest logit and sum of exponentials over ``model``, each
    label's logit from its owner) and over the whole vocabulary where
    ``model`` does not divide it (250), each rank its rows over
    ``data``: the global mean, z-loss included, the same bits on every
    rank, within F32 of the reference's ``cross_entropy``; and the
    gradient of each rank's logits the reference's there (whole rows:
    each rank along ``model`` holds a quarter of it)."""
    r = np.random.default_rng(5)
    logits = (4 * r.normal(size=(4, 8, V))).astype(np.float32)
    labels = r.integers(0, V, size=(4, 8))
    loss, grad = jax.value_and_grad(lambda x: jcross_entropy(
        x, jnp.asarray(labels, jnp.int32)))(jnp.asarray(logits))
    grad = np.asarray(grad)
    results = pool.run(mesh_ce_job, logits, labels, V % 4 == 0)
    share = 1 if V % 4 == 0 else 4
    assert len({r[1] for r in results}) == (4 if V % 4 == 0 else 1)
    for (lo, hi), (a, b), got, bits, g in results:
        assert bits == results[0][3]
        np.testing.assert_allclose(got, float(loss), **F32)
        np.testing.assert_allclose(share * g, grad[lo:hi, :, a:b], **F32)


@pytest.mark.parametrize("arch,kw,B,S", [
    ("llama3.2-1b", {}, 4, 16),
    ("granite-moe-1b-a400m", {"remat": "full"}, 4, 16),
    ("mixtral-8x22b", {}, 4, 16),
    ("zamba2-2.7b", {}, 4, 16),
    ("rwkv6-1.6b", {}, 4, 16),
    ("llama3.2-1b", {"ddp": True}, 8, 16),
    ("qwen3-14b", {"attn_context_parallel": True}, 2, 4096),
    ("granite-moe-1b-a400m", {"moe_tp_fused": True, "remat": "full"}, 4, 18),
], ids=["dense", "moe-ep-remat", "adafactor-model", "hybrid", "ssm", "ddp",
        "cp", "moe-tp-remat"])
def test_gradients_on_a_mesh_equal_the_reference(pool, arch, kw, B, S):
    jc, _ = configs(arch, "float32")
    jc = dataclasses.replace(jc, **kw)
    jmesh = _mesh()
    params = JT.init_params(jax.random.PRNGKey(1), jc)
    batch = _batch(jc, B, S)
    pool.submit(mesh_grad_job, arch, kw, npt(params), batch)
    dax = data_axes_of(jmesh)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, b, jc, jmesh, dax)))
    with jmesh:
        loss, grads = fn(_placed(params, jc, jmesh),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    results = pool.collect(mesh_grad_job)
    got_loss = _same_on_every_rank([r[0] for r in results])
    np.testing.assert_allclose(got_loss, float(loss), **F32)
    want = {"/".join(k): np.asarray(v) for k, v in by_path(grads).items()}
    for r in results:
        assert sorted(r[1]) == sorted(want)
        for name, g in r[1].items():
            assert g.shape == want[name].shape
            np.testing.assert_allclose(g, want[name], err_msg=name, **F32)


def _ref_state(jc, jmesh, seed=0, **kw):
    step_fn, opt_init = JS.make_train_step(jc, jmesh, **kw)
    params = JT.init_params(jax.random.PRNGKey(seed), jc)
    state = JS.TrainState(params, opt_init(params), jnp.zeros((), jnp.int32))
    return state, step_fn


@pytest.mark.parametrize("arch,seed,step_kw", [
    ("granite-moe-1b-a400m", 0, {}),
    ("mixtral-8x22b", 2, {"warmup": 1, "peak_lr": 1e-3}),
], ids=["adamw", "adafactor"])
def test_train_step_slices_equal_the_reference(pool, tmp_path, arch, seed,
                                               step_kw):
    """One step from the same state: every rank's slices of the new
    weights and optimizer state where the reference's ``make_shardings``
    of its state places them on that rank's device; the metrics on every
    rank.  The Adafactor case also saves the new state from the mesh,
    and the reference's ``rescale_state`` restores it onto ``Mesh`` (4, 2)
    equal bit for bit to the ranks' state put together whole."""
    jc, _ = configs(arch, "float32")
    jmesh = _mesh()
    jstate, step_fn = _ref_state(jc, jmesh, seed, **step_kw)
    batch = JPipeline(jc.vocab, 4, 16).batch_at(0)
    ckpt = tmp_path / "port" if arch == "mixtral-8x22b" else None
    pool.submit(mesh_step_job, arch, npt(jstate), batch, step_kw,
                None if ckpt is None else str(ckpt))
    placed = _placed(jstate, jc, jmesh)
    with jmesh:
        new, metrics = jax.jit(step_fn)(placed, batch)
    results = pool.collect(mesh_step_job)
    shardings = jax.tree.leaves(make_shardings(jax.eval_shape(
        lambda: new), jc, jmesh))
    ref = jax.tree.leaves(new)
    devices = jax.devices()
    for r, out in enumerate(results):
        for k in ("loss", "lr", "grad_norm"):
            assert out["kinds"][k] == ((), "torch.float32")
            np.testing.assert_allclose(out["metrics"][k],
                                       float(metrics[k]), **F32)
            assert out["metrics"][k] == results[0]["metrics"][k]
        assert len(out["slices"]) == len(ref)
        for i, (mine, leaf, sh) in enumerate(zip(out["slices"], ref,
                                                 shardings)):
            want = _slices_of(leaf, sh, devices[r])
            assert np.shape(mine) == want.shape, (i, r)
            np.testing.assert_allclose(mine, want.astype(np.float32),
                                       err_msg=f"leaf {i} rank {r}", **F32)
    if ckpt is None:
        return
    assert all(out["latest"] == 1 for out in results)
    whole = results[0]["whole"]
    for out in results[1:]:
        for a, b in zip(out["whole"], whole):
            np.testing.assert_array_equal(a, b)
    restored = JE.rescale_state(None, jstate, jc, _mesh((4, 2)),
                                JCheckpointManager(ckpt))
    for a, b in zip(jax.tree.leaves(restored), whole):
        assert np.asarray(a).shape == np.shape(b)
        np.testing.assert_array_equal(np.asarray(a), b)


def test_train_through_a_crash_equals_the_reference(pool, tmp_path):
    """granite's smoke config trained on the mesh for 4 steps, a
    checkpoint every 2, a crash injected at step 3: the port on the ranks
    and the reference's ``train`` on the (2, 4) ``Mesh`` from the same
    weights, step by step, through the restart from step 2."""
    jc, _ = configs("granite-moe-1b-a400m", "float32")
    kw = dict(steps=4, batch=4, seq=16, ckpt_every=2, crash_at=3)
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    pool.submit(mesh_train_job, "granite-moe-1b-a400m", npt(params), kw,
                str(tmp_path / "port"))
    lines = []
    _, want = JTR.train(jc, _mesh(), ckpt_dir=tmp_path / "ref",
                        log_every=1, logger=lines.append, **kw)
    ref_losses = [float(ln.split()[4]) for ln in lines
                  if ln.startswith("[train] step")]
    results = pool.collect(mesh_train_job)
    for losses, log, _ in results:
        assert losses == results[0][0]
        assert "[train] restored step 2" in log
        got = [float(ln.split()[4]) for ln in log
               if ln.startswith("[train] step")]
        assert [int(ln.split()[2]) for ln in log
                if ln.startswith("[train] step")] == [0, 1, 2, 2, 3]
        np.testing.assert_allclose(got, ref_losses, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(results[0][0], want, **F32)
    assert results[0][2] == ["step_000000002", "step_000000004"]


@pytest.mark.parametrize("layout", [(2, 4), (4, 2)])
def test_reference_checkpoint_restores_onto_the_ranks(pool, tmp_path,
                                                      layout):
    """A checkpoint the reference saves from a state placed on the (2, 4)
    ``Mesh`` (after one step), restored by the port's ``rescale_state``
    onto the ranks' ``layout`` mesh: each rank's slices are, bit for bit,
    those the reference's ``make_shardings`` places on its device of a
    ``Mesh`` of that layout."""
    jc, _ = configs("granite-moe-1b-a400m", "float32")
    jmesh = _mesh()
    jstate, step_fn = _ref_state(jc, jmesh)
    with jmesh:
        new, _ = jax.jit(step_fn)(_placed(jstate, jc, jmesh),
                                  JPipeline(jc.vocab, 4, 16).batch_at(0))
    JCheckpointManager(tmp_path).save(1, new)
    results = pool.run(mesh_restore_job, "granite-moe-1b-a400m",
                       str(tmp_path), layout)
    target = _mesh(layout)
    shardings = jax.tree.leaves(make_shardings(jax.eval_shape(
        lambda: new), jc, target))
    ref = [np.asarray(a) for a in jax.tree.leaves(new)]
    devices = jax.devices()
    for r, slices in enumerate(results):
        assert len(slices) == len(ref)
        for i, (mine, leaf, sh) in enumerate(zip(slices, ref, shardings)):
            want = _slices_of(leaf, sh, devices[r])
            assert np.shape(mine) == want.shape
            np.testing.assert_array_equal(mine, want,
                                          err_msg=f"leaf {i} rank {r}")


def test_train_cli_and_wrong_meshes(pool):
    """``train --mesh 2,4 --device cpu`` on the ranks (the group is up,
    as ``torchrun`` leaves it) gives the losses of ``train`` with the
    same arguments on every rank; a mesh that is not the group's size
    raises ``ValueError`` in ``train`` and in the CLI."""
    argv = ["--arch", "granite-moe-1b-a400m", "--smoke", "--steps", "2",
            "--batch", "4", "--seq", "16", "--mesh", "2,4", "--device",
            "cpu"]
    results = pool.run(train_cli_job, argv, "granite-moe-1b-a400m",
                       dict(steps=2, batch=4, seq=16))
    for cli, fn in results:
        assert len(cli) == 2 and np.isfinite(cli).all()
        assert cli == fn == results[0][0]
    for out in pool.run(mesh_train_errors_job):
        assert "a mesh of 4 ranks in a process group of 8" in out["train"]
        assert "a mesh of 4 ranks in a process group of 8" in out["cli"]
