"""The port's checkpoints and elastic rescale (``repro_torch.runtime``) on
the CPU: the reference's four checkpoint tests (round trip, async saves
and garbage collection, atomicity, corruption); checkpoints across the
two packages in both directions (the reference's ``TrainState`` leaves,
block leaves stacked as (L, …), bf16 as its 16-bit pattern); ``plan_
rescale`` against the reference's over a grid; and ``rescale_state``
onto one device (onto a mesh: ``test_torch_mesh_train.py``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.runtime import CheckpointManager as JCheckpointManager
from repro.runtime import elastic as JE
from repro_torch.configs import get_config
from repro_torch.launch import steps as S
from repro_torch.launch import train as TR
from repro_torch.models.convert import train_state_leaves
from repro_torch.runtime import (CheckpointManager, RescalePlan,
                                 plan_rescale, rescale_state)
from torch_model_helpers import F32, configs


def _state(v=0.0):
    return {"w": torch.full((8, 4), v, dtype=torch.float32),
            "step": 3,
            "nested": {"b": torch.arange(5, dtype=torch.float32) + v}}


# --- the reference's checkpoint tests ----------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    s = _state(1.5)
    mgr.save(7, s)
    out = mgr.restore(_state())
    assert float(out["w"][0, 0]) == 1.5 and int(out["step"]) == 3
    assert torch.equal(out["nested"]["b"], s["nested"]["b"])
    assert mgr.latest_step() == 7


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for k in range(5):
        mgr.save_async(k, _state(float(k)))
    mgr.wait()
    mgr.save(99, _state(9.0))
    steps = mgr.all_steps()
    assert 99 in steps and len(steps) <= 2
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_checkpoint_atomicity(tmp_path):
    """A dir without _COMMITTED must be ignored (crash during save)."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state(1.0))
    broken = tmp_path / "step_000000099"
    broken.mkdir()
    (broken / "manifest.json").write_text("{}")
    assert mgr.latest_step() == 1


def test_checkpoint_corruption_detected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    s = _state(2.0)
    mgr.save(1, s)
    leaf = next((tmp_path / "step_000000001").glob("leaf_0.npy"))
    arr = np.load(leaf)
    arr.flat[0] += 1
    np.save(leaf, arr)
    with pytest.raises(IOError):
        mgr.restore(_state())


def test_checkpoint_layout_is_the_references(tmp_path):
    """The same dict state written by both packages: the same leaf order,
    shapes, dtypes, bytes and crcs."""
    CheckpointManager(tmp_path / "port").save(4, _state(0.5))
    JCheckpointManager(tmp_path / "ref").save(4, {
        "w": jnp.full((8, 4), 0.5, jnp.float32),
        "step": jnp.asarray(3, jnp.int32),
        "nested": {"b": jnp.arange(5, dtype=jnp.float32) + 0.5}})
    mp, mr = (json.loads((tmp_path / d / "step_000000004" / "manifest.json")
                         .read_text()) for d in ("port", "ref"))
    assert mp["step"] == mr["step"] == 4
    assert mp["leaves"] == mr["leaves"]


# --- training states across the two packages ---------------------------------


def _ref_state(jc, seed=0, steps=1):
    """The reference's state after ``steps`` steps (moments non-zero)."""
    step_fn, opt_init = JS.make_train_step(jc, None, warmup=1)
    params = JT.init_params(jax.random.PRNGKey(seed), jc)
    state = JS.TrainState(params, opt_init(params), jnp.zeros((), jnp.int32))
    run = jax.jit(step_fn)
    from repro.data.pipeline import TokenPipeline
    pipe = TokenPipeline(jc.vocab, 2, 16)
    for i in range(steps):
        state, _ = run(state, pipe.batch_at(i))
    return state, run, pipe


def _port_state(tc):
    state, step, _ = TR.build_everything(tc, None, 2, 16, seed=9,
                                         device="cpu")
    return state, step


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m"])
def test_reference_checkpoint_restored_and_stepped_by_the_port(tmp_path,
                                                                arch):
    jc, tc = configs(arch, "float32")
    jstate, run, pipe = _ref_state(jc)
    JCheckpointManager(tmp_path).save(1, jstate)
    state, _ = _port_state(tc)
    state = CheckpointManager(tmp_path).restore(state)
    assert state.step == state.opt.step == 1
    for a, b in zip(train_state_leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    step, _ = S.make_train_step(tc, None, warmup=1)
    state, got = step(state, pipe.batch_at(1))
    jstate, want = run(jstate, pipe.batch_at(1))
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **F32)
    for a, b in zip(train_state_leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **F32)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b",
                                  "mixtral-8x22b"])
def test_port_checkpoint_restored_by_the_reference(tmp_path, arch):
    """bf16 weights, float32 moments (AdamW, or Adafactor's stacked
    statistics), int32 steps: equal arrays after the reference's
    restore."""
    jc, tc = configs(arch, "bfloat16")
    state, step = _port_state(tc)
    from repro_torch.data.pipeline import TokenPipeline
    state, _ = step(state, TokenPipeline(tc.vocab, 2, 16).batch_at(0))
    CheckpointManager(tmp_path).save(1, state)
    like = jax.eval_shape(lambda: _ref_state(jc, steps=0)[0])
    restored = JCheckpointManager(tmp_path).restore(like)
    mine = train_state_leaves(state)
    ref = jax.tree.leaves(restored)
    assert len(mine) == len(ref)
    for a, b, shape in zip(mine, ref, jax.tree.leaves(like)):
        assert b.dtype == shape.dtype and b.shape == shape.shape
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert int(restored.step) == int(restored.opt.step) == 1


def test_bf16_reference_checkpoint_restores_bit_for_bit(tmp_path):
    jc, tc = configs("granite-moe-1b-a400m", "bfloat16")
    jstate = _ref_state(jc)[0]
    JCheckpointManager(tmp_path).save(1, jstate)
    state = CheckpointManager(tmp_path).restore(_port_state(tc)[0])
    assert state.params.embed.dtype == torch.bfloat16
    for a, b in zip(train_state_leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# --- elastic rescale ---------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_plan_rescale_matches_the_reference(arch):
    """Over old meshes, chip counts and global batches, padded
    accumulation included (a data extent that divides no batch)."""
    jc, tc = jget(arch), get_config(arch)
    seen_pad = False
    for old in ({"data": 16, "model": 16}, {"data": 4, "model": 2},
                {"pod": 2, "data": 8, "model": 16}, {"data": 1}):
        for chips in (1, 3, 6, 24, 96, 256, 512, 768):
            for batch in (1, 7, 256, 1000):
                want = JE.plan_rescale(old, chips, jc, batch)
                got = plan_rescale(old, chips, tc, batch)
                assert isinstance(got, RescalePlan)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.n_chips == want.n_chips == chips
                seen_pad |= any("padded" in n for n in got.notes)
    assert seen_pad


def test_rescale_state_onto_one_device(tmp_path):
    _, tc = configs("llama3.2-1b", "float32")
    a, _ = _port_state(tc)
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, a)
    b = TR.build_everything(tc, None, 2, 16, seed=1, device="cpu")[0]
    assert not torch.equal(a.params.embed, b.params.embed)
    out = rescale_state(a, b, tc, None, mgr)
    assert out.params is b.params
    for x, y in zip(train_state_leaves(out), train_state_leaves(a)):
        np.testing.assert_array_equal(x, y)
