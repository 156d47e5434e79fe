"""The port's training step and loop (``repro_torch.launch.steps.
make_train_step``, ``repro_torch.launch.train``) on the CPU: three steps
of the llama3.2-1b and granite-moe-1b-a400m float32 smoke variants
against the reference's ``make_train_step(cfg, None)`` from the same
state (loss, lr, grad_norm, and every leaf of the state after each step,
within float32 rtol 1e-4, atol 1e-5); a crash-resumed ``train`` equal bit
for bit to the uninterrupted run; the CLI; and the refusal of a mesh that
is not the process group's (training on a mesh:
``test_torch_mesh_train.py``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.launch import steps as S
from repro_torch.launch import train as TR
from repro_torch.models.convert import (train_state_from_jax,
                                        train_state_leaves)
from repro_torch.runtime import CheckpointManager
from torch_model_helpers import F32, configs, npt


def _ref_state(jc, seed=0):
    step_fn, opt_init = JS.make_train_step(jc, None)
    params = JT.init_params(jax.random.PRNGKey(seed), jc)
    return (JS.TrainState(params, opt_init(params), jnp.zeros((), jnp.int32)),
            jax.jit(step_fn))


@pytest.mark.parametrize("arch,remat", [("llama3.2-1b", "none"),
                                        ("granite-moe-1b-a400m", "full")])
def test_three_steps_match_the_reference(arch, remat):
    jc, tc = configs(arch, "float32")
    jc = dataclasses.replace(jc, remat=remat)
    tc = dataclasses.replace(tc, remat=remat)
    jstate, jstep = _ref_state(jc)
    state = train_state_from_jax(tc, npt(jstate), device="cpu")
    step, _ = S.make_train_step(tc, None)
    pipe = JPipeline(jc.vocab, 2, 32)
    for i in range(3):
        batch = pipe.batch_at(i)
        jstate, want = jstep(jstate, batch)
        state, got = step(state, batch)
        assert state.step == int(jstate.step) == i + 1
        for k in ("loss", "lr", "grad_norm"):
            assert got[k].dtype == torch.float32 and got[k].shape == ()
            np.testing.assert_allclose(float(got[k]), float(want[k]), **F32)
        mine = train_state_leaves(state)
        ref = jax.tree.leaves(jstate)
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            assert a.shape == np.shape(b)
            np.testing.assert_allclose(a, np.asarray(b, np.float32), **F32)


def test_adafactor_steps_match_the_reference():
    """mixtral's optimizer on its smoke variant: stacked (L, …) leaves
    factored and clipped whole."""
    jc, tc = configs("mixtral-8x22b", "float32")
    assert jc.optimizer == tc.optimizer == "adafactor"
    jstate, jstep = _ref_state(jc, seed=2)
    state = train_state_from_jax(tc, npt(jstate), device="cpu")
    step, _ = S.make_train_step(tc, None, warmup=1, peak_lr=1e-3)
    jstep = jax.jit(JS.make_train_step(jc, None, warmup=1, peak_lr=1e-3)[0])
    pipe = JPipeline(jc.vocab, 2, 16)
    for i in range(2):
        jstate, want = jstep(jstate, pipe.batch_at(i))
        state, got = step(state, pipe.batch_at(i))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   **F32)
    for a, b in zip(train_state_leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **F32)


def _leaf_files(directory, step):
    d = directory / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return [np.load(d / f"leaf_{k}.npy")
            for k in range(len(manifest["leaves"]))]


def test_crash_resume_equals_the_uninterrupted_run(tmp_path):
    """Training crashes at step 7, resumes from the step-5 checkpoint and
    finishes: its losses and final state equal the uninterrupted run's
    bit for bit (the reference's crash/resume test, and more)."""
    from repro_torch.configs import get_config, smoke_variant
    cfg = smoke_variant(get_config("llama3.2-1b"))
    lines = []
    runs = {}
    for name, crash in (("crashed", 7), ("whole", None)):
        runs[name] = TR.train(cfg, None, steps=10, batch=2, seq=32,
                              ckpt_dir=tmp_path / name, ckpt_every=5,
                              crash_at=crash, logger=lines.append,
                              device="cpu")
    (final, losses), (final_w, losses_w) = runs["crashed"], runs["whole"]
    assert final == final_w == 10
    assert len(losses) == 5 and losses == losses_w[5:]
    assert any("restored step 5" in ln for ln in lines)
    for name in runs:
        assert CheckpointManager(tmp_path / name).latest_step() == 10
    for a, b in zip(_leaf_files(tmp_path / "crashed", 10),
                    _leaf_files(tmp_path / "whole", 10)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_main_cli(tmp_path, capsys):
    final, losses = TR.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                             "--steps", "3", "--batch", "2", "--seq", "16",
                             "--mesh", "1,1", "--ckpt-dir", str(tmp_path),
                             "--device", "cpu"])
    assert final == 3 and len(losses) == 3 and np.isfinite(losses).all()
    assert "[train] done: 3 steps" in capsys.readouterr().out
    assert CheckpointManager(tmp_path).latest_step() == 3


@pytest.mark.parametrize("mesh", ["1,2", "2,1", "4,2"])
def test_mesh_is_item_10c(mesh):
    """``--mesh`` of more than one rank outside a process group of that
    size (``torchrun`` sets one up; ``test_torch_mesh_train.py`` trains
    on one) raises."""
    d, m = (int(v) for v in mesh.split(","))
    with pytest.raises(ValueError, match=f"a mesh of {d * m} ranks in a "
                                         f"process group of 0"):
        TR.main(["--smoke", "--steps", "1", "--mesh", mesh,
                 "--device", "cpu"])


def test_one_device_limits():
    """``train`` on a mesh whose ranks are not the process group's (here:
    none) raises; ``make_train_step`` on a mesh places the optimizer
    state by ``make_shardings`` (the rules need no transport)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.dist.sharding import MeshLayout
    cfg = smoke_variant(get_config("llama3.2-1b"))
    layout = MeshLayout(("data", "model"), (1, 2), (0, 0))
    with pytest.raises(ValueError, match="a mesh of 2 ranks in a process "
                                         "group of 0"):
        TR.train(cfg, layout, steps=1, batch=1, seq=8, device="cpu")
    model = TR.build_everything(cfg, layout, 1, 8, device="cpu")[0].params
    _, init = S.make_train_step(cfg, layout)
    opt = init(model)
    wq = model.blocks[0].attn.wq
    assert tuple(wq.shape) == (cfg.d_model // 2, cfg.n_heads * cfg.head_dim)
    assert tuple(opt.mu[("blocks", "attn", "wq")][0].shape) == tuple(
        wq.shape)


def test_entry_points_default_to_the_card():
    """Without a card and without ``device="cpu"`` training refuses to
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.configs import get_config, smoke_variant
    cfg = smoke_variant(get_config("llama3.2-1b"))
    with pytest.raises(RuntimeError):
        TR.build_everything(cfg, None, 1, 8)
