"""The port's public entry point ``repro_torch.psort``: its options against
the reference, what it refuses, where it runs, and that the port (and
``chip_smoke.py``) never load JAX or the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import SortConfig as JConfig
from repro.core import psort as j_psort
from repro.core import types as jt
from repro.data.distributions import generate_instance
from repro_torch import ExternalPolicy, SortConfig, psort

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _same_as_reference(x, p, levels=None, **algo_kw):
    want, wi = j_psort(x, config=JConfig(p=p, algorithm="rams",
                                         backend="sim", levels=levels,
                                         algo_kw=algo_kw), return_info=True)
    got, gi = psort(x, SortConfig(p=p, algorithm="rams", levels=levels,
                                  algo_kw=algo_kw),
                    return_info=True, device="cpu")
    want = np.asarray(want)
    g = got.numpy() if got.dtype != torch.uint32 else \
        got.view(torch.int32).numpy().view(np.uint32)
    assert g.dtype == want.dtype
    assert np.array_equal(g.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(gi["counts"].numpy(), np.asarray(wi["counts"]))
    assert gi["overflow"] == wi["overflow"]
    assert np.array_equal(gi["perm"].numpy(),
                          np.asarray(wi["perm"]).astype(np.int64))
    return gi


@pytest.mark.parametrize("levels,algo_kw,per", [
    (1, {}, 90), (3, {}, 90), (None, {"tie_break": False}, 90),
    (None, {"shuffle": False}, 90), (None, {"oversample": 2, "seed": 7}, 90),
    (None, {"level_bits": (1, 2)}, 90), (None, {"slot_factor": 0.2}, 5000)])
def test_rams_options_match_reference(levels, algo_kw, per):
    x = generate_instance("DeterDupl", 8, 8 * per).astype(np.uint32)
    info = _same_as_reference(x, 8, levels, **algo_kw)
    if "slot_factor" in algo_kw:
        assert info["overflow"] > 0               # the drop path ran


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_key_dtypes_match_reference(dtype):
    g = np.random.default_rng(3)
    x = (g.standard_normal(8 * 50) * 1e4).astype(dtype)
    x[:4] = [0, -0.0 if dtype == np.float32 else 0, 5, -5]
    _same_as_reference(x, 8)


def test_empty_and_tiny_inputs_match_reference():
    for n in (0, 1, 3):
        _same_as_reference(np.arange(n, dtype=np.uint32)[::-1].copy(), 4)


def test_psort_accepts_a_torch_tensor_and_keeps_its_dtype():
    x = torch.tensor([5, -3, 9, 0, -3], dtype=torch.int32)
    out = psort(x, SortConfig(p=2, algorithm="rams"), device="cpu")
    assert out.dtype == torch.int32
    assert out.tolist() == [-3, -3, 0, 5, 9]


def test_psort_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psort(np.arange(8, dtype=np.uint32), SortConfig(p=2,
                                                        algorithm="rams"))


@pytest.mark.parametrize("kw,match", [
    ({"axis": "rows"}, None),
    ({"fault_policy": object(), "backend": "shard_map"}, "backend='sim'"),
    ({"mesh": object()}, "runs meshless; drop the mesh arg"),
    ({"backend": "shard_map"}, "backend='sim'")])
def test_unported_knobs_raise_not_implemented(kw, match):
    """The knobs this port refused until the distributed backend came
    behave as the reference's: ``axis`` builds a config that sorts as the
    reference's, a mesh on the sim backend raises its ``ValueError``, and
    ``backend="shard_map"`` without a process group raises its
    default-mesh error, which points at the sim backend (the reference
    raises it for p past its devices; with them it would sort there).
    The distributed runs themselves are ``tests/test_torch_dist.py``'s."""
    x = np.arange(64, dtype=np.uint32)[::-1].copy()
    cfg = SortConfig(p=4, algorithm="rquick", **kw)
    if match is None:
        want = j_psort(x, config=JConfig(p=4, algorithm="rquick",
                                         backend="sim", **kw))
        got = psort(x, cfg, device="cpu")
        assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                              np.asarray(want))
        return
    with pytest.raises(ValueError, match=match) as got:
        psort(x, cfg, device="cpu")
    if "backend" in kw:
        # the reference's error where the mesh cannot hold p
        with pytest.raises(ValueError, match=match) as want:
            j_psort(x, config=JConfig(p=16, algorithm="rquick", **kw))
        tail = "(use backend='sim' for emulated PE counts)"
        assert str(got.value).endswith(tail) and str(want.value).endswith(
            tail)
        return
    with pytest.raises(ValueError) as want:
        j_psort(x, config=JConfig(p=4, algorithm="rquick", backend="sim",
                                  **kw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    {"mesh_shape": (2, 2)}, {"mesh_shape": [2, 2], "p": 4},
    {"mesh_shape": (1, 4), "mesh_axes": ("slow", "fast")},
    {"data_axis": "batch", "p": 4}])
def test_nested_and_batch_knobs_sort_as_the_reference(kw):
    """``mesh_shape``, ``mesh_axes`` and ``data_axis``, refused until they
    were ported, sort bit for bit as the reference does with them, 1-D
    and 2-D keys alike."""
    x = generate_instance("Staggered", 4, 4 * 24).astype(np.uint32)
    for keys in (x, np.stack([x, x[::-1].copy()])):
        want, wi = j_psort(keys, config=JConfig(algorithm="rams",
                                                backend="sim", **kw),
                           return_info=True)
        got, gi = psort(keys, SortConfig(algorithm="rams", **kw),
                        return_info=True, device="cpu")
        assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                              np.asarray(want))
        assert np.array_equal(gi["perm"].numpy(),
                              np.asarray(wi["perm"]).astype(np.int64))
        assert np.array_equal(gi["counts"].numpy(), np.asarray(wi["counts"]))
        assert (gi["mesh_shape"], gi["d"]) == (wi["mesh_shape"], wi["d"])


_MODEL = None


def _model():
    """The reference's CPU profile, loaded into the port's CostModel."""
    global _MODEL
    if _MODEL is None:
        from repro_torch.core.selection import CostModel
        _MODEL = CostModel.load(ROOT / "profiles" / "linux-x86_64-sim.json")
    return _MODEL


@pytest.mark.parametrize("kw,ref_kw", [
    ({"overlap": True, "algorithm": "rams"},
     {"overlap": True, "algorithm": "rams"}),
    ({"external": ExternalPolicy(budget=4), "overlap": True,
      "algorithm": "external"}, {"overlap": True, "algorithm": "external"}),
    ({"algorithm": "auto", "cost_model": "cpu"},
     {"algorithm": "auto", "cost_model": "cpu"}),
    ({"algorithm": "auto", "cost_model": "cpu", "levels": 1},
     {"algorithm": "auto", "cost_model": "cpu", "levels": 1}),
    ({"algorithm": "rams", "algo_kw": {"overlap": True}},
     {"algorithm": "rams", "algo_kw": {"overlap": True}})])
def test_knobs_of_selection_and_overlap_sort_as_the_reference(kw, ref_kw):
    """``overlap``, ``cost_model``, ``"auto"`` (with ``levels``) and the
    ``overlap`` keyword, refused until they were ported, sort bit for bit
    as the reference does with the same knobs (the same CostModel)."""
    from repro.core import ExternalPolicy as JPolicy
    from repro.core.selection import CostModel as JModel
    kw, ref_kw = dict(kw), dict(ref_kw)
    if kw.get("cost_model") == "cpu":
        kw["cost_model"] = _model()
        ref_kw["cost_model"] = JModel.load(
            str(ROOT / "profiles" / "linux-x86_64-sim.json"))
    if "external" in kw:
        ref_kw["external"] = JPolicy(budget=4)
    x = generate_instance("Staggered", 4, 4 * 24).astype(np.uint32)
    want, wi = j_psort(x, config=JConfig(p=4, backend="sim", **ref_kw),
                       return_info=True)
    got, gi = psort(x, SortConfig(p=4, **kw), return_info=True,
                    device="cpu")
    assert gi["algorithm"] == wi["algorithm"]
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                          np.asarray(want))
    assert np.array_equal(gi["counts"].numpy(), np.asarray(wi["counts"]))
    assert gi["overflow"] == wi["overflow"]
    assert np.array_equal(gi["perm"].numpy(),
                          np.asarray(wi["perm"]).astype(np.int64))


@pytest.mark.parametrize("knob,default,other,item", [
    ("axis", "sort", "rows", None),
    ("data_axis", "data", "batch", None),
    ("mesh_axes", ("inter", "intra"), ("intra", "inter"), None),
    ("mesh_axes", ["inter", "intra"], ["inter"], None),
    ("mesh", None, object(), "runs meshless")])
def test_reference_defaults_of_unported_knobs_are_accepted(knob, default,
                                                           other, item):
    """The reference's own defaults (``repro/core/api.py``) build a config
    that sorts as the plain one does.  Another value sorts as the
    reference does with it (the names are the sim layout's, which reads
    them only on a nested mesh), or raises the reference's error
    (``item``: a mesh on the sim backend)."""
    cfg = SortConfig(p=4, algorithm="rquick", **{knob: default})
    assert cfg == SortConfig(p=4, algorithm="rquick")
    x = np.arange(64, dtype=np.uint32)[::-1].copy()
    assert np.array_equal(
        psort(x, cfg, device="cpu").view(torch.int32).numpy(),
        np.arange(64, dtype=np.int32))
    if item is not None:
        with pytest.raises(ValueError, match=item) as got:
            psort(x, SortConfig(p=4, **{knob: other}), device="cpu")
        with pytest.raises(ValueError, match=item) as want:
            j_psort(x, config=JConfig(p=4, backend="sim", **{knob: other}))
        assert str(got.value) == str(want.value)
        return
    got = psort(x, SortConfig(p=4, algorithm="rquick", **{knob: other}),
                device="cpu")
    want = j_psort(x, config=JConfig(p=4, algorithm="rquick", backend="sim",
                                     **{knob: other}))
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                          np.asarray(want))


def test_all_reference_defaults_at_once():
    cfg = SortConfig(p=4, axis="sort", data_axis="data",
                     mesh_axes=("inter", "intra"), mesh=None,
                     mesh_shape=None, cost_model=None, fault_policy=None,
                     overlap=False)
    _same_as_reference(np.arange(40, dtype=np.uint32)[::-1].copy(), 4)
    assert cfg == SortConfig(p=4)


@pytest.mark.parametrize("algorithm,kw", [
    ("ntb-ams", {"seed": 3, "levels": 2, "level_bits": [1, 2],
                 "oversample": 2, "tie_break": False, "shuffle": False,
                 "slot_factor": 1.5}),
    ("rfis", {"capacity": 64}),
    ("ssort", {"seed": 3, "robust": False, "sample_factor": 4,
               "slot_factor": 1.5, "oracle_splitters": [1, 2, 3]}),
    ("ns-ssort", {"seed": 3, "sample_factor": 4, "slot_factor": 1.5,
                  "oracle_splitters": (1, 2, 3)}),
    ("bitonic", {}),
    ("gatherm", {"dims": [0, 1]}),
    ("allgatherm", {"dims": (1,)})])
def test_each_algorithm_takes_its_keywords_only(algorithm, kw):
    cfg = SortConfig(p=4, algorithm=algorithm, algo_kw=kw)
    assert cfg.algorithm == algorithm
    assert dict(cfg.algo_kw) == {k: tuple(v) if isinstance(v, list) else v
                                 for k, v in kw.items()}
    hash(cfg)                       # lists become tuples: a hashable key
    with pytest.raises(ValueError, match=f"unknown {algorithm.upper()} "
                                         f"keywords"):
        SortConfig(p=4, algorithm=algorithm, algo_kw={**kw, "typo": 1})


@pytest.mark.parametrize("algorithm", ["rquick", "ntb-quick", "rfis",
                                       "ssort", "ns-ssort", "bitonic",
                                       "gatherm", "allgatherm", "external"])
def test_levels_applies_to_the_ams_family_only(algorithm):
    with pytest.raises(ValueError, match="levels= applies"):
        SortConfig(p=4, algorithm=algorithm, levels=2)
    for ams in ("rams", "ntb-ams"):
        assert SortConfig(p=4, algorithm=ams, levels=2).levels == 2


def test_bad_configs_are_refused():
    with pytest.raises(TypeError):
        SortConfig(p=4, no_such_knob=1)
    with pytest.raises(ValueError, match="unknown algorithm"):
        SortConfig(p=4, algorithm="quick")
    with pytest.raises(ValueError, match="RAMS keywords"):
        SortConfig(p=4, algorithm="rams", algo_kw={"typo": 1})
    with pytest.raises(TypeError, match="CostModel"):
        SortConfig(p=4, cost_model=object())
    with pytest.raises(TypeError, match="overlap"):
        SortConfig(p=4, overlap="yes")
    with pytest.raises(ValueError, match="power of two"):
        psort(np.arange(6, dtype=np.uint32), SortConfig(p=3), device="cpu")
    # 2-D keys are a batch of sorts (tests/test_torch_batched.py); 3-D
    # keys raise the reference's error
    assert psort(np.array([[3, 1, 2, 0], [9, 8, 7, 6]], np.uint32),
                 SortConfig(p=2, algorithm="rquick"), device="cpu").view(
        torch.int32).tolist() == [[0, 1, 2, 3], [6, 7, 8, 9]]
    with pytest.raises(ValueError, match="1-D .* or 2-D"):
        psort(np.zeros((2, 2, 4), np.uint32), SortConfig(p=2), device="cpu")
    # 8-byte keys: RQuick sorts them, RAMS raises the reference's error
    x = np.array([3, -1, 2 ** 40, 0], np.int64)
    assert psort(x, SortConfig(p=2, algorithm="rquick"),
                 device="cpu").tolist() == sorted(x.tolist())
    with pytest.raises(ValueError, match="rams requires uint32 keys"):
        psort(x, SortConfig(p=2, algorithm="rams"), device="cpu")
    with pytest.raises(TypeError, match="int64"):     # the reference's type
        psort(np.zeros(4, np.int16), SortConfig(p=2), device="cpu")
    assert SortConfig(p=4) == SortConfig(p=4, overlap=False, mesh_shape=None)
    assert SortConfig(p=4).replace(p=8).p == 8


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_the_port_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, numpy as np\n"
        "from repro_torch import SortConfig, psort\n"
        "import repro_torch.kernels, repro_torch.data\n"
        "x = np.arange(64, dtype=np.uint32)[::-1].copy()\n"
        "out = psort(x, SortConfig(p=4, algorithm='rams'), device='cpu')\n"
        "assert out.view(__import__('torch').int32).tolist()[:2] == [0, 1]\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_source_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "tools").glob("*torch*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    scanned = {f.parent.name for f in files}
    assert {"core", "kernels", "runtime", "launch", "data"} <= scanned
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                (f, mod)


def test_chip_smoke_fails_without_a_gpu_or_the_repository(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
