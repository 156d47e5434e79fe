"""The reference's legacy call styles, its exports, its kernel switch and
its error types, in the port, against the reference on the same inputs.

- ``psort(keys, 8, ...)`` (a bare int is p) and ``psort(keys, p=8, ...)``
  (keywords split by ``SortConfig.from_kwargs`` into fields and
  ``algo_kw``) sort as the config style does, with exactly one
  ``DeprecationWarning`` each, the reference's message; mixing the styles
  raises ``TypeError``; ``device`` stays the port's own keyword.
- ``trace_collectives(n, p, algorithm, capacity_factor)`` equals the
  reference's trace of the same legacy call, event for event.
- ``repro_torch.core`` exports the six names of ``repro.core`` it lacked;
  every name the ``__init__`` of ``repro.core``, ``repro.data``,
  ``repro.dist`` and the three kernel packages exports exists in the
  port's same package, but the Pallas entry points (``sort_tile``,
  ``merge_tiles``, ``partition_tile``, ``supported``, ``LANES``); the JAX
  ``Collectives`` classes and ``sim_map`` stay out of ``comm`` too;
- ``key_to_uint``/``uint_to_key`` give the reference's unsigned words for
  the six key dtypes (±0.0, ±inf and NaN included) and round-trip.
- ``REPRO_LOCAL_KERNELS`` (and the legacy ``REPRO_PALLAS_LOCAL_SORT``)
  parse to the reference's policy; ``set_local_kernels`` round-trips.
- int16 keys raise ``TypeError``; ``select_rank(data, [])`` raises
  ``ZeroDivisionError``.
"""
import ast
import importlib
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import SortConfig as JConfig
from repro.core import psort as j_psort
from repro.core import selection as js
from repro.core import types as jt
from repro.core.api import trace_collectives as j_trace
from repro.data.distributions import generate_instance
import repro_torch.core as tcore
from repro_torch import SortConfig, psort, trace_collectives
from repro_torch.core import selection as ts
from repro_torch.kernels import policy
from repro_torch.runtime import FaultPolicy

from torch_helpers import bits


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _deprecations(fn, *args, **kw):
    """(result, the messages of the DeprecationWarnings ``fn`` emitted)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, [str(w.message) for w in seen
                 if issubclass(w.category, DeprecationWarning)]


ROOT = Path(__file__).resolve().parents[1]
X = generate_instance("Uniform", 8, 64 * 8).astype(np.int32)


@pytest.mark.parametrize("args,kw", [
    ((8,), {"algorithm": "rquick"}),
    ((), {"p": 8, "algorithm": "rquick"}),
    ((), {"p": 8, "algorithm": "rams", "seed": 7, "levels": 2}),
    ((4,), {"algorithm": "ssort", "sample_factor": 8}),
    ((), {"p": 8, "algorithm": "bitonic", "capacity_factor": 3.0}),
])
def test_legacy_psort_styles_warn_once_and_sort_as_the_reference(args, kw):
    (want, wi), wmsg = _deprecations(j_psort, X, *args, backend="sim",
                                     return_info=True, **kw)
    (got, gi), gmsg = _deprecations(psort, X, *args, return_info=True,
                                    device="cpu", **kw)
    assert len(gmsg) == 1 and gmsg == wmsg
    assert np.array_equal(bits(got), bits(np.asarray(want)))
    assert np.array_equal(gi["perm"].numpy(),
                          np.asarray(wi["perm"]).astype(np.int64))
    assert gi["algorithm"] == wi["algorithm"]
    # and the config style gives the same, with no warning
    cfg = SortConfig.from_kwargs(**({"p": args[0]} if args else {}), **kw)
    (same, _), none = _deprecations(psort, X, cfg, return_info=True,
                                    device="cpu")
    assert not none and torch.equal(same, got)


def test_from_kwargs_splits_as_the_reference():
    kw = dict(p=16, algorithm="rams", seed=3, levels=2, capacity_factor=2.5,
              slot_factor=3.0, overlap=True, mesh_shape=[4, 4])
    want, got = JConfig.from_kwargs(**kw), SortConfig.from_kwargs(**kw)
    for name in ("p", "algorithm", "levels", "capacity_factor", "overlap",
                 "mesh_shape", "mesh_axes", "algo_kw", "data_axis",
                 "fault_policy", "external", "cost_model"):
        assert getattr(got, name) == getattr(want, name), name


def test_mixed_styles_raise_type_error():
    for fn, conf, kw in ((j_psort, JConfig, {}),
                         (psort, SortConfig, {"device": "cpu"})):
        with pytest.raises(TypeError, match="both config= and legacy"):
            fn(X, conf(p=8), p=8, **kw)
        with pytest.raises(TypeError, match="config must be a SortConfig"):
            fn(X, "rams", **kw)
        with pytest.raises(TypeError, match="both config= and legacy"):
            fn(X, conf(p=8), algorithm="rams", **kw)


def test_device_is_never_a_legacy_keyword():
    out, msgs = _deprecations(psort, X, SortConfig(p=8, algorithm="rquick"),
                              device="cpu")
    assert not msgs and out.device.type == "cpu"


def test_legacy_trace_collectives_equals_reference():
    (want, wmsg), (got, gmsg) = (
        _deprecations(j_trace, 64, 8, "bitonic"),
        _deprecations(trace_collectives, 64, 8, "bitonic", device="cpu"))
    assert len(gmsg) == 1 and gmsg == wmsg
    assert [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
            for e in got.events] == [
        (e.primitive, e.bytes, e.group_size, e.axis, e.tag)
        for e in want.events]
    (want, _), (got, _) = (
        _deprecations(j_trace, 512, 8, "rams", 3.0),
        _deprecations(trace_collectives, 512, 8, "rams", 3.0, device="cpu"))
    assert got.summary(8) == want.summary(8)
    for fn, kw in ((j_trace, {}), (trace_collectives, {"device": "cpu"})):
        with pytest.raises(TypeError, match="at most 2 legacy positional"):
            fn(64, 8, "bitonic", 2.0, "extra", **kw)


def test_the_six_exports():
    for name in ("select_algorithm", "cost_select", "merge_shards",
                 "LocalKernelPolicy", "local_kernels", "set_local_kernels"):
        assert hasattr(jcore, name)
        assert callable(getattr(tcore, name)), name
    path = ROOT / "profiles" / "linux-x86_64-sim.json"
    for n, p in ((1 << 20, 64), (1 << 10, 256), (1 << 16, 1 << 14)):
        assert tcore.select_algorithm(n, p, model=ts.CostModel.load(path)) \
            == jcore.select_algorithm(n, p, model=js.CostModel.load(
                str(path)))


# the reference's exports that the port leaves out by design: the Pallas
# entry points (the CUDA kernels have their own wrappers) and, in comm,
# the JAX Collectives classes and sim_map
PALLAS_ONLY = {"sort_tile", "merge_tiles", "partition_tile", "supported",
               "LANES"}
JAX_COMM_ONLY = ("Collectives", "LaxCollectives", "CountingCollectives",
                 "SimCollectives", "NestedCollectives", "sim_map")


def _init_exports(package: str) -> set:
    """The names a reference package's ``__init__`` imports from its own
    modules."""
    init = ROOT / "src" / "repro" / Path(*package.split(".")) / "__init__.py"
    return {a.asname or a.name for node in ast.walk(ast.parse(
        init.read_text())) if isinstance(node, ast.ImportFrom)
        and node.level >= 1 for a in node.names}


@pytest.mark.parametrize("package", ["core", "data", "dist",
                                     "kernels.bitonic", "kernels.kway",
                                     "kernels.partition"])
def test_every_export_of_the_reference(package):
    names = _init_exports(package)
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    assert names and all(hasattr(ref, n) for n in names)
    missing = sorted(n for n in names - PALLAS_ONLY if not hasattr(port, n))
    assert missing == [], missing
    for n in ("default_mesh", "key_to_uint", "uint_to_key",
              "TokenPipeline", "length_balanced_batches", "make_shardings",
              "shard_act", "data_axes_of", "batch_axes_of"):
        if n in names:
            assert callable(getattr(port, n)), n


def test_the_jax_collectives_stay_out():
    from repro.core import comm as jcomm
    from repro_torch.core import comm as tcomm
    for n in JAX_COMM_ONLY:
        assert hasattr(jcomm, n) and not hasattr(tcomm, n), n


def _words(x):
    """Keys of every kind for the unsigned map: spread values, the
    extremes, and for floats ±0.0, ±inf and NaN."""
    rng = np.random.default_rng(5)
    if x.kind == "f":
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -1.5,
                            np.finfo(x).tiny, -np.finfo(x).max], x)
        return np.concatenate([special, rng.normal(size=64).astype(x)])
    info = np.iinfo(x)
    ends = np.array([info.min, info.min + 1, 0, 1, info.max - 1, info.max],
                    x)
    return np.concatenate([ends, rng.integers(info.min, info.max, size=64,
                                              dtype=x)])


@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32", "int64",
                                   "uint64", "float64"])
def test_key_to_uint_gives_the_reference_words(dtype):
    import jax.numpy as jnp
    x = _words(np.dtype(dtype))
    want = np.asarray(jcore.key_to_uint(jnp.asarray(x)))
    u = tcore.key_to_uint(torch.from_numpy(x))
    assert str(u.dtype) == f"torch.{want.dtype}"
    signed, np_signed = {4: (torch.int32, np.int32),
                         8: (torch.int64, np.int64)}[x.itemsize]
    assert np.array_equal(u.view(signed).numpy(), want.view(np_signed))
    for orig in (getattr(torch, dtype), dtype):
        back = tcore.uint_to_key(u, orig)
        assert np.array_equal(back.view(signed).numpy(), x.view(np_signed))
    ref_back = np.asarray(jcore.uint_to_key(jnp.asarray(want), x.dtype))
    assert np.array_equal(ref_back.view(np_signed), x.view(np_signed))


SPECS = ["auto", "none", "all", "sort", "partition", "sort,partition",
         " Partition , sort ", "1", "true", "yes", "on", "0", "off", "false",
         "no", ""]


def _policies(monkeypatch, spec, ref_spec, legacy):
    """The port's policy under ``REPRO_LOCAL_KERNELS=spec`` and the
    reference's under ``ref_spec`` (None: unset), with the legacy sort
    toggle set to ``legacy`` in both."""
    if legacy is None:
        monkeypatch.delenv("REPRO_PALLAS_LOCAL_SORT", raising=False)
    else:
        monkeypatch.setenv("REPRO_PALLAS_LOCAL_SORT", legacy)
    prev_t, prev_j = tcore.set_local_kernels(None), jt.set_local_kernels(None)
    try:
        out = []
        for fn, value in ((tcore.local_kernels, spec),
                          (jt.local_kernels, ref_spec)):
            if value is None:
                monkeypatch.delenv("REPRO_LOCAL_KERNELS", raising=False)
            else:
                monkeypatch.setenv("REPRO_LOCAL_KERNELS", value)
            pol = fn()
            out.append((pol.sort, pol.partition))
    finally:
        tcore.set_local_kernels(prev_t)
        jt.set_local_kernels(prev_j)
    return out


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("legacy", [None, "1", "0"])
def test_local_kernels_parse_as_the_reference(monkeypatch, spec, legacy):
    """Every spelling parses as the reference parses it; ``auto`` (and no
    variable at all) is the port's default, both families on for CUDA
    tensors, which the reference spells ``all`` (its ``auto`` is on where
    the backend is a TPU only)."""
    ref_spec = "all" if spec == "auto" else spec
    got, want = _policies(monkeypatch, spec, ref_spec, legacy)
    assert got == want
    got, want = _policies(monkeypatch, None, "all", legacy)
    assert got == want


def test_unknown_kernel_names_raise(monkeypatch):
    monkeypatch.setenv("REPRO_LOCAL_KERNELS", "sort,merge")
    prev_t, prev_j = tcore.set_local_kernels(None), jt.set_local_kernels(None)
    try:
        for fn in (tcore.local_kernels, jt.local_kernels):
            with pytest.raises(ValueError, match="unknown kernel"):
                fn()
    finally:
        tcore.set_local_kernels(prev_t)
        jt.set_local_kernels(prev_j)


def test_set_local_kernels_round_trips():
    first = tcore.LocalKernelPolicy(sort=True)
    prev = tcore.set_local_kernels(first)
    try:
        assert tcore.local_kernels() == first
        assert tcore.set_local_kernels(None) is first
        off = tcore.LocalKernelPolicy()
        assert tcore.set_local_kernels(off) is None
        assert tcore.local_kernels() == off
    finally:
        tcore.set_local_kernels(prev)


def test_the_switch_never_sends_a_card_tensor_to_the_plain_version():
    """A CPU tensor takes the plain version whatever the policy; any other
    device's tensor launches the kernel, and raises where the caller
    turned its family off."""
    cpu, meta = torch.empty(1), torch.empty(1, device="meta")
    prev = tcore.set_local_kernels(tcore.LocalKernelPolicy(sort=True))
    try:
        assert policy.plain(cpu, "sort") and policy.plain(cpu, "partition")
        assert not policy.plain(meta, "sort")
        with pytest.raises(RuntimeError, match="'partition' kernels are "
                                               "switched off"):
            policy.plain(meta, "partition")
    finally:
        tcore.set_local_kernels(prev)


def test_fault_policy_takes_no_part_in_equality():
    a = SortConfig(p=8, fault_policy=FaultPolicy())
    assert a == SortConfig(p=8) and hash(a) == hash(SortConfig(p=8))
    assert a.replace(algorithm="rams").fault_policy is a.fault_policy
    # on the distributed backend the fault lane is refused, as by the
    # reference (without a process group the default mesh refuses first;
    # both errors point at the sim backend)
    b = SortConfig(p=8, backend="shard_map", fault_policy=FaultPolicy())
    assert b == SortConfig(p=8, backend="shard_map")
    with pytest.raises(ValueError, match="backend='sim'"):
        psort(np.arange(64, dtype=np.int32), b, device="cpu")


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float16])
def test_unsupported_key_dtypes_raise_type_error(dtype):
    x = np.arange(32).astype(dtype)
    with pytest.raises(TypeError, match="unsupported key dtype"):
        j_psort(x, config=JConfig(p=4, algorithm="rquick", backend="sim"))
    with pytest.raises(TypeError, match="unsupported key dtype"):
        psort(x, SortConfig(p=4, algorithm="rquick"), device="cpu")


def test_select_rank_of_no_ranks_raises_zero_division():
    x = np.arange(64, dtype=np.uint32)
    with pytest.raises(ZeroDivisionError):
        jcore.select_rank(jcore.shard_data(x, p=4), [], backend="sim")
    with pytest.raises(ZeroDivisionError):
        tcore.select_rank(tcore.shard_data(x, 4, device="cpu"), [])
