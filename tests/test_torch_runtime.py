"""The port's runtime (``repro_torch.runtime``) and fault injection
(``repro_torch.core.comm``) against the reference's, on the same inputs.

``StepWatchdog``, ``flag_stragglers``, ``run_with_restarts`` and
``plan_sort_rescale`` are copies of the reference's plain-Python
functions: hypothesis draws their inputs and every output (flags,
returns, raised errors, log lines, hook calls, rescale plans) must be
equal.  The fault plan and the faulty scope run one sequence of
collectives under the reference's ``FaultyCollectives`` (over a counter
over its sim backend, as its ``psort`` fault lane builds it) and under
the port's ``comm.faulty`` scope: the same events, the same
``fired_delays``, the same ``PEFailure``.  Last, the port's own checks:
the injection runs with no counting scope open, and a rescale and a
final error leave none of the dead attempt's tensors alive.
"""
import contextlib
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import comm as jc
from repro.runtime import elastic as je
from repro.runtime import failures as jf
from repro_torch import SortConfig, psort
from repro_torch.core import comm as tc
from repro_torch.runtime import elastic as te
from repro_torch.runtime import failures as tf

from faults_helpers import events

pytestmark = pytest.mark.faults

times = st.lists(st.floats(min_value=0.0, max_value=100.0,
                           allow_nan=False), max_size=40)


@settings(max_examples=60, deadline=None)
@given(times, st.floats(min_value=0.5, max_value=10.0),
       st.integers(min_value=0, max_value=8))
def test_step_watchdog_equals_reference(dts, k_mad, warmup):
    want, got = jf.StepWatchdog(k_mad, warmup), tf.StepWatchdog(k_mad, warmup)
    for i, dt in enumerate(dts):
        assert _outcome(got.observe, i, dt) == _outcome(want.observe, i, dt)
    assert got.flagged == want.flagged and got.times == want.times


def _outcome(fn, *args, **kw):
    """What ``fn`` returned, or the type of what it raised (warmup = 0
    indexes an empty history in both packages)."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — compared with the other's
        return type(e)


def test_step_watchdog_start_stop():
    for wd in (jf.StepWatchdog(), tf.StepWatchdog()):
        with pytest.raises(RuntimeError, match="without a matching start"):
            wd.stop(0)
    want, got = jf.StepWatchdog(warmup=1), tf.StepWatchdog(warmup=1)
    for step, now in enumerate((1.0, 1.1, 9.0)):
        for wd in (want, got):
            wd._t0 = 0.0
        assert got.stop(step, now=now) == want.stop(step, now=now)
    assert got.flagged == want.flagged == [2]


@settings(max_examples=80, deadline=None)
@given(times, st.floats(min_value=0.5, max_value=10.0),
       st.integers(min_value=0, max_value=8))
def test_flag_stragglers_equals_reference(dts, k_mad, warmup):
    assert _outcome(tf.flag_stragglers, dts, k_mad=k_mad, warmup=warmup) \
        == _outcome(jf.flag_stragglers, dts, k_mad=k_mad, warmup=warmup)


class _Crash(Exception):
    pass


def _restart_run(mod, fails, progress, max_restarts, retry):
    """``run_with_restarts`` of one package over a function that fails
    ``fails`` times (``_Crash``, or ``KeyError`` where ``retry`` excludes
    it) with the progress markers ``progress``: what it returned or
    raised, its log lines and its hook calls."""
    log, hooks, calls = [], [], []
    marks = iter(progress)

    def train(start):
        calls.append(start)
        if len(calls) <= fails:
            raise _Crash(f"crash {len(calls)}") if retry else KeyError("k")
        return ("done", start)

    try:
        out = mod.run_with_restarts(
            train, max_restarts=max_restarts, logger=log.append,
            retry_on=(_Crash,),
            on_failure=lambda e, r: hooks.append((str(e), r)),
            progress_fn=(lambda: next(marks)) if progress else None)
    except (_Crash, KeyError) as e:
        out = (type(e).__name__, str(e))
    return out, log, hooks, calls


@settings(max_examples=80, deadline=None)
@given(st.integers(min_value=0, max_value=5),
       st.lists(st.integers(min_value=-8, max_value=8), min_size=0,
                max_size=12),
       st.integers(min_value=0, max_value=4), st.booleans())
def test_run_with_restarts_equals_reference(fails, progress, max_restarts,
                                            retry):
    # a progress function is called twice per failure and once per
    # attempt: give it enough markers (or none)
    if progress:
        progress = (progress * 4)[:3 * (fails + 1)]
    assert _restart_run(tf, fails, progress, max_restarts, retry) == \
        _restart_run(jf, fails, progress, max_restarts, retry)


def test_fault_policy_defaults_equal_reference():
    want, got = jf.FaultPolicy(), tf.FaultPolicy()
    for name in ("plan", "max_restarts", "k_mad", "warmup",
                 "base_step_time", "logger", "trace", "attempts"):
        assert getattr(got, name) == getattr(want, name), name


@settings(max_examples=100, deadline=None)
@given(st.integers(min_value=0, max_value=10),
       st.lists(st.integers(min_value=-3, max_value=1100), max_size=12),
       st.one_of(st.none(), st.tuples(st.integers(0, 5), st.integers(0, 5))))
def test_plan_sort_rescale_equals_reference(log_p, failed, mesh_bits):
    p = 1 << log_p
    mesh = None
    if mesh_bits is not None:
        lo = min(mesh_bits[1], log_p)
        mesh = (1 << (log_p - lo), 1 << lo)
    try:
        want = je.plan_sort_rescale(p, failed, mesh_shape=mesh)
    except ValueError as e:
        with pytest.raises(ValueError, match="no surviving PEs"):
            te.plan_sort_rescale(p, failed, mesh_shape=mesh)
        assert "no surviving PEs" in str(e)
        return
    got = te.plan_sort_rescale(p, failed, mesh_shape=mesh)
    assert (got.p_old, got.failed, got.p_new, got.mesh_shape, got.notes,
            got.survivors) == (want.p_old, want.failed, want.p_new,
                               want.mesh_shape, want.notes, want.survivors)


def test_fault_plan_equals_reference():
    faults = [("kill_pe", (3,), {"tag": "level0"}),
              ("delay_pe", (1,), {"factor": 8.0, "after": 2}),
              ("kill_pe", (9,), {}), ("delay_pe", (3,), {})]
    want = jc.FaultPlan(tuple(getattr(jc, k)(*a, **kw) for k, a, kw in faults))
    got = tc.FaultPlan(tuple(getattr(tc, k)(*a, **kw) for k, a, kw in faults))
    assert [dataclass_tuple(f) for f in got.faults] == \
        [dataclass_tuple(f) for f in want.faults]
    assert bool(got) and not tc.FaultPlan()
    for pe, p_new in ((3, 8), (1, 4), (0, 16)):
        assert [dataclass_tuple(f) for f in got.surviving(pe, p_new).faults] \
            == [dataclass_tuple(f) for f in want.surviving(pe, p_new).faults]
    for mod in (jc, tc):
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.PEFault("stall", 0)
    err = tc.PEFailure(5, phase="level1", primitive="all_to_all", axis="sort")
    assert str(err) == str(jc.PEFailure(5, phase="level1",
                                        primitive="all_to_all", axis="sort"))


def dataclass_tuple(f):
    return (f.kind, f.pe, f.tag, f.after, f.factor)


# --- injection: one body of collectives in both packages -------------------

P = 8
GROUPS = [[0, 1, 2, 3], [4, 5, 6, 7]]
XOR1 = [(i, i ^ 1) for i in range(P)]


def _ref_body(x):
    """Tagged collectives of the reference, per PE: a psum, a grouped
    all_gather, two ppermutes and an all_to_all."""
    with jc.tagged("a"):
        s = jc.psum(x, "sort")
        g = jc.all_gather(x, "sort", axis_index_groups=GROUPS, tiled=True)
    with jc.tagged("b"):
        y = jc.ppermute(x, "sort", XOR1)
        y = jc.ppermute(y + s, "sort", XOR1)
    z = jc.all_to_all(jnp.tile(x, P), "sort", 0, 0, tiled=True)
    return y + g.sum() + z.sum()


def _port_body(x):
    with tc.tagged("a"):
        s = tc.psum(x)
        g = tc.all_gather(x, GROUPS, tiled=True)
    with tc.tagged("b"):
        y = tc.ppermute(x, XOR1)
        y = tc.ppermute(y + s, XOR1)
    z = tc.all_to_all(x.repeat(1, P))
    return y + g.sum(dim=1, keepdim=True) + z.sum(dim=1, keepdim=True)


def _faults(mod, spec):
    return [getattr(mod, k)(*a, **kw) for k, a, kw in spec]


def _ref_events(spec):
    tr = jc.CommTrace()
    fc = jc.FaultyCollectives(jc.CountingCollectives(jc.SIM, tr),
                              jc.FaultPlan(tuple(_faults(jc, spec))), tr)
    x = jnp.arange(P * 2, dtype=jnp.int32).reshape(P, 2)
    try:
        jax.jit(jc.sim_map(_ref_body, "sort", P, impl=fc))(x)
        err = None
    except jc.PEFailure as e:
        err = (e.pe, e.phase, e.primitive, e.axis)
    return events(tr), dict(fc.fired_delays), err


def _port_events(spec, counting=True):
    tr = tc.CommTrace()
    x = torch.arange(P * 2, dtype=torch.int32).reshape(P, 2)
    with tc.recording(tr) if counting else contextlib.nullcontext(), \
            tc.faulty(tuple(_faults(tc, spec)), tr) as fc:
        try:
            _port_body(x)
            err = None
        except tc.PEFailure as e:
            err = (e.pe, e.phase, e.primitive, e.axis)
    return events(tr), dict(fc.fired_delays), err


SPECS = [
    [],
    [("kill_pe", (3,), {})],
    [("kill_pe", (2,), {"tag": "b", "after": 1})],
    [("delay_pe", (4,), {"factor": 3.0}), ("kill_pe", (6,), {"tag": "b"})],
    # kills outrank delays within one launch; a delay keeps its largest
    [("delay_pe", (1,), {"factor": 2.0}), ("kill_pe", (1,), {})],
    [("delay_pe", (5,), {"factor": 2.0}),
     ("delay_pe", (5,), {"factor": 7.0, "after": 3}),
     ("delay_pe", (0,), {"tag": "a", "after": 1})],
    [("kill_pe", (7,), {"tag": "missing"})],
    [("kill_pe", (0,), {"after": 4})],
    [("kill_pe", (0,), {"after": 9})],
]


@pytest.mark.parametrize("spec", SPECS, ids=[str(i) for i in range(len(SPECS))])
def test_injection_equals_reference(spec):
    assert _port_events(spec) == _ref_events(spec)


def test_injection_runs_without_counting():
    """The faulty scope checks every launch with no counting scope open;
    its events then go to a trace of its own."""
    spec = [("delay_pe", (4,), {"factor": 3.0}),
            ("kill_pe", (6,), {"tag": "b", "after": 1})]
    seen, delays, err = _port_events(spec, counting=False)
    assert [e[0] for e in seen] == ["fault:delay", "fault:kill"]
    assert delays == {4: 3.0} and err == (6, "b", "ppermute", "sort")
    with tc.faulty(tc.FaultPlan((tc.kill_pe(1),))) as fc:
        with pytest.raises(tc.PEFailure):
            tc.psum(torch.ones(P, 1, dtype=torch.int32))
    assert [e.primitive for e in fc.trace.events] == ["fault:kill"]


def test_faulty_scope_writes_to_the_open_counting_trace():
    with tc.counting() as tr, tc.faulty([tc.delay_pe(2)]) as fc:
        tc.psum(torch.ones(P, 1, dtype=torch.int32))
    assert fc.trace is tr
    assert [e.primitive for e in tr.events] == ["fault:delay", "psum"]


def _big_tensors(n):
    return [o for o in gc.get_objects()
            if issubclass(type(o), torch.Tensor) and o.numel() >= n]


def test_rescale_drops_the_dead_attempt():
    """At the rescale (where the policy's logger hears ``[psort]``) the
    only tensors of the input's size or more alive are the input and its
    words; after a final error, only the input.  A killed attempt did
    real work, and the exception's frames would hold it."""
    p, n = 4, 1 << 14
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32))
    seen = []

    def logger(msg):
        if msg.startswith("[psort]"):
            seen.append(len(_big_tensors(n)))

    for plan, ok in (((tc.kill_pe(1, tag="level0"),), True),
                     ((tc.kill_pe(1, tag="level0"), tc.kill_pe(0)), False)):
        before = len(_big_tensors(n))
        pol = tf.FaultPolicy(plan=tc.FaultPlan(plan), logger=logger,
                             max_restarts=1)
        cfg = SortConfig(p=p, algorithm="rams", fault_policy=pol)
        if ok:
            out = psort(x, cfg, device="cpu")
            assert torch.equal(out, torch.sort(x)[0])
            del out
        else:
            with pytest.raises(tc.PEFailure):
                psort(x, cfg, device="cpu")
        # the input words: the internal int32 words and their (1, n) view
        assert seen.pop() <= before + 2
        assert len(_big_tensors(n)) == before
