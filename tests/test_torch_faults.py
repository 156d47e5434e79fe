"""The port's fault lane against the reference's, bit for bit.

Every case of the reference's fast lane (``tests/test_faults.py``: one
kill and one straggler for each algorithm at p = 8, attempts 8 → 4 → 2;
a kill at a tag; a straggler alone; a delay under the threshold; two
kills; ``"auto"``; the exhausted budget; the empty plan; the injected
events kept out of the launch counts) runs through the reference with
its kernels off and through ``repro_torch.psort(..., device="cpu")`` on
the same numpy input.  Compared: the output, ``counts``, ``overflow``,
``perm``, ``info["fault"]``, ``policy.attempts`` and every event of
``policy.trace`` (primitive, bytes, group size, axis, tag and PE), so the
``fault:kill``, ``fault:delay`` and ``rescale`` events and the launches
around them.  All integers: the tolerance is 0.  The slow matrix of the
reference (p = 16, two kills and a straggler) has its counterpart under
``slow``.  The nested, batched, streamed and external cases are in
``test_torch_faults_lanes.py``.
"""
from pathlib import Path

import numpy as np
import pytest

from repro.core import selection as js
from repro.core import types as jt
from repro.data.distributions import generate_instance
from repro_torch.core import comm as tc
from repro_torch.core import selection as ts

from faults_helpers import (ALGOS, assert_same_error, assert_same_run, delay,
                            kill, run_both)

pytestmark = pytest.mark.faults

ROOT = Path(__file__).resolve().parents[1]
DISTS = ["Uniform", "Zero", "DeterDupl"]
NON_ROBUST = {("ssort", "Zero"), ("ssort", "DeterDupl")}


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _uniform(p, per):
    return generate_instance("Uniform", p, per * p).astype(np.int32)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_kill_and_straggler_every_algorithm(algorithm):
    ref, port = run_both(_uniform(8, 32), [kill(2), delay(1, factor=8.0)],
                         p=8, algorithm=algorithm)
    info = assert_same_run(ref, port)
    assert info["fault"]["failed"] == (2, 1)
    assert [a["p"] for a in port[1].attempts] == [8, 4, 2]
    prims = [e.primitive for e in port[1].trace.injected()]
    assert prims.count("fault:kill") == 1 and prims.count("rescale") == 2


def test_single_kill_rescale_semantics():
    ref, port = run_both(_uniform(8, 64), [kill(3, tag="shuffle")], p=8,
                         algorithm="rams")
    assert_same_run(ref, port)
    kills = [e for e in port[1].trace.injected()
             if e.primitive == "fault:kill"]
    assert [(e.pe, e.tag) for e in kills] == [(3, "shuffle")]
    rescale = [e for e in port[1].trace.injected() if e.primitive == "rescale"]
    assert [(e.pe, e.group_size) for e in rescale] == [(3, 4)]


def test_straggler_only_excluded_via_watchdog():
    ref, port = run_both(_uniform(8, 32), [delay(5, factor=16.0)], p=8,
                         algorithm="rquick")
    assert_same_run(ref, port)
    rescale = [e for e in port[1].trace.injected() if e.primitive == "rescale"]
    assert [(e.pe, e.tag) for e in rescale] == [(5, "straggler")]


@pytest.mark.parametrize("factor", [1.2, 1.5])
def test_delay_below_threshold_is_not_a_straggler(factor):
    """A delay under the 1.5x gate fires (its event is recorded) and the
    sort completes in one attempt."""
    ref, port = run_both(_uniform(8, 16), [delay(2, factor=factor)], p=8,
                         algorithm="rquick")
    assert_same_run(ref, port)
    assert [a["ok"] for a in port[1].attempts] == [True]
    assert [e.primitive for e in port[1].trace.injected()] == ["fault:delay"]


def test_two_kills_two_rescales():
    ref, port = run_both(_uniform(8, 32), [kill(6), kill(1, after=2)], p=8,
                         algorithm="rfis")
    assert_same_run(ref, port)
    assert [a["p"] for a in port[1].attempts] == [8, 4, 2]


def test_auto_reconsults_selection_at_reduced_p():
    """``"auto"`` chooses again at every p, on the reference's profile
    loaded into both packages (their default models differ)."""
    path = ROOT / "profiles" / "linux-x86_64-sim.json"
    for per, victim in ((64, 0), (2, 5)):
        ref, port = run_both(
            _uniform(8, per), [kill(victim)], p=8, algorithm="auto",
            ref_cfg={"cost_model": js.CostModel.load(str(path))},
            port_cfg={"cost_model": ts.CostModel.load(path)})
        info = assert_same_run(ref, port)
        assert info["algorithm"] == port[1].attempts[-1]["algorithm"]


def test_restart_budget_exhausted_reraises():
    ref, port = run_both(np.arange(64, dtype=np.int32), [kill(0), kill(1)],
                         policy_kw={"max_restarts": 1}, p=4,
                         algorithm="rquick")
    err = assert_same_error(ref, port, Exception, tc.PEFailure)
    assert type(ref[0]).__name__ == "PEFailure"
    assert (err.pe, err.phase, err.primitive, err.axis) == (
        ref[0].pe, ref[0].phase, ref[0].primitive, ref[0].axis)
    assert str(err) == str(ref[0])
    assert [a["ok"] for a in port[1].attempts] == [False, False]


def test_injected_events_excluded_from_launch_stats():
    ref, port = run_both(np.arange(128, dtype=np.int32), [kill(2)], p=4,
                         algorithm="rquick")
    assert_same_run(ref, port)
    tr = port[1].trace
    assert len(tr.injected()) == 2                  # kill + rescale
    assert tr.launches == len(tr.events) - 2
    assert tr.summary(4) == ref[1].trace.summary(4)


def test_empty_plan_single_attempt():
    ref, port = run_both(np.arange(64, dtype=np.int32), [], p=4,
                         algorithm="bitonic")
    info = assert_same_run(ref, port)
    assert info["fault"]["p_final"] == 4 and not info["fault"]["failed"]


def test_logger_hears_every_restart():
    """The policy's logger hears the restart loop and the rescale: the
    reference's messages in the reference's order."""
    heard = ([], [])
    ref, port = run_both(_uniform(8, 32), [kill(2), delay(1, factor=8.0)],
                         loggers=(heard[0].append, heard[1].append), p=8,
                         algorithm="bitonic")
    assert_same_run(ref, port)
    assert heard[1] == heard[0]
    assert [m.split("]")[0] for m in heard[1]] == [
        "[failures", "[psort", "[failures", "[psort"]


@pytest.mark.slow
@pytest.mark.parametrize("instance", DISTS)
@pytest.mark.parametrize("algorithm", ALGOS)
def test_fault_matrix_full(algorithm, instance):
    """The reference's nightly matrix: 2 kills + 1 straggler at p = 16."""
    if (algorithm, instance) in NON_ROBUST:
        pytest.skip("classical sample sort is non-robust on heavy "
                    "duplicates by design (paper §VII-B)")
    x = generate_instance(instance, 16, 64 * 16).astype(np.int32)
    ref, port = run_both(x, [kill(3), kill(5, after=2),
                             delay(1, factor=8.0)], p=16,
                         algorithm=algorithm)
    assert_same_run(ref, port)
    assert [a["p"] for a in port[1].attempts] == [16, 8, 4, 2]


@pytest.mark.slow
@pytest.mark.parametrize("algorithm", ["rams", "rquick", "bitonic"])
def test_fault_matrix_nested(algorithm):
    x = generate_instance("DeterDupl", 16, 64 * 16).astype(np.int32)
    ref, port = run_both(x, [kill(9), delay(2, factor=8.0)],
                         mesh_shape=(4, 4), algorithm=algorithm)
    assert_same_run(ref, port)
    assert [a["mesh_shape"] for a in port[1].attempts] == [(4, 4), (2, 4),
                                                           (1, 4)]
