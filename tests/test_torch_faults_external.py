"""The port's fault lane against the reference's on the external lane,
bit for bit: a kill in the k-way merge pass, a kill in an exchange pass
(each attempt rebuilds runs, splitters and slices from the host input at
its p) and a rescale that pushes n/p past the budget, so the rescaled
attempt enters the lane.  Compared as in ``test_torch_faults.py``:
output, ``counts``, ``overflow``, ``perm``, ``info["fault"]``,
``policy.attempts`` and every trace event (the lane's ``ext:h2d`` and
``ext:d2h`` copies included, which are never injection points), with
tolerance 0.
"""
import numpy as np
import pytest

from repro.core import ExternalPolicy as JPolicy
from repro.core import types as jt
from repro.data.distributions import generate_instance
from repro_torch import ExternalPolicy

from faults_helpers import assert_same_run, kill, run_both

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _x(name, p, per):
    return generate_instance(name, p, per * p).astype(np.int32)


def _kills(port):
    return [(e.pe, e.tag) for e in port[1].trace.injected()
            if e.primitive == "fault:kill"]


def _lane(budget):
    return {"ref_cfg": {"external": JPolicy(budget=budget)},
            "port_cfg": {"external": ExternalPolicy(budget=budget)}}


def test_external_kill_during_merge_pass():
    ref, port = run_both(_x("Uniform", 8, 32), [kill(3, tag="ext:merge")],
                         p=8, algorithm="auto", **_lane(8))
    info = assert_same_run(ref, port)
    assert info["algorithm"] == "external"
    assert "external" not in info and "pass_seconds" not in info
    assert [a["algorithm"] for a in port[1].attempts] == ["external"] * 2
    assert _kills(port) == [(3, "ext:merge")]


def test_external_kill_during_exchange_pass():
    ref, port = run_both(_x("Staggered", 4, 32), [kill(1, tag="ext:pass1")],
                         p=4, algorithm="auto", **_lane(8))
    assert_same_run(ref, port)
    assert [tag for _, tag in _kills(port)] == ["ext:pass1"]


def test_rescale_crosses_into_external_regime():
    ref, port = run_both(_x("Uniform", 8, 16), [kill(2)], p=8,
                         algorithm="auto", **_lane(24))
    info = assert_same_run(ref, port)
    algos = [a["algorithm"] for a in port[1].attempts]
    assert algos[0] != "external" and algos[-1] == "external"
    assert info["fault"]["p_final"] == 4
