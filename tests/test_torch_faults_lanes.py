"""The port's fault lane against the reference's on its other layouts, bit
for bit: nested meshes (a kill keeps the inner axis; every stage of a
decomposed collective is a launch that counts toward ``after``), the
streamed exchange (a stream is one launch, however many chunk events it
records; on a nested mesh the barrier fallback's stages are), batched
rows, and the rescale past RAMS's capacity limit, which fails in both
packages (the reference's ``AssertionError``, the port's ``ValueError``).
The external lane's cases are in ``test_torch_faults_external.py``.
Compared as in ``test_torch_faults.py``: output, ``counts``,
``overflow``, ``perm``, ``info["fault"]``, ``policy.attempts`` and every
trace event, with tolerance 0.
"""
import numpy as np
import pytest

from repro.core import types as jt
from repro.data.distributions import generate_instance

from faults_helpers import (assert_same_error, assert_same_run, delay, kill,
                            run_both)

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def kernels_off():
    prev = jt.set_local_kernels(jt.LocalKernelPolicy())
    yield
    jt.set_local_kernels(prev)


def _x(name, p, per, dtype=np.int32):
    return generate_instance(name, p, per * p).astype(dtype)


def _kills(port):
    return [(e.pe, e.tag, e.axis) for e in port[1].trace.injected()
            if e.primitive == "fault:kill"]


def test_nested_mesh_kill_preserves_inner_axis():
    ref, port = run_both(_x("Uniform", 8, 64), [kill(5)], mesh_shape=(2, 4),
                         algorithm="rams")
    info = assert_same_run(ref, port)
    assert [a["mesh_shape"] for a in port[1].attempts] == [(2, 4), (1, 4)]
    assert info["mesh_shape"] == (1, 4)


@pytest.mark.parametrize("after", [1, 3, 6])
def test_nested_after_counts_every_stage(after):
    """Each real-axis stage of a nested collective is one launch: the
    (after + 1)-th stage kills, on that stage's axis."""
    ref, port = run_both(_x("Uniform", 8, 64), [kill(5, after=after)],
                         mesh_shape=(2, 4), algorithm="rams")
    assert_same_run(ref, port)
    assert len(_kills(port)) == 1


@pytest.mark.parametrize("algorithm,tag,after", [
    ("rams", "level0", 2), ("rams", "shuffle", 0), ("ssort", None, 2)])
def test_overlap_stream_is_one_launch(algorithm, tag, after):
    """A streamed exchange is one injection point before its chunk
    events (flat), the barrier fallback's stages on a nested mesh."""
    for layout in ({"p": 8}, {"mesh_shape": (2, 4)}):
        ref, port = run_both(_x("Uniform", 8, 64),
                             [kill(5, tag=tag, after=after)], overlap=True,
                             algorithm=algorithm, **layout)
        assert_same_run(ref, port)
        assert len(_kills(port)) == 1


def test_batched_rows_survive_fault():
    r = np.random.default_rng(3)
    xs = r.integers(0, 1 << 20, size=(3, 16 * 4)).astype(np.int32)
    ref, port = run_both(xs, [kill(1)], p=4, algorithm="rquick")
    info = assert_same_run(ref, port)
    assert info["fault"]["p_final"] == 2


def test_batched_kill_counts_each_call_once():
    """A collective of d batched sorts is one launch, whatever d is."""
    x = _x("Uniform", 8, 64)
    ref, port = run_both(np.stack([x, x[::-1], x // 3]),
                         [kill(6, tag="level0", after=1),
                          delay(2, factor=8.0)], p=8, algorithm="rams")
    assert_same_run(ref, port)
    assert [a["p"] for a in port[1].attempts] == [8, 4, 2]


def test_rescale_past_rams_capacity_fails_as_the_reference():
    """p = 2, n = 2^19: the rescale to p = 1 needs a capacity of 2^20,
    which RAMS refuses (the RAMS cell's p = 256 → 128 case, small)."""
    ref, port = run_both(_x("Uniform", 2, 1 << 18, np.uint32),
                         [kill(1, tag="level0")], p=2, algorithm="rams")
    err = assert_same_error(ref, port, AssertionError, ValueError)
    assert "capacity < 2^20" in str(err)
    assert [(a["p"], a["ok"]) for a in port[1].attempts] == [(2, False),
                                                            (1, False)]
