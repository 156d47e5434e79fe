"""Shared pieces of the port's fault-lane tests (``test_torch_faults*.py``):
one fault plan built in both packages, ``psort`` with a ``FaultPolicy``
run through the reference (kernels off) and the port on the CPU on the
same numpy input, and the comparison of everything the lane returns, bit
for bit."""
import numpy as np

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import SortConfig as JConfig
from repro.core import comm as jc
from repro.core import psort as j_psort
from repro.runtime.failures import FaultPolicy as JPolicy
from repro_torch import SortConfig, psort
from repro_torch.core import comm as tc
from repro_torch.runtime import FaultPolicy

from torch_helpers import bits

# the reference's fast-lane algorithms (tests/test_faults.py)
ALGOS = ["gatherm", "allgatherm", "rfis", "rquick", "rams", "bitonic",
         "ssort"]


def kill(pe, tag=None, after=0):
    return ("kill_pe", (pe,), {"tag": tag, "after": after})


def delay(pe, factor=4.0, tag=None, after=0):
    return ("delay_pe", (pe,), {"factor": factor, "tag": tag,
                                "after": after})


def events(trace):
    """Every field of every event, in order."""
    return [(e.primitive, e.bytes, e.group_size, e.axis, e.tag, e.pe)
            for e in trace.events]


def policies(faults, **policy_kw):
    """The same plan as the reference's policy and the port's."""
    jp = JPolicy(plan=jc.FaultPlan(tuple(getattr(jc, k)(*a, **kw)
                                         for k, a, kw in faults)),
                 **policy_kw)
    tp = FaultPolicy(plan=tc.FaultPlan(tuple(getattr(tc, k)(*a, **kw)
                                             for k, a, kw in faults)),
                     **policy_kw)
    return jp, tp


def run_both(x, faults, policy_kw=None, ref_cfg=None, port_cfg=None,
             loggers=(None, None), **cfg):
    """``psort`` with the fault plan in both packages: ((out, info) or the
    error, policy) of the reference, then of the port on the CPU.
    ``ref_cfg``/``port_cfg`` are each package's own config values (its
    ``ExternalPolicy``, its ``CostModel``); ``loggers`` each policy's."""
    jp, tp = policies(faults, **(policy_kw or {}))
    jp.logger, tp.logger = loggers
    runs = []
    for fn, conf, pol, own, kw in (
            (j_psort, JConfig, jp, dict(ref_cfg or {}, backend="sim"), {}),
            (psort, SortConfig, tp, port_cfg or {}, {"device": "cpu"})):
        try:
            out = fn(x, config=conf(fault_policy=pol, **own, **cfg),
                     return_info=True, **kw)
        except Exception as e:  # noqa: BLE001 — compared with the other's
            out = e
        runs.append((out, pol))
    return runs


def assert_same_run(ref, port):
    """Output, counts, overflow, perm, ``info["fault"]``, the attempts and
    every trace event equal; the same info keys."""
    (want, jp), (got, tp) = ref, port
    assert not isinstance(want, Exception), want
    assert not isinstance(got, Exception), got
    (wo, wi), (go, gi) = want, got
    assert np.array_equal(bits(go), bits(np.asarray(wo)))
    assert np.array_equal(np.asarray(gi["counts"]), np.asarray(wi["counts"]))
    assert gi["overflow"] == wi["overflow"]
    assert np.array_equal(np.asarray(gi["perm"]),
                          np.asarray(wi["perm"]).astype(np.int64))
    assert gi["balance"] == float(wi["balance"])
    assert gi["algorithm"] == wi["algorithm"]
    assert gi["mesh_shape"] == wi["mesh_shape"]
    assert gi["fault"] == wi["fault"]
    assert tp.attempts == jp.attempts
    assert events(tp.trace) == events(jp.trace)
    assert gi["comm_trace"] is tp.trace
    assert sorted(gi) == sorted(wi)
    return gi


def assert_same_error(ref, port, ref_type, port_type=None):
    """Both runs raised (the port ``port_type``, default the reference's
    type), with the same attempts and trace events."""
    (want, jp), (got, tp) = ref, port
    assert isinstance(want, ref_type), want
    assert isinstance(got, port_type or ref_type), got
    assert tp.attempts == jp.attempts
    assert events(tp.trace) == events(jp.trace)
    return got
