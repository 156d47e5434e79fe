"""Failure recovery and straggler mitigation (a copy of the reference's
``repro/runtime/failures.py``, which is plain Python and numpy).

``run_with_restarts`` is the crash-recovery loop: it runs a function and,
on a retryable exception, restarts it — classically from the latest
committed checkpoint (the launcher-side training loop, combined with the
deterministic per-step data pipeline this gives exactly-once step
semantics modulo the steps since the last checkpoint), but the loop is
generic: ``psort``'s fault-tolerance lane (``repro_torch/core/api.py``)
drives it with ``retry_on=(PEFailure,)`` and an ``on_failure`` hook that
rescales the sort mesh between attempts.  Two give-up conditions bound the retries: the
``max_restarts`` budget, and *no progress between consecutive restarts*
(a crash that destroys checkpoint progress would otherwise burn the whole
budget replaying the same failure).

``StepWatchdog`` is the straggler detector: it tracks a robust step-time
estimate (median + MAD over the last 100 steps) and flags steps exceeding
``k_mad`` deviations — the signal a deployment uses to trigger re-dispatch
of a slow host's shard or to exclude a failing node at the next elastic
restart.  :func:`flag_stragglers` applies it to one round of per-PE step
times (the psort fault lane: a delayed PE past ``k_mad`` goes down the
same exclude-and-rescale path as a dead one).

``FaultPolicy`` is the user-facing configuration of that lane: the
:class:`repro_torch.core.comm.FaultPlan` to execute, the retry budget,
and the watchdog thresholds; after a run ``psort`` leaves the merged
``CommTrace`` on ``policy.trace`` and a per-attempt log on
``policy.attempts``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class StepWatchdog:
    """Median + MAD straggler detector over a sliding 100-step window.

    ``observe(step, dt)`` returns True when ``dt`` exceeds the window
    median by ``k_mad`` MADs *and* by 50 % — the double guard keeps a
    constant-rate stream (MAD ≈ 0) from flagging on noise.  The first
    ``warmup`` observations build history and never flag; the window
    holds the most recent 100 durations, so a regime change (deliberate
    slowdown, different batch shape) stops flagging once the window
    refills.
    """

    def __init__(self, k_mad: float = 6.0, warmup: int = 5):
        self.times: List[float] = []
        self.k_mad = k_mad
        self.warmup = warmup
        self.flagged: List[int] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int, *, now: Optional[float] = None) -> bool:
        """Record step duration; returns True when flagged as straggler.

        Each ``stop`` consumes the preceding :meth:`start` — calling it
        without one is a usage bug and raises instead of a bare
        ``TypeError`` on the ``None`` arithmetic.
        """
        if self._t0 is None:
            raise RuntimeError(
                "StepWatchdog.stop() called without a matching start(); "
                "call start() at the beginning of the step being timed")
        dt = (now if now is not None else time.perf_counter()) - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> bool:
        hist = self.times[-100:]
        self.times.append(dt)
        if len(hist) < self.warmup:
            return False
        med = sorted(hist)[len(hist) // 2]
        mad = sorted(abs(t - med) for t in hist)[len(hist) // 2] + 1e-9
        if dt > med + self.k_mad * mad and dt > 1.5 * med:
            self.flagged.append(step)
            return True
        return False


def flag_stragglers(step_times: Sequence[float], *, k_mad: float = 6.0,
                    warmup: int = 5) -> List[int]:
    """Indices of straggling entries in one round of per-PE step times.

    Drives the ``psort`` fault lane: a :class:`StepWatchdog` is warmed on
    the round's median (so a single round suffices), then each PE's time
    is observed in rank order — a PE stretched past ``k_mad`` MADs flags,
    a constant round never does.
    """
    times = [float(t) for t in step_times]
    if not times:
        return []
    wd = StepWatchdog(k_mad=k_mad, warmup=warmup)
    med = float(np.median(times))
    for _ in range(max(1, wd.warmup)):
        wd.observe(-1, med)
    return [i for i, dt in enumerate(times) if wd.observe(i, dt)]


@dataclasses.dataclass
class FaultPolicy:
    """Configuration of ``psort(..., fault_policy=...)`` (core/api.py).

    ``plan`` is the :class:`repro_torch.core.comm.FaultPlan` executed by
    :class:`repro_torch.core.comm.FaultyCollectives` while each attempt
    runs; ``max_restarts`` bounds the exclude-and-rescale retries;
    ``k_mad`` / ``warmup`` / ``base_step_time`` parameterize the
    straggler lane (per-PE simulated step times are ``base_step_time``
    stretched by the fired delay factors, scanned by
    :func:`flag_stragglers`).

    ``psort`` writes results back: ``trace`` holds the merged
    ``CommTrace`` across attempts (injected events + regular launches +
    ``rescale`` markers), ``attempts`` one dict per attempt with the
    topology and algorithm it ran.  Use a fresh policy (or at least a
    fresh ``trace``) per ``psort`` call.
    """

    plan: Any = None                     # comm.FaultPlan (duck-typed)
    max_restarts: int = 3
    k_mad: float = 6.0
    warmup: int = 5
    base_step_time: float = 1.0
    logger: Optional[Callable] = None
    trace: Any = None                    # comm.CommTrace, set by psort
    attempts: List[Dict] = dataclasses.field(default_factory=list)


def run_with_restarts(train_fn: Callable[[int], Any], *, ckpt_manager=None,
                      max_restarts: int = 3, logger=print,
                      retry_on=(Exception,),
                      on_failure: Optional[Callable] = None,
                      progress_fn: Optional[Callable[[], Any]] = None):
    """Run ``train_fn(start) -> result`` with bounded crash recovery.

    ``train_fn`` receives the current progress marker (the latest
    committed checkpoint step when ``ckpt_manager`` is given, else the
    attempt index) and must be resumable from it.  Retries are bounded
    two ways:

      * ``max_restarts`` — the overall budget;
      * **no progress between consecutive restarts** — when the progress
        marker (default ``ckpt_manager.latest_step()``) did not advance
        since the previous failure, retrying would replay the identical
        crash, so the loop gives up early and re-raises.

    ``retry_on`` restricts which exceptions trigger recovery (anything
    else propagates immediately); ``on_failure(exc, restarts)`` runs
    before each retry — the elastic hook where ``psort`` re-plans its
    topology (``repro_torch.runtime.elastic.plan_sort_rescale``).  The final
    re-raise is logged as a give-up, never as another "restart N/max".
    """
    if progress_fn is None and ckpt_manager is not None:
        progress_fn = lambda: (ckpt_manager.latest_step() or 0)  # noqa: E731
    restarts = 0
    prev_progress = None
    while True:
        start = progress_fn() if progress_fn is not None else restarts
        try:
            return train_fn(start)
        except KeyboardInterrupt:
            raise
        except retry_on as e:  # noqa: BLE001 — retry_on scopes the recovery
            restarts += 1
            progress = progress_fn() if progress_fn is not None else None
            if restarts > max_restarts:
                logger(f"[failures] giving up after {max_restarts} "
                       f"restart(s) ({type(e).__name__}: {e})")
                raise
            if prev_progress is not None and progress is not None \
                    and progress <= prev_progress:
                logger(f"[failures] no progress between restarts (stuck at "
                       f"{progress}); giving up ({type(e).__name__}: {e})")
                raise
            prev_progress = progress
            logger(f"[failures] step crashed ({type(e).__name__}: {e}); "
                   f"restart {restarts}/{max_restarts} from "
                   f"{progress if progress is not None else start}")
            if on_failure is not None:
                on_failure(e, restarts)
