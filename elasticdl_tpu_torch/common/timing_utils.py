"""Opt-in wall-clock accounting per phase and profiler regions (port of
elasticdl_tpu/common/timing_utils.py).

``Timing`` accumulates seconds per named phase (the sparse trainer's
``sparse_pull``, ``sparse_push`` and ``batch_process``) when
``EDL_TIMING`` is set or ``enabled=True``; otherwise every call is a
no-op and nothing is measured. ``end_record_sync`` waits for the card
(``torch.cuda.synchronize``) before it stops the clock, so a phase that
launched asynchronous device work is charged its real duration. The
port keeps each phase's samples too, so ``summary()`` gives medians.

The metrics bridge: with metrics collection on, every phase also lands
in ``edl_phase_seconds{phase}`` and the step phase in
``edl_step_time_seconds``, as host time. Only ``EDL_TIMING`` waits for
the card: a metric must not change the step it measures.

``trace(name)`` is the reference's profiler region in its
``torch.profiler`` form: with ``EDL_PROFILE_DIR`` set, the region's
host activity (and the card's, where there is one) lands as a chrome
trace under ``EDL_PROFILE_DIR/<name>/`` (chrome://tracing, Perfetto or
TensorBoard's profile plugin read it), and ``step_annotation(name,
step)`` names a sub-region inside it. With the knob unset both are
no-ops.
"""

import contextlib
import os
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import metrics as obs_metrics

logger = _logger_factory("elasticdl_tpu_torch.common.timing_utils")

# the phase whose duration is "the step"
STEP_PHASE = "batch_process"
PROFILE_DIR_ENV = "EDL_PROFILE_DIR"


def _sync(result):
    """Wait for the card when ``result`` is a tensor on it."""
    if isinstance(result, torch.Tensor) and result.is_cuda:
        torch.cuda.synchronize(result.device)


class Timing:
    def __init__(self, enabled=None):
        if enabled is None:
            enabled = env_str("EDL_TIMING", "") not in ("", "0")
        self._enabled = bool(enabled)
        self._samples = {}  # phase -> [seconds, ...] since the last report
        # phase -> duration of the most recent record
        self.last_seconds = {}
        self._metrics_on = obs_metrics.metrics_enabled()
        if self._metrics_on:
            self._phase_hist = obs_metrics.histogram(
                "edl_phase_seconds",
                "Wall-clock per training-loop phase (timing_utils bridge)",
                ("phase",),
            )
            self._step_gauge = obs_metrics.gauge(
                "edl_step_time_seconds",
                "Duration of the most recent train step",
            )
        self._measure = self._enabled or self._metrics_on

    @property
    def enabled(self):
        return self._enabled

    def start(self):
        return time.monotonic() if self._measure else 0.0

    def end_record(self, phase, start):
        if not self._measure:
            return
        elapsed = time.monotonic() - start
        self.last_seconds[phase] = elapsed
        if self._metrics_on:
            self._phase_hist.labels(phase).observe(elapsed)
            if phase == STEP_PHASE:
                self._step_gauge.set(elapsed)
        if self._enabled:
            self._samples.setdefault(phase, []).append(elapsed)

    def end_record_sync(self, phase, start, result=None):
        """Wait for the card (when ``result`` is a CUDA tensor, and only
        under EDL_TIMING) before recording."""
        if not self._measure:
            return
        if self._enabled:
            _sync(result)
        self.end_record(phase, start)

    @contextlib.contextmanager
    def timeit(self, phase, sync_result=None):
        """Time a block; ``sync_result=lambda: x`` waits for the card
        on tensor ``x`` before the clock stops."""
        start = self.start()
        try:
            yield
        finally:
            if self._enabled and sync_result is not None:
                _sync(sync_result())
            self.end_record(phase, start)

    def summary(self):
        """{phase: {"seconds": total, "count": n, "median_ms": median}}
        over the samples since the last report."""
        return {
            phase: {
                "seconds": round(float(sum(samples)), 4),
                "count": len(samples),
                "median_ms": float(np.median(samples)) * 1e3,
            }
            for phase, samples in sorted(self._samples.items())
        }

    def report(self, context=""):
        """Log the summary and reset it."""
        if not self._enabled or not self._samples:
            return
        logger.info("Timing%s: %s",
                    " (%s)" % context if context else "", self.summary())
        self._samples.clear()


@contextlib.contextmanager
def trace(name="edl_train"):
    """``torch.profiler`` region -> ``EDL_PROFILE_DIR/<name>/``, one
    ``*.pt.trace.json`` per region, written when it closes. CPU activity
    always, CUDA activity when a card is present. Yields the profiler,
    or None when the knob is unset (a no-op)."""
    profile_dir = env_str(PROFILE_DIR_ENV, "")
    if not profile_dir:
        yield None
        return
    out = os.path.join(profile_dir, name)
    os.makedirs(out, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(out),
    ) as prof:
        yield prof


@contextlib.contextmanager
def step_annotation(name, step):
    """A named sub-region (``<name>#<step>``) inside a ``trace``; a no-op
    with ``EDL_PROFILE_DIR`` unset."""
    if not env_str(PROFILE_DIR_ENV, ""):
        yield
        return
    with torch.profiler.record_function("%s#%d" % (name, step)):
        yield
