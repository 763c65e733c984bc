"""Training-health sentinels: numerics watchdogs over the train step
(port of elasticdl_tpu/train/health.py).

The train step also returns cheap scalars -- the masked loss, the global
gradient L2 norm and a nonfinite flag -- and the trainer feeds them into
a :class:`HealthTracker` with the JAX package's decisions:

- **loss spike**    -- robust z-score of the loss against its own EWMA
  (the deviation scale is an EWMA of absolute deviation).
- **grad explosion**-- global grad norm beyond an absolute ceiling
  (``EDL_HEALTH_GRAD_NORM_MAX``) or a multiple of its own EWMA
  (``EDL_HEALTH_GRAD_FACTOR``).
- **nonfinite**     -- NaN/Inf loss or gradients, tracked as a
  cumulative count and a consecutive streak.

Nonfinite batches trigger the configured action
(``EDL_HEALTH_ON_NONFINITE``): ``alert`` (default: record and warn;
training is unchanged), ``skip`` (the step keeps the previous state, so
the batch contributes nothing) or ``halt`` (raise
:class:`HealthSentinelError`). ``EDL_HEALTH=0`` disables it all: the
step returns no extra outputs and no tracker is built.

Each detection is journaled (``health_loss_spike``,
``health_grad_explosion``, ``health_nonfinite`` at a streak's start,
``health_halt``) and counted in the ``edl_worker_*`` health series.
"""

import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_float, env_int, env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as obs_metrics

logger = _logger_factory("elasticdl_tpu_torch.train.health")

HEALTH_ENV = "EDL_HEALTH"
ON_NONFINITE_ENV = "EDL_HEALTH_ON_NONFINITE"
SPIKE_Z_ENV = "EDL_HEALTH_SPIKE_Z"
GRAD_NORM_MAX_ENV = "EDL_HEALTH_GRAD_NORM_MAX"
GRAD_FACTOR_ENV = "EDL_HEALTH_GRAD_FACTOR"
WARMUP_STEPS_ENV = "EDL_HEALTH_WARMUP_STEPS"

ACTIONS = ("alert", "skip", "halt")

GRAD_NORM_KEY = "grad_norm"
NONFINITE_KEY = "nonfinite"


def health_enabled():
    """EDL_HEALTH gate: default on; ``0`` disables."""
    return env_str(HEALTH_ENV, "").strip() != "0"


def nonfinite_action():
    """The action for a nonfinite batch; misconfiguration fails at
    construction time, not mid-job."""
    raw = env_str(ON_NONFINITE_ENV, "").strip().lower()
    if not raw:
        return "alert"
    if raw not in ACTIONS:
        raise ValueError(
            "unknown %s=%r (expected one of %s)"
            % (ON_NONFINITE_ENV, raw, "/".join(ACTIONS))
        )
    return raw


class HealthSentinelError(RuntimeError):
    """EDL_HEALTH_ON_NONFINITE=halt tripped: the task must fail loudly."""


class HealthTracker:
    """Per-trainer numerics watchdog over the step's health scalars.

    ``observe(loss, grad_norm, nonfinite)`` folds one finished batch in
    and returns ``None`` (healthy or alert-only) or ``"skip"`` (the step
    kept the previous state), or raises ``HealthSentinelError`` under
    ``halt``. The detection state is EWMAs: O(1) a batch, no history.
    """

    def __init__(self, action=None, spike_z=None, grad_norm_max=None,
                 grad_factor=None, warmup_steps=None, role=""):
        self.action = action if action is not None else nonfinite_action()
        if self.action not in ACTIONS:
            raise ValueError("unknown health action %r" % (self.action,))
        self.spike_z = (
            spike_z if spike_z is not None
            else env_float(SPIKE_Z_ENV, 8.0)
        )
        # absolute grad-norm ceiling; 0 disables the absolute check
        self.grad_norm_max = (
            grad_norm_max if grad_norm_max is not None
            else env_float(GRAD_NORM_MAX_ENV, 0.0)
        )
        self.grad_factor = (
            grad_factor if grad_factor is not None
            else env_float(GRAD_FACTOR_ENV, 50.0)
        )
        # spike/explosion detection engages only past the warmup
        self.warmup_steps = (
            warmup_steps if warmup_steps is not None
            else env_int(WARMUP_STEPS_ENV, 20)
        )
        self.role = role
        self._lock = threading.Lock()
        self.samples = 0
        self.loss_ewma = 0.0
        self.loss_dev_ewma = 0.0
        self.loss_last = 0.0
        self.grad_norm_ewma = 0.0
        self.grad_norm_last = 0.0
        self.nonfinite_total = 0
        self.nonfinite_streak = 0
        self.loss_spikes = 0
        self.grad_explosions = 0
        self.skipped_batches = 0
        self.last_nonfinite_ts = 0.0
        # counters (no-ops when metrics are off); the loss and norm
        # gauges read straight off the tracker's fields
        self._m_nonfinite = obs_metrics.counter(
            "edl_worker_nonfinite_batches_total",
            "Batches whose loss or gradients were NaN/Inf",
        )
        self._m_spikes = obs_metrics.counter(
            "edl_worker_loss_spikes_total",
            "Loss spikes beyond the robust z threshold",
        )
        self._m_explosions = obs_metrics.counter(
            "edl_worker_grad_explosions_total",
            "Global grad-norm explosions beyond the ceiling",
        )
        self._m_skipped = obs_metrics.counter(
            "edl_worker_health_skipped_batches_total",
            "Nonfinite batches dropped under the skip sentinel",
        )
        obs_metrics.gauge(
            "edl_worker_loss_ewma", "Loss EWMA the spike detector tracks"
        ).set_function(lambda: self.loss_ewma)
        obs_metrics.gauge(
            "edl_worker_grad_norm",
            "Global gradient L2 norm, last finished batch",
        ).set_function(lambda: self.grad_norm_last)

    def observe(self, loss, grad_norm, nonfinite):
        """Fold one batch's health scalars; returns None or "skip", or
        raises HealthSentinelError (halt)."""
        loss = float(loss)
        grad_norm = float(grad_norm)
        nonfinite = bool(nonfinite)
        spiked = exploded = False
        with self._lock:
            if nonfinite:
                self.nonfinite_total += 1
                self.nonfinite_streak += 1
                self.last_nonfinite_ts = time.time()
                # the last-seen values show the NaN itself; the EWMAs
                # exclude nonfinite samples (a NaN would wedge them)
                self.loss_last = loss
                self.grad_norm_last = grad_norm
            else:
                self.nonfinite_streak = 0
                self.samples += 1
                past_warmup = self.samples > self.warmup_steps
                deviation = abs(loss - self.loss_ewma)
                if (
                    past_warmup
                    and self.spike_z > 0
                    and deviation > self.spike_z * max(
                        self.loss_dev_ewma, 1e-8
                    )
                ):
                    spiked = True
                    self.loss_spikes += 1
                if past_warmup and (
                    (self.grad_norm_max > 0
                     and grad_norm > self.grad_norm_max)
                    or (self.grad_factor > 0
                        and self.grad_norm_ewma > 0
                        and grad_norm > self.grad_factor
                        * self.grad_norm_ewma)
                ):
                    exploded = True
                    self.grad_explosions += 1
                if self.samples == 1:
                    self.loss_ewma = loss
                    self.grad_norm_ewma = grad_norm
                else:
                    self.loss_ewma = 0.9 * self.loss_ewma + 0.1 * loss
                    self.loss_dev_ewma = (
                        0.9 * self.loss_dev_ewma + 0.1 * deviation
                    )
                    self.grad_norm_ewma = (
                        0.9 * self.grad_norm_ewma + 0.1 * grad_norm
                    )
                self.loss_last = loss
                self.grad_norm_last = grad_norm
            streak = self.nonfinite_streak
        # edge-triggered side effects outside the lock (journal IO)
        if spiked:
            self._m_spikes.inc()
            logger.warning(
                "loss spike: %.6g vs ewma %.6g (dev scale %.3g)",
                loss, self.loss_ewma, self.loss_dev_ewma,
            )
            # no role kwarg: events.emit stamps the process's role
            events.emit(
                "health_loss_spike",
                loss=round(loss, 6), ewma=round(self.loss_ewma, 6),
            )
        if exploded:
            self._m_explosions.inc()
            logger.warning(
                "grad-norm explosion: %.6g (ewma %.6g, ceiling "
                "max=%g factor=%g)", grad_norm, self.grad_norm_ewma,
                self.grad_norm_max, self.grad_factor,
            )
            events.emit(
                "health_grad_explosion",
                grad_norm=round(grad_norm, 6),
                ewma=round(self.grad_norm_ewma, 6),
            )
        if not nonfinite:
            return None
        self._m_nonfinite.inc()
        if streak == 1:
            # the streak's edge, not every step of a stuck run
            events.emit(
                "health_nonfinite",
                loss=repr(loss), grad_norm=repr(grad_norm),
                action=self.action,
            )
        logger.warning(
            "nonfinite batch (loss=%r grad_norm=%r, streak %d); "
            "sentinel action=%s", loss, grad_norm, streak, self.action,
        )
        if self.action == "halt":
            events.emit(
                "health_halt", loss=repr(loss),
                grad_norm=repr(grad_norm), streak=streak,
            )
            events.flush()
            raise HealthSentinelError(
                "nonfinite loss/gradients (loss=%r grad_norm=%r); "
                "%s=halt -- failing the task loudly"
                % (loss, grad_norm, ON_NONFINITE_ENV)
            )
        if self.action == "skip":
            self._m_skipped.inc()
            with self._lock:
                self.skipped_batches += 1
            return "skip"
        return None

    def stats(self):
        """Telemetry snapshot."""
        with self._lock:
            return {
                "loss_ewma": self.loss_ewma,
                "loss_last": self.loss_last,
                "grad_norm": self.grad_norm_last,
                "nonfinite_batches": self.nonfinite_total,
                "nonfinite_streak": self.nonfinite_streak,
                "loss_spikes": self.loss_spikes,
                "grad_explosions": self.grad_explosions,
                "skipped_batches": self.skipped_batches,
            }


def maybe_tracker(role=""):
    """HealthTracker per the env knobs, or None under EDL_HEALTH=0."""
    if not health_enabled():
        return None
    return HealthTracker(role=role)
