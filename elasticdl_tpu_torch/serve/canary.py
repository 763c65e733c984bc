"""Canary rollout judge for the serving fleet (port of
elasticdl_tpu/serve/canary.py).

New export versions do not hit the whole tier at once: the router's
``CanaryController`` notices a fresh export bundle (replicas report the
newest complete bundle in their heartbeats), directs a canary subset of
replicas to load it, and slices ``EDL_CANARY_FRACTION`` of traffic onto
that subset by affinity-key hash. While the canary runs, the router
attributes every response to the model stamp that actually served it
(``PredictResponse.model_stamp``, correct even mid-swap) and keeps two
``PredictionStats`` books, canary and incumbent, over the same window.

Once both arms saw ``EDL_CANARY_MIN_REQUESTS`` requests the judge
compares their prediction distributions by total-variation distance:

- **promote** -- TV distance within ``EDL_CANARY_DRIFT_MAX`` and the
  canary's error+shed rate no worse than the incumbent's (plus a small
  absolute slack): every replica is directed to the new export and it
  becomes the incumbent (new joiners load it at register time).
- **rollback** -- otherwise: canary members are directed back to the
  incumbent export and the rejected stamp is never retried (a newer
  export clears the way again).
- a canary that cannot reach the verdict inside
  ``EDL_CANARY_TIMEOUT_SECS`` rolls back too ("timeout" reason).

Every transition is journaled (``canary_started`` / ``canary_promoted``
/ ``canary_rolled_back``) with the measured numbers as reasons, and
counted in ``edl_serve_canary_total{outcome}``.
"""

import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_float, env_int
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as obs_metrics

logger = _logger_factory("elasticdl_tpu_torch.serve.canary")

CANARY_FRACTION_ENV = "EDL_CANARY_FRACTION"
CANARY_MIN_REQUESTS_ENV = "EDL_CANARY_MIN_REQUESTS"
CANARY_DRIFT_MAX_ENV = "EDL_CANARY_DRIFT_MAX"
CANARY_TIMEOUT_ENV = "EDL_CANARY_TIMEOUT_SECS"

# absolute slack on the error-rate comparison: a canary may be this
# much worse than the incumbent before the judge calls it a regression
# (two error-free arms should not flip on one unlucky shed)
_ERROR_SLACK = 0.02

_BINS = 10
# the traffic slice is cut on this many hash buckets, so the fraction
# resolves to 1/10000 granularity
_SLICE_BUCKETS = 10000


class PredictionStats:
    """One arm's book: prediction-score histogram + outcome tallies.

    Scores are the per-request mean predicted value clipped to [0, 1]
    (CTR-style models emit probabilities; anything else still lands in
    a comparable bucket). Thread-safe: the router's worker threads feed
    it concurrently.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._bins = [0] * _BINS
        self._sum = 0.0
        self._predictions = 0
        self._outcomes = {}  # outcome -> count

    def observe_prediction(self, value):
        v = min(1.0, max(0.0, float(value)))
        idx = min(_BINS - 1, int(v * _BINS))
        with self._lock:
            self._bins[idx] += 1
            self._sum += v
            self._predictions += 1

    def observe_outcome(self, outcome):
        with self._lock:
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1

    @property
    def predictions(self):
        with self._lock:
            return self._predictions

    def distribution(self):
        with self._lock:
            total = self._predictions
            if total == 0:
                return [0.0] * _BINS
            return [b / total for b in self._bins]

    def mean(self):
        with self._lock:
            if self._predictions == 0:
                return 0.0
            return self._sum / self._predictions

    def failure_rate(self):
        """(errors + sheds) / all outcomes — the canary must not buy a
        drifted model OR a slower one that sheds."""
        with self._lock:
            total = sum(self._outcomes.values())
            if total == 0:
                return 0.0
            bad = sum(
                n for o, n in self._outcomes.items() if o != "ok"
            )
            return bad / total

    def snapshot(self):
        with self._lock:
            return {
                "predictions": self._predictions,
                "mean": round(self._sum / self._predictions, 4)
                if self._predictions else 0.0,
                "outcomes": dict(self._outcomes),
            }


def total_variation(p, q):
    """TV distance between two discrete distributions: 0 identical,
    1 disjoint. The promote gate is ``tv <= EDL_CANARY_DRIFT_MAX``."""
    return 0.5 * sum(abs(a - b) for a, b in zip(p, q))


class CanaryController:
    """The rollout state machine: idle -> canary -> promote/rollback."""

    def __init__(self, registry, fraction=None, min_requests=None,
                 drift_max=None, timeout_secs=None):
        self._registry = registry
        self._fraction = min(1.0, max(0.0, (
            fraction
            if fraction is not None
            else env_float(CANARY_FRACTION_ENV, 0.25)
        )))
        self._min_requests = max(1, (
            min_requests
            if min_requests is not None
            else env_int(CANARY_MIN_REQUESTS_ENV, 200)
        ))
        self._drift_max = (
            drift_max
            if drift_max is not None
            else env_float(CANARY_DRIFT_MAX_ENV, 0.25)
        )
        self._timeout = (
            timeout_secs
            if timeout_secs is not None
            else env_float(CANARY_TIMEOUT_ENV, 120.0)
        )
        self._lock = threading.Lock()
        self._state = "idle"
        self._incumbent_export = ""
        self._incumbent_stamp = ""
        self._canary_export = ""
        self._canary_stamp = ""
        self._members = []
        self._started_at = 0.0
        self._rejected = set()  # stamps that rolled back; never retried
        self._incumbent_stats = PredictionStats()
        self._canary_stats = PredictionStats()
        self._m_cycles = obs_metrics.counter(
            "edl_serve_canary_total",
            "Canary rollout transitions", ("outcome",),
        )
        for outcome in ("started", "promoted", "rolled_back"):
            self._m_cycles.labels(outcome=outcome)

    # -- data-plane feed -----------------------------------------------
    def assign_arm(self, key_hash):
        """Which arm serves this request: the canary subset takes the
        ``EDL_CANARY_FRACTION`` slice of the key space (stable per key:
        a user either IS in the canary or is not — flapping between
        arms would blur both books). Answers "incumbent" whenever no
        canary runs."""
        with self._lock:
            if self._state != "canary":
                return "incumbent"
            slice_width = int(self._fraction * _SLICE_BUCKETS)
            if key_hash % _SLICE_BUCKETS < slice_width:
                return "canary"
            return "incumbent"

    def canary_members(self):
        with self._lock:
            return list(self._members)

    def active(self):
        with self._lock:
            return self._state == "canary"

    def note_result(self, stamp, mean_prediction, outcome):
        """Attribute one response to the arm whose model served it —
        by the RESPONSE's stamp, not by which replica answered, so a
        canary member still mid-swap books under the incumbent."""
        with self._lock:
            if self._state != "canary":
                return
            if stamp == self._canary_stamp:
                book = self._canary_stats
            elif stamp == self._incumbent_stamp:
                book = self._incumbent_stats
            else:
                return
        book.observe_outcome(outcome)
        if mean_prediction is not None and outcome == "ok":
            book.observe_prediction(mean_prediction)

    # -- control loop ---------------------------------------------------
    def tick(self, now=None):
        """One pass on the router's 1 Hz tick. Never raises."""
        try:
            self._tick(time.time() if now is None else now)
        except Exception:
            logger.exception("canary tick failed")

    def _tick(self, now):
        with self._lock:
            state = self._state
        if state == "idle":
            self._maybe_adopt_incumbent()
            self._maybe_start(now)
        else:
            self._maybe_judge(now)

    def state(self):
        """JSON-ready /statusz section."""
        with self._lock:
            return {
                "state": self._state,
                "incumbent": {
                    "export": self._incumbent_export,
                    "stamp": self._incumbent_stamp,
                },
                "canary": {
                    "export": self._canary_export,
                    "stamp": self._canary_stamp,
                    "members": list(self._members),
                    "fraction": self._fraction,
                },
                "books": {
                    "incumbent": self._incumbent_stats.snapshot(),
                    "canary": self._canary_stats.snapshot(),
                },
                "rejected": sorted(self._rejected),
            }

    # -- internals ------------------------------------------------------
    def _maybe_adopt_incumbent(self):
        """Bootstrap: before any rollout the incumbent is whatever the
        fleet already runs — the export most replicas report loaded."""
        with self._lock:
            if self._incumbent_stamp:
                return
        votes = {}  # (export, stamp) -> count
        for rid in self._registry.routable_ids():
            entry = self._registry.get(rid)
            # loaded_export only arrives with the first heartbeat
            # (register carries the stamp alone) — a nameless vote
            # would adopt an incumbent no replica can be directed to
            if (entry is None or not entry.loaded_stamp
                    or not entry.loaded_export):
                continue
            key = (entry.loaded_export, entry.loaded_stamp)
            votes[key] = votes.get(key, 0) + 1
        if not votes:
            return
        (export, stamp), _ = max(votes.items(), key=lambda kv: kv[1])
        with self._lock:
            if self._incumbent_stamp:
                return
            self._incumbent_export = export
            self._incumbent_stamp = stamp
        self._registry.set_default_target(export)
        # pin the whole fleet: before the adopt, directed replicas
        # bootstrap onto "newest available" — from here on every
        # version move goes through the canary state machine
        self._registry.set_target(self._registry.live_ids(), export)
        logger.info(
            "canary: adopted incumbent %r (stamp %s)", export, stamp
        )

    def _maybe_start(self, now):
        with self._lock:
            if not self._incumbent_stamp:
                return
            incumbent_stamp = self._incumbent_stamp
            rejected = set(self._rejected)
        # the newest complete bundle any routable replica can see that
        # is neither the incumbent nor a rejected stamp
        candidate = None  # (step, export, stamp)
        for rid in self._registry.routable_ids():
            entry = self._registry.get(rid)
            if entry is None or not entry.available_stamp:
                continue
            stamp = entry.available_stamp
            if stamp == incumbent_stamp or stamp in rejected:
                continue
            step = int(stamp.split(":", 1)[0])
            if candidate is None or step > candidate[0]:
                candidate = (step, entry.available_export, stamp)
        if candidate is None:
            return
        _, export, stamp = candidate
        routable = self._registry.routable_ids()
        if not routable:
            return
        members = sorted(routable)[
            : max(1, round(self._fraction * len(routable)))
        ]
        with self._lock:
            self._state = "canary"
            self._canary_export = export
            self._canary_stamp = stamp
            self._members = members
            self._started_at = now
            self._incumbent_stats = PredictionStats()
            self._canary_stats = PredictionStats()
        self._registry.set_target(members, export, canary=True)
        self._m_cycles.labels(outcome="started").inc()
        logger.info(
            "canary started: export %r (stamp %s) on %s, %.0f%% of "
            "traffic", export, stamp, members, self._fraction * 100,
        )
        events.emit(
            "canary_started", export=export, stamp=stamp,
            members=members, fraction=self._fraction,
        )

    def _maybe_judge(self, now):
        with self._lock:
            canary_n = self._canary_stats.predictions
            incumbent_n = self._incumbent_stats.predictions
            waited = now - self._started_at
        if waited > self._timeout and (
            canary_n < self._min_requests
            or incumbent_n < self._min_requests
        ):
            self._rollback([
                "timeout: %d canary / %d incumbent requests after "
                "%.0fs < %d minimum"
                % (canary_n, incumbent_n, waited, self._min_requests),
            ])
            return
        if canary_n < self._min_requests or (
            incumbent_n < self._min_requests
        ):
            return
        tv = total_variation(
            self._canary_stats.distribution(),
            self._incumbent_stats.distribution(),
        )
        fail_c = self._canary_stats.failure_rate()
        fail_i = self._incumbent_stats.failure_rate()
        measured = (
            "tv=%.3f (max %.3f), failure %.3f vs incumbent %.3f, "
            "mean %.4f vs %.4f over %d/%d requests"
            % (tv, self._drift_max, fail_c, fail_i,
               self._canary_stats.mean(), self._incumbent_stats.mean(),
               canary_n, incumbent_n)
        )
        reasons = []
        if tv > self._drift_max:
            reasons.append("prediction drift: " + measured)
        if fail_c > fail_i + _ERROR_SLACK:
            reasons.append("failure regression: " + measured)
        if reasons:
            self._rollback(reasons)
        else:
            self._promote(["healthy: " + measured])

    def _promote(self, reasons):
        with self._lock:
            export = self._canary_export
            stamp = self._canary_stamp
            self._incumbent_export = export
            self._incumbent_stamp = stamp
            self._state = "idle"
            members = self._members
            self._members = []
            self._canary_export = ""
            self._canary_stamp = ""
        self._registry.set_target(
            self._registry.live_ids(), export, canary=False
        )
        self._registry.set_default_target(export)
        self._m_cycles.labels(outcome="promoted").inc()
        logger.info("canary promoted: %r — %s", export,
                    "; ".join(reasons))
        events.emit(
            "canary_promoted", export=export, stamp=stamp,
            members=members, reasons=reasons,
        )

    def _rollback(self, reasons):
        with self._lock:
            export = self._canary_export
            stamp = self._canary_stamp
            incumbent = self._incumbent_export
            members = self._members
            self._rejected.add(stamp)
            self._state = "idle"
            self._members = []
            self._canary_export = ""
            self._canary_stamp = ""
        self._registry.set_target(members, incumbent, canary=False)
        self._m_cycles.labels(outcome="rolled_back").inc()
        logger.warning("canary rolled back: %r — %s", export,
                       "; ".join(reasons))
        events.emit(
            "canary_rolled_back", export=export, stamp=stamp,
            members=members, reasons=reasons,
        )
