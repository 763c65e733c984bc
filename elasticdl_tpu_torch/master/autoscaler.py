"""Elasticity control loop: the ``ElasticController``, the graceful
drain and the autoscaler hysteresis (port of
elasticdl_tpu/master/autoscaler.py).

``ElasticController`` reads the dispatcher's queue and the fleet
monitor's telemetry on the task monitor's 1 Hz scan and makes bounded,
hysteresis-damped grow and shrink decisions through a *scaler* (the
k8s pod manager, k8s/pod_manager.py, or any object with
``worker_ids``, ``scale_up`` and ``remove_worker``):

- **grow** when the backlog exceeds
  ``EDL_AUTOSCALE_BACKLOG_PER_WORKER`` tasks a live worker for
  ``EDL_AUTOSCALE_HOLD_SECS``, up to ``EDL_MAX_WORKERS`` pods in all,
  damped by the marginal-gain guard: a grow that bought less than
  ``EDL_AUTOSCALE_GAIN_FLOOR`` of the per-worker throughput, measured
  ``EDL_AUTOSCALE_GAIN_SETTLE_SECS`` after it, sets a ceiling the
  controller does not grow past.
- **shrink** at the job's tail (nothing queued, no epochs left, fewer
  tasks in flight than workers), or at once when the limit
  (``set_limits``) falls under the live count. Victims: workers without
  telemetry first, newest first, then the slowest step-time EWMA.

Each decision counts in ``edl_master_scale_decisions_total{direction}``
and journals a ``scale_decision`` event with the signals that fired.

Spot preemptions, evictions and scale-downs reach a worker as SIGTERM.
``DrainManager.begin_drain`` marks a worker the control plane removes on
purpose, so the servicer's ``get_task`` gate answers
``WAIT(draining=true)`` (no new task); the worker finishes its current
task, joins its in-flight async push, flushes its dirty device-tier rows
to the PS and sends ``deregister_worker``, the drain ack, after which
the master forgets it with no requeue. A worker SIGTERMed directly
drains the same way and acks without a ``begin_drain``. A drain that
outlives ``EDL_DRAIN_DEADLINE_SECS`` (60 s on the master) falls back to
requeue-on-death: ``take_expired`` hands the worker to the task
monitor's ``mark_worker_dead``, so a wedged worker never strands its
tasks.

The fleet monitor (``fleet``) goes quiet about a draining worker and
forgets a drained one; each outcome counts in
``edl_master_drains_total{outcome}`` and journals ``worker_draining``,
``drain_ack`` or ``drain_expired``.

``DecisionGate`` is the hold + cooldown hysteresis every autoscaler
shares; the serving fleet's ``ReplicaAutoscaler`` (serve/fleet.py) runs
on it.

Knobs (the environment; constructor arguments override):
``EDL_AUTOSCALE`` ("1", "true" or "on" enables the controller),
``EDL_MIN_WORKERS`` (1), ``EDL_MAX_WORKERS`` (64),
``EDL_AUTOSCALE_STEP`` (2 workers a decision at most),
``EDL_AUTOSCALE_COOLDOWN_SECS`` (15), ``EDL_AUTOSCALE_HOLD_SECS`` (5),
``EDL_AUTOSCALE_BACKLOG_PER_WORKER`` (2), ``EDL_AUTOSCALE_GAIN_FLOOR``
(0.1), ``EDL_AUTOSCALE_GAIN_SETTLE_SECS`` (max(3 x hold, 90): a new pod
starts and warms up before it adds throughput),
``EDL_DRAIN_DEADLINE_SECS`` (60).
"""

import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_float, env_int, env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as obs_metrics

logger = _logger_factory("elasticdl_tpu_torch.master.autoscaler")

AUTOSCALE_ENV = "EDL_AUTOSCALE"
MIN_WORKERS_ENV = "EDL_MIN_WORKERS"
MAX_WORKERS_ENV = "EDL_MAX_WORKERS"
STEP_ENV = "EDL_AUTOSCALE_STEP"
COOLDOWN_ENV = "EDL_AUTOSCALE_COOLDOWN_SECS"
HOLD_ENV = "EDL_AUTOSCALE_HOLD_SECS"
BACKLOG_ENV = "EDL_AUTOSCALE_BACKLOG_PER_WORKER"
GAIN_FLOOR_ENV = "EDL_AUTOSCALE_GAIN_FLOOR"
GAIN_SETTLE_ENV = "EDL_AUTOSCALE_GAIN_SETTLE_SECS"
DRAIN_DEADLINE_ENV = "EDL_DRAIN_DEADLINE_SECS"

# ids that acked their drain but whose pods the scaler may still report
# only need covering for that lag; the bound keeps a long-lived job from
# accumulating ids forever
DEPARTED_CAP = 256


def _env_num(name, default, cast=float):
    if cast is int:
        return env_int(name, default)
    return env_float(name, default)


class DecisionGate:
    """Hold + cooldown hysteresis shared by every autoscaler.

    A condition must persist for ``hold_secs`` before it may fire (one
    transient spike buys nothing), and after any decision the gate stays
    closed for ``cooldown_secs`` (let the previous resize land before
    judging again). Conditions are named so each direction keeps its
    own hold timer while the cooldown is shared.
    """

    def __init__(self, hold_secs, cooldown_secs):
        self._hold = float(hold_secs)
        self._cooldown = float(cooldown_secs)
        self._lock = threading.Lock()
        self._since = {}  # condition name -> first-observed ts
        self._last_action = None  # no decision yet: no cooldown

    def observe(self, condition, want, now):
        """Feed one tick's reading of ``condition``. Returns True when
        the condition has held for ``hold_secs`` and the gate is out of
        cooldown; a False ``want`` resets that condition's hold timer.
        The hold timer keeps accumulating through a cooldown window, so
        a condition that persisted across it fires the moment the
        cooldown lifts."""
        with self._lock:
            if not want:
                self._since.pop(condition, None)
                return False
            since = self._since.setdefault(condition, now)
            if now - since < self._hold:
                return False
            return not (
                self._last_action is not None
                and now - self._last_action < self._cooldown
            )

    def fired(self, condition, now):
        """Record a decision: starts the shared cooldown and resets
        ``condition``'s hold timer (the other conditions keep theirs: a
        grow must not forgive a brewing shrink signal's history)."""
        with self._lock:
            self._last_action = now
            self._since.pop(condition, None)

    def in_cooldown(self, now):
        with self._lock:
            return (
                self._last_action is not None
                and now - self._last_action < self._cooldown
            )


class DrainManager:
    """Tracks workers the control plane is removing on purpose, from
    ``begin_drain`` to the worker's ``deregister_worker`` ack, or to the
    deadline fallback when the ack never comes."""

    def __init__(
        self,
        dispatcher,
        servicer=None,
        fleet=None,
        rendezvous=None,
        deadline_secs=None,
    ):
        self._dispatcher = dispatcher
        self._servicer = servicer
        self._fleet = fleet
        self._rendezvous = rendezvous
        self._deadline = (
            deadline_secs
            if deadline_secs is not None
            else _env_num(DRAIN_DEADLINE_ENV, 60.0)
        )
        self._lock = threading.Lock()
        self._draining = {}  # worker_id -> {since, deadline, reason}
        # drained or expired ids whose pods a scaler may still report;
        # insertion-ordered and capped at DEPARTED_CAP (oldest out)
        self._departed = {}
        self._m_drains = obs_metrics.counter(
            "edl_master_drains_total",
            "Graceful-drain outcomes", ("outcome",),
        )
        for outcome in ("ack", "expired"):
            self._m_drains.labels(outcome=outcome)  # stable series set

    # ------------------------------------------------------------------
    def begin_drain(self, worker_id, reason="scale_down",
                    initiator="master"):
        """Mark ``worker_id`` draining: the get_task gate stops handing
        it work and the fleet detectors go quiet about it. Idempotent;
        False when already draining."""
        now = time.time()
        with self._lock:
            if worker_id in self._draining:
                return False
            self._draining[worker_id] = {
                "since": now,
                "deadline": now + self._deadline,
                "reason": reason,
            }
        if self._fleet is not None:
            self._fleet.mark_draining(worker_id)
        logger.info(
            "draining worker %s (%s, deadline %.0fs)",
            worker_id, reason, self._deadline,
        )
        events.emit(
            "worker_draining", worker=worker_id, reason=reason,
            initiator=initiator,
        )
        return True

    def is_draining(self, worker_id):
        with self._lock:
            return worker_id in self._draining

    def draining_ids(self):
        with self._lock:
            return set(self._draining)

    def _note_departed_locked(self, worker_id):
        self._departed[worker_id] = None
        while len(self._departed) > DEPARTED_CAP:
            self._departed.pop(next(iter(self._departed)))

    def departed_ids(self, current_ids=None):
        """Ids that already acked (or expired) whose pods a scaler may
        still report. ``current_ids`` (the scaler's ids) prunes the ones
        it no longer reports: a relaunch mints a new worker id, so a
        departed id never comes back live."""
        with self._lock:
            if current_ids is not None:
                keep = set(current_ids)
                for wid in [w for w in self._departed if w not in keep]:
                    del self._departed[wid]
            return set(self._departed)

    # ------------------------------------------------------------------
    def deregister(self, request):
        """The drain ack (servicer.deregister_worker): the worker
        finished flushing and is about to exit. Remove it everywhere
        without a counted requeue. Also serves workers the master never
        marked (SIGTERMed directly)."""
        worker_id = request.worker_id
        with self._lock:
            entry = self._draining.pop(worker_id, None)
            self._note_departed_locked(worker_id)
        initiator = "master" if entry is not None else "worker"
        host = (
            self._servicer.worker_host(worker_id)
            if self._servicer is not None
            else None
        )
        # leftovers requeue uncounted; a clean drain holds nothing (the
        # worker finished its current task before acking)
        self._dispatcher.recover_tasks(worker_id)
        if self._servicer is not None:
            # also leaves Master.run's set of workers to tell "job over"
            self._servicer.forget_worker(worker_id)
        if self._fleet is not None:
            self._fleet.mark_drained(worker_id, reason=request.reason)
        if self._rendezvous is not None and host:
            self._rendezvous.remove_worker_host(
                host, reason=request.reason or "drain"
            )
        self._m_drains.labels(outcome="ack").inc()
        logger.info(
            "worker %s drained cleanly (%s; pushes_joined=%s "
            "tier_flushed=%s handed_back=%d)",
            worker_id, request.reason or "unspecified",
            request.pushes_joined, request.tier_flushed,
            request.tasks_reported,
        )
        events.emit(
            "drain_ack", worker=worker_id, reason=request.reason,
            initiator=initiator, pushes_joined=request.pushes_joined,
            tier_flushed=request.tier_flushed,
            handed_back=request.tasks_reported,
        )

    def take_expired(self, now=None):
        """Pop every drain whose deadline passed; the caller (the task
        monitor) routes each through ``mark_worker_dead``, the
        requeue-on-death fallback."""
        now = time.time() if now is None else now
        with self._lock:
            expired = [
                wid for wid, entry in self._draining.items()
                if now >= entry["deadline"]
            ]
            entries = {wid: self._draining.pop(wid) for wid in expired}
            for wid in expired:
                self._note_departed_locked(wid)
        for wid in expired:
            self._m_drains.labels(outcome="expired").inc()
            logger.warning(
                "drain of worker %s expired after %.0fs; falling back "
                "to requeue-on-death", wid, self._deadline,
            )
            events.emit(
                "drain_expired", worker=wid,
                reason=entries[wid]["reason"],
                waited_secs=round(now - entries[wid]["since"], 2),
            )
        return expired

    def on_worker_dead(self, worker_id):
        """The task monitor evicted this worker for its own reasons:
        drop the drain entry so its deadline cannot fire a second
        eviction later."""
        with self._lock:
            self._draining.pop(worker_id, None)

    def state(self):
        """JSON-ready view of the drains in progress."""
        now = time.time()
        with self._lock:
            return {
                str(wid): {
                    "reason": entry["reason"],
                    "draining_secs": round(now - entry["since"], 2),
                    "deadline_in": round(entry["deadline"] - now, 2),
                }
                for wid, entry in self._draining.items()
            }


class ElasticController:
    """Bounded, hysteresis-damped grow and shrink decisions off the
    fleet's telemetry. ``tick()`` rides the task monitor's 1 Hz scan."""

    def __init__(
        self,
        dispatcher,
        scaler,
        drain_manager,
        fleet=None,
        min_workers=None,
        max_workers=None,
        step=None,
        cooldown_secs=None,
        hold_secs=None,
        backlog_per_worker=None,
        gain_floor=None,
        gain_settle_secs=None,
        tag="",
    ):
        self._dispatcher = dispatcher
        self._scaler = scaler
        self._drain = drain_manager
        self._fleet = fleet
        self._min = int(
            min_workers
            if min_workers is not None
            else _env_num(MIN_WORKERS_ENV, 1, int)
        )
        self._max = int(
            max_workers
            if max_workers is not None
            else _env_num(MAX_WORKERS_ENV, 64, int)
        )
        self._step = max(1, int(
            step if step is not None else _env_num(STEP_ENV, 2, int)
        ))
        self._cooldown = (
            cooldown_secs
            if cooldown_secs is not None
            else _env_num(COOLDOWN_ENV, 15.0)
        )
        self._hold = (
            hold_secs
            if hold_secs is not None
            else _env_num(HOLD_ENV, 5.0)
        )
        self._backlog = max(0.1, (
            backlog_per_worker
            if backlog_per_worker is not None
            else _env_num(BACKLOG_ENV, 2.0)
        ))
        self._gain_floor = (
            gain_floor
            if gain_floor is not None
            else _env_num(GAIN_FLOOR_ENV, 0.1)
        )
        # a fresh pod starts and warms up before it adds a single
        # example/s: measured too early, the first grow reads as
        # worthless and freezes the ceiling at the pre-grow size
        self._gain_settle = (
            gain_settle_secs
            if gain_settle_secs is not None
            else _env_num(GAIN_SETTLE_ENV, max(3.0 * self._hold, 90.0))
        )
        self._tag = tag
        self._lock = threading.Lock()
        self._gate = DecisionGate(self._hold, self._cooldown)
        # after a grow: the throughput measured once the fleet settles;
        # a grow that bought < gain_floor of the pre-grow per-worker
        # throughput sets the ceiling
        self._pending_gain = None  # {measure_at, before, workers_before}
        self._gain_ceiling = None
        self._last_decision = {}
        self._m_decisions = obs_metrics.counter(
            "edl_master_scale_decisions_total",
            "Autoscaler resize decisions", ("direction",),
        )
        for direction in ("grow", "shrink"):
            self._m_decisions.labels(direction=direction)

    @classmethod
    def maybe_create(cls, dispatcher, scaler, drain_manager, fleet=None,
                     **kwargs):
        """The controller when ``EDL_AUTOSCALE`` is on and the scaler
        speaks the protocol; else None (a static fleet)."""
        if env_str(AUTOSCALE_ENV, "") not in ("1", "true", "on"):
            return None
        if scaler is None or not hasattr(scaler, "scale_up"):
            logger.warning(
                "%s set but no scaler available (no pod manager?); "
                "autoscaling disabled", AUTOSCALE_ENV,
            )
            return None
        return cls(dispatcher, scaler, drain_manager, fleet=fleet,
                   **kwargs)

    # ------------------------------------------------------------------
    def set_limits(self, min_workers=None, max_workers=None):
        """Move the operator's or the budget's envelope at run time; the
        next tick enforces the new ceiling."""
        with self._lock:
            if min_workers is not None:
                self._min = int(min_workers)
            if max_workers is not None:
                self._max = int(max_workers)

    def state(self):
        """JSON-ready /statusz section."""
        with self._lock:
            return {
                "min_workers": self._min,
                "max_workers": self._max,
                "step": self._step,
                "gain_ceiling": self._gain_ceiling,
                "last_decision": dict(self._last_decision),
            }

    # ------------------------------------------------------------------
    def tick(self, now=None):
        """One decision pass, from the task monitor's scan. Never raises
        (a scan tick must survive the scaler's hiccups)."""
        try:
            self._tick(time.time() if now is None else now)
        except Exception:
            logger.exception("autoscaler tick failed")

    def _tick(self, now):
        counts = self._dispatcher.queue_counts()
        # pending work of every type: a deep evaluation backlog at the
        # epoch's end is work too, and must not be left to a shrunken
        # fleet
        queue = sum(counts["queue_depth"].values())
        epochs_left = counts["epochs_left"]
        doing = counts["doing"]
        ids = list(self._scaler.worker_ids())
        not_live = (
            self._drain.draining_ids() | self._drain.departed_ids(ids)
        )
        live = [wid for wid in ids if wid not in not_live]
        effective = len(live)
        throughput = (
            self._fleet.fleet_examples_per_sec()
            if self._fleet is not None
            else 0.0
        )
        self._settle_gain(now, effective, throughput)

        with self._lock:
            min_w, max_w = self._min, self._max

        # budget: a lowered ceiling shrinks at once (no hold, no
        # cooldown: the budget is an order). Victims count as draining
        # from the next tick and as departed from their ack until the
        # scaler forgets their pods, so this cannot fire again against
        # capacity that is already leaving. The floor still binds: a
        # ceiling under min_workers must not drain the whole fleet,
        # which could then never grow again
        budget_floor = max(min_w, max_w)
        if effective > budget_floor:
            self._shrink(
                now, effective - budget_floor, live, queue,
                reasons=["over_budget: %d live > max_workers %d"
                         % (effective, max_w)],
            )
            return

        # grow: a backlog a worker above the watermark, held. The
        # ceiling binds on all pods (live, draining and departed): a
        # drain victim still holds a real pod
        total = len(ids)
        backlog = queue / max(1, effective)
        want_grow = (
            queue > 0
            and backlog > self._backlog
            and total < max_w
        )
        if want_grow and self._gain_ceiling is not None and (
            effective >= self._gain_ceiling
        ):
            want_grow = False  # adding workers stopped paying
        if self._gate.observe("grow", want_grow, now):
            delta = min(
                self._step,
                max_w - total,
                max(1, int(queue / self._backlog) - effective),
            )
            if self._gain_ceiling is not None:
                # never past the size already proven unprofitable
                delta = min(delta, self._gain_ceiling - effective)
            self._grow(
                now, delta, effective, throughput, queue,
                reasons=[
                    "backlog: %d queued / %d workers > %.1f per-worker "
                    "watermark" % (queue, effective, self._backlog),
                ],
            )
            return

        # shrink: the job's tail, nothing queued, nothing coming, fewer
        # tasks in flight than workers
        want_shrink = (
            queue == 0
            and epochs_left == 0
            and effective > min_w
            and doing < effective
        )
        if self._gate.observe("shrink", want_shrink, now):
            target = max(min_w, doing)
            delta = min(self._step, effective - target)
            if delta > 0:
                self._shrink(
                    now, delta, live, queue,
                    reasons=[
                        "idle_tail: 0 queued, 0 epochs left, %d doing "
                        "< %d workers" % (doing, effective),
                    ],
                )

    # ------------------------------------------------------------------
    def _settle_gain(self, now, effective, throughput):
        with self._lock:
            pending = self._pending_gain
            if pending is None or now < pending["measure_at"]:
                return
            self._pending_gain = None
        added = effective - pending["workers_before"]
        if added <= 0:
            return  # the grow evaporated (deaths): nothing to learn
        gain_per_worker = (throughput - pending["before"]) / added
        per_worker_before = (
            pending["before"] / max(1, pending["workers_before"])
        )
        if per_worker_before > 0 and gain_per_worker < (
            self._gain_floor * per_worker_before
        ):
            with self._lock:
                self._gain_ceiling = effective
            logger.info(
                "autoscaler: marginal gain %.1f ex/s per added worker "
                "< %.0f%% of per-worker throughput %.1f; ceiling at %d "
                "workers",
                gain_per_worker, self._gain_floor * 100,
                per_worker_before, effective,
            )
        elif self._gain_ceiling is not None and effective < (
            self._gain_ceiling
        ):
            with self._lock:
                self._gain_ceiling = None  # the fleet shrank: re-probe

    def _grow(self, now, delta, effective, throughput, queue, reasons):
        started = self._scaler.scale_up(delta)
        added = len(started) if started is not None else delta
        if added <= 0:
            return  # the scaler placed none (pool exhausted)
        self._gate.fired("grow", now)
        with self._lock:
            if throughput > 0:
                self._pending_gain = {
                    "measure_at": now + self._gain_settle,
                    "before": throughput,
                    "workers_before": effective,
                }
            self._last_decision = {
                "direction": "grow", "delta": added,
                "workers": effective, "queue_depth": queue,
                "at": now, "reasons": reasons,
            }
        self._m_decisions.labels(direction="grow").inc()
        logger.info(
            "autoscaler grow +%d (workers %d, queue %d): %s",
            added, effective, queue, "; ".join(reasons),
        )
        events.emit(
            "scale_decision", direction="grow", delta=added,
            workers=effective, queue_depth=queue, reasons=reasons,
            tag=self._tag,
        )

    def _shrink(self, now, delta, live, queue, reasons):
        victims = self._pick_victims(delta, live)
        if not victims:
            return
        self._gate.fired("shrink", now)
        with self._lock:
            self._last_decision = {
                "direction": "shrink", "delta": len(victims),
                "workers": len(live), "queue_depth": queue,
                "victims": victims, "at": now, "reasons": reasons,
            }
        self._m_decisions.labels(direction="shrink").inc()
        logger.info(
            "autoscaler shrink -%d (victims %s, workers %d): %s",
            len(victims), victims, len(live), "; ".join(reasons),
        )
        events.emit(
            "scale_decision", direction="shrink", delta=len(victims),
            workers=len(live), queue_depth=queue, victims=victims,
            reasons=reasons, tag=self._tag,
        )
        for wid in victims:
            # draining first (the dispatch gate, the quiet detectors),
            # then the scaler's eviction: pod delete -> SIGTERM -> the
            # worker's graceful drain
            self._drain.begin_drain(wid, reason="scale_down")
            remove = getattr(self._scaler, "remove_worker", None)
            if remove is not None:
                try:
                    remove(wid)
                except Exception:
                    logger.exception(
                        "scaler.remove_worker(%s) failed", wid
                    )

    def _pick_victims(self, count, live):
        """Ids without telemetry first (never trained: the least
        warmth), newest first; then the slowest step-time EWMA."""
        ewmas = (
            self._fleet.worker_step_ewmas()
            if self._fleet is not None
            else {}
        )
        silent = sorted(
            (wid for wid in live if wid not in ewmas), reverse=True
        )
        reporting = sorted(
            (wid for wid in live if wid in ewmas),
            key=lambda wid: ewmas[wid], reverse=True,
        )
        return (silent + reporting)[: max(0, count)]
