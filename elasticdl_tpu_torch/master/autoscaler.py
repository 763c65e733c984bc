"""Graceful drain (port of the ``DrainManager`` of
elasticdl_tpu/master/autoscaler.py).

Spot preemptions, evictions and scale-downs reach a worker as SIGTERM.
``begin_drain`` marks a worker the control plane removes on purpose, so
the servicer's ``get_task`` gate answers ``WAIT(draining=true)`` (no new
task); the worker finishes its current task, joins its in-flight async
push, flushes its dirty device-tier rows to the PS and sends
``deregister_worker``, the drain ack, after which the master forgets it
with no requeue. A worker SIGTERMed directly drains the same way and
acks without a ``begin_drain``. A drain that outlives
``EDL_DRAIN_DEADLINE_SECS`` (60 s on the master) falls back to
requeue-on-death: ``take_expired`` hands the worker to the task
monitor's ``mark_worker_dead``, so a wedged worker never strands its
tasks.

The fleet monitor (``fleet``) goes quiet about a draining worker and
forgets a drained one; each outcome counts in
``edl_master_drains_total{outcome}`` and journals ``worker_draining``,
``drain_ack`` or ``drain_expired``.

Not ported (ROADMAP): the ``ElasticController`` and its
``DecisionGate``, which need a scaler (the k8s pod manager).
"""

import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_float
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as obs_metrics

logger = _logger_factory("elasticdl_tpu_torch.master.autoscaler")

DRAIN_DEADLINE_ENV = "EDL_DRAIN_DEADLINE_SECS"

# ids that acked their drain but whose pods the scaler may still report
# only need covering for that lag; the bound keeps a long-lived job from
# accumulating ids forever
DEPARTED_CAP = 256


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
            else env_float(DRAIN_DEADLINE_ENV, 60.0)
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
