"""Failure detection: worker liveness and task timeouts (port of
elasticdl_tpu/master/task_monitor.py).

A worker silent for longer than ``liveness_timeout_secs`` while it holds
tasks (or while it is a mesh member) is presumed dead, and so is one
whose task runs 3x slower than the rolling average (floored at the
liveness timeout); its tasks go back to the queue through
``recover_tasks``. A graceful drain whose deadline passed
(master/autoscaler.py ``DrainManager.take_expired``) joins the dead.

The fleet monitor's detectors (master/fleet.py) ride the same scan: one
``evaluate()`` a tick, and ``mark_dead`` on a worker presumed dead. So
does the elastic controller (master/autoscaler.py): one ``tick`` a scan,
once ``set_autoscaler`` attached it.
"""

import threading
import time

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events

logger = _logger_factory("elasticdl_tpu_torch.master.task_monitor")


class TaskMonitor:
    def __init__(
        self,
        task_dispatcher,
        servicer,
        rendezvous=None,
        on_worker_dead=None,
        liveness_timeout_secs=30.0,
        timeout_factor=3.0,
        scan_interval_secs=1.0,
        mesh_restart_grace_secs=30.0,
        mesh_rejoin_timeout_secs=90.0,
        fleet_monitor=None,
        drain_manager=None,
        autoscaler=None,
    ):
        self._dispatcher = task_dispatcher
        self._servicer = servicer
        self._rendezvous = rendezvous
        self._on_worker_dead = on_worker_dead
        # fleet anomaly detectors (master/fleet.py) ride this thread's
        # 1 Hz scan: one evaluate() a tick keeps the alert counters and
        # journal current without a second timer thread
        self._fleet = fleet_monitor
        # drain deadlines are enforced on this scan: an expired drain
        # falls back to mark_worker_dead (requeue-on-death); the
        # autoscaler gets its decision tick here too
        self._drain_manager = drain_manager
        self._autoscaler = autoscaler
        self._liveness_timeout = liveness_timeout_secs
        # after a membership change every mesh member restarts, and its
        # liveness lapses for the restart: mesh eviction pauses this
        # long after any change (task recovery does not)
        self._mesh_restart_grace = mesh_restart_grace_secs
        # on a bump the members' clocks are forward-dated by
        # (rejoin_timeout - liveness_timeout), so a member is evicted
        # only if silent for rejoin_timeout after the bump
        self._mesh_rejoin_timeout = mesh_rejoin_timeout_secs
        self._seen_epoch = None
        self._timeout_factor = timeout_factor
        self._scan_interval = scan_interval_secs
        self._stopping = threading.Event()
        self._thread = None

    def set_autoscaler(self, autoscaler):
        """Late binding: the pod manager, the autoscaler's scaler, is
        attached to the master after construction, so the controller is
        made in ``Master.prepare`` and hooked here."""
        self._autoscaler = autoscaler

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="task-monitor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stopping.set()
        if self._thread is not None:
            self._thread.join()

    def _loop(self):
        while not self._stopping.wait(self._scan_interval):
            try:
                self._scan()
            except Exception:
                logger.exception("task monitor scan failed")

    def _scan(self):
        now = time.time()
        dead = set()
        if self._fleet is not None:
            self._fleet.evaluate()
        if self._drain_manager is not None:
            dead.update(self._drain_manager.take_expired(now))
        if self._autoscaler is not None:
            self._autoscaler.tick(now)
        # liveness: a worker silent for too long while holding tasks OR
        # while a registered mesh member (an idle member that dies must
        # still leave the rendezvous)
        mesh_ids = set(self._servicer.mesh_worker_ids())
        if self._rendezvous is not None:
            epoch = self._rendezvous.mesh_epoch
            if epoch != self._seen_epoch:
                # every member restarts for the new epoch: forward-date
                # their clocks so the relaunch gap cannot read as death
                self._seen_epoch = epoch
                self._servicer.extend_liveness(
                    mesh_ids,
                    now + self._mesh_rejoin_timeout
                    - self._liveness_timeout,
                )
        liveness = self._servicer.worker_liveness()
        doing = self._dispatcher.doing_tasks()
        holders = {worker_id for worker_id, _ in doing.values()}
        holders |= mesh_ids
        in_grace = (
            self._rendezvous is not None
            and now - self._rendezvous.last_change_time
            < self._mesh_restart_grace
        )
        for worker_id in holders:
            if in_grace and worker_id in mesh_ids:
                continue
            last = liveness.get(worker_id)
            if last is not None and now - last > self._liveness_timeout:
                logger.warning(
                    "Worker %s silent for %.0fs; presumed dead",
                    worker_id,
                    now - last,
                )
                dead.add(worker_id)

        # task timeout: 3x slower than the rolling average, floored at
        # the liveness timeout, so a heartbeating worker whose first
        # task carries its start-up gets at least the liveness window
        threshold = max(
            self._timeout_factor * self._dispatcher.avg_task_duration(),
            self._liveness_timeout,
        )
        for task_id, (worker_id, start_time) in doing.items():
            if now - start_time > threshold:
                logger.warning(
                    "Task %s on worker %s exceeded %.0fs; recovering",
                    task_id,
                    worker_id,
                    threshold,
                )
                dead.add(worker_id)

        for worker_id in dead:
            self.mark_worker_dead(worker_id)

    def mark_worker_dead(self, worker_id):
        """Recover a worker's tasks and drop it from liveness and the
        rendezvous. Idempotent and self-healing: a worker wrongly
        presumed dead re-registers on its next RPC."""
        host = self._servicer.worker_host(worker_id)
        events.emit(
            "worker_presumed_dead", worker=worker_id, host=host or "",
        )
        if self._drain_manager is not None:
            # a draining worker evicted for its own reasons must not be
            # evicted again when its drain deadline later expires
            self._drain_manager.on_worker_dead(worker_id)
        self._dispatcher.recover_tasks(worker_id)
        self._servicer.forget_worker(worker_id)
        if self._fleet is not None:
            # force the dead-air transition if it had not fired yet (a
            # fast-task job's 3x-average timeout beats the dead-air
            # window) and leave an eviction tombstone on /alerts
            self._fleet.mark_dead(worker_id)
        if self._rendezvous is not None and host:
            self._rendezvous.remove_worker_host(host, reason="worker_death")
        if self._on_worker_dead is not None:
            try:
                self._on_worker_dead(worker_id)
            except Exception:
                logger.exception("on_worker_dead callback failed")
