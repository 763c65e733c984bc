"""gRPC Master service implementation (port of
elasticdl_tpu/master/servicer.py).

``get_task`` (WAIT when the queue is temporarily empty), the task
report (a ``"requeue:"`` hand-back is uncounted), the evaluation
metrics and model-version reports, ``reset_worker`` (the master-assigned
relaunch epoch a worker stamps on its pushes) and ``get_comm_info``
(the mesh epoch, master/rendezvous.py). Every RPC from a worker is a
liveness sighting, which the task monitor reads.

A draining worker gets ``WAIT(draining=true)`` from ``get_task`` and
leaves through ``deregister_worker`` (master/autoscaler.py
``DrainManager``). With a state journal the relaunch-epoch grants and
their base are journaled, and ``master_epoch`` is the journal's boot
counter.

Every RPC that carries a ``TelemetryBlob`` folds it into the fleet
monitor (master/fleet.py); the handlers record the ``dispatch`` span and
the ``task_dispatch``, ``worker_register`` and ``task_report`` events.
"""

import threading
import time

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events, trace
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

logger = _logger_factory("elasticdl_tpu_torch.master.servicer")


class MasterServicer:
    def __init__(
        self,
        task_dispatcher,
        evaluation_service=None,
        rendezvous=None,
        auto_join_mesh=True,
        fleet_monitor=None,
        state_journal=None,
        recovered=None,
    ):
        self._task_dispatcher = task_dispatcher
        self._evaluation_service = evaluation_service
        self._rendezvous = rendezvous
        # graceful-drain coordination (master/autoscaler.py), set by the
        # Master after construction; a bare servicer builds one on the
        # first deregister_worker
        self.drain_manager = None
        # fleet telemetry sink (master/fleet.py): every RPC is a
        # liveness sighting, and requests carrying the piggybacked
        # TelemetryBlob update the role's fleet-view entry
        self._fleet = fleet_monitor
        # membership = live workers: a worker's first get_comm_info
        # joins its host to the mesh
        self._auto_join_mesh = auto_join_mesh
        self._lock = threading.Lock()
        # worker_id -> last RPC timestamp: the liveness signal of the
        # timeout scanner
        self._worker_liveness = {}
        # worker_id -> host (from get_comm_info); lets the task monitor
        # evict a dead worker's host from the mesh rendezvous
        self._worker_hosts = {}
        # workers that have been answered "job over" (Master.run waits
        # for every live worker to hear it before the server stops)
        self._told_job_over = set()
        # poller id -> the stream watermark its last CommInfo carried
        self._told_watermark = {}
        # worker_id -> reset_worker count: the logical relaunch epoch a
        # worker stamps onto its gradient pushes as its incarnation,
        # monotonic per worker_id so the sync PS can order a relaunch
        # after its dead predecessor without trusting host clocks
        self._worker_restarts = {}
        # the epoch base re-anchors monotonicity across master restarts:
        # the master's own clock at startup, far above relaunch counts.
        # With a state journal the base is persisted, and a relaunched
        # master re-anchors strictly above its predecessor's, whatever
        # this node's clock says
        self._journal = state_journal
        self._restart_epoch_base = int(time.time())
        if recovered is not None:
            self._worker_restarts = {
                int(w): int(c)
                for w, c in recovered.get("worker_restarts", {}).items()
            }
            self._restart_epoch_base = max(
                self._restart_epoch_base,
                int(recovered.get("epoch_base", 0)) + 1,
            )
        if self._journal is not None:
            self._journal.append(
                {"op": "epoch_base", "base": self._restart_epoch_base}
            )
        # restart detector stamped on responses (Task / CommInfo /
        # ResetWorkerResponse): the journal's boot counter, or without
        # one the startup base; either moves across master restarts, so
        # reconnecting workers re-register
        self._master_epoch = (
            state_journal.master_epoch
            if state_journal is not None
            else self._restart_epoch_base
        )

    # ------------------------------------------------------------------
    def _touch(self, worker_id):
        with self._lock:
            # monotonic max: extend_liveness may have credited a future
            # horizon; an ordinary ping must not pull the clock back
            self._worker_liveness[worker_id] = max(
                time.time(), self._worker_liveness.get(worker_id, 0.0)
            )

    def worker_liveness(self):
        with self._lock:
            return dict(self._worker_liveness)

    def forget_worker(self, worker_id):
        with self._lock:
            self._worker_liveness.pop(worker_id, None)
            self._worker_hosts.pop(worker_id, None)

    def extend_liveness(self, worker_ids, horizon):
        """Credit workers with liveness up to a future ``horizon`` (the
        task monitor's allowance on a mesh-epoch bump, when every member
        goes dark for its relaunch). _touch is monotonic, so stray pings
        cannot shorten the allowance."""
        with self._lock:
            for worker_id in worker_ids:
                self._worker_liveness[worker_id] = max(
                    self._worker_liveness.get(worker_id, 0.0), horizon
                )

    def workers_not_told_job_over(self):
        """Live workers (ids >= 0; a PS polls with a negative id) that
        have not been answered "job over" yet."""
        with self._lock:
            return sorted(w for w in self._worker_liveness
                          if w >= 0 and w not in self._told_job_over)

    def mesh_worker_ids(self):
        """Workers registered as mesh members (sent a worker_host)."""
        with self._lock:
            return list(self._worker_hosts)

    def worker_host(self, worker_id):
        with self._lock:
            return self._worker_hosts.get(worker_id)

    # ------------------------------------------------------------------
    # RPC handlers (also callable in-process without gRPC)

    def get_task(self, request, context=None):
        self._observe(request)
        if self.drain_manager is not None and (
            self.drain_manager.is_draining(request.worker_id)
        ):
            # drain gate: a draining worker gets no new work;
            # WAIT(draining=true) tells it to finish its current task,
            # flush and deregister
            return pb.Task(
                type=pb.WAIT, master_epoch=self._master_epoch,
                draining=True,
            )
        task_type = request.task_type if request.task_type else None
        dispatch_start = time.time()
        task = self._task_dispatcher.get(request.worker_id, task_type)
        if task is not None:
            # constant per process: stamping the shared record's proto
            # is idempotent
            task.master_epoch = self._master_epoch
            # the master-side anchor of the cross-role task trace: the
            # worker's train/push spans carry the same task_id
            trace.complete(
                "dispatch", dispatch_start,
                task_id=task.task_id, worker_id=request.worker_id,
            )
            events.emit(
                "task_dispatch", task=task.task_id,
                worker=request.worker_id,
                type=pb.TaskType.Name(task.type).lower(),
            )
            return task
        with self._lock:
            # decided under the lock report_version's evaluation trigger
            # takes: no evaluation round starts after a worker was told
            # the job is over (no worker would be left to run it)
            if (
                self._task_dispatcher.finished()
                or self._task_dispatcher.job_failed()
            ):
                # default Task (task_id=0, type=TRAINING): the job is
                # over (success or terminal failure) and the worker
                # should exit
                self._told_job_over.add(request.worker_id)
                return pb.Task(master_epoch=self._master_epoch)
        # queue temporarily empty (between epochs, during an eval pass):
        # the worker waits and polls again
        return pb.Task(type=pb.WAIT, master_epoch=self._master_epoch)

    def reset_worker(self, request, context=None):
        """A freshly (re)launched worker declares itself: anything still
        assigned to its id belongs to a dead predecessor, so it requeues
        uncounted now instead of waiting out the task timeout (the
        successor reuses the id and heartbeats at once).

        Returns this worker_id's relaunch epoch (base + 1, base + 2,
        ...): the worker's push incarnation."""
        self._observe(request)
        with self._lock:
            count = self._worker_restarts.get(request.worker_id, 0) + 1
            self._worker_restarts[request.worker_id] = count
            epoch = self._restart_epoch_base + count
        if self._journal is not None:
            # durable before the worker can stamp it on a push: a
            # relaunched master that forgot the grant would issue lower
            # epochs again
            self._journal.append({
                "op": "grant", "worker": request.worker_id,
                "count": count,
            })
        self._task_dispatcher.recover_tasks(request.worker_id)
        events.emit(
            "worker_register", worker=request.worker_id, epoch=epoch,
            relaunch=count > 1,
        )
        return pb.ResetWorkerResponse(
            restart_count=epoch, master_epoch=self._master_epoch
        )

    def deregister_worker(self, request, context=None):
        """The graceful-drain ack: the worker finished draining (its
        current task reported, its async push joined, its device-tier
        rows flushed) and exits on purpose. It is removed with no
        counted requeue, whether the master asked for the drain or the
        worker was SIGTERMed directly."""
        if request.HasField("telemetry") and self._fleet is not None:
            # final telemetry fold (not _observe: that would re-add the
            # liveness entry the drain is about to remove)
            self._fleet.observe(request.worker_id, request.telemetry)
        if self.drain_manager is None:
            # bare servicer: the ack's bookkeeping is the same either
            # way, so build the manager on first use
            from elasticdl_tpu_torch.master.autoscaler import DrainManager

            self.drain_manager = DrainManager(
                self._task_dispatcher, servicer=self,
                fleet=self._fleet, rendezvous=self._rendezvous,
            )
        self.drain_manager.deregister(request)
        return pb.Empty()

    def worker_relaunch_count(self):
        """Relaunches observed across all workers (each reset_worker
        beyond a worker_id's first is a relaunch): the master's
        ``edl_master_worker_relaunches`` gauge."""
        with self._lock:
            return sum(
                max(0, n - 1) for n in self._worker_restarts.values()
            )

    def report_task_result(self, request, context=None):
        self._observe(request)
        success = not request.err_message
        # "requeue:" prefix = lifecycle hand-back: requeue WITHOUT
        # charging the task's retry cap
        count_failure = not request.err_message.startswith("requeue:")
        if not success:
            log = logger.info if not count_failure else logger.warning
            log(
                "Task %s failed: %s", request.task_id, request.err_message
            )
        self._task_dispatcher.report(
            request.task_id, success, worker_id=request.worker_id,
            count_failure=count_failure,
        )
        trace.instant(
            "task_reported", task_id=request.task_id,
            worker_id=request.worker_id, success=success,
        )
        events.emit(
            "task_report", task=request.task_id,
            worker=request.worker_id, ok=success,
            err=request.err_message[:200],
        )
        return pb.Empty()

    def report_evaluation_metrics(self, request, context=None):
        self._touch(request.worker_id)
        if self._evaluation_service is not None:
            self._evaluation_service.report_evaluation_metrics(
                request.model_outputs, request.labels
            )
        return pb.Empty()

    def report_version(self, request, context=None):
        if self._journal is not None:
            self._journal.append(
                {"op": "version", "version": request.model_version}
            )
        if self._evaluation_service is not None:
            with self._lock:
                # a version report that arrives after the job was
                # declared over (the last task's report came first, or
                # a PS reported its last push late) starts no round: it
                # would reopen a finished job that no worker serves
                if not self._told_job_over:
                    self._evaluation_service.add_evaluation_task_if_needed(
                        request.model_version
                    )
        return pb.Empty()

    def _observe(self, request):
        """Fold one RPC into the fleet view: a liveness sighting always,
        plus the telemetry blob when the sender piggybacked one."""
        self._touch(request.worker_id)
        if self._fleet is not None:
            blob = (
                request.telemetry
                if request.HasField("telemetry")
                else None
            )
            self._fleet.observe(request.worker_id, blob)

    def export_worker_state(self):
        """Snapshot section for journal compaction: the relaunch-epoch
        grants and their base (state_store.empty_state keys)."""
        with self._lock:
            return {
                "worker_restarts": dict(self._worker_restarts),
                "epoch_base": self._restart_epoch_base,
            }

    def _stream_watermark(self, request=None):
        """The dispatcher's record watermark (0 outside streaming
        mode), stamped on CommInfo: workers and PS shards drive their
        stream checkpoints off it through the polls they already
        make. Noted per poller, so the end of a stream can wait for
        every PS to have read the last one."""
        watermark = getattr(self._task_dispatcher, "stream_watermark", None)
        watermark = watermark() if callable(watermark) else 0
        if request is not None:
            with self._lock:
                self._told_watermark[request.worker_id] = watermark
        return watermark

    def pollers_behind_watermark(self, watermark):
        """Live pollers with a negative id (a PS, a serving replica)
        whose last CommInfo carried a watermark below ``watermark``."""
        with self._lock:
            return sorted(
                w for w in self._worker_liveness
                if w < 0 and self._told_watermark.get(w, 0) < watermark)

    def get_comm_info(self, request, context=None):
        self._observe(request)
        if self._rendezvous is None:
            return pb.CommInfo(
                rank=0, world_size=1, mesh_epoch=0,
                master_epoch=self._master_epoch,
                stream_watermark=self._stream_watermark(request),
            )
        if request.worker_host:
            with self._lock:
                self._worker_hosts[request.worker_id] = request.worker_host
            if self._auto_join_mesh:
                self._rendezvous.add_worker_host(
                    request.worker_host, reason="worker_join"
                )
        rank, size, epoch, coordinator = self._rendezvous.get_comm_info(
            request.worker_host
        )
        return pb.CommInfo(
            rank=rank,
            world_size=size,
            mesh_epoch=epoch,
            coordinator_addr=coordinator,
            master_epoch=self._master_epoch,
            stream_watermark=self._stream_watermark(request),
        )
