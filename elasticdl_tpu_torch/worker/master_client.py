"""Thin gRPC wrapper the worker (and the PS's liveness poll) uses to
talk to the master (port of elasticdl_tpu/worker/master_client.py).

``get_task`` answers an empty Task on an RPC error, which the worker
reads as "job over", so a master that exits never strands its workers.
Connection errors on ``get_task`` are first retried with full-jitter
backoff through ``MASTER_RETRY_BUDGET_SECS`` (a master relaunch window;
``EDL_MASTER_RETRY_BUDGET_SECS`` overrides), and every response's
``master_epoch`` feeds a restart detector: when it moves, a registered
client calls ``reset_worker`` again so the new master knows it. The
detector runs under one lock that ``get_task`` holds across its call:
the heartbeat skips it while a ``get_task`` is in flight (that call's
own response carries the new epoch), so one restart re-registers once
and no task is kept that the re-registration requeued.

``telemetry_provider`` (set by the worker or the PS) returns the
``TelemetryBlob`` that get_task, report_task_result, get_comm_info and
deregister_worker carry to the master's fleet monitor: telemetry never
makes an RPC of its own. The channel carries the client metrics
interceptor when metrics are on.
"""

import threading

import grpc

from elasticdl_tpu_torch.common.constants import GRPC
from elasticdl_tpu_torch.common.env_utils import env_float
from elasticdl_tpu_torch.common.grpc_utils import build_channel, retry_call
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability.grpc_metrics import instrument_channel
from elasticdl_tpu_torch.common.tensor_utils import ndarray_to_blob
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.services import MasterStub

logger = _logger_factory("elasticdl_tpu_torch.worker.master_client")

# how long get_task keeps retrying a CONNECTION failure before reading
# it as job-over: must cover a master relaunch
MASTER_RETRY_BUDGET_SECS = env_float(
    "EDL_MASTER_RETRY_BUDGET_SECS", 120.0
)


class MasterClient:
    def __init__(self, master_addr, worker_id, worker_host=""):
        """``worker_host`` names this process in the master's mesh
        rendezvous. The port has no multi-host trainer, so by default a
        worker stays out of the mesh ("", as a PS does) and the task
        monitor judges it by its liveness alone; pass a host to join."""
        self._channel = instrument_channel(build_channel(master_addr))
        self._stub = MasterStub(self._channel)
        self._worker_id = worker_id
        self._worker_host = worker_host
        # master-assigned relaunch epoch (reset_worker response): the
        # worker's push incarnation. None until reset_worker succeeds.
        self._incarnation = None
        # restart detector: the master's boot epoch as last seen. Only a
        # client that registered re-registers on a move (a PS's liveness
        # poll must not start registering).
        self._seen_master_epoch = None
        self._registered = False
        # serialises the detector with get_task's dispatch (module note)
        self._register_lock = threading.Lock()
        # readiness signal for /readyz: True once any RPC round-tripped
        self._channel_ok = False
        # fleet-telemetry piggyback: a callable returning a
        # pb.TelemetryBlob (or None to skip) that get_task /
        # report_task_result / get_comm_info / deregister_worker attach
        # to their requests; no extra RPC is ever made for telemetry
        self.telemetry_provider = None

    def _attach_telemetry(self, request):
        provider = self.telemetry_provider
        if provider is None:
            return request
        try:
            blob = provider()
        except Exception:
            logger.warning("telemetry provider failed", exc_info=True)
            return request
        if blob is not None:
            request.telemetry.CopyFrom(blob)
        return request

    @property
    def worker_id(self):
        return self._worker_id

    @property
    def incarnation(self):
        """Master-assigned relaunch epoch, or None if reset_worker has
        not succeeded."""
        return self._incarnation

    def channel_ok(self):
        """The worker's /readyz check: has the master channel carried a
        successful RPC recently? Updated by reset_worker and the
        heartbeat's get_comm_info, so a dead master flips the worker
        unready within a heartbeat interval."""
        return self._channel_ok

    # get_task deadline misses tolerated before concluding job-over: an
    # empty Task makes the worker exit, so one slow call must not end
    # training
    GET_TASK_DEADLINE_RETRIES = 3

    def _maybe_reregister(self, master_epoch):
        """Fold a response's master_epoch into the restart detector;
        True when the master restarted and this client re-registered
        (the caller discards the triggering response: re-registration
        requeued anything the new master had just assigned us). The
        caller holds ``_register_lock``."""
        if not master_epoch or not self._registered:
            return False
        if self._seen_master_epoch is None:
            self._seen_master_epoch = master_epoch
            return False
        if master_epoch == self._seen_master_epoch:
            return False
        logger.warning(
            "master restarted (epoch %d -> %d); re-registering "
            "worker %d", self._seen_master_epoch, master_epoch,
            self._worker_id,
        )
        # the new epoch is committed only if re-registration succeeded
        # (reset_worker records it), so a transient failure retries on
        # the next response
        return self.reset_worker() is not None

    def get_task(self, task_type=None):
        request = pb.GetTaskRequest(worker_id=self._worker_id)
        if task_type is not None:
            request.task_type = task_type
        self._attach_telemetry(request)
        deadline_misses = 0
        while True:
            with self._register_lock:
                try:
                    task = retry_call(
                        lambda: self._stub.get_task(
                            request, timeout=GRPC.DEFAULT_RPC_TIMEOUT_SECS
                        ),
                        "get_task",
                        MASTER_RETRY_BUDGET_SECS,
                        retryable=(grpc.StatusCode.UNAVAILABLE,),
                        channel=self._channel,
                    )
                except grpc.RpcError as e:
                    code = e.code() if hasattr(e, "code") else None
                    if (
                        code == grpc.StatusCode.DEADLINE_EXCEEDED
                        and deadline_misses < self.GET_TASK_DEADLINE_RETRIES
                    ):
                        deadline_misses += 1
                        logger.warning(
                            "get_task deadline exceeded (%d/%d); master "
                            "slow, retrying",
                            deadline_misses, self.GET_TASK_DEADLINE_RETRIES,
                        )
                        continue
                    # master gone past the whole budget: job over
                    return pb.Task()
                self._channel_ok = True
                if self._maybe_reregister(task.master_epoch):
                    continue
            return task

    def report_task_result(self, task_id, err_message="",
                           exec_counters=None):
        request = pb.ReportTaskResultRequest(
            task_id=task_id,
            err_message=err_message,
            worker_id=self._worker_id,
        )
        self._attach_telemetry(request)
        for key, value in (exec_counters or {}).items():
            request.exec_counters[key] = str(value)
        try:
            self._stub.report_task_result(
                request, timeout=GRPC.DEFAULT_RPC_TIMEOUT_SECS
            )
        except grpc.RpcError:
            logger.warning("report_task_result(%s) failed", task_id)

    def report_evaluation_metrics(self, model_version, model_outputs, labels):
        request = pb.ReportEvaluationMetricsRequest(
            worker_id=self._worker_id, model_version=model_version
        )
        for name, array in model_outputs.items():
            ndarray_to_blob(array, request.model_outputs[name])
        ndarray_to_blob(labels, request.labels)
        try:
            self._stub.report_evaluation_metrics(
                request, timeout=GRPC.DEFAULT_RPC_TIMEOUT_SECS
            )
        except grpc.RpcError:
            logger.warning("report_evaluation_metrics failed")

    def report_version(self, model_version):
        try:
            self._stub.report_version(
                pb.ReportVersionRequest(model_version=model_version),
                timeout=GRPC.DEFAULT_RPC_TIMEOUT_SECS,
            )
        except grpc.RpcError:
            logger.warning("report_version(%s) failed", model_version)

    def reset_worker(self):
        """Declare this process a fresh incarnation of worker_id: the
        master requeues (uncounted) any task a dead predecessor still
        holds. Call once at startup.

        Returns the master-assigned relaunch epoch (also kept on
        ``self.incarnation``), or None when the RPC failed."""
        try:
            response = self._stub.reset_worker(
                pb.GetTaskRequest(worker_id=self._worker_id),
                timeout=GRPC.DEFAULT_RPC_TIMEOUT_SECS,
            )
        except grpc.RpcError:
            logger.warning("reset_worker failed")
            return None
        self._incarnation = response.restart_count
        self._registered = True
        self._channel_ok = True
        if response.master_epoch:
            self._seen_master_epoch = response.master_epoch
        return self._incarnation

    def deregister_worker(self, reason="", pushes_joined=False,
                          tier_flushed=False, tasks_reported=0):
        """The graceful-drain ack: tell the master this worker leaves on
        purpose, after flushing. True when the master acknowledged;
        False when the RPC failed (a master without the method answers
        UNIMPLEMENTED, or the master is gone): the caller exits anyway
        and the master's liveness and drain-deadline fallback covers the
        cleanup."""
        request = self._attach_telemetry(
            pb.DeregisterWorkerRequest(
                worker_id=self._worker_id,
                reason=reason,
                pushes_joined=pushes_joined,
                tier_flushed=tier_flushed,
                tasks_reported=tasks_reported,
            )
        )
        try:
            self._stub.deregister_worker(
                request, timeout=GRPC.DEFAULT_RPC_TIMEOUT_SECS
            )
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            if code == grpc.StatusCode.UNIMPLEMENTED:
                logger.warning(
                    "master predates deregister_worker; exiting without "
                    "a drain ack (the liveness fallback will requeue)"
                )
            else:
                logger.warning("deregister_worker failed: %s", code)
            return False
        self._registered = False
        return True

    def get_comm_info(self):
        """The heartbeat and the PS's liveness poll. A failure answers
        ``mesh_epoch=-1`` (the master-gone marker)."""
        request = self._attach_telemetry(
            pb.GetCommInfoRequest(
                worker_id=self._worker_id,
                worker_host=self._worker_host,
            )
        )
        try:
            # a short channel-driving retry: fail-fast attempts alone
            # never re-dial a TRANSIENT_FAILURE channel
            info = retry_call(
                lambda: self._stub.get_comm_info(
                    request, timeout=GRPC.DEFAULT_RPC_TIMEOUT_SECS
                ),
                "get_comm_info",
                8.0,
                retryable=(grpc.StatusCode.UNAVAILABLE,),
                channel=self._channel,
            )
        except grpc.RpcError:
            self._channel_ok = False
            return pb.CommInfo(rank=-1, world_size=0, mesh_epoch=-1)
        self._channel_ok = True
        # the heartbeat is usually the first RPC to see a restarted
        # master: re-register before the next dispatch, unless a
        # get_task is in flight and re-registers from its own response
        if self._register_lock.acquire(blocking=False):
            try:
                self._maybe_reregister(info.master_epoch)
            finally:
                self._register_lock.release()
        return info

    def close(self):
        self._channel.close()
