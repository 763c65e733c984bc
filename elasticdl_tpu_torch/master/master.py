"""Master composition root: owns the whole job (port of
elasticdl_tpu/master/master.py).

Loads the model module, builds the task dispatcher over the readers'
shards, starts the evaluation service, the gRPC server and the task
monitor, then polls for completion. The job type follows the data
given: prediction data makes a prediction-only job, validation data
alone an evaluation-only one. With ``saved_model_path`` (``--output``)
a training job ends with the train-end task, whose worker exports the
model there. The master runs on the host: it touches no card.

With ``EDL_STATE_DIR`` set the master journals its state there
(master/state_store.py): a master relaunched with the same flags and
directory replays it and finishes the job, every task done once. The
``DrainManager`` (master/autoscaler.py) serves workers that drain on
SIGTERM.

Not ported (ROADMAP): the pod manager and the elastic controller, the
fleet monitor, the stream feeder, tensorboard and the observability
endpoints.
"""

import time

from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.common.grpc_utils import build_server
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.data.readers import create_data_reader
from elasticdl_tpu_torch.master.autoscaler import DrainManager
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.rendezvous import MeshRendezvous
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.state_store import MasterStateJournal
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.master.task_monitor import TaskMonitor
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.proto.services import add_master_servicer_to_server

logger = _logger_factory("elasticdl_tpu_torch.master.master")


class Master:
    def __init__(
        self,
        model_zoo_module,
        training_data=None,
        validation_data=None,
        prediction_data=None,
        records_per_task=1024,
        num_epochs=1,
        port=50001,
        eval_steps=0,
        eval_throttle_secs=0,
        eval_start_delay_secs=0,
        saved_model_path=None,
        data_reader_params=None,
        task_timeout_secs=30.0,
        seed=None,
        model_def="",
        model_params="",
    ):
        self.spec = get_model_spec(
            model_zoo_module, model_def=model_def,
            model_params=model_params,
        )
        reader_params = data_reader_params or {}

        def shards_of(origin):
            if not origin:
                return {}
            reader = create_data_reader(origin, **reader_params)
            return reader.create_shards()

        self.job_type = self._infer_job_type(
            training_data, validation_data, prediction_data
        )
        # crash recovery (EDL_STATE_DIR): replay the predecessor's
        # journal, so a relaunched master resumes the job mid-epoch
        self.state_journal = MasterStateJournal.maybe_create()
        self._recovered = (
            self.state_journal.load()
            if self.state_journal is not None
            else None
        )
        self.task_dispatcher = TaskDispatcher(
            training_shards=shards_of(training_data),
            evaluation_shards=shards_of(validation_data),
            prediction_shards=shards_of(prediction_data),
            records_per_task=records_per_task,
            num_epochs=num_epochs,
            seed=seed,
            state_journal=self.state_journal,
            recovered=self._recovered,
        )
        if saved_model_path and self.job_type != JobType.PREDICTION_ONLY:
            self.task_dispatcher.add_deferred_callback_create_train_end_task(
                {"saved_model_path": saved_model_path}
            )
        self.evaluation_service = None
        if validation_data:
            self.evaluation_service = EvaluationService(
                self.task_dispatcher,
                self.spec.eval_metrics_fn,
                eval_start_delay_secs=eval_start_delay_secs,
                eval_throttle_secs=eval_throttle_secs,
                eval_steps=eval_steps,
            )
        self.rendezvous = MeshRendezvous()
        self.servicer = MasterServicer(
            self.task_dispatcher,
            self.evaluation_service,
            self.rendezvous,
            state_journal=self.state_journal,
            recovered=self._recovered,
        )
        if self.state_journal is not None:
            # compaction snapshots read the live state from both owners
            self.state_journal.register_section(
                "dispatcher", self.task_dispatcher.export_state
            )
            self.state_journal.register_section(
                "workers", self.servicer.export_worker_state
            )
        # the deregister RPC and SIGTERM drains need it on any fleet
        self.drain_manager = DrainManager(
            self.task_dispatcher,
            servicer=self.servicer,
            rendezvous=self.rendezvous,
        )
        self.servicer.drain_manager = self.drain_manager
        self.task_monitor = TaskMonitor(
            self.task_dispatcher,
            self.servicer,
            self.rendezvous,
            liveness_timeout_secs=task_timeout_secs,
            drain_manager=self.drain_manager,
        )
        self._task_timeout_secs = task_timeout_secs
        self._port = port
        self._server = None

    @staticmethod
    def _infer_job_type(training_data, validation_data, prediction_data):
        if prediction_data:
            return JobType.PREDICTION_ONLY
        if training_data and validation_data:
            return JobType.TRAINING_WITH_EVALUATION
        if validation_data:
            return JobType.EVALUATION_ONLY
        return JobType.TRAINING_ONLY

    # ------------------------------------------------------------------
    def prepare(self):
        if self.evaluation_service is not None:
            self.evaluation_service.start()
        if self.job_type == JobType.EVALUATION_ONLY:
            n = self.task_dispatcher.create_evaluation_tasks(-1)
            if self.evaluation_service is not None:
                self.evaluation_service.init_eval_only_job(n)
        self._server = build_server()
        add_master_servicer_to_server(self.servicer, self._server)
        try:
            bound = self._server.add_insecure_port("[::]:%d" % self._port)
        except RuntimeError:
            bound = 0
        if not bound:
            # a relaunch whose port another process took meanwhile:
            # fail now, with the reason, rather than serve nowhere
            logger.error("Master cannot bind port %d (in use by another "
                         "process); exiting", self._port)
            raise RuntimeError("master cannot bind port %d" % self._port)
        self._server.start()
        self.task_monitor.start()
        logger.info("Master serving on :%d", self._port)
        return self

    def run(self, poll_secs=1.0, timeout_secs=None):
        """Block until the job finishes; returns 0 on success, 1 on
        failure (task retries exhausted, or ``timeout_secs`` passed).

        A finished job keeps serving until every live worker has been
        answered "job over" (at most the liveness timeout): a worker
        that polls while it waits for its last task must not find the
        server gone and sit out its reconnect budget."""
        start = time.time()
        try:
            while True:
                if self.task_dispatcher.finished():
                    logger.info("Job finished")
                    self._wait_for_workers_told()
                    return 0
                if self.task_dispatcher.job_failed():
                    logger.error("Job failed (task retries exhausted)")
                    self._wait_for_workers_told()
                    return 1
                if timeout_secs and time.time() - start > timeout_secs:
                    logger.error("Job timed out")
                    return 1
                time.sleep(poll_secs)
        finally:
            self.stop()

    def _wait_for_workers_told(self):
        deadline = time.time() + self._task_timeout_secs
        while (self.servicer.workers_not_told_job_over()
               and time.time() < deadline):
            time.sleep(0.05)

    def stop(self):
        self.task_monitor.stop()
        if self.evaluation_service is not None:
            self.evaluation_service.stop()
        if self._server is not None:
            self._server.stop(grace=1.0).wait()
            self._server = None
        if self.state_journal is not None:
            self.state_journal.close()
