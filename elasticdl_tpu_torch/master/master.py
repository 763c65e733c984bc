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

A ``pod_manager`` (k8s/pod_manager.py ``K8sPodManager``, attached by
master/main.py in a cluster) starts the PS and worker pods at the end of
``prepare``, relaunches the ones that die, deletes a worker the task
monitor presumes dead, and patches the master pod's status label at
``stop``; the job fails when every worker pod failed. With
``EDL_AUTOSCALE`` and a pod manager, ``prepare`` also makes the
``ElasticController``, which grows and shrinks the fleet on the task
monitor's scan (master/autoscaler.py).

The master builds one ``FleetMonitor`` (master/fleet.py), fed by the
telemetry its workers and PS piggyback on their RPCs and evaluated on
the task monitor's scan. With ``metrics_port`` (``--metrics_port`` or
``EDL_METRICS_PORT``) it serves ``/metrics``, ``/healthz``, ``/readyz``,
``/statusz`` (the fleet snapshot and the task queue) and ``/alerts``
(the firing detectors); ``EDL_EVENTS_DIR`` and ``EDL_TRACE_DIR`` turn on
its events journal and trace.

Continual streaming (``EDL_STREAM=synthetic|replay``, stream/feeder.py):
training tasks are minted from arriving windows by a ``StreamFeeder``
thread instead of epochs, ``training_data`` is the window spool (or the
replayed origin), and the feeder mints export tasks on the watermark's
``EDL_STREAM_EXPORT_EVERY`` cadence. ``tensorboard_log_dir``
(``--tensorboard_log_dir``) writes each evaluation's metrics as
TensorBoard scalars (master/tensorboard_service.py).
"""

import os
import time

from elasticdl_tpu_torch.common.constants import JobType
from elasticdl_tpu_torch.common.grpc_utils import build_server
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.data.readers import create_data_reader
from elasticdl_tpu_torch.master.autoscaler import (
    DrainManager,
    ElasticController,
)
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.fleet import FleetMonitor
from elasticdl_tpu_torch.master.rendezvous import MeshRendezvous
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.state_store import MasterStateJournal
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.master.task_monitor import TaskMonitor
from elasticdl_tpu_torch.master.tensorboard_service import TensorboardService
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.observability import (
    events,
    http_server,
    profiler,
    trace,
)
from elasticdl_tpu_torch.proto.services import add_master_servicer_to_server
from elasticdl_tpu_torch.stream.feeder import StreamFeeder, source_from_env

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
        pod_manager=None,
        seed=None,
        model_def="",
        model_params="",
        symbol_overrides=None,
        metrics_port=0,
        tensorboard_log_dir=None,
        mesh_restart_grace_secs=30.0,
        mesh_rejoin_timeout_secs=90.0,
    ):
        if metrics_port:
            # programmatic construction (no CLI entry ran): publish the
            # knob before the first instrument is constructed (the
            # fleet monitor's alert counter below is the earliest), or
            # the process-global registry freezes disabled and /metrics
            # serves empty
            os.environ.setdefault(http_server.PORT_ENV, str(metrics_port))
        self.spec = get_model_spec(
            model_zoo_module, model_def=model_def,
            model_params=model_params,
            symbol_overrides=symbol_overrides,
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
        # streaming mode (EDL_STREAM): tasks come from arriving windows,
        # so training_data is never sharded up front
        stream_source = source_from_env(
            training_data, reader_params=reader_params
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
            training_shards=(
                {} if stream_source is not None
                else shards_of(training_data)
            ),
            evaluation_shards=shards_of(validation_data),
            prediction_shards=shards_of(prediction_data),
            records_per_task=records_per_task,
            num_epochs=0 if stream_source is not None else num_epochs,
            seed=seed,
            state_journal=self.state_journal,
            recovered=self._recovered,
            stream=stream_source is not None,
        )
        # cluster-level fleet view + anomaly detectors (/statusz,
        # /alerts): fed by telemetry piggybacked on worker/PS RPCs,
        # evaluated on the task monitor's scan tick
        self.fleet_monitor = FleetMonitor()
        # built after the fleet monitor: the windows' drift stats fold
        # straight into its label_shift detector
        self.stream_feeder = None
        if stream_source is not None:
            self.stream_feeder = StreamFeeder(
                self.task_dispatcher,
                stream_source,
                saved_model_path=saved_model_path or "",
                fleet=self.fleet_monitor,
            )
        if saved_model_path and self.job_type != JobType.PREDICTION_ONLY:
            self.task_dispatcher.add_deferred_callback_create_train_end_task(
                {"saved_model_path": saved_model_path}
            )
        self.tensorboard_service = None
        if tensorboard_log_dir:
            self.tensorboard_service = TensorboardService(tensorboard_log_dir)
        self.evaluation_service = None
        if validation_data:
            self.evaluation_service = EvaluationService(
                self.task_dispatcher,
                self.spec.eval_metrics_fn,
                eval_start_delay_secs=eval_start_delay_secs,
                eval_throttle_secs=eval_throttle_secs,
                eval_steps=eval_steps,
                summary_writer=self.tensorboard_service,
            )
        self.rendezvous = MeshRendezvous()
        self.servicer = MasterServicer(
            self.task_dispatcher,
            self.evaluation_service,
            self.rendezvous,
            fleet_monitor=self.fleet_monitor,
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
        self.pod_manager = pod_manager
        # the deregister RPC and SIGTERM drains need it on any fleet; the
        # autoscaler only under EDL_AUTOSCALE with a pod manager that can
        # scale, made in prepare() (main() may attach one after this)
        self.drain_manager = DrainManager(
            self.task_dispatcher,
            servicer=self.servicer,
            fleet=self.fleet_monitor,
            rendezvous=self.rendezvous,
        )
        self.servicer.drain_manager = self.drain_manager
        self.autoscaler = None
        self.task_monitor = TaskMonitor(
            self.task_dispatcher,
            self.servicer,
            self.rendezvous,
            on_worker_dead=self._on_worker_dead,
            liveness_timeout_secs=task_timeout_secs,
            mesh_restart_grace_secs=mesh_restart_grace_secs,
            mesh_rejoin_timeout_secs=mesh_rejoin_timeout_secs,
            fleet_monitor=self.fleet_monitor,
            drain_manager=self.drain_manager,
        )
        self._task_timeout_secs = task_timeout_secs
        self._port = port
        self._server = None
        self._metrics_port = metrics_port
        self._serving = False
        self.observability = None
        self._register_domain_gauges()

    def _register_domain_gauges(self):
        """Master-side gauges: pending/doing/done task counts, per-stage
        queue depth, and worker relaunches, callback-fed from the
        dispatcher/servicer so a scrape always reads live state. All
        no-op instruments when metrics collection is off."""
        from elasticdl_tpu_torch.observability import metrics as obs_metrics

        dispatcher = self.task_dispatcher
        # one dispatcher.stats() snapshot per scrape, not one per
        # series: each stats() is an O(tasks) scan under the dispatcher
        # lock the RPC handlers contend on
        cache = {"at": 0.0, "stats": None}

        def stats():
            now = time.monotonic()
            if cache["stats"] is None or now - cache["at"] > 1.0:
                cache["stats"] = dispatcher.stats()
                cache["at"] = now
            return cache["stats"]

        tasks = obs_metrics.gauge(
            "edl_master_tasks",
            "Task counts by lifecycle state and task type",
            ("state", "type"),
        )
        for type_name in ("training", "evaluation", "prediction"):
            for state in ("pending", "doing", "done"):
                tasks.labels(state=state, type=type_name).set_function(
                    lambda state=state, type_name=type_name: stats()[
                        state
                    ].get(type_name, 0)
                )
        depth = obs_metrics.gauge(
            "edl_master_queue_depth",
            "Tasks queued per dispatch stage (training includes the "
            "train-end callback task)",
            ("queue",),
        )
        for queue in ("training", "evaluation"):
            depth.labels(queue=queue).set_function(
                lambda queue=queue: stats()["queue_depth"][queue]
            )
        obs_metrics.gauge(
            "edl_master_epochs_left", "Training epochs not yet created"
        ).set_function(lambda: stats()["epochs_left"])
        servicer = self.servicer
        # no _total suffix: a callback-fed snapshot that resets with
        # the master, exposed as a gauge
        obs_metrics.gauge(
            "edl_master_worker_relaunches",
            "Worker relaunches observed (reset_worker beyond a "
            "worker_id's first)",
        ).set_function(servicer.worker_relaunch_count)
        obs_metrics.gauge(
            "edl_master_live_workers",
            "Workers with a liveness entry (heartbeating recently)",
        ).set_function(lambda: len(servicer.worker_liveness()))

    @staticmethod
    def _infer_job_type(training_data, validation_data, prediction_data):
        if prediction_data:
            return JobType.PREDICTION_ONLY
        if training_data and validation_data:
            return JobType.TRAINING_WITH_EVALUATION
        if validation_data:
            return JobType.EVALUATION_ONLY
        return JobType.TRAINING_ONLY

    def _on_worker_dead(self, worker_id):
        if self.pod_manager is not None:
            self.pod_manager.on_worker_presumed_dead(worker_id)

    # ------------------------------------------------------------------
    def prepare(self):
        if self.autoscaler is None and self.pod_manager is not None:
            # None on a static fleet, or when the pod manager cannot
            # scale (maybe_create checks both)
            self.autoscaler = ElasticController.maybe_create(
                self.task_dispatcher,
                self.pod_manager,
                self.drain_manager,
                fleet=self.fleet_monitor,
            )
            if self.autoscaler is not None:
                self.task_monitor.set_autoscaler(self.autoscaler)
                logger.info("Autoscaler enabled: %s",
                            self.autoscaler.state())
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
        self._serving = True
        trace.configure("master")
        events.configure("master")
        events.emit("role_start", port=self._port)
        # the host stack sampler: on when EDL_PROF_HZ is set, served as
        # /profilez on the observability port below
        profiler.maybe_start("master")
        if self._recovered is not None:
            # flight-recorder marker: the postmortem threads the crash,
            # the relaunch and the resumed dispatch into one timeline
            events.emit(
                "master_restarted",
                master_epoch=self.state_journal.master_epoch,
                todo=len(self._recovered.get("todo", ())),
                requeued=len(self._recovered.get("doing", ())),
                epochs_left=self._recovered.get("epochs_left", 0),
            )
        self.observability = http_server.maybe_start(
            "master", cli_port=self._metrics_port
        )
        if self.observability is not None:
            # readiness milestone: the gRPC servicer is started
            self.observability.add_readiness_check(
                "servicer_started", lambda: self._serving
            )
            # the cluster-level view: the fleet snapshot (+ task queue
            # stats) and the firing anomaly detectors
            self.observability.add_json_handler(
                "/statusz",
                lambda: self.fleet_monitor.snapshot(
                    extra={
                        "tasks": self.task_dispatcher.stats(),
                        "draining": self.drain_manager.state(),
                        "autoscaler": (
                            self.autoscaler.state()
                            if self.autoscaler is not None
                            else None
                        ),
                        "stream": (
                            self.stream_feeder.state()
                            if self.stream_feeder is not None
                            else None
                        ),
                    }
                ),
            )
            self.observability.add_json_handler(
                "/alerts", self.fleet_monitor.alerts
            )
        if self.tensorboard_service is not None:
            self.tensorboard_service.start()
        if self.stream_feeder is not None:
            # after the journal replay settled the dispatcher: the
            # feeder seeks the source to the journaled position
            self.stream_feeder.start()
        self.task_monitor.start()
        if self.pod_manager is not None:
            self.pod_manager.start()
        logger.info("Master serving on :%d", self._port)
        return self

    def run(self, poll_secs=1.0, timeout_secs=None):
        """Block until the job finishes; returns 0 on success, 1 on
        failure (task retries exhausted, every worker pod failed, or
        ``timeout_secs`` passed).

        A finished job keeps serving until every live worker has been
        answered "job over" (at most the liveness timeout): a worker
        that polls while it waits for its last task must not find the
        server gone and sit out its reconnect budget. A finished stream
        also waits, within the same bound, until every live PS has read
        the final watermark, so its last stream checkpoint is taken."""
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
                if (
                    self.pod_manager is not None
                    and self.pod_manager.all_workers_failed()
                ):
                    logger.error("All workers failed; aborting job")
                    return 1
                if timeout_secs and time.time() - start > timeout_secs:
                    logger.error("Job timed out")
                    return 1
                time.sleep(poll_secs)
        finally:
            self.stop()

    def _wait_for_workers_told(self):
        deadline = time.time() + self._task_timeout_secs
        stream = self.task_dispatcher.stream_state()["stream"]
        watermark = self.task_dispatcher.stream_watermark()
        while ((self.servicer.workers_not_told_job_over()
                or (stream and self.servicer.pollers_behind_watermark(
                    watermark)))
               and time.time() < deadline):
            time.sleep(0.05)

    def stop(self):
        self._serving = False
        if self.observability is not None:
            self.observability.stop()
            self.observability = None
        events.emit("role_stop")
        events.flush()
        trace.flush()
        if self.stream_feeder is not None:
            self.stream_feeder.stop()
        self.task_monitor.stop()
        if self.evaluation_service is not None:
            self.evaluation_service.stop()
        if self.tensorboard_service is not None:
            self.tensorboard_service.stop()
        if self.pod_manager is not None:
            self.pod_manager.stop()
        if self._server is not None:
            self._server.stop(grace=1.0).wait()
            self._server = None
        if self.state_journal is not None:
            self.state_journal.close()
