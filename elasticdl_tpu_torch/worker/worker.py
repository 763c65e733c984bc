"""The elastic worker: pulls tasks from the master and trains on the
card (port of elasticdl_tpu/worker/worker.py).

What the worker keeps of the reference is the protocol: the continuous
task stream with record-level accounting (worker/task_data_service.py),
evaluation tasks interleaved with training, model-version reports that
let the master trigger evaluations, and a heartbeat that keeps the
master's liveness table fresh through long steps. A model with sparse
embedding specs (DeepFM) trains through ``train.sparse.SparseTrainer``
over the PS processes (``PSClient``, stamped with the master-assigned
incarnation), sequentially or through the pipelined ``train_stream``;
any other model through ``worker.trainer.TorchTrainer``. Both run on
``device`` (``cuda`` unless the caller asks for the CPU; no card
raises).

Not ported (ROADMAP): the lockstep multi-host loop, the graceful
drain, dense checkpoints, prediction tasks, the train-end task with
its callbacks (a train-end task is handed back failed), stream
checkpoints, telemetry and trace spans.
"""

import contextlib
import threading
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.common.timing_utils import Timing
from elasticdl_tpu_torch.data.pipeline import (
    Dataset,
    batch_real_count,
    normalize_outputs,
)
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.train.health import HealthSentinelError
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

logger = _logger_factory("elasticdl_tpu_torch.worker.worker")


class Worker:
    # the heartbeat's get_comm_info cadence: well inside the master's
    # liveness timeout (--task_timeout_secs)
    HEARTBEAT_SECS = 3.0

    def __init__(
        self,
        master_client,
        model_zoo_module,
        data_reader,
        minibatch_size=32,
        mode=Mode.TRAINING,
        compute_dtype=None,
        report_version_steps=10,
        wait_sleep_secs=2.0,
        seed=0,
        trainer_factory=None,
        grad_accum_steps=1,
        ps_addrs=None,
        sparse_pipeline=False,
        sparse_cache_staleness=0,
        sparse_push_interval=1,
        model_def="",
        model_params="",
        log_loss_steps=100,
        device="cuda",
    ):
        """``trainer_factory(**kwargs)`` replaces the trainer class (a
        test injects one); it gets the keyword arguments of
        ``SparseTrainer`` for a sparse model and of ``TorchTrainer``
        otherwise."""
        self.device = resolve_device(device)
        self._mc = master_client
        self.spec = get_model_spec(
            model_zoo_module, model_def=model_def,
            model_params=model_params,
        )
        self.spec.require_training()
        self._log_loss_steps = log_loss_steps
        self._reader = data_reader
        self._minibatch_size = minibatch_size
        self._mode = mode
        self._report_version_steps = report_version_steps
        self.tds = TaskDataService(
            master_client, data_reader, wait_sleep_secs=wait_sleep_secs
        )
        # the weights come from ``seed`` without touching the caller's
        # global RNG stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = self.spec.custom_model()
        trainer_kwargs = dict(
            model=model,
            loss_fn=self.spec.loss,
            optimizer=self.spec.optimizer(),
            compute_dtype=compute_dtype,
            device=self.device,
        )
        if self.spec.sparse_embedding_specs:
            # sparse model: PS embedding tables + dense on the card
            if not ps_addrs:
                raise ValueError(
                    "Model %s declares sparse_embedding_specs; the worker "
                    "needs --ps_addrs pointing at parameter servers"
                    % model_zoo_module
                )
            from elasticdl_tpu_torch.train.sparse import SparseTrainer
            from elasticdl_tpu_torch.worker.ps_client import PSClient

            factory = trainer_factory or SparseTrainer
            trainer_kwargs["specs"] = self.spec.sparse_embedding_specs(
                batch_size=minibatch_size
            )
            trainer_kwargs["ps_client"] = PSClient(
                ps_addrs, worker_id=self._mc.worker_id,
                # master-assigned relaunch epoch (reset_worker in
                # worker/main.py): a relaunch orders after its dead
                # predecessor at the sync PS
                incarnation=getattr(self._mc, "incarnation", None),
            )
            trainer_kwargs["seed"] = seed
            trainer_kwargs["cache_staleness"] = sparse_cache_staleness
        else:
            from elasticdl_tpu_torch.worker.trainer import TorchTrainer

            factory = trainer_factory or TorchTrainer
            trainer_kwargs["grad_accum_steps"] = grad_accum_steps
        self.trainer = factory(**trainer_kwargs)
        # the pipelined sparse stream only where it exists and the model
        # is sparse (train/sparse.py train_stream)
        self._sparse_pipeline = bool(
            sparse_pipeline
            and self.spec.sparse_embedding_specs
            and hasattr(self.trainer, "train_stream")
        )
        self._sparse_push_interval = max(1, sparse_push_interval)
        self.state = None
        self._version = 0
        # per-phase wall clock (EDL_TIMING=1)
        self._timing = Timing()
        self._heartbeat_stop = threading.Event()
        self._heartbeat_thread = None

    def _start_heartbeat(self):
        def beat():
            while not self._heartbeat_stop.wait(self.HEARTBEAT_SECS):
                self._mc.get_comm_info()

        self._heartbeat_thread = threading.Thread(
            target=beat, name="worker-heartbeat", daemon=True
        )
        self._heartbeat_thread.start()

    def _stop_heartbeat(self):
        self._heartbeat_stop.set()
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join()
            self._heartbeat_thread = None

    # ------------------------------------------------------------------
    @property
    def model_version(self):
        return self._version

    def _batches(self, record_stream, mode):
        dataset = self.spec.dataset_fn(
            Dataset(lambda: record_stream), mode, self._reader.metadata
        )
        return dataset.batch(self._minibatch_size).prefetch(2)

    def _join_trainer_pushes(self):
        """Depth-1 async-push barrier (train/sparse.py join_pushes) at a
        stream boundary, so an in-flight push lands or raises here. A
        no-op for dense trainers."""
        join = getattr(self.trainer, "join_pushes", None)
        if join is not None:
            join()

    def _timed_train_step(self, batch):
        t0 = self._timing.start()
        self.state, loss = self.trainer.train_step(self.state, batch)
        self._timing.end_record_sync("batch_process", t0, loss)
        return loss

    def _after_train_batch(self, batch, loss):
        """Per-batch bookkeeping shared by both loops: version, record
        accounting, version reports, the loss log."""
        self._version += 1
        with self._timing.timeit("report_record"):
            self.tds.report_record_done(batch_real_count(batch))
        if (
            self._report_version_steps
            and self._version % self._report_version_steps == 0
        ):
            self._mc.report_version(self._version)
        if (
            self._log_loss_steps
            and self._version % self._log_loss_steps == 0
        ):
            # the float() fetch syncs only on these steps
            logger.info(
                "step %d loss %.6f", self._version, float(loss)
            )

    def _train_batches_pipelined(self, batches):
        """Drive the sparse trainer's pipelined stream: batch N+1's PS
        pull rides under batch N's step, pushes go out on a background
        thread (train/sparse.py train_stream)."""
        stream = self.trainer.train_stream(
            self.state,
            batches,
            push_interval=self._sparse_push_interval,
        )
        # deterministic close: the stream's finally drains the in-flight
        # background push even when an exception unwinds
        with contextlib.closing(stream):
            for state, loss, batch in stream:
                self.state = state
                self._after_train_batch(batch, loss)

    def _train_batches_sequential(self, batches):
        for batch in batches:
            loss = self._timed_train_step(batch)
            self._after_train_batch(batch, loss)

    def _run_training_stream(self):
        """Consume one continuous training stream until it pauses."""
        try:
            batches = self._batches(
                self.tds.training_record_stream(), Mode.TRAINING
            )
            if self._sparse_pipeline:
                self._train_batches_pipelined(batches)
            else:
                self._train_batches_sequential(batches)
            # stream boundary: a failed in-flight async push surfaces
            # here and routes through the same handlers as an in-stream
            # failure (tasks get retried, not lost)
            self._join_trainer_pushes()
        except HealthSentinelError as e:
            # EDL_HEALTH_ON_NONFINITE=halt: the task fails loudly (a
            # counted failure), parked work goes back, and the error
            # propagates: never train past a halt
            self.tds.report_pending_failed("health halt: %s" % (e,))
            self.tds.report_parked_failed("requeue: health halt")
            raise
        except Exception as e:  # report so tasks get retried elsewhere
            logger.exception("Training stream failed")
            self.tds.report_pending_failed(str(e))
        finally:
            self._timing.report("training stream")
            trainer_timing = getattr(self.trainer, "timing", None)
            if trainer_timing is not None:
                trainer_timing.report("sparse trainer")

    def _process_eval_task(self, task):
        try:
            for batch in self._batches(
                self.tds.task_record_stream(task), Mode.EVALUATION
            ):
                self.state = self.trainer.ensure_state(self.state, batch)
                outputs = self.trainer.eval_step(self.state, batch)
                real = batch_real_count(batch)
                outputs = normalize_outputs(outputs, real)
                labels = np.asarray(batch["labels"])[:real]
                self._mc.report_evaluation_metrics(
                    task.model_version, outputs, labels
                )
            self._mc.report_task_result(task.task_id)
        except Exception as e:
            logger.exception("Evaluation task %s failed", task.task_id)
            self._mc.report_task_result(task.task_id, str(e))

    def _drain_out_of_band(self):
        while self.tds.out_of_band_tasks:
            task = self.tds.out_of_band_tasks.popleft()
            if task.type == pb.EVALUATION:
                self._process_eval_task(task)
            else:
                # prediction tasks are not ported: a counted failure, so
                # a job that hands them out fails loudly at the cap
                logger.error("Unsupported task type %s", task.type)
                self._mc.report_task_result(
                    task.task_id, "task type %s is not supported by this "
                    "worker" % pb.TaskType.Name(task.type)
                )

    # ------------------------------------------------------------------
    def run(self):
        self._start_heartbeat()
        try:
            self._run()
        finally:
            self._stop_heartbeat()
            # release the sparse trainer's push thread and write the
            # device tier's rows back (failures were surfaced at the
            # stream boundary, so close only logs)
            close = getattr(self.trainer, "close", None)
            if close is not None:
                close()

    def _run(self):
        if self._mode == Mode.EVALUATION:
            self._run_task_mode(pb.EVALUATION, self._process_eval_task)
            return
        while True:
            self._run_training_stream()
            self._drain_out_of_band()
            if self.tds.train_end_task is not None:
                # train-end callbacks are not ported: hand the task back
                # as a counted failure rather than report an export done
                logger.error("train-end task received; not supported")
                self.tds.report_parked_failed(
                    "train-end callbacks are not supported by this worker"
                )
                continue
            if self.tds.job_over:
                logger.info(
                    "Worker %s done at version %d",
                    self._mc.worker_id,
                    self._version,
                )
                return

    def _run_task_mode(self, task_type, process_fn):
        while True:
            task = self._mc.get_task(task_type)
            if task.task_id == 0:
                if task.type == pb.WAIT:
                    time.sleep(0.2)
                    continue
                return
            process_fn(task)
