"""Evaluation orchestration on the master (port of
elasticdl_tpu/master/evaluation_service.py).

A time-based trigger thread, a step-based trigger driven by model
version reports, and one EvaluationJob at a time accumulating metrics
over worker-reported (model_outputs, labels) chunks.
"""

import threading

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.common.tensor_utils import blob_to_ndarray
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.train.metrics import EvaluationMetrics

logger = _logger_factory("elasticdl_tpu_torch.master.evaluation_service")


class EvaluationJob:
    """One evaluation pass at a given model version."""

    def __init__(self, metrics_dict, model_version, total_tasks=-1):
        self.model_version = model_version
        self._total_tasks = total_tasks
        self._completed_tasks = 0
        self.evaluation_metrics = EvaluationMetrics(metrics_dict)

    def complete_task(self):
        self._completed_tasks += 1

    def finished(self):
        return self._total_tasks >= 0 and self._completed_tasks >= self._total_tasks

    def report_evaluation_metrics(self, model_outputs_pb, labels_pb):
        labels = blob_to_ndarray(labels_pb)
        outputs = {
            name: blob_to_ndarray(blob)
            for name, blob in model_outputs_pb.items()
        }
        self.evaluation_metrics.update_evaluation_metrics(outputs, labels)
        return True


class EvaluationService:
    """Creates evaluation tasks and books their reported metrics.

    Triggers: every ``eval_throttle_secs`` after ``eval_start_delay_secs``
    (time-based), and/or every ``eval_steps`` model versions (step-based).
    Only one job runs at a time; overlapping triggers are dropped.
    """

    def __init__(
        self,
        task_dispatcher,
        eval_metrics_fn,
        eval_start_delay_secs=0,
        eval_throttle_secs=0,
        eval_steps=0,
        eval_only=False,
        summary_writer=None,
    ):
        self._task_dispatcher = task_dispatcher
        self._eval_metrics_fn = eval_metrics_fn
        self._start_delay_secs = eval_start_delay_secs
        self._throttle_secs = eval_throttle_secs
        self._eval_steps = eval_steps
        self._eval_only = eval_only
        self._summary_writer = summary_writer

        self._lock = threading.Lock()
        self._trigger_lock = threading.Lock()
        self._eval_job = None
        self._last_eval_version = -1
        self._stopping = threading.Event()
        self._timer_thread = None
        self.completed_summaries = []  # [(model_version, summary_dict)]

        task_dispatcher.add_task_completed_callback(self._on_task_completed)

    # ------------------------------------------------------------------
    def start(self):
        if self._throttle_secs > 0:
            self._timer_thread = threading.Thread(
                target=self._time_trigger_loop,
                name="evaluation-timer",
                daemon=True,
            )
            self._timer_thread.start()
        return self

    def stop(self):
        self._stopping.set()

    def _time_trigger_loop(self):
        if self._stopping.wait(self._start_delay_secs):
            return
        while not self._stopping.is_set():
            self.add_evaluation_task(model_version=-1)
            if self._stopping.wait(self._throttle_secs):
                return

    # ------------------------------------------------------------------
    def add_evaluation_task(self, model_version):
        """Queue a full evaluation pass unless one is already running."""
        with self._lock:
            if self._eval_job is not None:
                return False
            total = self._task_dispatcher.create_evaluation_tasks(model_version)
            if total == 0:
                return False
            self._eval_job = EvaluationJob(
                self._eval_metrics_fn(), model_version, total_tasks=total
            )
            return True

    def add_evaluation_task_if_needed(self, model_version):
        """Step-based trigger: called on report_version from the trainer.

        The high-water mark only advances when a job is actually created,
        so an eval window that arrives while another job is running is
        deferred to the next report, not silently dropped.
        """
        if self._eval_steps <= 0:
            return False
        with self._trigger_lock:
            if model_version < self._last_eval_version + self._eval_steps:
                return False
            created = self.add_evaluation_task(model_version)
            if created:
                self._last_eval_version = model_version
            return created

    def init_eval_only_job(self, num_tasks):
        with self._lock:
            self._eval_job = EvaluationJob(
                self._eval_metrics_fn(), model_version=-1, total_tasks=num_tasks
            )

    # ------------------------------------------------------------------
    def report_evaluation_metrics(self, model_outputs_pb, labels_pb):
        with self._lock:
            if self._eval_job is None:
                return False
            return self._eval_job.report_evaluation_metrics(
                model_outputs_pb, labels_pb
            )

    def _on_task_completed(self, task):
        if task is None or task.type != pb.EVALUATION:
            return
        finished_job = None
        with self._lock:
            if self._eval_job is None:
                return
            self._eval_job.complete_task()
            if self._eval_job.finished():
                finished_job = self._eval_job
                self._eval_job = None
        if finished_job is not None:
            self._complete_job(finished_job)

    def _complete_job(self, job):
        summary = job.evaluation_metrics.get_evaluation_summary()
        self.completed_summaries.append((job.model_version, summary))
        logger.info(
            "Evaluation finished at model version %s: %s",
            job.model_version,
            summary,
        )
        if self._summary_writer is not None:
            self._summary_writer.write_eval_summary(job.model_version, summary)
