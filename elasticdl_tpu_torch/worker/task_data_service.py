"""Turns the master's task stream into continuous record streams (port
of elasticdl_tpu/worker/task_data_service.py).

The training stream spans task boundaries so batches stay full, a
``_pending_tasks`` deque tracks how many records of each in-flight task
have been consumed, and a task is reported done exactly when its range
is covered. Evaluation tasks met on the stream are parked for the
worker; a TRAIN_END_CALLBACK task is remembered on ``train_end_task``.
"""

import collections
import threading
import time

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.data.pipeline import FLUSH
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

logger = _logger_factory("elasticdl_tpu_torch.worker.task_data_service")


class TaskDataService:
    def __init__(self, master_client, data_reader, wait_sleep_secs=2.0):
        self._mc = master_client
        self._reader = data_reader
        self._wait_sleep_secs = wait_sleep_secs
        self._lock = threading.Lock()
        # deque of [task, records_total, records_reported, fetched_at]
        self._pending_tasks = collections.deque()
        # wall-clock duration of the most recently completed task
        # (fetch -> fully reported); 0.0 until a task completes
        self.last_task_seconds = 0.0
        # bumped whenever a stream is (re)opened or failed: the stream
        # producer runs on a prefetch thread, and without a generation
        # check it could fetch one more task AFTER report_pending_failed
        # cleared the books, orphaning it on a worker about to exit
        self._stream_gen = 0
        self.train_end_task = None
        self.job_over = False
        # once set, the training stream stops fetching new tasks and
        # ends after the current task's records are consumed
        self.draining = False
        # non-training tasks met while streaming training records; the
        # worker drains these between minibatch loops
        self.out_of_band_tasks = collections.deque()

    # ------------------------------------------------------------------
    def training_record_stream(self):
        """Yield raw records across training tasks until the job ends.

        A WAIT from the master after records were yielded emits a
        pipeline.FLUSH first: the batcher downstream may hold a
        sub-minibatch tail whose task the master is waiting on, and
        without the flush worker and master deadlock whenever the
        records of one stream are not a multiple of the minibatch.
        """
        with self._lock:
            self._stream_gen += 1
            my_gen = self._stream_gen
        dirty = False  # records yielded since the last flush
        while True:
            with self._lock:
                if self._stream_gen != my_gen:
                    return  # stream was failed or superseded
            if self.draining:
                # the current task's records are fully yielded (the
                # check sits between tasks): flush the batcher's tail
                # so the task is reported done, not handed back
                if dirty:
                    yield FLUSH
                return
            task = self._mc.get_task()
            if getattr(task, "draining", False):
                self.draining = True
            if task.task_id == 0:
                if task.type == pb.WAIT:
                    if dirty:
                        dirty = False
                        yield FLUSH
                    if self.draining:
                        return
                    time.sleep(self._wait_sleep_secs)
                    continue
                self.job_over = True
                return
            if task.type != pb.TRAINING:
                # park it and end the stream: the worker drains
                # out_of_band_tasks and opens a fresh training stream. A
                # task fetched after the stream was failed is handed
                # back instead
                with self._lock:
                    stale = self._stream_gen != my_gen
                    if not stale:
                        if task.type == pb.TRAIN_END_CALLBACK:
                            self.train_end_task = task
                        else:
                            self.out_of_band_tasks.append(task)
                if stale:
                    self._mc.report_task_result(
                        task.task_id, "requeue: stream closed"
                    )
                return
            total = task.end - task.start
            with self._lock:
                if self._stream_gen != my_gen:
                    stale = task  # fetched in the failure window
                else:
                    stale = None
                    self._pending_tasks.append(
                        [task, total, 0, time.time()]
                    )
            if stale is not None:
                # hand it straight back so it requeues for a live worker
                self._mc.report_task_result(
                    stale.task_id, "requeue: stream closed"
                )
                return
            yield from self._reader.read_records(task)
            dirty = True

    def report_record_done(self, count):
        """Account ``count`` consumed records to the oldest pending tasks;
        report each task whose full range is now covered. Returns the
        number of tasks reported."""
        done = []
        with self._lock:
            while count > 0 and self._pending_tasks:
                entry = self._pending_tasks[0]
                task, total, reported, fetched_at = entry
                take = min(count, total - reported)
                entry[2] += take
                count -= take
                if entry[2] >= total:
                    self._pending_tasks.popleft()
                    self.last_task_seconds = time.time() - fetched_at
                    done.append(task)
        for task in done:
            self._mc.report_task_result(task.task_id, "")
        return len(done)

    def report_pending_failed(self, err_message):
        """Report every pending task as failed (training step blew up).

        Also invalidates the live stream generation so the prefetch
        producer cannot fetch-and-orphan one more task afterwards."""
        with self._lock:
            self._stream_gen += 1
            pending = [entry[0] for entry in self._pending_tasks]
            self._pending_tasks.clear()
        for task in pending:
            self._mc.report_task_result(task.task_id, err_message)
        return len(pending)

    def report_parked_failed(self, err_message):
        """Hand back parked tasks (out-of-band eval, train-end). Only for
        fatal exits: a worker that keeps running drains these itself."""
        with self._lock:
            self._stream_gen += 1
            parked = list(self.out_of_band_tasks)
            self.out_of_band_tasks.clear()
            if self.train_end_task is not None:
                parked.append(self.train_end_task)
                self.train_end_task = None
        for task in parked:
            self._mc.report_task_result(task.task_id, err_message)
        return len(parked)

    def has_pending(self):
        with self._lock:
            return bool(self._pending_tasks)

    def current_task_id(self):
        """task_id of the oldest pending task (the one the records on
        the training stream are currently drawn from); None between
        tasks."""
        with self._lock:
            if self._pending_tasks:
                return self._pending_tasks[0][0].task_id
            return None

    # ------------------------------------------------------------------
    def task_record_stream(self, task):
        """Records of a single (evaluation) task."""
        yield from self._reader.read_records(task)
