"""Dynamic data sharding: the elasticity core (port of
elasticdl_tpu/master/task_dispatcher.py).

The unit of elasticity is the *task*, a ``(shard_name, start, end)``
record range, not the worker. Workers are stateless consumers of this
master-held queue, so a worker dying mid-task is recovered by requeueing
the task ranges it held.

A prediction job's tasks are its prediction shards, created once and
unshuffled. A job with an export path registers the train-end task
(TRAIN_END_CALLBACK), created once all training is done: one worker
takes it and runs the train-end callbacks (the export).

With a state journal (master/state_store.py) every queue transition is
journaled write-through, and a relaunched master resumes from the
replayed state (``recovered``) mid-epoch: in-flight tasks go back to
the queue, and their pre-restart holder's completion is still accepted
once.

Streaming mode (``stream=True``): training tasks are minted from
arriving windows (``add_stream_window``, the master's stream feeder)
instead of epochs, and ``finished()`` becomes a drain contract: the
job is over only once the feeder closed the stream and the queue
drained. The watermark, the records of completed window tasks, is the
job's durability clock: checkpoint and export cadence ride it where an
epoch job rides epoch boundaries. The journal records every minted
window with the source position, so a relaunched master resumes
minting after the last journaled window and never re-mints one.
"""

import random
import threading
import time

from elasticdl_tpu_torch.common.constants import MAX_TASK_RETRIES
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

logger = _logger_factory("elasticdl_tpu_torch.master.task_dispatcher")


class _TaskRecord:
    """Internal task bookkeeping wrapper around the proto Task."""

    __slots__ = ("task", "retry_count")

    def __init__(self, task):
        self.task = task
        self.retry_count = 0


class TaskDispatcher:
    """Master-side work queue over record ranges of data shards.

    Shards are ``{shard_name: (start, num_records)}`` dicts (what
    ``AbstractDataReader.create_shards`` returns). Training tasks are
    created one epoch at a time and shuffled; the next epoch's tasks are
    created lazily when the queue drains, so a worker that joins late
    always finds work without the master materializing the whole job.
    """

    def __init__(
        self,
        training_shards,
        evaluation_shards=None,
        prediction_shards=None,
        records_per_task=1024,
        num_epochs=1,
        max_task_retries=MAX_TASK_RETRIES,
        shuffle=True,
        seed=None,
        state_journal=None,
        recovered=None,
        stream=False,
    ):
        self._lock = threading.Lock()
        # crash recovery (master/state_store.py): ops are decided under
        # the lock and written after it (the journal does file I/O)
        self._journal = state_journal
        self._journal_ops = []
        # task_id -> pre-restart assignee of a task the replay requeued
        # out of ``doing``: if that worker survived and finishes, its
        # success report is accepted (no shard trained twice)
        self._recovered_assignee = {}
        self._training_shards = dict(training_shards or {})
        self._evaluation_shards = dict(evaluation_shards or {})
        self._prediction_shards = dict(prediction_shards or {})
        self._records_per_task = records_per_task
        self._max_task_retries = max_task_retries
        self._shuffle = shuffle
        self._rng = random.Random(seed)
        # epochs only apply to training; an eval- or predict-only job
        # must not leave a phantom epoch that keeps finished() False
        # forever
        self._epochs_left = num_epochs if self._training_shards else 0
        self._next_task_id = 1
        # task_id -> _TaskRecord for every task queued or handed out
        self._records = {}
        self._todo = []  # task ids, FIFO
        self._eval_todo = []
        # task_id -> (worker_id, start_time)
        self._doing = {}
        # worker_id -> set of task_ids (inverse of _doing)
        self._worker_doing = {}
        self._task_completed_callbacks = []
        # the train-end task's creation, run once training is done
        self._deferred_callbacks = []
        self._job_failed = False
        # rolling task-duration samples for the timeout scanner
        self._task_durations = []
        # task type -> successfully completed count
        self._done_counts = {}
        # streaming books: source windows minted, their records, and
        # the records of completed window tasks (the watermark)
        self._stream = bool(stream)
        self._stream_open = bool(stream)
        self._stream_pos = 0
        self._stream_minted_records = 0
        self._stream_done_records = 0
        if recovered is not None:
            # authoritative even when empty: a journal that says "all
            # tasks done" must not be answered with a fresh epoch
            self._load_recovered_locked(recovered)
        elif self._prediction_shards:
            ids = self._create_tasks_locked(
                pb.PREDICTION, self._prediction_shards)
            self._todo.extend(ids)
            self._journal_tasks_locked(ids, "train")
        elif self._training_shards and not self._stream:
            self._create_training_epoch_locked()
        if (self._stream and recovered is None
                and self._journal is not None):
            self._journal_ops.append({"op": "stream_open"})
        self._flush_journal()

    # ------------------------------------------------------------------
    # crash recovery (master/state_store.py)

    def _journal_tasks_locked(self, ids, queue):
        if self._journal is None or not ids:
            return
        self._journal_ops.append({
            "op": "tasks_created",
            "queue": queue,
            "tasks": [
                [t.task_id, t.type, t.shard_name, t.start, t.end,
                 t.model_version]
                for t in (self._records[i].task for i in ids)
            ],
            "epochs_left": self._epochs_left,
        })

    def _flush_journal(self):
        """Write the ops buffered under the lock; called after release."""
        if self._journal is None:
            return
        with self._lock:
            ops, self._journal_ops = self._journal_ops, []
        for op in ops:
            self._journal.append(op)

    def _load_recovered_locked(self, recovered):
        """Adopt a replayed state (state_store.load): queued tasks keep
        their place, in-flight ``doing`` tasks are requeued at the back
        (their holder may be dead; if it is not, its completion report
        is still honoured through ``_recovered_assignee``)."""
        for task_id, fields in recovered["tasks"].items():
            task_id = int(task_id)
            record = _TaskRecord(pb.Task(
                task_id=task_id,
                type=int(fields[1]),
                shard_name=fields[2],
                start=int(fields[3]),
                end=int(fields[4]),
                model_version=int(fields[5]),
            ))
            record.retry_count = int(
                recovered.get("retries", {}).get(task_id, 0)
            )
            self._records[task_id] = record
        self._todo = [t for t in recovered["todo"] if t in self._records]
        self._eval_todo = [
            t for t in recovered["eval_todo"] if t in self._records
        ]
        # at the back, so a still-live holder usually reports done
        # before the task is dispatched again
        for task_id, worker in recovered["doing"].items():
            task_id = int(task_id)
            if task_id not in self._records:
                continue
            record = self._records[task_id]
            queue = (
                self._eval_todo
                if record.task.type == pb.EVALUATION
                else self._todo
            )
            if task_id not in queue:
                queue.append(task_id)
            self._recovered_assignee[task_id] = worker
            self._journal_ops.append({
                "op": "requeue", "task": task_id,
                "retries": record.retry_count,
            })
        self._epochs_left = int(recovered.get("epochs_left", 0))
        self._next_task_id = max(
            int(recovered.get("next_task_id", 1)),
            max(self._records, default=0) + 1,
        )
        self._done_counts = {
            int(t): int(n)
            for t, n in recovered.get("done_counts", {}).items()
        }
        self._job_failed = bool(recovered.get("job_failed", False))
        stream = recovered.get("stream") or {}
        if stream.get("open") or stream.get("pos"):
            # the journal is authoritative about the stream: the
            # relaunched feeder resumes the source at ``pos`` and the
            # watermark carries on from the predecessor's completions
            self._stream = True
            self._stream_open = bool(stream.get("open", False))
            self._stream_pos = int(stream.get("pos", 0))
            self._stream_minted_records = int(
                stream.get("minted_records", 0))
            self._stream_done_records = int(stream.get("done_records", 0))
        logger.info(
            "Dispatcher resumed from journal: %d todo, %d eval, "
            "%d requeued in-flight, epochs left %d%s",
            len(self._todo), len(self._eval_todo),
            len(self._recovered_assignee), self._epochs_left,
            (", stream pos %d watermark %d"
             % (self._stream_pos, self._stream_done_records)
             if self._stream else ""),
        )

    def export_state(self):
        """Replay-schema snapshot for journal compaction (the keys of
        state_store.empty_state this dispatcher owns)."""
        with self._lock:
            return {
                "tasks": {
                    task_id: [
                        r.task.task_id, r.task.type, r.task.shard_name,
                        r.task.start, r.task.end, r.task.model_version,
                    ]
                    for task_id, r in self._records.items()
                },
                "todo": list(self._todo),
                "eval_todo": list(self._eval_todo),
                "doing": {
                    task_id: worker
                    for task_id, (worker, _) in self._doing.items()
                },
                "retries": {
                    task_id: r.retry_count
                    for task_id, r in self._records.items()
                    if r.retry_count
                },
                "done_counts": dict(self._done_counts),
                "epochs_left": self._epochs_left,
                "next_task_id": self._next_task_id,
                "job_failed": self._job_failed,
                "stream": {
                    "open": self._stream_open,
                    "pos": self._stream_pos,
                    "minted_records": self._stream_minted_records,
                    "done_records": self._stream_done_records,
                },
            }

    # ------------------------------------------------------------------
    # task creation

    def _slice_shards(self, shards):
        """Yield (shard_name, start, end) ranges of records_per_task."""
        for name, (start, num_records) in shards.items():
            end = start + num_records
            for lo in range(start, end, self._records_per_task):
                yield name, lo, min(lo + self._records_per_task, end)

    def _create_tasks_locked(self, task_type, shards, model_version=-1):
        ids = []
        for name, lo, hi in self._slice_shards(shards):
            task = pb.Task(
                task_id=self._next_task_id,
                type=task_type,
                shard_name=name,
                start=lo,
                end=hi,
                model_version=model_version,
            )
            self._records[task.task_id] = _TaskRecord(task)
            ids.append(task.task_id)
            self._next_task_id += 1
        return ids

    def _create_training_epoch_locked(self):
        if self._epochs_left <= 0:
            return
        self._epochs_left -= 1
        ids = self._create_tasks_locked(pb.TRAINING, self._training_shards)
        if self._shuffle:
            self._rng.shuffle(ids)
        self._todo.extend(ids)
        self._journal_tasks_locked(ids, "train")
        logger.info(
            "Created %d training tasks (epochs left: %d)",
            len(ids),
            self._epochs_left,
        )

    def create_evaluation_tasks(self, model_version=-1):
        """Queue one pass of evaluation tasks (used by EvaluationService)."""
        with self._lock:
            ids = self._create_tasks_locked(
                pb.EVALUATION, self._evaluation_shards, model_version
            )
            self._eval_todo.extend(ids)
            self._journal_tasks_locked(ids, "eval")
        self._flush_journal()
        return len(ids)

    # ------------------------------------------------------------------
    # streaming mode

    def add_stream_window(self, shard_name, start, end, model_version=-1):
        """Mint one TRAINING task from an arrived stream window and
        journal it with the source position. Returns the task id."""
        with self._lock:
            if not self._stream_open:
                raise RuntimeError(
                    "add_stream_window on a closed/non-stream dispatcher")
            task = pb.Task(
                task_id=self._next_task_id,
                type=pb.TRAINING,
                shard_name=shard_name,
                start=int(start),
                end=int(end),
                model_version=model_version,
            )
            self._records[task.task_id] = _TaskRecord(task)
            self._next_task_id += 1
            self._todo.append(task.task_id)
            self._stream_pos += 1
            self._stream_minted_records += int(end) - int(start)
            if self._journal is not None:
                self._journal_ops.append({
                    "op": "stream_window",
                    "pos": self._stream_pos,
                    "task": [task.task_id, int(pb.TRAINING), shard_name,
                             int(start), int(end), model_version],
                })
            task_id = task.task_id
        self._flush_journal()
        return task_id

    def add_stream_export_task(self, extended_config=None):
        """Mint an export (TRAIN_END_CALLBACK) task mid-stream: one
        worker joins its pushes, flushes its device tier and writes a
        fresh export, which the serving tier's watcher then takes."""
        with self._lock:
            task = pb.Task(
                task_id=self._next_task_id,
                type=pb.TRAIN_END_CALLBACK,
                shard_name="",
                start=0,
                end=0,
            )
            for key, value in (extended_config or {}).items():
                task.extended_config[key] = value
            self._records[task.task_id] = _TaskRecord(task)
            self._next_task_id += 1
            self._todo.append(task.task_id)
            self._journal_tasks_locked([task.task_id], "train")
            task_id = task.task_id
        self._flush_journal()
        return task_id

    def close_stream(self):
        """No more windows will arrive: ``finished()`` can report true
        once the queue drains."""
        with self._lock:
            if not self._stream_open:
                return
            self._stream_open = False
            if self._journal is not None:
                self._journal_ops.append({"op": "stream_close"})
            if (not self._todo
                    and not self._doing_training_locked()
                    and self._deferred_callbacks
                    and not self._records_have_train_end_locked()):
                # the queue drained while the stream was open: no later
                # report() fires the deferred train-end task, so the
                # close must
                self._fire_deferred_locked()
        self._flush_journal()
        logger.info(
            "Stream closed at pos %d (%d records minted, watermark %d)",
            self._stream_pos, self._stream_minted_records,
            self._stream_done_records,
        )

    def stream_watermark(self):
        """Records of completed stream-window tasks: every record below
        the watermark was trained and reported. 0 for a non-stream job
        (the proto default on CommInfo)."""
        with self._lock:
            return self._stream_done_records

    def stream_pos(self):
        """Source windows minted so far: where a (re)started feeder
        seeks its source to."""
        with self._lock:
            return self._stream_pos

    def stream_state(self):
        """O(1) snapshot for /statusz and the feeder."""
        with self._lock:
            return {
                "stream": self._stream,
                "open": self._stream_open,
                "pos": self._stream_pos,
                "minted_records": self._stream_minted_records,
                "watermark": self._stream_done_records,
                "backlog_records": (self._stream_minted_records
                                    - self._stream_done_records),
            }

    def add_deferred_callback_create_train_end_task(self,
                                                    extended_config=None):
        """Register the train-end task, created once all training is
        done. One worker receives it and runs the train-end callbacks
        (the model export)."""

        # runs through _fire_deferred_locked, under the lock
        def _create():
            task = pb.Task(
                task_id=self._next_task_id,
                type=pb.TRAIN_END_CALLBACK,
                shard_name="",
                start=0,
                end=0,
            )
            for key, value in (extended_config or {}).items():
                task.extended_config[key] = value
            self._records[task.task_id] = _TaskRecord(task)
            self._next_task_id += 1
            self._todo.append(task.task_id)
            self._journal_tasks_locked([task.task_id], "train")

        with self._lock:
            # one train-end task per job: none while one is queued or
            # done (a relaunched master's replayed state included, which
            # would otherwise create a second one at the next drain)
            if self._records_have_train_end_locked() or self._done_counts.get(
                pb.TRAIN_END_CALLBACK, 0
            ):
                return
            self._deferred_callbacks.append(_create)

    def _fire_deferred_locked(self):
        callbacks, self._deferred_callbacks = self._deferred_callbacks, []
        for callback in callbacks:
            callback()

    def fire_deferred_callbacks(self):
        with self._lock:
            self._fire_deferred_locked()
        self._flush_journal()

    # ------------------------------------------------------------------
    # queue operations

    def get(self, worker_id, task_type=None):
        """Pop the next task for a worker; None when nothing is available.

        Evaluation tasks take priority so eval jobs finish promptly while
        training continues. When the training queue drains and epochs
        remain, the next epoch is created lazily.
        """
        with self._lock:
            if task_type == pb.EVALUATION:
                queue = self._eval_todo
            else:
                queue = self._eval_todo if self._eval_todo else self._todo
                if not queue and self._epochs_left > 0:
                    self._create_training_epoch_locked()
                    queue = self._todo
            if not queue:
                task = None
            else:
                task_id = queue.pop(0)
                self._doing[task_id] = (worker_id, time.time())
                self._worker_doing.setdefault(worker_id, set()).add(task_id)
                # dispatched again: the pre-restart assignee (if any) is
                # no longer the task's source of truth
                self._recovered_assignee.pop(task_id, None)
                if self._journal is not None:
                    self._journal_ops.append({
                        "op": "dispatch", "task": task_id,
                        "worker": worker_id,
                    })
                task = self._records[task_id].task
        self._flush_journal()
        return task

    def report(self, task_id, success, worker_id=None, count_failure=True):
        """Mark a task done or failed; failed tasks requeue up to the cap.

        ``count_failure=False`` requeues without charging the retry cap:
        a lifecycle hand-back (a stream closed under a worker) or a dead
        worker's recovery is not evidence against the TASK.

        ``worker_id``, when given, must match the task's current
        assignee; otherwise the report is stale (the task was recovered
        from a presumed-dead worker and reassigned) and is ignored so it
        cannot clobber the new assignee's run.

        Returns (evaluation_task_completed, task) so the caller can feed
        the evaluation service.
        """
        completed_callbacks = []
        result = (False, None)
        # events decided under the lock, emitted after it (the journal
        # does file I/O; never under the lock the RPC handlers contend on)
        journal = []
        with self._lock:
            record = self._records.get(task_id)
            if record is None:
                logger.warning("Unknown task id reported: %s", task_id)
                return False, None
            doing = self._doing.get(task_id)
            if doing is None and success and worker_id is not None and (
                self._recovered_assignee.get(task_id) == worker_id
            ):
                # the replay requeued this in-flight task, but its
                # pre-restart assignee survived the restart and finished
                # it: accept the completion once (another worker
                # running the shard would train it twice)
                queue = (
                    self._eval_todo
                    if record.task.type == pb.EVALUATION
                    else self._todo
                )
                if task_id in queue:
                    queue.remove(task_id)
                    self._recovered_assignee.pop(task_id, None)
                    doing = (worker_id, None)
                    logger.info(
                        "Accepted post-restart completion of task %s "
                        "from its pre-restart assignee %s",
                        task_id, worker_id,
                    )
            if doing is None or (
                worker_id is not None and doing[0] != worker_id
            ):
                # stale report: the task was already recovered (and
                # maybe reassigned) or reported twice; the current
                # assignment stays the single source of truth
                logger.warning(
                    "Stale report for task %s from worker %s; ignored",
                    task_id,
                    worker_id,
                )
                return False, record.task
            self._doing.pop(task_id, None)
            assignee, start_time = doing
            self._worker_doing.get(assignee, set()).discard(task_id)

            task = record.task
            if success:
                if start_time is not None and task.type == pb.TRAINING:
                    self._task_durations.append(time.time() - start_time)
                    del self._task_durations[:-64]
                del self._records[task_id]
                self._done_counts[task.type] = (
                    self._done_counts.get(task.type, 0) + 1
                )
                stream_records = 0
                if self._stream and task.type == pb.TRAINING:
                    # the watermark advances by this window's records;
                    # the journal carries the count so a replay
                    # reconstructs the same watermark
                    stream_records = task.end - task.start
                    self._stream_done_records += stream_records
                if self._journal is not None:
                    done_op = {
                        "op": "done", "task": task_id, "type": task.type,
                    }
                    if stream_records:
                        done_op["records"] = stream_records
                    self._journal_ops.append(done_op)
                if not self._todo and not self._doing_training_locked():
                    if self._epochs_left > 0:
                        self._create_training_epoch_locked()
                    elif (
                        self._deferred_callbacks
                        # an open stream draining its queue is not the
                        # end of training: close_stream fires it then
                        and not self._stream_open
                        and not self._records_have_train_end_locked()
                    ):
                        # the last training task of the last epoch is
                        # done: the train-end task comes now
                        self._fire_deferred_locked()
                completed_callbacks = list(self._task_completed_callbacks)
                result = (task.type == pb.EVALUATION, task)
            else:
                if count_failure:
                    record.retry_count += 1
                result = (False, task)
                if record.retry_count > self._max_task_retries:
                    logger.error(
                        "Task %s failed %d times; marking job failed",
                        task_id,
                        record.retry_count,
                    )
                    self._job_failed = True
                    journal.append(
                        ("job_failed",
                         dict(task=task_id, retries=record.retry_count))
                    )
                    if self._journal is not None:
                        self._journal_ops.append(
                            {"op": "job_failed", "task": task_id}
                        )
                else:
                    queue = (
                        self._eval_todo
                        if task.type == pb.EVALUATION
                        else self._todo
                    )
                    queue.append(task_id)
                    journal.append(
                        ("task_requeue",
                         dict(task=task_id, worker=assignee,
                              retries=record.retry_count,
                              counted=count_failure))
                    )
                    if self._journal is not None:
                        self._journal_ops.append({
                            "op": "requeue", "task": task_id,
                            "retries": record.retry_count,
                        })
        self._flush_journal()
        for event, fields in journal:
            events.emit(event, **fields)
        # completion callbacks run outside the lock: they may call back
        # into the dispatcher (the evaluation service queueing tasks)
        for cb in completed_callbacks:
            cb(result[1])
        return result

    def _doing_training_locked(self):
        return any(
            self._records[tid].task.type == pb.TRAINING for tid in self._doing
        )

    def _records_have_train_end_locked(self):
        return any(
            r.task.type == pb.TRAIN_END_CALLBACK
            for r in self._records.values()
        )

    def recover_tasks(self, worker_id):
        """Requeue every in-flight task of a dead worker, uncounted:
        what makes worker death a non-event."""
        with self._lock:
            task_ids = list(self._worker_doing.get(worker_id, set()))
        for task_id in task_ids:
            self.report(
                task_id, success=False, worker_id=worker_id,
                count_failure=False,
            )
        with self._lock:
            self._worker_doing.pop(worker_id, None)
        if task_ids:
            logger.info(
                "Recovered %d tasks from worker %s", len(task_ids), worker_id
            )

    # ------------------------------------------------------------------
    # introspection

    def finished(self):
        """All work done successfully. A job that failed past the retry
        cap is never 'finished': check job_failed() for that exit."""
        with self._lock:
            return (
                not self._job_failed
                and not self._todo
                and not self._eval_todo
                and not self._doing
                and self._epochs_left <= 0
                # a registered train-end task not created yet
                and not self._deferred_callbacks
                # an open stream is never finished: more windows come
                and not self._stream_open
            )

    def job_failed(self):
        with self._lock:
            return self._job_failed

    def add_task_completed_callback(self, callback):
        with self._lock:
            self._task_completed_callbacks.append(callback)

    def doing_tasks(self):
        """Snapshot of {task_id: (worker_id, start_time)}."""
        with self._lock:
            return dict(self._doing)

    def avg_task_duration(self, default=300.0, min_samples=20):
        """Rolling mean task duration; ``default`` until enough samples
        (the timeout scanner's 3x-slower-than-average threshold)."""
        with self._lock:
            if len(self._task_durations) < min_samples:
                return default
            return sum(self._task_durations) / len(self._task_durations)

    def stats(self):
        """Queue-state snapshot: {"pending": {type name: n}, "doing":
        {type name: n}, "done": {type name: n}, "queue_depth":
        {"training": n, "evaluation": n}, "epochs_left": n}. Type names
        are lowercase proto enum names ("training", "evaluation")."""
        with self._lock:
            pending = {}
            for task_id in self._todo + self._eval_todo:
                name = pb.TaskType.Name(
                    self._records[task_id].task.type
                ).lower()
                pending[name] = pending.get(name, 0) + 1
            doing = {}
            for task_id in self._doing:
                name = pb.TaskType.Name(
                    self._records[task_id].task.type
                ).lower()
                doing[name] = doing.get(name, 0) + 1
            done = {
                pb.TaskType.Name(t).lower(): n
                for t, n in self._done_counts.items()
            }
            return {
                "pending": pending,
                "doing": doing,
                "done": done,
                "queue_depth": {
                    "training": len(self._todo),
                    "evaluation": len(self._eval_todo),
                },
                "epochs_left": self._epochs_left,
            }

    def queue_counts(self):
        """The four numbers the 1 Hz elasticity tick reads, without
        ``stats()``'s per-task type names under the lock every
        get_task and report contends on."""
        with self._lock:
            return {
                "queue_depth": {
                    "training": len(self._todo),
                    "evaluation": len(self._eval_todo),
                },
                "doing": len(self._doing),
                "epochs_left": self._epochs_left,
            }
