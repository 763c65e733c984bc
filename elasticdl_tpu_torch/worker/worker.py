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

The job's artifact: the worker saves dense checkpoints every
``checkpoint_steps`` versions (``train/checkpoint.py``), after the
in-flight async push lands and the device tier's rows are flushed to
the PS, so the PS state the checkpoint pairs with carries every update.
``checkpoint_dir_for_init`` resumes from them on the first batch (a
restore that finds data but fails is fatal, ``CheckpointRestoreError``;
``resume_optional`` lets a missing or empty directory mean a fresh
start). Evaluation and prediction tasks score the restored model; the
train-end task runs the callbacks (the ``SavedModelExporter`` added
when the model declares none) behind the same push and tier barriers.

The graceful drain: ``begin_drain`` (what the SIGTERM hook of
worker/drain.py calls) lets the current task finish, then
``_finish_drain`` joins the in-flight push, flushes the device tier to
the PS, hands back any task it still holds (uncounted) and sends the
master ``deregister_worker``. ``EDL_DRAIN_DEADLINE_SECS`` (45 s) bounds
it: past the deadline the process exits 1 and the master's
requeue-on-death fallback takes over.

Telemetry: a compact ``TelemetryBlob`` (step-time EWMA, examples/s,
the device tier's tallies, the health tracker's fields and
``observability/device.py``'s memory view) rides the master RPCs the
worker already makes; ``EDL_TELEMETRY=0`` opts out. With
``EDL_TRACE_DIR`` each sequential train step is the root span of a
trace (``train_batch``, carrying the task id) that covers the step and
its bookkeeping, so the PS pulls and pushes and the task's report to
the master join it over gRPC.

Not ported (ROADMAP): the lockstep multi-host loop and stream
checkpoints.
"""

import contextlib
import os
import threading
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.env_utils import env_float, env_str
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
from elasticdl_tpu_torch.observability import device as device_obs
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as obs_metrics
from elasticdl_tpu_torch.observability import trace
from elasticdl_tpu_torch.ops import embedding_tier as tier_ops
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.train.callbacks import SavedModelExporter
from elasticdl_tpu_torch.train.health import HealthSentinelError
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

logger = _logger_factory("elasticdl_tpu_torch.worker.worker")


class CheckpointRestoreError(RuntimeError):
    """Fatal: --checkpoint_dir_for_init was given but restore failed."""


# the device tier's tallies a drain's flush moves (stats() keys)
_FLUSH_TALLIES = ("written_back_rows", "row_reads", "staged_chunks",
                  "evict_chunks", "gather_only_combines")


def _flush_tallies(trainer):
    """The device tier's flush tallies and the process's K1 launch
    count; None without a tier."""
    tier = getattr(trainer, "device_tier", None)
    if tier is None:
        return None
    stats = tier.stats()
    tallies = {key: stats[key] for key in _FLUSH_TALLIES}
    tallies["k1_launches"] = tier_ops.GATHER_LAUNCHES
    return tallies


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
        checkpoint_dir="",
        checkpoint_steps=0,
        keep_checkpoint_max=3,
        async_checkpoint=False,
        checkpoint_dir_for_init="",
        resume_optional=False,
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
        self._wait_sleep_secs = wait_sleep_secs
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
            trainer_kwargs["seed"] = seed
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
        self.stop_training = False
        self._version = 0
        # dense checkpoints (params, model state, optimizer slots, step);
        # the restore runs on the first batch, when the state's shapes
        # are known
        self._checkpoint_steps = checkpoint_steps
        self._checkpoint_mgr = None
        self._init_checkpoint_dir = checkpoint_dir_for_init
        self._restore_attempted = not checkpoint_dir_for_init
        # lenient: a missing or empty init directory is a fresh start
        # (an elastic relaunch pointed at its own directory); an
        # operator's explicit resume stays strict
        self._resume_optional = resume_optional
        if checkpoint_dir and checkpoint_steps:
            from elasticdl_tpu_torch.train.checkpoint import (
                DenseCheckpointManager,
            )

            self._checkpoint_mgr = DenseCheckpointManager(
                checkpoint_dir, keep_max=keep_checkpoint_max,
                async_save=async_checkpoint,
            )
        if checkpoint_dir and not checkpoint_steps:
            logger.warning(
                "--checkpoint_dir=%r given without --checkpoint_steps; "
                "NO checkpoints will be written", checkpoint_dir,
            )
        if self.spec.sparse_embedding_specs and (
            self._checkpoint_mgr is not None or checkpoint_dir_for_init
        ):
            # the worker snapshots the dense state; the PS processes
            # checkpoint the embedding tables themselves
            logger.warning(
                "Sparse model: worker checkpoint flags cover only the "
                "dense state; pass --checkpoint_dir/--checkpoint_dir_for_"
                "init to the parameter servers to snapshot/restore "
                "embedding tables"
            )
        self._callbacks = list(self.spec.callbacks() or [])
        # --output exports every model, not only those declaring an
        # exporter (the default no-ops without saved_model_path)
        if not any(isinstance(cb, SavedModelExporter)
                   for cb in self._callbacks):
            self._callbacks.append(SavedModelExporter())
        for cb in self._callbacks:
            cb.set_worker(self)
        # per-phase wall clock (EDL_TIMING=1)
        self._timing = Timing()
        # domain gauges fed off the step telemetry (no second timer);
        # no-op instruments when metrics are off
        self._m_examples_per_sec = obs_metrics.gauge(
            "edl_worker_examples_per_second",
            "Real (unpadded) examples trained per second, last step",
        )
        self._m_version = obs_metrics.gauge(
            "edl_worker_model_version", "This worker's model version"
        )
        self._heartbeat_stop = threading.Event()
        self._heartbeat_thread = None
        # graceful drain (begin_drain / _finish_drain)
        self._draining = False
        self._drain_reason = None
        self._drain_done = False
        # fleet telemetry: a compact blob piggybacked on the master RPCs
        # this worker already makes. Cost: one clock read and a few
        # float ops a batch, one small proto a RPC; EDL_TELEMETRY=0
        # opts out
        self._telemetry_on = env_str("EDL_TELEMETRY", "") != "0"
        self._step_ewma = 0.0
        self._last_examples_per_sec = 0.0
        self._prev_batch_end = 0.0
        self._telemetry_samples = 0
        self._ewma_outlier_streak = 0
        if self._telemetry_on and hasattr(
            master_client, "telemetry_provider"
        ):
            master_client.telemetry_provider = self._telemetry_blob

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

    def _telemetry_blob(self):
        """The piggyback payload of the master RPCs. Called on the RPC
        path (get_task, report, heartbeat, deregister), never a step."""
        blob = pb.TelemetryBlob(
            role="worker-%d" % self._mc.worker_id,
            step_time_ewma=self._step_ewma,
            examples_per_sec=self._last_examples_per_sec,
            last_task_seconds=self.tds.last_task_seconds,
            model_version=self._version,
        )
        # the device tier's hot-set health
        tier = getattr(self.trainer, "device_tier", None)
        if tier is not None:
            stats = tier.stats()
            blob.tier_hit_rate = stats["hit_rate"]
            blob.tier_occupancy = stats["occupancy"]
            blob.tier_hits = stats["hits"]
            blob.tier_misses = stats["misses"]
            blob.tier_evictions = stats["evictions"]
        # training health: the numerics sentinels' view of this
        # worker's model, for the master's nonfinite_loss / loss_spike /
        # grad_explosion detectors
        tracker = getattr(self.trainer, "health", None)
        if tracker is not None:
            stats = tracker.stats()
            blob.health_loss_ewma = stats["loss_ewma"]
            blob.health_loss_last = stats["loss_last"]
            blob.health_grad_norm = stats["grad_norm"]
            blob.health_nonfinite_batches = stats["nonfinite_batches"]
            blob.health_nonfinite_streak = stats["nonfinite_streak"]
            blob.health_loss_spikes = stats["loss_spikes"]
            blob.health_grad_explosions = stats["grad_explosions"]
            blob.health_skipped_batches = stats["skipped_batches"]
        # device runtime: the allocator's HBM view (what hbm_pressure
        # reads); the compile ledger's fields stay 0 (no compiled step)
        device_obs.fill_blob(blob)
        if tier is not None and device_obs.device_obs_enabled():
            blob.tier_hbm_bytes = tier.hbm_bytes()
        # the overload plane: this process's circuit-breaker, retry
        # budget and brownout tallies
        ostats = overload.client_stats()
        blob.circuit_open_count = ostats["circuit_open_count"]
        blob.degraded_pulls = ostats["degraded_pulls"]
        blob.retry_budget_exhausted = ostats["retry_budget_exhausted"]
        blob.brownout_skipped_pushes = getattr(
            self.trainer, "brownout_skipped_pushes", 0
        )
        return blob

    def _update_step_telemetry(self, real_count):
        """Fold one finished batch into the telemetry EWMA: the wall
        time between batch ends (the step's device work is asynchronous,
        and no telemetry may synchronize the card). Every worker
        measures the same way, which is all the straggler's
        fleet-relative comparison needs.

        Outliers: the first batch carries the start-up and is skipped;
        later samples over 10x the EWMA (and over 1 s, a task-boundary
        gap) are skipped unless three arrive in a row, so a worker that
        really slowed down re-anchors after three steps."""
        now = time.time()
        step_secs = (now - self._prev_batch_end
                     if self._prev_batch_end > 0.0 else None)
        self._prev_batch_end = now
        if step_secs is None or step_secs <= 0:
            return
        self._telemetry_samples += 1
        if self._telemetry_samples == 1:
            return
        if (
            self._step_ewma > 0.0
            and step_secs > 10.0 * self._step_ewma
            and step_secs > 1.0
        ):
            self._ewma_outlier_streak += 1
            if self._ewma_outlier_streak < 3:
                return
            self._step_ewma = step_secs  # sustained: the new reality
        else:
            self._step_ewma = (
                step_secs
                if self._step_ewma == 0.0
                else 0.9 * self._step_ewma + 0.1 * step_secs
            )
        self._ewma_outlier_streak = 0
        self._last_examples_per_sec = real_count / step_secs
        self._m_examples_per_sec.set(self._last_examples_per_sec)

    # ------------------------------------------------------------------
    @property
    def model_version(self):
        return self._version

    # ------------------------------------------------------------------
    # graceful drain

    def begin_drain(self, reason="sigterm"):
        """Request a graceful drain: finish the current task, then flush
        and deregister instead of fetching more work. Called from the
        SIGTERM hook (worker/drain.py) on the main thread, it only flips
        flags and arms the deadline watchdog; the run loop flushes at
        its next task boundary. Idempotent."""
        if self._draining:
            return
        self._draining = True
        self._drain_reason = reason
        # the record stream ends AFTER the current task's records, so
        # the task completes (reported done, never requeued); the loops
        # must not see stop_training, which breaks mid-task
        self.tds.draining = True
        logger.warning(
            "Worker %s draining (%s): finishing current task, then "
            "flush + deregister", self._mc.worker_id, reason,
        )
        events.emit(
            "worker_draining", worker=self._mc.worker_id, reason=reason,
            initiator="worker",
        )
        deadline = env_float("EDL_DRAIN_DEADLINE_SECS", 45.0)
        # bounds a wedged drain (a PS that stopped answering): past the
        # deadline the process dies and the master's requeue-on-death
        # fallback takes over
        watchdog = threading.Timer(
            deadline, self._drain_deadline_abort, args=(deadline,)
        )
        watchdog.daemon = True
        watchdog.start()

    def _drain_deadline_abort(self, deadline):
        if self._drain_done:
            return
        logger.error(
            "drain did not finish within %.0fs; aborting", deadline
        )
        events.dump("drain_deadline")
        events.flush()
        trace.flush()
        os._exit(1)

    def _finish_drain(self):
        """The drain's tail, at a task boundary: join the in-flight
        async push, flush dirty device-tier rows to the PS (K1 reads),
        hand back any task that could not be finished (uncounted; none
        on the clean path), then send the drain ack. Each step is
        guarded on its own: a dead PS must not stop the deregister, and
        a dead master must not stop the exit."""
        self._draining = True
        self.tds.draining = True
        reason = self._drain_reason or "master_drain"
        joined = flushed = True
        try:
            self._join_trainer_pushes()
        except Exception:
            joined = False
            logger.exception("drain: joining in-flight pushes failed")
        before = _flush_tallies(self.trainer)
        t0 = time.monotonic()
        try:
            self._flush_device_tier()
        except Exception:
            flushed = False
            logger.exception("drain: device-tier flush failed")
        flush_s = time.monotonic() - t0
        after = _flush_tallies(self.trainer)
        handed_back = 0
        try:
            # both kinds of hand-back, pending record-stream tasks and
            # parked out-of-band or train-end tasks, so the ack cannot
            # call a drain clean while parked work requeued
            handed_back += self.tds.report_pending_failed(
                "requeue: draining"
            )
            handed_back += self.tds.report_parked_failed(
                "requeue: draining"
            )
        except Exception:
            logger.exception("drain: task hand-back failed")
        acked = self._mc.deregister_worker(
            reason,
            pushes_joined=joined,
            tier_flushed=flushed,
            tasks_reported=handed_back,
        )
        if not acked:
            # the master journals the canonical drain_ack on the RPC;
            # this side's record of an unheard flush has its own name
            events.emit(
                "drain_unacked", worker=self._mc.worker_id,
                reason=reason, pushes_joined=joined,
                tier_flushed=flushed, handed_back=handed_back,
            )
        events.flush()
        self._drain_done = True
        logger.info(
            "Worker %s drained at version %d (%s; acked=%s "
            "pushes_joined=%s tier_flushed=%s handed_back=%d)",
            self._mc.worker_id, self._version, reason, acked, joined,
            flushed, handed_back,
        )
        if before is not None:
            delta = {key: after[key] - before[key] for key in after}
            logger.info(
                "Worker %s drain tier flush: %d rows written back, %d K1 "
                "launches, %d row reads, %d staged chunks, %d evict "
                "chunks, %d gather-only combines, %.4f s",
                self._mc.worker_id, delta["written_back_rows"],
                delta["k1_launches"], delta["row_reads"],
                delta["staged_chunks"], delta["evict_chunks"],
                delta["gather_only_combines"], flush_s,
            )

    def _batches(self, record_stream, mode):
        dataset = self.spec.dataset_fn(
            Dataset(lambda: record_stream), mode, self._reader.metadata
        )
        return dataset.batch(self._minibatch_size).prefetch(2)

    def _join_trainer_pushes(self):
        """Depth-1 async-push barrier (train/sparse.py join_pushes) at
        the worker's boundaries (checkpoints, stream ends, the train-end
        export), so an in-flight push lands or raises here. A no-op for
        dense trainers."""
        join = getattr(self.trainer, "join_pushes", None)
        if join is not None:
            join()

    def _flush_device_tier(self):
        """Device-tier writeback barrier (train/device_tier.py): the
        checkpoint and train-end boundaries write the tier's dirty rows
        back to the PS first, so the PS state those artifacts pair with
        carries the tier's updates. A no-op for dense trainers and with
        the tier off."""
        flush = getattr(self.trainer, "flush_device_tier", None)
        if flush is not None:
            flush()

    def _save_checkpoint(self):
        # a checkpoint claiming version V must not precede V's gradients
        # and tier rows reaching the PS
        self._join_trainer_pushes()
        self._flush_device_tier()
        self._checkpoint_mgr.save(self._version, self.state)
        events.emit("checkpoint_saved", version=self._version,
                    kind="dense")

    def _timed_train_step(self, batch):
        t0 = self._timing.start()
        self.state, loss = self.trainer.train_step(self.state, batch)
        self._timing.end_record_sync("batch_process", t0, loss)
        return loss

    def _after_train_batch(self, batch, loss):
        """Per-batch bookkeeping shared by both loops: version,
        checkpoint, record accounting, version reports, the loss log,
        callbacks."""
        self._version += 1
        if (
            self._checkpoint_mgr is not None
            and self._version % self._checkpoint_steps == 0
        ):
            self._save_checkpoint()
        real = batch_real_count(batch)
        if self._telemetry_on:
            self._update_step_telemetry(real)
        with self._timing.timeit("report_record"):
            self.tds.report_record_done(real)
        self._m_version.set(self._version)
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
        for cb in self._callbacks:
            cb.on_batch_end(self._version, loss)

    def _train_batches_pipelined(self, batches):
        """Drive the sparse trainer's pipelined stream: batch N+1's PS
        pull rides under batch N's step, pushes go out on a background
        thread (train/sparse.py train_stream)."""

        def on_first_batch(batch):
            if not self._restore_attempted:
                self._restore_from_checkpoint(batch)
            return self.state

        stream = self.trainer.train_stream(
            self.state,
            batches,
            on_first_batch=on_first_batch,
            push_interval=self._sparse_push_interval,
        )
        # deterministic close: the stream's finally drains the in-flight
        # background push even when an exception unwinds
        with contextlib.closing(stream):
            for state, loss, batch in stream:
                self.state = state
                self._after_train_batch(batch, loss)
                if self.stop_training:
                    break

    def _step_trace(self):
        """With EDL_TRACE_DIR: the root span of a train step's trace
        (``train_batch``, under the current task's id). The PS client's
        pull and push spans become its children, and the context
        crosses the gRPC hops, so the PS handlers and the master's task
        report land in the same trace. A span is host time: the step's
        device work is asynchronous and nothing here waits for it."""
        if not trace.enabled():
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(trace.task_context(self.tds.current_task_id()))
        stack.enter_context(trace.root_span(
            "train_batch", role="worker", version=self._version
        ))
        return stack

    def _train_batches_sequential(self, batches):
        for batch in batches:
            if not self._restore_attempted:
                self._restore_from_checkpoint(batch)
            with self._step_trace():
                loss = self._timed_train_step(batch)
                self._after_train_batch(batch, loss)
            if self.stop_training:
                break

    def _read_template_batch(self):
        """One batch read straight from the reader's first shard (no
        master round trip): the restore's template."""
        shards = self._reader.create_shards()
        name, (start, count) = next(iter(shards.items()))
        template_task = pb.Task(
            shard_name=name,
            start=start,
            end=start + min(count, self._minibatch_size),
            type=pb.TRAINING,
        )
        return next(iter(self._batches(
            self._reader.read_records(template_task), Mode.TRAINING
        )))

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
        except CheckpointRestoreError:
            # fatal for this process: held tasks go back first (a
            # relaunch under this worker id keeps liveness fresh, so the
            # master would never recover them)
            self.tds.report_pending_failed("checkpoint restore failed")
            self.tds.report_parked_failed("checkpoint restore failed")
            raise
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

    def _restore_from_checkpoint(self, batch):
        """Resume from --checkpoint_dir_for_init on the first batch: the
        freshly initialized state is the template the checkpoint loads
        into. A restore that finds data but fails is fatal
        (``CheckpointRestoreError`` out of every task handler): training
        or scoring from random weights after the operator asked for a
        resume would discard real progress. A pod relaunch is the retry
        for transient storage errors."""
        from elasticdl_tpu_torch.train.checkpoint import (
            DenseCheckpointManager,
        )

        self.state = self.trainer.ensure_state(self.state, batch)
        if self._resume_optional and not os.path.isdir(
            self._init_checkpoint_dir
        ):
            # never created: a first launch. Leniency covers only
            # "nothing saved yet"
            logger.info("No checkpoint dir %r yet; fresh initialization",
                        self._init_checkpoint_dir)
            self._restore_attempted = True
            return
        mgr = None
        t0 = time.monotonic()
        try:
            # the constructor too: a missing directory (create=False) is
            # fatal, not a retryable task failure
            mgr = DenseCheckpointManager(
                self._init_checkpoint_dir, keep_max=0, create=False
            )
            restored = mgr.restore(template=self.state)
        except Exception as e:
            raise CheckpointRestoreError(
                "restore from --checkpoint_dir_for_init=%r failed: %s"
                % (self._init_checkpoint_dir, e)
            ) from e
        finally:
            if mgr is not None:
                mgr.close()
        if restored is None:
            if self._resume_optional:
                logger.info("No checkpoint in %r yet; fresh "
                            "initialization", self._init_checkpoint_dir)
                self._restore_attempted = True
                return
            raise CheckpointRestoreError(
                "--checkpoint_dir_for_init=%r holds no restorable "
                "checkpoint" % self._init_checkpoint_dir
            )
        self._restore_attempted = True
        self.state = restored
        self._version = int(restored.step)
        logger.info("Resumed from checkpoint at version %d (%.3f s)",
                    self._version, time.monotonic() - t0)

    def _ensure_state_restored(self, batch):
        """ensure_state and the one-time --checkpoint_dir_for_init
        restore: evaluation and prediction never score random
        weights."""
        if not self._restore_attempted:
            self._restore_from_checkpoint(batch)
        else:
            self.state = self.trainer.ensure_state(self.state, batch)

    def _process_eval_task(self, task):
        try:
            for batch in self._batches(
                self.tds.task_record_stream(task), Mode.EVALUATION
            ):
                self._ensure_state_restored(batch)
                outputs = self.trainer.eval_step(self.state, batch)
                real = batch_real_count(batch)
                outputs = normalize_outputs(outputs, real)
                labels = np.asarray(batch["labels"])[:real]
                self._mc.report_evaluation_metrics(
                    task.model_version, outputs, labels
                )
            self._mc.report_task_result(task.task_id)
        except CheckpointRestoreError:
            self._mc.report_task_result(task.task_id, "restore failed")
            raise
        except Exception as e:
            logger.exception("Evaluation task %s failed", task.task_id)
            self._mc.report_task_result(task.task_id, str(e))

    def _process_prediction_task(self, task):
        processor_cls = self.spec.prediction_outputs_processor
        processor = processor_cls() if processor_cls else None
        try:
            for batch in self._batches(
                self.tds.task_record_stream(task), Mode.PREDICTION
            ):
                self._ensure_state_restored(batch)
                outputs = self.trainer.eval_step(self.state, batch)
                real = batch_real_count(batch)
                if processor is not None:
                    processor.process(normalize_outputs(outputs, real),
                                      self._mc.worker_id)
            if processor is not None and hasattr(processor, "close"):
                # buffered writes land before the task is reported done
                # (a write failure surfaces here and requeues the task)
                processor.close()
            self._mc.report_task_result(task.task_id)
        except CheckpointRestoreError:
            self._mc.report_task_result(task.task_id, "restore failed")
            raise
        except Exception as e:
            logger.exception("Prediction task %s failed", task.task_id)
            self._mc.report_task_result(task.task_id, str(e))

    def _process_train_end_task(self, task):
        # the artifact must carry every pushed gradient and every tier
        # row update (the export pairs with the PS tables)
        self._join_trainer_pushes()
        self._flush_device_tier()
        wants_export = bool(task.extended_config.get("saved_model_path"))
        if wants_export and self.state is None:
            # this worker never trained (relaunched with only the
            # train-end task left): restore before giving the task up
            self._try_restore_for_export()
        if wants_export and self.state is None:
            # failed, so the dispatcher requeues it for a worker that
            # trained (a success would end the job without its
            # artifact); the sleep keeps the refetch from burning the
            # retry cap in milliseconds
            self._mc.report_task_result(
                task.task_id, "no trained state to export"
            )
            time.sleep(self._wait_sleep_secs)
            return
        export_error = None
        for cb in self._callbacks:
            try:
                cb.on_train_end(self.state, dict(task.extended_config))
            except Exception as e:
                logger.exception("train-end callback failed")
                if isinstance(cb, SavedModelExporter):
                    export_error = e
        if export_error is not None:
            # the export is the job's artifact: a failed exporter fails
            # the task (bounded by the retry cap)
            self._mc.report_task_result(
                task.task_id, "export failed: %s" % export_error
            )
            time.sleep(self._wait_sleep_secs)
            return
        self._mc.report_task_result(task.task_id)

    def _try_restore_for_export(self):
        """Best-effort restore for a worker that only saw the train-end
        task: a template batch from the reader, then the strict
        checkpoint restore (the lenient default would export fresh
        weights as if trained)."""
        if not self._init_checkpoint_dir:
            return
        try:
            batch = self._read_template_batch()
            previous = self._resume_optional
            self._resume_optional = False
            try:
                self._restore_attempted = False
                self._restore_from_checkpoint(batch)
            finally:
                self._resume_optional = previous
        except Exception:
            logger.exception("restore-for-export failed")
            # a failed restore leaves no state to export
            self.state = None

    def _drain_out_of_band(self):
        while self.tds.out_of_band_tasks:
            task = self.tds.out_of_band_tasks.popleft()
            if task.type == pb.EVALUATION:
                self._process_eval_task(task)
            elif task.type == pb.PREDICTION:
                self._process_prediction_task(task)
            else:
                logger.warning("Unexpected out-of-band task type %s",
                               task.type)
                self._mc.report_task_result(task.task_id)

    def _drain_fast(self):
        """After MaxStepsStopping: take the remaining tasks without
        training (reported done), the train-end task still run, so the
        job can finish. A drain ends it: once this worker drains, the
        master's gate answers WAIT(draining=true) forever, so looping on
        it would wait for the watchdog; no task is held between
        iterations, so any point here is a task boundary."""
        while True:
            if self._draining:
                self._finish_drain()
                return
            task = self._mc.get_task()
            if task.draining:
                self._finish_drain()
                return
            if task.task_id == 0:
                if task.type == pb.WAIT:
                    time.sleep(0.2)
                    continue
                return
            if task.type == pb.TRAIN_END_CALLBACK:
                self._process_train_end_task(task)
            else:
                self._mc.report_task_result(task.task_id)

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
            if self._checkpoint_mgr is not None:
                # an async save's write lands before the process exits
                self._checkpoint_mgr.close()
                self._checkpoint_mgr = None

    def _run(self):
        if self._mode == Mode.EVALUATION:
            self._run_task_mode(pb.EVALUATION, self._process_eval_task)
            return
        if self._mode == Mode.PREDICTION:
            self._run_task_mode(pb.PREDICTION,
                                self._process_prediction_task)
            return
        while True:
            self._run_training_stream()
            if self._draining or self.tds.draining:
                # the stream ended at a task boundary (the current task
                # reported done): flush and deregister, fetch no more
                self._finish_drain()
                return
            self._drain_out_of_band()
            if self.tds.train_end_task is not None:
                task = self.tds.train_end_task
                self.tds.train_end_task = None
                self._process_train_end_task(task)
                continue
            if self.stop_training:
                # the task the step limit cut short is done too (an
                # empty message reports success), or the master would
                # wait on it forever; the stream's producer stops
                self.tds.report_pending_failed("")
                self._drain_fast()
                return
            if self.tds.job_over:
                logger.info(
                    "Worker %s done at version %d",
                    self._mc.worker_id,
                    self._version,
                )
                return

    def _run_task_mode(self, task_type, process_fn):
        while True:
            if self._draining:
                self._finish_drain()
                return
            task = self._mc.get_task(task_type)
            if task.draining:
                self._finish_drain()
                return
            if task.task_id == 0:
                if task.type == pb.WAIT:
                    time.sleep(0.2)
                    continue
                return
            process_fn(task)
