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
any other model through ``worker.trainer.TorchTrainer``, or, given a
mesh (``--mesh`` or the model's ``mesh_config``), through
``parallel.spmd_trainer.SpmdTrainer`` over the ranks of the default
process group. They run on ``device`` (``cuda`` unless the caller asks
for the CPU; no card raises).

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
the device tier's tallies, the health tracker's fields,
``observability/device.py``'s memory view and the mesh's shape and
collective bytes a step) rides the master RPCs the
worker already makes; ``EDL_TELEMETRY=0`` opts out. With
``EDL_TRACE_DIR`` each sequential train step is the root span of a
trace (``train_batch``, carrying the task id) that covers the step and
its bookkeeping, so the PS pulls and pushes and the task's report to
the master join it over gRPC.

Stream checkpoints (``EDL_STREAM_CHECKPOINT_EVERY``): in a continual
stream the master's record watermark rides the heartbeat's CommInfo,
and the worker refreshes it after each task it reports. Each time it
crosses a boundary of that many records the worker runs the barriers a
step-cadence checkpoint runs (the in-flight push joined, the device
tier's dirty rows flushed through K1, the dense checkpoint saved where
configured), re-clocked from steps to stream records. The first
boundary observed only anchors the marker. In a stream job these
barriers and the export's re-assert every tier-resident row, clean ones
too: the PS's embedding lifecycle may have evicted a clean row the tier
holds, and the checkpoint or export must carry it.

Lockstep (several worker processes train one model): with a trainer
that has a ``consensus`` (parallel/multihost_trainer.py,
train/sparse_spmd.py) the worker runs ``_train_batches_lockstep``:
every process runs the same sequence of collectives, pads a partial
batch to the minibatch size, steps on zero batches while its stream is
dry, and leaves only when every process's stream has ended. A moved
mesh epoch (read from the heartbeat) or a failed collective hands the
held tasks back and raises ``MeshEpochChanged``; worker/main.py exits
with ``EPOCH_RESTART_EXIT_CODE`` for the pod manager's relaunch, which
rejoins at the new epoch and resumes from the checkpoint.
"""

import contextlib
import inspect
import os
import queue
import threading
import time

import numpy as np
import torch

from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.env_utils import env_float, env_int, env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.common.timing_utils import Timing
from elasticdl_tpu_torch.data.pipeline import (
    Dataset,
    batch_real_count,
    normalize_outputs,
    pad_batch,
    zero_batch_like,
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


class MeshEpochChanged(RuntimeError):
    """The alive worker set changed: this process must restart, rejoin
    the mesh at the new epoch and resume from the latest checkpoint.
    Raised out of the training loop; worker/main.py exits with
    EPOCH_RESTART_EXIT_CODE so the pod manager relaunches it."""


EPOCH_RESTART_EXIT_CODE = 3


class _BatchPoller:
    """Non-blocking view over a (possibly blocking) batch iterator.

    The lockstep loop must never block inside ``next()``: the iterator
    chain ends in the master's get_task, which answers WAIT while a peer
    holds the last task, and the peer is meanwhile waiting in the
    consensus for us. A pump thread absorbs the blocking; ``poll``
    returns (batch or None, ended) within the timeout. The iterator's
    exceptions surface on the consuming thread."""

    _END = object()

    def __init__(self, batches):
        self._queue = queue.Queue(maxsize=1)
        self._ended = False
        self._thread = threading.Thread(
            target=self._pump, args=(batches,), name="lockstep-batch-pump",
            daemon=True,
        )
        self._thread.start()

    def _pump(self, batches):
        try:
            for batch in batches:
                self._queue.put(batch)
            self._queue.put(self._END)
        except BaseException as e:  # re-raised by poll() on the consumer
            self._queue.put(e)

    def poll(self, timeout):
        if self._ended:
            return None, True
        try:
            item = self._queue.get(timeout=timeout)
        except queue.Empty:
            return None, False
        if item is self._END:
            self._ended = True
            return None, True
        if isinstance(item, BaseException):
            self._ended = True
            raise item
        return item, False


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


def tier_launches(worker):
    """The exit line's record: the worker's train steps and the
    process's K1-K3 launches; None without a device tier."""
    if getattr(worker.trainer, "device_tier", None) is None:
        return None
    return {"steps": worker.train_steps,
            "k1": tier_ops.GATHER_LAUNCHES,
            "k2": tier_ops.SET_ROWS_LAUNCHES,
            "k3": tier_ops.SCATTER_APPLY_LAUNCHES}


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
        symbol_overrides=None,
        log_loss_steps=100,
        device="cuda",
        mesh_config=None,
        multihost_runtime=None,
        consensus_interval=1,
    ):
        """``trainer_factory(**kwargs)`` replaces the trainer class (a
        test injects one); it gets the keyword arguments of
        ``SparseTrainer`` for a sparse model, of ``SpmdTrainer`` on a
        mesh and of ``TorchTrainer`` otherwise.

        ``mesh_config`` (``--mesh``), or else the model's
        ``mesh_config(num_devices)``, trains a dense model through
        ``parallel.spmd_trainer.SpmdTrainer`` and a sparse one through
        ``train.sparse_spmd.SparseSpmdTrainer`` over the ranks of the
        default process group (one rank started here when none is), as
        the reference's worker picks its SpmdTrainer; the model is built
        over the mesh when its ``custom_model`` takes one. A mesh
        trainer class given as ``trainer_factory`` (worker/main.py gives
        the lockstep ``MultiHostSpmdTrainer`` under a multi-process
        ``multihost_runtime``) builds its mesh over the group that is
        there; a sparse model maps it onto its sparse composition
        (``sparse_trainer_for``). ``consensus_interval``: the lockstep
        loop's consensus every that many rounds."""
        self.device = resolve_device(device)
        self._mc = master_client
        self.spec = get_model_spec(
            model_zoo_module, model_def=model_def,
            model_params=model_params,
            symbol_overrides=symbol_overrides,
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
        from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer

        mesh = None
        if mesh_config is None and self.spec.mesh_config:
            mesh_config = self.spec.mesh_config(
                torch.distributed.get_world_size()
                if torch.distributed.is_initialized() else 1)
        if mesh_config is not None or (
                isinstance(trainer_factory, type)
                and issubclass(trainer_factory, SpmdTrainer)):
            from elasticdl_tpu_torch.parallel.mesh import (
                build_mesh,
                init_local_group,
            )

            # a multi-process runtime formed the group already
            init_local_group(self.device.type)
            mesh = build_mesh(mesh_config)
        # the weights come from ``seed`` without touching the caller's
        # global RNG stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            if mesh is not None and "mesh" in inspect.signature(
                    self.spec.custom_model).parameters:
                model = self.spec.custom_model(mesh=mesh)
            else:
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
            from elasticdl_tpu_torch.train.sparse_spmd import (
                SparseSpmdTrainer,
                sparse_trainer_for,
            )
            from elasticdl_tpu_torch.worker.ps_client import PSClient

            if trainer_factory is None and mesh is not None:
                factory = SparseSpmdTrainer
            else:
                factory = sparse_trainer_for(trainer_factory)
            if mesh is not None and "mesh" in inspect.signature(
                    factory).parameters:
                trainer_kwargs["mesh"] = mesh
                if self.spec.sharding_rules:
                    trainer_kwargs["sharding_rules"] = (
                        self.spec.sharding_rules())
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
        elif mesh is not None:
            factory = trainer_factory or SpmdTrainer
            trainer_kwargs.update(grad_accum_steps=grad_accum_steps,
                                  seed=seed, mesh=mesh)
            if self.spec.sharding_rules:
                trainer_kwargs["sharding_rules"] = self.spec.sharding_rules()
            if self.spec.batch_spec:
                trainer_kwargs["batch_spec"] = self.spec.batch_spec()
        else:
            from elasticdl_tpu_torch.worker.trainer import TorchTrainer

            factory = trainer_factory or TorchTrainer
            trainer_kwargs["grad_accum_steps"] = grad_accum_steps
            trainer_kwargs["seed"] = seed
        self.trainer = factory(**trainer_kwargs)
        # lockstep over processes: the trainer's mesh spans the worker
        # processes and it has the consensus collective
        self._lockstep = hasattr(self.trainer, "consensus")
        self._multihost = multihost_runtime
        # the batch poll's wait paces the consensus rounds while a worker
        # is between tasks (_train_batches_lockstep)
        self._lockstep_poll_secs = min(0.25, wait_sleep_secs)
        self._consensus_interval = max(1, int(consensus_interval))
        # the last mesh epoch the heartbeat saw; the loops read it, no
        # RPC on the step path
        self._seen_mesh_epoch = None
        # lockstep rounds this process stepped (zero batches included)
        # and the host clock of its first and last
        self.lockstep_rounds = 0
        self.lockstep_span = None
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
        # the batches this process trained (the version counts restored
        # steps too)
        self.train_steps = 0
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

            if async_checkpoint and self._lockstep:
                logger.warning("--async_checkpoint ignored under lockstep "
                               "(every rank gathers at the save; sync saves)")
            self._checkpoint_mgr = DenseCheckpointManager(
                checkpoint_dir, keep_max=keep_checkpoint_max,
                async_save=async_checkpoint and not self._lockstep,
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
        # the streaming checkpoint cadence: the watermark last seen on
        # a CommInfo, and the boundary last acted on
        self._stream_ckpt_every = env_int("EDL_STREAM_CHECKPOINT_EVERY", 0)
        self._stream_ckpt_mark = None
        self._seen_stream_watermark = 0
        # one record per fired boundary (watermark, version, the tier
        # flush's tallies and seconds)
        self.stream_barriers = []

    def _note_comm_info(self, info):
        if info.mesh_epoch >= 0:
            self._seen_stream_watermark = info.stream_watermark
            self._seen_mesh_epoch = info.mesh_epoch

    def _check_mesh_epoch(self):
        """The elastic membership probe of the loops: reads the
        heartbeat's epoch, no RPC on the step path."""
        if self._multihost is not None and self._multihost.epoch_moved(
                self._seen_mesh_epoch):
            raise MeshEpochChanged(
                "mesh epoch moved to %s at version %d"
                % (self._seen_mesh_epoch, self._version))

    def _start_heartbeat(self):
        def beat():
            while not self._heartbeat_stop.wait(self.HEARTBEAT_SECS):
                self._note_comm_info(self._mc.get_comm_info())

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
        # the dense data plane: the mesh this worker trains over and its
        # collectives' bytes a step (parallel/dense_plane.py), empty and
        # 0 off a mesh
        blob.mesh_shape = str(
            getattr(self.trainer, "mesh_shape_str", "") or "")
        blob.collective_bytes_per_step = float(
            getattr(self.trainer, "collective_bytes_per_step", 0.0) or 0.0)
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
        # must not see stop_training, which breaks mid-task. Lockstep is
        # the exception: a member cannot leave a collective mid-round,
        # so the stop becomes its end-of-stream vote (tasks handed back
        # uncounted) and the drain deadline bounds the wait for peers
        if self._lockstep:
            self.stop_training = True
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
        carries the tier's updates. In a continual stream job
        (EDL_STREAM_CHECKPOINT_EVERY set, or a watermark seen) the PS
        may run the embedding lifecycle, which evicts rows the tier
        holds clean, so from then on the tier's flushes re-assert every
        resident row (``DeviceEmbeddingTier.reassert``). A no-op for
        dense trainers and with the tier off."""
        tier = getattr(self.trainer, "device_tier", None)
        if tier is not None and (self._stream_ckpt_every > 0
                                 or self._seen_stream_watermark > 0):
            tier.reassert = True
        flush = getattr(self.trainer, "flush_device_tier", None)
        if flush is not None:
            flush()

    def _save_checkpoint(self):
        # a checkpoint claiming version V must not precede V's gradients
        # and tier rows reaching the PS
        self._join_trainer_pushes()
        self._flush_device_tier()
        state = self.state
        if self._lockstep:
            # every rank gathers the whole state at the same version (a
            # collective the lockstep loop aligns); rank 0 writes it
            state = self.trainer.checkpoint_state(state)
            if not self.trainer.checkpoint_writer:
                return
        self._checkpoint_mgr.save(self._version, state)
        events.emit("checkpoint_saved", version=self._version,
                    kind="dense")

    def maybe_stream_checkpoint(self):
        """Fire the checkpoint barriers when the last seen watermark
        crossed an EDL_STREAM_CHECKPOINT_EVERY boundary, so the PS-side
        state a stream checkpoint snapshots carries every update this
        worker holds in flight. True when a boundary fired."""
        every = self._stream_ckpt_every
        watermark = self._seen_stream_watermark
        if every <= 0 or watermark <= 0:
            return False
        boundary = watermark // every
        if self._stream_ckpt_mark is None:
            # a freshly joined worker must not fire on a boundary its
            # peers already covered
            self._stream_ckpt_mark = boundary
            return False
        if boundary <= self._stream_ckpt_mark:
            return False
        self._stream_ckpt_mark = boundary
        before = _flush_tallies(self.trainer)
        t0 = time.monotonic()
        if self._checkpoint_mgr is not None:
            # _save_checkpoint runs the join and flush barriers itself
            self._save_checkpoint()
        else:
            self._join_trainer_pushes()
            self._flush_device_tier()
        seconds = time.monotonic() - t0
        after = _flush_tallies(self.trainer)
        record = {"watermark": int(watermark), "version": self._version,
                  "seconds": seconds}
        if before is not None:
            record.update({key: after[key] - before[key] for key in after})
        self.stream_barriers.append(record)
        events.emit("stream_watermark", watermark=int(watermark),
                    kind="checkpoint")
        logger.info(
            "Worker %s stream checkpoint barrier at watermark %d, version "
            "%d: %d rows written back, %d K1 launches, %.4f s",
            self._mc.worker_id, watermark, self._version,
            record.get("written_back_rows", 0),
            record.get("k1_launches", 0), seconds,
        )
        return True

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
        self.train_steps += 1
        if (
            self._checkpoint_mgr is not None
            and self._version % self._checkpoint_steps == 0
        ):
            self._save_checkpoint()
        real = batch_real_count(batch)
        if self._telemetry_on:
            self._update_step_telemetry(real)
        with self._timing.timeit("report_record"):
            reported = self.tds.report_record_done(real)
        if reported and self._stream_ckpt_every > 0:
            # a window task reported moves the watermark: read it now,
            # not at the next heartbeat, so no boundary passes unseen
            self._note_comm_info(self._mc.get_comm_info())
        self.maybe_stream_checkpoint()
        self._m_version.set(self._version)
        if (
            self._report_version_steps
            and self._version % self._report_version_steps == 0
        ):
            self._mc.report_version(self._version)
        self._check_mesh_epoch()
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

    def _train_batches_lockstep(self, batches):
        """Several processes in lockstep: every process runs the same
        collective sequence (parallel/multihost_trainer.py). A consensus
        counts the processes that hold a real batch; a partial batch is
        padded to the minibatch size and a dried-up process steps on
        zero-masked batches until the count reaches zero, so no process
        leaves a peer waiting inside a collective.

        Batch acquisition is a NON-BLOCKING poll (_BatchPoller): the
        master answers WAIT while the queue is empty for now (a peer
        holds the epoch's last task, evaluation tasks are out), and a
        worker blocked in ``next()`` on that WAIT would leave its peer
        blocked in the consensus. An empty poll is an "I have nothing
        this round" vote; the worker keeps the cadence with zero batches
        and takes real work back when the master has some.

        Two invariants keep the processes' collectives identical: (1)
        parked evaluation and prediction tasks are drained INLINE
        between consensus rounds (local work only) with the stream
        reopened in place, never by leaving the loop, which would pit
        one process's consensus against a peer's step; (2) the only
        exit is the round whose consensus reports every process's
        stream ended, so everyone leaves together.

        The consensus runs every ``consensus_interval`` rounds: its
        host read waits for the collectives before it, so a consensus
        every round forbids dispatching ahead. Within a window every
        process steps (a dried-up one on zero batches) and the exit and
        idle decisions happen only at the boundaries."""
        poller = _BatchPoller(batches)
        template = None
        exhausted = False
        stopping = False
        window = self._consensus_interval
        round_in_window = 0
        while True:
            boundary = round_in_window == 0
            if self.stop_training and not stopping:
                # a host-side stop (the step limit, a drain) must not
                # break out of the loop alone: a peer would run its
                # next collective against a departed process. It becomes
                # a stream-end vote: fetched tasks go back, zero batches
                # until every process's stream ended
                stopping = True
                exhausted = True
                self.tds.report_pending_failed(
                    "requeue: stopped at max steps")
            if exhausted and not stopping and self.tds.out_of_band_tasks:
                # the stream ended because evaluation or prediction tasks
                # were parked: drain them here, between consensus rounds,
                # and reopen the stream (peers' next consensus waits a
                # few seconds)
                self._drain_out_of_band()
                if self.tds.train_end_task is None:
                    poller = _BatchPoller(self._batches(
                        self.tds.training_record_stream(), Mode.TRAINING))
                    exhausted = False
            batch = None
            if not exhausted:
                batch, exhausted = poller.poll(self._lockstep_poll_secs)
            have = batch is not None
            if have:
                batch = pad_batch(batch, self._minibatch_size)
                template = batch
            if boundary:
                alive, ended = self.trainer.consensus(have, exhausted)
                if ended == self.trainer.process_count:
                    # every process's stream is over: the loop's only
                    # exit, taken by everyone in this round
                    break
                if alive == 0:
                    # everyone is between tasks: poll again (the poll's
                    # wait paces the rounds; an exhausted worker has no
                    # poll, so it sleeps). No polled batch is dropped:
                    # ``have`` is False on every process here
                    if exhausted:
                        time.sleep(self._lockstep_poll_secs)
                    continue
            if not have:
                if template is None:
                    # a live round before this worker ever saw a batch:
                    # the shapes come from the reader
                    template = self._fabricate_template_batch()
                batch = zero_batch_like(template)
            round_in_window = (round_in_window + 1) % window
            if not self._restore_attempted:
                self._restore_from_checkpoint(batch)
            with self._step_trace():
                loss = self._timed_train_step(batch)
                self._note_lockstep_round()
                if stopping:
                    # a zero-batch round while peers finish: no version,
                    # checkpoint or record bookkeeping
                    continue
                self._after_train_batch(batch, loss)

    def _note_lockstep_round(self):
        now = time.time()
        if self.lockstep_span is None:
            self.lockstep_span = [now, now]
            logger.info("Worker %s first lockstep step at version %d",
                        self._mc.worker_id, self._version)
        self.lockstep_span[1] = now
        self.lockstep_rounds += 1

    def _fabricate_template_batch(self):
        """A zero batch of the minibatch's shape: the lockstep
        collectives need shapes even from a worker that never got a
        task."""
        return zero_batch_like(pad_batch(self._read_template_batch(),
                                         self._minibatch_size))

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
            if self._lockstep:
                self._train_batches_lockstep(batches)
            elif self._sparse_pipeline:
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
        except MeshEpochChanged:
            # hand the tasks back NOW: the relaunch reuses this worker id
            # and heartbeats at once, so the master's liveness scan would
            # never see this "death"; parked tasks go back too
            self.tds.report_pending_failed("requeue: mesh epoch changed")
            self.tds.report_parked_failed("requeue: mesh epoch changed")
            raise
        except Exception as e:  # report so tasks get retried elsewhere
            logger.exception("Training stream failed")
            if self._lockstep:
                # a failed lockstep step is a MESH event (a peer died or
                # restarted mid-collective; the group cannot recover in
                # the process), not evidence against the task: the tasks
                # go back uncounted and the process restarts to rejoin
                self.tds.report_pending_failed(
                    "requeue: lockstep peer failure (%s)" % (e,))
                self.tds.report_parked_failed(
                    "requeue: lockstep peer failure")
                raise MeshEpochChanged(
                    "lockstep collective failed: %s" % (e,)) from e
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
            template = self.state
            if self._lockstep:
                # the whole state's shapes (every rank calls this first
                # batch hook in the same round); adopt_restored below
                # keeps this rank's blocks of the current mesh
                template = self.trainer.checkpoint_state(self.state)
            restored = mgr.restore(template=template)
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
        if hasattr(self.trainer, "adopt_restored"):
            restored = self.trainer.adopt_restored(restored)
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
        # no mesh-epoch probe here (the reference has one): evaluation
        # and prediction tasks run no collective, so a moved epoch
        # leaves them nothing to restart for
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
