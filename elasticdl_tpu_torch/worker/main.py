"""Worker process entry point (port of elasticdl_tpu/worker/main.py).

Usage: python -m elasticdl_tpu_torch.worker.main --master_addr=... \
    --worker_id=0 --model_zoo=... --training_data=... \
    [--ps_addrs=host:port,host:port] [--device cuda|cpu] \
    [--checkpoint_dir=DIR --checkpoint_steps=N] \
    [--checkpoint_dir_for_init=DIR] [--mode training|evaluation|prediction]

Trains on ``cuda`` unless ``--device cpu`` is given; with ``cuda`` and
no card it raises rather than fall back. ``--mode evaluation`` and
``--mode prediction`` take only those tasks (an evaluation-only or
prediction-only job), scoring the model restored from
``--checkpoint_dir_for_init``. Exits 0 when the master says the job is
over, 1 on a health-sentinel halt or a failed restore.

SIGTERM drains: the worker finishes its current task, joins its
in-flight push, flushes its device tier to the PS, deregisters and
exits 0 (worker/drain.py), within ``EDL_DRAIN_DEADLINE_SECS`` (45 s; past
it the process exits 1 and the master requeues its tasks). A SIGTERM
before the worker exists exits 0 at once.

Several workers train one model with ``--multihost 1`` (each with its
own ``--worker_host``, all with one ``--checkpoint_dir``): the worker
joins the master's mesh rendezvous and forms the torch.distributed
group there (parallel/multihost.py: gloo when ranks share a card or run
on the CPU, NCCL when each owns its card); a world of more than one
trains through the lockstep trainers (``MultiHostSpmdTrainer``, and
``MultiHostSparseSpmdTrainer`` for a sparse model). A moved mesh epoch
or a failed collective exits 3 (``EPOCH_RESTART_EXIT_CODE``) after the
journal and trace flush: the pod manager relaunches the worker with the
same command line, and it rejoins and resumes from the newest
checkpoint in ``--checkpoint_dir`` (the default init directory under
``--multihost``). At exit a multi-host worker logs the digest of its
dense parameters (``dense digest at exit``: equal on every worker of one
model) and its collectives' seconds.

``--metrics_port`` (or ``EDL_METRICS_PORT``) serves ``/metrics``,
``/healthz`` and ``/readyz`` (ready once the master channel carried an
RPC); ``EDL_EVENTS_DIR`` and ``EDL_TRACE_DIR`` turn on the worker's
events journal and trace (role ``worker-<id>``). At exit the worker logs
its device tier's tallies (``tier stats at exit``) and its train steps
beside the process's K1-K3 launches (``tier launches at exit``).
"""

import hashlib
import json
import logging
import os
import socket
import sys
import warnings

from elasticdl_tpu_torch.common.args import (
    parse_worker_args,
    symbol_overrides_from_args,
)
from elasticdl_tpu_torch.common.log_utils import configure as configure_logging
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.data.readers import create_data_reader
from elasticdl_tpu_torch.models.registry import parse_params_string
from elasticdl_tpu_torch.observability import (
    events,
    http_server,
    profiler,
    trace,
)
from elasticdl_tpu_torch.parallel.mesh import parse_mesh_spec
from elasticdl_tpu_torch.testing import faults
from elasticdl_tpu_torch.train.health import HealthSentinelError
from elasticdl_tpu_torch.worker.drain import install_sigterm_drain
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.worker import (
    EPOCH_RESTART_EXIT_CODE,
    CheckpointRestoreError,
    MeshEpochChanged,
    Worker,
    tier_launches,
)

logger = _logger_factory("elasticdl_tpu_torch.worker.main")


def main(argv=None):
    # first: a SIGTERM from here on drains (or, before the worker
    # exists, exits 0)
    drain_hook = install_sigterm_drain()
    args = parse_worker_args(argv)
    configure_logging(args.log_level, args.log_file_path)
    role = "worker-%d" % args.worker_id
    if args.metrics_port:
        # publish the knob before any instrument (or instrumented
        # channel) is constructed: the registry decides enabled/no-op
        # at first touch
        os.environ[http_server.PORT_ENV] = str(args.metrics_port)
    trace.configure(role)
    events.configure(role)
    # the host stack sampler: on when EDL_PROF_HZ is set, served as
    # /profilez on the observability port below
    profiler.maybe_start(role)
    # before any master or PS channel is built: fault specs match on role
    faults.set_role(role)
    # in chain order: the drain hook came first, so the crash hooks
    # capture it as the previous handler; a SIGTERM dumps the event
    # ring, flushes the journal and the trace, then drains
    events.install_crash_hooks()
    # a multi-host worker names itself in the mesh rendezvous (the
    # hostname unless --worker_host says otherwise); others stay out
    master_client = MasterClient(
        args.master_addr, worker_id=args.worker_id,
        worker_host=((args.worker_host or socket.gethostname())
                     if args.multihost else ""))
    observability = http_server.maybe_start(role, cli_port=args.metrics_port)
    if observability is not None:
        # readiness milestone: the master channel has carried an RPC
        # (reset_worker below, then the heartbeat)
        observability.add_readiness_check(
            "master_channel_ready", master_client.channel_ok
        )
    # fresh incarnation: flush any task a dead predecessor with this
    # worker_id still holds; the answer is this worker_id's relaunch
    # epoch, the push incarnation the sync PS orders relaunches by
    master_client.reset_worker()
    events.emit(
        "role_start", worker=args.worker_id,
        epoch=master_client.incarnation or 0,
    )
    multihost_runtime = None
    trainer_factory = None
    if args.multihost:
        from elasticdl_tpu_torch.common.device import resolve_device
        from elasticdl_tpu_torch.parallel.multihost import MultiHostRuntime

        multihost_runtime = MultiHostRuntime(
            master_client, coordinator_port=args.coordinator_port,
            device=resolve_device(args.device))
        multihost_runtime.ensure_runtime()
        if multihost_runtime.world_size > 1:
            # the mesh spans the worker processes: the lockstep trainer
            # (a sparse model takes its sparse composition)
            from elasticdl_tpu_torch.parallel.multihost_trainer import (
                MultiHostSpmdTrainer,
            )

            trainer_factory = MultiHostSpmdTrainer
    # an elastic restart resumes from the newest state: the init
    # directory defaults to the worker's own checkpoint directory
    checkpoint_dir_for_init = args.checkpoint_dir_for_init or (
        args.checkpoint_dir if args.multihost else "")
    if args.multihost and not checkpoint_dir_for_init:
        warnings.warn("--multihost without --checkpoint_dir: a mesh-epoch "
                      "restart will lose all training progress",
                      stacklevel=1)
    reader = create_data_reader(
        args.training_data or args.validation_data or args.prediction_data,
        **parse_params_string(args.data_reader_params),
    )
    worker = Worker(
        master_client,
        args.model_zoo,
        reader,
        minibatch_size=args.minibatch_size,
        mode=args.mode,
        compute_dtype=args.compute_dtype or None,
        report_version_steps=args.report_version_steps,
        grad_accum_steps=args.grad_accum_steps,
        ps_addrs=args.ps_addrs or None,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_steps=args.checkpoint_steps,
        keep_checkpoint_max=args.keep_checkpoint_max,
        async_checkpoint=bool(args.async_checkpoint),
        checkpoint_dir_for_init=checkpoint_dir_for_init,
        # the elastic default directory is empty at the first launch;
        # only an operator's explicit resume is strict
        resume_optional=not args.checkpoint_dir_for_init,
        trainer_factory=trainer_factory,
        multihost_runtime=multihost_runtime,
        consensus_interval=args.consensus_interval,
        sparse_pipeline=bool(args.sparse_pipeline),
        sparse_cache_staleness=args.sparse_cache_staleness,
        sparse_push_interval=args.sparse_push_interval,
        model_def=args.model_def,
        model_params=args.model_params,
        symbol_overrides=symbol_overrides_from_args(args),
        log_loss_steps=args.log_loss_steps,
        device=args.device,
        mesh_config=parse_mesh_spec(args.mesh),
    )
    # SIGTERM now runs the graceful drain instead of a bare exit
    drain_hook.bind(worker)
    try:
        worker.run()
    except MeshEpochChanged as e:
        # the pod manager relaunches the worker with the same command
        # line; it rejoins at the new epoch and resumes from the
        # checkpoint. os._exit: run() already closed the checkpoint
        # manager, and a thread left in a collective must not hold the
        # exit
        logger.warning("Restarting for a new mesh epoch: %s", e)
        events.emit("mesh_epoch_restart", worker=args.worker_id,
                    epoch=master_client.incarnation or 0,
                    reason=str(e)[:200])
        events.flush()
        trace.flush()
        logging.shutdown()
        os._exit(EPOCH_RESTART_EXIT_CODE)
    except HealthSentinelError as e:
        # the task was already reported failed (requeued once); exit
        # nonzero so the failure is loud, with the buffers flushed
        logger.error("health sentinel halt: %s", e)
        events.emit(
            "role_stop", worker=args.worker_id, reason="health_halt"
        )
        events.flush()
        trace.flush()
        return 1
    except CheckpointRestoreError as e:
        # held tasks were handed back; the restore is not retried here
        logger.error("checkpoint restore failed: %s", e)
        events.emit(
            "role_stop", worker=args.worker_id, reason="restore_failed"
        )
        events.flush()
        trace.flush()
        return 1
    tier = getattr(worker.trainer, "device_tier", None)
    if tier is not None:
        logger.info("Worker %d tier stats at exit: %s", args.worker_id,
                    json.dumps(tier.stats(), sort_keys=True))
        logger.info("Worker %d tier launches at exit: %s", args.worker_id,
                    json.dumps(tier_launches(worker), sort_keys=True))
    if multihost_runtime is not None:
        logger.info("Worker %d dense digest at exit: %s", args.worker_id,
                    json.dumps(exit_record(worker), sort_keys=True))
        multihost_runtime.shutdown()
    events.emit("role_stop", worker=args.worker_id)
    events.flush()
    trace.flush()
    return 0


def dense_digest(trainer, state):
    """sha256 over the dense parameters (sorted by name, fp32 bytes):
    equal on the workers of one lockstep model."""
    local = getattr(trainer, "local_state", None)
    if local is not None:
        state = local(state)
    digest = hashlib.sha256()
    for name in sorted(state.params):
        digest.update(name.encode())
        digest.update(state.params[name].detach().float().cpu().numpy()
                      .tobytes())
    return digest.hexdigest()


def exit_record(worker):
    """A multi-host worker's exit line: its dense digest, version,
    sync-PS rejections and collectives' host seconds."""
    trainer = worker.trainer
    record = {"version": worker.model_version,
              "push_rejections": getattr(trainer, "push_rejections", 0),
              "lockstep": getattr(trainer, "lockstep_stats", None),
              "rounds": worker.lockstep_rounds,
              "span_s": (worker.lockstep_span[1] - worker.lockstep_span[0]
                         if worker.lockstep_span else None),
              "digest": None}
    if worker.state is not None:
        try:
            record["digest"] = dense_digest(trainer, worker.state)
        except ValueError as e:  # fsdp across processes: no local whole
            logger.warning("no dense digest: %s", e)
    return record


if __name__ == "__main__":
    sys.exit(main())
