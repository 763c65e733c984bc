"""Master process entry point (port of elasticdl_tpu/master/main.py).

Usage: python -m elasticdl_tpu_torch.master.main --model_zoo=... \
    --training_data=... [--validation_data=...] [--port=50001] \
    [--output=EXPORT_DIR]

``--prediction_data`` alone makes a prediction-only job,
``--validation_data`` alone an evaluation-only one. With ``--output``
a training job ends with the train-end task: one worker exports the
model there. The master runs on the host and exits 0 when the job
finished, 1 when it failed. ``--metrics_port`` (or
``EDL_METRICS_PORT``) serves ``/metrics``, ``/healthz``, ``/readyz``,
``/statusz`` and ``/alerts``. ``--tensorboard_log_dir`` writes the
evaluation metrics as TensorBoard scalars; ``EDL_STREAM`` turns the job
into a continual stream (master/master.py).

With ``EDL_STATE_DIR=DIR`` in its environment the master journals its
state under DIR. A master that died (SIGKILL, a lost node) is relaunched
with the same flags and the same ``EDL_STATE_DIR``: it replays the
journal, its workers re-register when they see its new
``master_epoch``, and the job finishes with every task done once.

In a cluster (``KUBERNETES_SERVICE_HOST`` set) a master with
``--job_name`` attaches the k8s pod manager (k8s/pod_manager.py): it
starts ``--num_ps_pods`` PS pods and ``--num_workers`` worker pods from
the pod-spec flags and heals them; ``EDL_AUTOSCALE`` lets the elastic
controller resize the fleet. ``build_master(args, api=...)`` attaches it
over any object with the k8s API's surface (k8s/api.py).
"""

import os
import sys

from elasticdl_tpu_torch.common.args import (
    parse_master_args,
    symbol_overrides_from_args,
)
from elasticdl_tpu_torch.common.log_utils import configure as configure_logging
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.models.registry import parse_params_string


def main(argv=None):
    args = parse_master_args(argv)
    configure_logging(args.log_level, args.log_file_path)
    # a SIGTERMed master leaves a complete flight record: SIGTERM dumps
    # the event ring and flushes the journal and trace buffer, then
    # exits so Master.run's finally runs stop(); uncaught exceptions
    # dump the ring too
    from elasticdl_tpu_torch.observability import events

    events.install_crash_hooks()
    from elasticdl_tpu_torch.testing import faults

    # before the gRPC server is built: fault specs match on role
    faults.set_role("master")
    if args.metrics_port:
        # publish the knob before any instrument is constructed: the
        # registry decides enabled/no-op at first touch
        from elasticdl_tpu_torch.observability.http_server import PORT_ENV

        os.environ[PORT_ENV] = str(args.metrics_port)
    master = build_master(args)
    master.prepare()
    return master.run()


class _PodDeaths:
    """The pod manager's hook into the master: a worker pod that failed
    or was deleted is a death notice. Through the task monitor its
    tasks requeue and the worker leaves the liveness table, the
    rendezvous and the roll of workers a finished job still tells "job
    over", which it would otherwise wait out for the liveness timeout."""

    def __init__(self, task_monitor):
        self.recover_tasks = task_monitor.mark_worker_dead


def build_master(args, api=None):
    """The ``Master`` of the parsed master ``args``; with ``--job_name``
    and a cluster (``api``, or ``KUBERNETES_SERVICE_HOST`` for the
    in-cluster ``K8sApi``) it gets the k8s pod manager."""
    records_per_task = args.records_per_task
    if args.num_minibatches_per_task > 0:
        records_per_task = (
            args.minibatch_size * args.num_minibatches_per_task
        )
    master = Master(
        model_zoo_module=args.model_zoo,
        training_data=args.training_data,
        validation_data=args.validation_data,
        prediction_data=args.prediction_data,
        records_per_task=records_per_task,
        num_epochs=args.num_epochs,
        port=args.port,
        eval_steps=args.evaluation_steps,
        eval_throttle_secs=args.evaluation_throttle_secs,
        eval_start_delay_secs=args.evaluation_start_delay_secs,
        saved_model_path=args.output or None,
        data_reader_params=parse_params_string(args.data_reader_params),
        task_timeout_secs=args.task_timeout_secs,
        model_def=args.model_def,
        model_params=args.model_params,
        symbol_overrides=symbol_overrides_from_args(args),
        metrics_port=args.metrics_port,
        tensorboard_log_dir=args.tensorboard_log_dir or None,
    )
    if args.job_name and (
        api is not None or os.environ.get("KUBERNETES_SERVICE_HOST")
    ):
        # provision and heal the worker and PS pods
        from elasticdl_tpu_torch.client.args import parse_envs_string
        from elasticdl_tpu_torch.k8s.pod_manager import K8sPodManager

        master.pod_manager = K8sPodManager(
            args,
            _PodDeaths(master.task_monitor),
            master.rendezvous,
            api=api,
            envs=parse_envs_string(args.envs),
        )
    return master


if __name__ == "__main__":
    sys.exit(main())
