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
"""

import os
import sys

from elasticdl_tpu_torch.common.args import (
    parse_master_args,
    symbol_overrides_from_args,
)
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.models.registry import parse_params_string


def main(argv=None):
    args = parse_master_args(argv)
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
    master.prepare()
    return master.run()


if __name__ == "__main__":
    sys.exit(main())
