"""Command-line flags of the master and the worker, and the boolean
flag helpers (port of elasticdl_tpu/common/args.py).

The master takes the JAX package's flags, the pod-spec and PS-mode ones
included: the client CLI (client/) forwards them to the master, and the
k8s pod manager (k8s/pod_manager.py) builds the worker and PS pods from
them. The worker's ``--mesh`` gives the SPMD trainer's axis sizes (e.g.
``dp=4,fsdp=2``; dp=-1 absorbs the ranks left over) over the ranks of
the default process group. The worker adds ``--device``
(``cuda`` unless the caller asks for the CPU, by the flag or by
``EDL_DEVICE``). The PS server's own
flags live in ``ps/server.py:parse_ps_args``.
"""

import argparse
import os

LOG_LOSS_STEPS_DEFAULT = 100

# the worker's --device default when the flag is absent: the pods the
# master launches get no --device, so a job's --envs picks their device
DEVICE_ENV = "EDL_DEVICE"


def _add_common(parser):
    parser.add_argument(
        "--model_zoo",
        required=True,
        help="Model module: dotted import path or file path",
    )
    parser.add_argument("--training_data", default="")
    parser.add_argument("--validation_data", default="")
    parser.add_argument("--prediction_data", default="")
    parser.add_argument("--minibatch_size", type=int, default=32)
    parser.add_argument(
        "--data_reader_params",
        default="",
        help="k=v;k=v parameters for the data reader",
    )
    parser.add_argument(
        "--compute_dtype",
        default="",
        help="Computation dtype of the step (e.g. bfloat16); params "
        "stay float32",
    )
    # --model_def picks the module (and optionally the model factory)
    # inside a model-zoo directory; --model_params is k=v;k=v kwargs
    # for custom_model
    parser.add_argument("--model_def", default="")
    parser.add_argument("--model_params", default="")
    # the contract's symbol names (--loss my_loss, ...)
    add_symbol_override_arguments(parser)
    add_logging_arguments(parser)


def parse_master_args(argv=None):
    parser = argparse.ArgumentParser("elasticdl_tpu_torch master")
    _add_common(parser)
    parser.add_argument("--port", type=int, default=50001)
    parser.add_argument("--records_per_task", type=int, default=1024)
    # alternative task sizing: records_per_task =
    # minibatch_size * num_minibatches_per_task
    parser.add_argument(
        "--num_minibatches_per_task", type=int, default=0
    )
    # accepted so the client can forward it; the workers the master
    # launches consume it
    parser.add_argument(
        "--log_loss_steps", type=int, default=LOG_LOSS_STEPS_DEFAULT
    )
    parser.add_argument("--num_epochs", type=int, default=1)
    parser.add_argument("--evaluation_steps", type=int, default=0)
    parser.add_argument("--evaluation_throttle_secs", type=int, default=0)
    parser.add_argument("--evaluation_start_delay_secs", type=int, default=0)
    # liveness timeout: a worker silent this long is presumed dead and
    # its tasks requeue
    parser.add_argument("--task_timeout_secs", type=float, default=30.0)
    parser.add_argument(
        "--output", default="", help="saved-model export path"
    )
    parser.add_argument("--num_workers", type=int, default=1)
    # forwarded to the worker pods (k8s/pod_manager.py)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--checkpoint_steps", type=int, default=0)
    parser.add_argument("--async_checkpoint", type=int, default=0)
    parser.add_argument("--grad_accum_steps", type=int, default=1)
    parser.add_argument("--keep_checkpoint_max", type=int, default=3)
    parser.add_argument("--checkpoint_dir_for_init", default="")
    parser.add_argument("--consensus_interval", type=int, default=1)
    # sparse host-PS mode, marshalled into the PS pods' command lines
    add_bool_argument(parser, "--use_async", default=0)
    parser.add_argument("--grads_to_wait", type=int, default=1)
    parser.add_argument("--sync_version_tolerance", type=int, default=0)
    add_bool_argument(parser, "--lr_staleness_modulation", default=0)
    # the job's name: with it, in a cluster, the master provisions and
    # heals its worker and PS pods (master/main.py)
    parser.add_argument("--job_name", default="")
    # pod-spec flags of the worker and PS pods the master creates
    # (client/args.py's resource, volume and env string formats)
    parser.add_argument("--image_name", default="")
    parser.add_argument("--image_pull_policy", default="")
    parser.add_argument("--restart_policy", default="Never")
    parser.add_argument("--worker_resource_request", default="")
    parser.add_argument("--worker_resource_limit", default="")
    parser.add_argument("--ps_resource_request", default="")
    parser.add_argument("--ps_resource_limit", default="")
    parser.add_argument("--worker_pod_priority", default="")
    parser.add_argument("--ps_pod_priority", default="")
    parser.add_argument("--volume", default="")
    parser.add_argument(
        "--tpu_resource",
        default="",
        help='accelerator resource per worker pod, e.g. '
        '"nvidia.com/gpu=1" (the flag keeps the JAX package\'s name)',
    )
    parser.add_argument("--cluster_spec", default="")
    parser.add_argument(
        "--distribution_strategy", default="AllreduceStrategy"
    )
    parser.add_argument("--num_ps_pods", type=int, default=0)
    parser.add_argument(
        "--mesh", default="", help='axis sizes, e.g. "dp=4,fsdp=2"'
    )
    parser.add_argument("--envs", default="")
    # evaluation metrics as TensorBoard scalars under this directory
    parser.add_argument("--tensorboard_log_dir", default="")
    # observability: /metrics + /healthz + /readyz on this port
    # (0/unset = disabled; falls back to EDL_METRICS_PORT)
    parser.add_argument("--metrics_port", type=int, default=0)
    return parser.parse_args(argv)


def parse_worker_args(argv=None):
    parser = argparse.ArgumentParser("elasticdl_tpu_torch worker")
    _add_common(parser)
    parser.add_argument("--master_addr", required=True)
    parser.add_argument("--worker_id", type=int, required=True)
    parser.add_argument(
        "--ps_addrs",
        default="",
        help="comma-separated PS addresses for sparse embedding models",
    )
    parser.add_argument(
        "--mode",
        default="training",
        choices=["training", "evaluation", "prediction"],
    )
    parser.add_argument(
        "--device", default=os.environ.get(DEVICE_ENV) or "cuda",
        help="torch device to train on (cuda, cuda:N or cpu; default "
        "$%s, else cuda); cuda without a card raises" % DEVICE_ENV,
    )
    parser.add_argument("--report_version_steps", type=int, default=10)
    # log the training loss every N batches
    parser.add_argument(
        "--log_loss_steps", type=int, default=LOG_LOSS_STEPS_DEFAULT
    )
    # split each batch into k microbatches with one optimizer update
    # (dense models)
    parser.add_argument("--grad_accum_steps", type=int, default=1)
    # mesh axis sizes for the SPMD trainer; dp=-1 absorbs the remaining
    # ranks (a dense model; empty: the single-card trainer, unless the
    # model exports mesh_config)
    parser.add_argument(
        "--mesh", default="", help='axis sizes, e.g. "dp=4,fsdp=2"'
    )
    # pipelined sparse training: overlap batch N+1's PS pull with batch
    # N's device step; optional hot-row reuse and push accumulation
    parser.add_argument("--sparse_pipeline", type=int, default=0)
    parser.add_argument("--sparse_cache_staleness", type=int, default=0)
    parser.add_argument("--sparse_push_interval", type=int, default=1)
    # dense checkpoints: every --checkpoint_steps versions into
    # --checkpoint_dir (the newest --keep_checkpoint_max kept); resume
    # from --checkpoint_dir_for_init (a restore that finds data but
    # fails is fatal)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--checkpoint_steps", type=int, default=0)
    parser.add_argument("--keep_checkpoint_max", type=int, default=3)
    parser.add_argument("--checkpoint_dir_for_init", default="")
    # write each dense checkpoint's file on a background thread (the
    # next save or the exit joins it; lockstep saves stay synchronous)
    parser.add_argument("--async_checkpoint", type=int, default=0)
    # several worker processes train one model in lockstep: join the
    # master's mesh rendezvous and form the torch.distributed group
    # there (parallel/multihost.py); a new mesh epoch exits 3 for the
    # pod manager's relaunch
    from elasticdl_tpu_torch.parallel.multihost import COORDINATOR_PORT

    parser.add_argument("--multihost", type=int, default=0)
    parser.add_argument(
        "--coordinator_port", type=int, default=COORDINATOR_PORT
    )
    # identity in the master's mesh rendezvous; defaults to the hostname
    # (override for several workers on one machine)
    parser.add_argument("--worker_host", default="")
    # lockstep consensus every k rounds (worker.py
    # _train_batches_lockstep)
    parser.add_argument("--consensus_interval", type=int, default=1)
    # observability: /metrics + /healthz + /readyz on this port
    # (0/unset = disabled; falls back to EDL_METRICS_PORT)
    parser.add_argument("--metrics_port", type=int, default=0)
    return parser.parse_args(argv)


# the contract symbol-name override flags: one list read by every
# parser that defines them and by symbol_overrides_from_args
SYMBOL_OVERRIDE_KEYS = (
    "loss",
    "optimizer",
    "dataset_fn",
    "eval_metrics_fn",
    "callbacks",
    "prediction_outputs_processor",
)


def add_symbol_override_arguments(parser):
    for key in SYMBOL_OVERRIDE_KEYS:
        parser.add_argument("--%s" % key, default="")


def add_logging_arguments(parser):
    """--log_level / --log_file_path, shared by every parser that takes
    them (the client's train, evaluate and predict, the master, the
    worker); common/log_utils.py ``configure`` applies them."""
    parser.add_argument("--log_level", default="")
    parser.add_argument("--log_file_path", default="")


def symbol_overrides_from_args(args):
    """The non-empty symbol-name flags as the ``symbol_overrides`` dict
    ``get_model_spec`` takes (None when all are left at their
    default)."""
    overrides = {
        k: getattr(args, k)
        for k in SYMBOL_OVERRIDE_KEYS
        if getattr(args, k, "")
    }
    return overrides or None


def bool_flag(value):
    """Accept the reference's bool spellings (--use_async=True) beside
    0/1; anything else is an argparse error."""
    lowered = str(value).strip().lower()
    if lowered in ("true", "yes", "1"):
        return 1
    if lowered in ("false", "no", "0"):
        return 0
    raise argparse.ArgumentTypeError(
        "expected a boolean (true/false/1/0), got %r" % (value,)
    )


def add_bool_argument(parser, name, default=0, help=None):
    """A bool flag whose bare spelling (``--use_async`` with no value)
    flips the default, while ``--use_async=True`` or ``--use_async 1``
    still parse through ``bool_flag``."""
    parser.add_argument(
        name,
        nargs="?",
        const=0 if default else 1,
        type=bool_flag,
        default=default,
        help=help,
    )
