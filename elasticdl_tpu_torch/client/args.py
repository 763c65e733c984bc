"""The client CLI's flags (port of elasticdl_tpu/client/args.py).

The ``edl-torch`` subcommands' parsers (train, evaluate, predict,
serve, zoo init/build/push), ``build_master_arguments``, which
re-serializes the parsed flags into the master pod's command line (the
master's parser, common/args.py, takes every one of them back), and the
pod-spec string formats: resources ``cpu=1,memory=4096Mi``, volumes
``claim_name=pvc,mount_path=/data`` or ``host_path=/p,mount_path=/data``,
envs ``K1=v1,K2=v2``.
"""

import argparse

from elasticdl_tpu_torch.common.args import (
    LOG_LOSS_STEPS_DEFAULT,
    add_bool_argument,
    add_logging_arguments,
    add_symbol_override_arguments,
)


def add_zoo_init_arguments(parser):
    parser.add_argument(
        "--base_image", default="python:3.12", help="Docker base image"
    )
    parser.add_argument(
        "--extra_pypi_package",
        action="append",
        default=[],
        help="extra pip packages baked into the image",
    )
    parser.add_argument(
        "--extra_pypi_index",
        default="",
        help="extra pip index URL for the image's installs",
    )
    parser.add_argument(
        "--cluster_spec",
        default="",
        help="python file customizing pod specs for your cluster",
    )


def _add_docker_connection_arguments(parser):
    parser.add_argument("--docker_base_url", default="")
    parser.add_argument("--docker_tlscert", default="")
    parser.add_argument("--docker_tlskey", default="")


def add_zoo_build_arguments(parser):
    parser.add_argument("path", help="model zoo directory")
    parser.add_argument(
        "--image", required=True, help="tag for the built image"
    )
    _add_docker_connection_arguments(parser)


def add_zoo_push_arguments(parser):
    parser.add_argument("image", help="image tag to push")
    # push must reach the same daemon the image was built on
    _add_docker_connection_arguments(parser)


def add_common_arguments(parser):
    parser.add_argument("--job_name", required=True)
    parser.add_argument("--image_name", default="")
    parser.add_argument(
        "--cluster_spec",
        default="",
        help="python module exporting `cluster` with "
        "with_pod/with_service manifest hooks; applied to every pod "
        "and service this job creates (in-cluster, the zoo image "
        "carries it under /cluster_spec/)",
    )
    parser.add_argument("--namespace", default="default")
    parser.add_argument(
        "--distribution_strategy",
        default="AllreduceStrategy",
        choices=[
            "Local",
            "AllreduceStrategy",  # dense SPMD (the default)
            "ParameterServerStrategy",  # + sparse host-PS
        ],
    )
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument(
        "--num_ps_pods",
        type=int,
        default=0,
        help="sparse host-PS pod count (dense gradients never touch a PS)",
    )
    parser.add_argument("--worker_resource_request", default="cpu=1,memory=4096Mi")
    parser.add_argument("--worker_resource_limit", default="")
    parser.add_argument("--ps_resource_request", default="cpu=1,memory=4096Mi")
    parser.add_argument("--ps_resource_limit", default="")
    parser.add_argument("--master_resource_request", default="cpu=0.5,memory=1024Mi")
    parser.add_argument("--master_resource_limit", default="")
    parser.add_argument(
        "--tpu_resource",
        default="",
        help='accelerator resource per worker pod, e.g. '
        '"nvidia.com/gpu=1" (the flag keeps the JAX package\'s name)',
    )
    parser.add_argument(
        "--mesh",
        default="",
        help='mesh axis sizes, e.g. "dp=4,fsdp=2" (defaults to all-dp)',
    )
    parser.add_argument("--master_pod_priority", default="")
    parser.add_argument("--worker_pod_priority", default="")
    parser.add_argument("--ps_pod_priority", default="")
    parser.add_argument(
        "--volume",
        default="",
        help='e.g. "claim_name=mypvc,mount_path=/data"',
    )
    parser.add_argument(
        "--envs", default="", help="k1=v1,k2=v2 env vars for all pods"
    )
    parser.add_argument("--restart_policy", default="Never")
    parser.add_argument("--image_pull_policy", default="Always")
    parser.add_argument(
        "--dry_run",
        action="store_true",
        help="print the master pod manifest as YAML instead of submitting",
    )
    parser.add_argument(
        "--yaml",
        default="",
        help="dump the master pod manifest to this file",
    )


def add_train_arguments(parser):
    parser.add_argument("--model_zoo", required=True)
    parser.add_argument("--model_def", default="")
    parser.add_argument("--model_params", default="")
    parser.add_argument("--training_data", default="")
    parser.add_argument("--validation_data", default="")
    parser.add_argument("--data_reader_params", default="")
    parser.add_argument("--minibatch_size", type=int, default=64)
    parser.add_argument("--num_epochs", type=int, default=1)
    parser.add_argument("--records_per_task", type=int, default=1024)
    parser.add_argument("--evaluation_steps", type=int, default=0)
    parser.add_argument("--evaluation_throttle_secs", type=int, default=0)
    parser.add_argument("--evaluation_start_delay_secs", type=int, default=0)
    parser.add_argument("--task_timeout_secs", type=float, default=300.0)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--checkpoint_steps", type=int, default=0)
    parser.add_argument("--async_checkpoint", type=int, default=0)
    parser.add_argument("--grad_accum_steps", type=int, default=1)
    parser.add_argument("--keep_checkpoint_max", type=int, default=3)
    parser.add_argument("--checkpoint_dir_for_init", default="")
    parser.add_argument("--output", default="")
    parser.add_argument("--compute_dtype", default="bfloat16")
    # sparse host-PS mode: forwarded to the master, which marshals them
    # into the PS pods' commands
    add_bool_argument(parser, "--use_async", default=0)
    parser.add_argument("--grads_to_wait", type=int, default=1)
    parser.add_argument("--sync_version_tolerance", type=int, default=0)
    add_bool_argument(parser, "--lr_staleness_modulation", default=0)
    # lockstep consensus cadence; forwarded master -> worker pods
    parser.add_argument("--consensus_interval", type=int, default=1)
    parser.add_argument("--tensorboard_log_dir", default="")
    parser.add_argument(
        "--num_minibatches_per_task", type=int, default=0
    )
    parser.add_argument(
        "--log_loss_steps", type=int, default=LOG_LOSS_STEPS_DEFAULT
    )
    _add_model_symbol_and_log_arguments(parser)


def _add_model_symbol_and_log_arguments(parser):
    # contract symbol-name overrides + logging: the master's and the
    # worker's own helpers, so the client cannot drift from them
    add_symbol_override_arguments(parser)
    add_logging_arguments(parser)


def add_evaluate_arguments(parser):
    parser.add_argument("--model_zoo", required=True)
    parser.add_argument("--model_def", default="")
    # must match the train-time binding or checkpoint restore sees a
    # different architecture
    parser.add_argument("--model_params", default="")
    parser.add_argument("--validation_data", required=True)
    parser.add_argument("--data_reader_params", default="")
    parser.add_argument("--minibatch_size", type=int, default=64)
    parser.add_argument("--records_per_task", type=int, default=1024)
    parser.add_argument("--checkpoint_dir_for_init", required=True)
    parser.add_argument("--compute_dtype", default="bfloat16")
    parser.add_argument("--num_epochs", type=int, default=1)
    parser.add_argument("--evaluation_steps", type=int, default=0)
    parser.add_argument("--tensorboard_log_dir", default="")
    parser.add_argument(
        "--num_minibatches_per_task", type=int, default=0
    )
    _add_model_symbol_and_log_arguments(parser)


def add_predict_arguments(parser):
    parser.add_argument("--model_zoo", required=True)
    parser.add_argument("--model_def", default="")
    # must match the train-time binding or checkpoint restore sees a
    # different architecture
    parser.add_argument("--model_params", default="")
    parser.add_argument("--prediction_data", required=True)
    parser.add_argument("--data_reader_params", default="")
    parser.add_argument("--minibatch_size", type=int, default=64)
    parser.add_argument("--records_per_task", type=int, default=1024)
    # required for the batch-job path; the online path
    # (--serving_addr) restores nothing client-side, so the check is
    # deferred to api.predict
    parser.add_argument("--checkpoint_dir_for_init", default="")
    parser.add_argument("--compute_dtype", default="bfloat16")
    parser.add_argument(
        "--num_minibatches_per_task", type=int, default=0
    )
    parser.add_argument(
        "--serving_addr",
        default="",
        help="host:port of a live serving role: stream the "
        "prediction data through its Predict RPC instead of submitting "
        "a batch prediction job",
    )
    parser.add_argument(
        "--affinity_key",
        type=int,
        default=0,
        help="online mode against a fleet router: affinity "
        "key stamped on every request so this stream keeps hitting the "
        "same replica (and its hot embedding cache); 0 = spread",
    )
    _add_model_symbol_and_log_arguments(parser)


def add_serve_arguments(parser):
    """``edl serve``: submit the online serving role, which loads a
    train/export.py artifact, serves Predict and hot-swaps new export
    versions with zero downtime (docs/SERVING.md). With ``--router``
    the pod is the fleet's router instead: affinity routing, failover
    and canary over replicas that register through ``--router_addr``."""
    parser.add_argument(
        "--router", action="store_true", default=False,
        help="submit the serving-fleet router (serve.router_main) "
        "instead of a single serve pod; replicas are serve pods "
        "submitted with --router_addr (docs/SERVING.md 'Fleet "
        "topology')",
    )
    parser.add_argument(
        "--router_addr", default="",
        help="host:port of a fleet router this serve pod should "
        "register with (replica mode); empty = standalone pod",
    )
    parser.add_argument(
        "--min_replicas", type=int, default=-1,
        help="router mode: autoscaler floor (<0 = EDL_SERVE_MIN_REPLICAS)",
    )
    parser.add_argument(
        "--max_replicas", type=int, default=-1,
        help="router mode: autoscaler ceiling "
        "(<0 = EDL_SERVE_MAX_REPLICAS)",
    )
    # required for serve pods, unused by --router (validated in
    # api.serve — argparse can't express the either/or)
    parser.add_argument("--model_zoo", default="")
    parser.add_argument("--model_def", default="")
    parser.add_argument("--model_params", default="")
    parser.add_argument(
        "--export_dir", default="",
        help="train/export.py artifact directory (typically a shared "
        "volume the training job exports into); required unless "
        "--router",
    )
    parser.add_argument("--ps_addrs", default="")
    parser.add_argument("--master_addr", default="")
    parser.add_argument("--port", type=int, default=50052)
    parser.add_argument("--compute_dtype", default="")
    parser.add_argument("--max_batch", type=int, default=0)
    parser.add_argument("--max_delay_ms", type=float, default=-1.0)
    parser.add_argument("--queue_depth", type=int, default=0)
    parser.add_argument("--deadline_ms", type=float, default=-1.0)
    parser.add_argument("--metrics_port", type=int, default=0)


# flags that belong to the client only and must NOT be forwarded to the
# master process command line
_CLIENT_ONLY = {
    "namespace",
    "dry_run",
    "yaml",
    # online-predict mode runs entirely client-side (api.predict)
    "serving_addr",
    "affinity_key",
    "docker_base_url",
    "docker_tlscert",
    "docker_tlskey",
    # the master pod's own spec is built by the client; everything the
    # MASTER needs to build worker/PS pod specs (image, resources,
    # priorities, volume, tpu_resource, pull/restart policy) is
    # forwarded
    "master_resource_request",
    "master_resource_limit",
    "master_pod_priority",
}


def build_master_arguments(parsed):
    """Re-serialize parsed args into the master's command line."""
    parts = []
    for key, value in sorted(vars(parsed).items()):
        if key in _CLIENT_ONLY or key in ("command", "zoo_command", "func"):
            continue
        # identity check for False: `0 in ("", None, False)` is True
        # (0 == False), which would silently drop meaningful zeros like
        # --use_async=0 and leave the master on its own default
        if value is None or value == "" or value is False or value == []:
            continue
        if value is True:
            parts.append("--%s" % key)
        else:
            parts.append("--%s=%s" % (key, value))
    return parts


def parse_resource_string(spec):
    """'cpu=1,memory=4096Mi' -> {'cpu': '1', 'memory': '4096Mi'}."""
    resources = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError("Bad resource segment %r" % part)
        key, value = part.split("=", 1)
        resources[key.strip()] = value.strip()
    return resources


def parse_envs_string(spec):
    envs = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        key, value = part.split("=", 1)
        envs[key.strip()] = value.strip()
    return envs


def parse_volume_string(spec):
    """'claim_name=x,mount_path=/data' (or 'host_path=/p,
    mount_path=/data') -> the pod's volume and mount dicts."""
    if not spec:
        return None
    fields = parse_resource_string(spec)
    mount_path = fields.get("mount_path")
    if not mount_path:
        raise ValueError("volume spec needs mount_path")
    name = "edl-volume-0"
    if "claim_name" in fields:
        volume = {
            "name": name,
            "persistentVolumeClaim": {"claimName": fields["claim_name"]},
        }
    elif "host_path" in fields:
        volume = {"name": name, "hostPath": {"path": fields["host_path"]}}
    else:
        raise ValueError("volume spec needs claim_name or host_path")
    return [{"volume": volume, "mount": {"name": name, "mountPath": mount_path}}]
