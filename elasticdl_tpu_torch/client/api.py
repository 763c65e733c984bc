"""The client's commands: the model-zoo image workflow and job
submission (port of elasticdl_tpu/client/api.py).

``zoo init`` renders a Dockerfile that installs this distribution with
its torch extra and copies the model zoo in; ``zoo build`` and ``zoo
push`` drive the ``docker`` CLI. ``train``, ``evaluate`` and
``predict`` re-serialize the parsed flags into the command line of the
port's master (``python -m elasticdl_tpu_torch.master.main``) and create
the master pod, or print its manifest as YAML (``--dry_run``) or write
it (``--yaml``); ``serve`` does the same for a serving pod or the
fleet's router. ``predict --serving_addr`` streams the data through a
live serving role instead. Each submitting command takes the k8s API
object as ``api`` (k8s/api.py's surface); without one it makes the
in-cluster ``K8sApi``, or an inert stub for a dry run.
"""

import os
import shlex
import subprocess

from elasticdl_tpu_torch.client import args as client_args
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.client.api")

# the distribution carries both packages; its torch extra is the port's
_DOCKERFILE_TEMPLATE = """\
FROM {base_image}

RUN pip install {index_args}"elasticdl_tpu[torch]" {extra_packages}
COPY . /model_zoo
ENV PYTHONPATH=/model_zoo:$PYTHONPATH
"""


def init_zoo(parsed):
    """Render a Dockerfile into the current directory."""
    extra = " ".join(parsed.extra_pypi_package)
    index = getattr(parsed, "extra_pypi_index", "")
    content = _DOCKERFILE_TEMPLATE.format(
        base_image=parsed.base_image,
        extra_packages=extra,
        index_args="--extra-index-url %s " % index if index else "",
    )
    if parsed.cluster_spec:
        content += "COPY %s /cluster_spec/\n" % parsed.cluster_spec
    with open("Dockerfile", "w") as f:
        f.write(content)
    logger.info("Wrote Dockerfile (base image %s)", parsed.base_image)


def build_zoo(parsed):
    _docker(parsed, "build", "-t", parsed.image, parsed.path)


def push_zoo(parsed):
    _docker(parsed, "push", parsed.image)


def _docker(parsed, *args):
    """Shell out to the docker CLI, honoring the daemon-connection
    flags."""
    command = ["docker"]
    base_url = getattr(parsed, "docker_base_url", "")
    if base_url:
        command += ["--host", base_url]
    tlscert = getattr(parsed, "docker_tlscert", "")
    tlskey = getattr(parsed, "docker_tlskey", "")
    if bool(tlscert) != bool(tlskey):
        raise ValueError(
            "--docker_tlscert and --docker_tlskey are both required "
            "for a TLS daemon connection (got only one)"
        )
    if tlscert:
        # --tls (not --tlsverify): client-cert auth without requiring a
        # CA file
        command += ["--tls", "--tlscert", tlscert, "--tlskey", tlskey]
    command += args
    logger.info("Running: %s", " ".join(shlex.quote(a) for a in command))
    subprocess.run(command, check=True)


# ----------------------------------------------------------------------
# ``api``: the k8s API object the pod is created through (k8s/api.py's
# surface); None makes the in-cluster one, or a stub for a dry run


def train(parsed, api=None):
    return _submit_job(parsed, "train", api)


def evaluate(parsed, api=None):
    return _submit_job(parsed, "evaluate", api)


def predict(parsed, api=None):
    if getattr(parsed, "serving_addr", ""):
        return _predict_online(parsed)
    if not parsed.checkpoint_dir_for_init:
        raise ValueError(
            "predict needs --checkpoint_dir_for_init (batch job) or "
            "--serving_addr (online, against a live serving role)"
        )
    return _submit_job(parsed, "predict", api)


def _predict_online(parsed):
    """Stream the prediction data through a live serving role's
    Predict RPC: no job submission, no cluster, no checkpoint restore
    (the serving tier already holds the model). Rows go through the
    model zoo's ``dataset_fn`` as on the batch path, land on its
    ``PredictionOutputsProcessor`` when it defines one, and come back
    as a list of per-batch output arrays (LocalExecutor.predict's
    contract)."""
    import numpy as np

    from elasticdl_tpu_torch.common.args import symbol_overrides_from_args
    from elasticdl_tpu_torch.data.pipeline import (
        Dataset,
        batch_real_count,
        normalize_outputs,
    )
    from elasticdl_tpu_torch.data.readers import create_data_reader
    from elasticdl_tpu_torch.models.registry import (
        get_model_spec,
        parse_params_string,
    )
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.serve.client import ServeClient

    spec = get_model_spec(
        parsed.model_zoo,
        model_def=parsed.model_def,
        model_params=parsed.model_params,
        symbol_overrides=symbol_overrides_from_args(parsed),
    )
    reader = create_data_reader(
        parsed.prediction_data,
        **parse_params_string(parsed.data_reader_params),
    )

    def records():
        for shard_name, (start, count) in reader.create_shards().items():
            task = pb.Task(
                shard_name=shard_name, start=start, end=start + count
            )
            yield from reader.read_records(task)

    client = ServeClient(parsed.serving_addr)
    # the server rejects requests larger than its batch cap
    # (INVALID_ARGUMENT), so clamp the batching to its advertised cap:
    # --minibatch_size's default (64) exceeds the serve default (32)
    batch_size = parsed.minibatch_size
    server_max = client.model_info().get("max_batch", 0)
    if server_max and server_max < batch_size:
        logger.info(
            "clamping --minibatch_size %d to the serving role's "
            "max_batch %d", batch_size, server_max,
        )
        batch_size = server_max
    dataset = spec.dataset_fn(
        Dataset(records), "prediction", reader.metadata
    ).batch(batch_size)
    processor_cls = spec.prediction_outputs_processor
    processor = processor_cls() if processor_cls else None
    results = []
    try:
        for batch in dataset:
            real = batch_real_count(batch)
            features = batch["features"]
            if isinstance(features, dict):
                features = {
                    k: np.asarray(v)[:real] for k, v in features.items()
                }
            else:
                features = np.asarray(features)[:real]
            outputs, _, _ = client.predict(
                features,
                affinity_key=getattr(parsed, "affinity_key", 0),
            )
            outputs = normalize_outputs(outputs, real)
            if processor is not None:
                processor.process(outputs, 0)
            results.append(outputs["output"])
        if processor is not None and hasattr(processor, "close"):
            processor.close()
    finally:
        client.close()
    logger.info(
        "served %d prediction batches through %s",
        len(results), parsed.serving_addr,
    )
    return results


def serve(parsed, api=None):
    """Submit the online serving role's pod (or dump YAML), a
    long-running low-latency tier (docs/SERVING.md). With ``--router``
    the pod is the fleet's router: replicas are serve pods submitted
    with ``--router_addr`` pointing at it."""
    if getattr(parsed, "router", False):
        command = [
            "python", "-m", "elasticdl_tpu_torch.serve.router_main",
            "--router_id=0",
            "--port=%d" % parsed.port,
        ]
        if parsed.min_replicas >= 0:
            command.append("--min_replicas=%d" % parsed.min_replicas)
        if parsed.max_replicas >= 0:
            command.append("--max_replicas=%d" % parsed.max_replicas)
        role, index_name = "router", "router-0"
    else:
        if not parsed.model_zoo or not parsed.export_dir:
            raise ValueError(
                "edl serve needs --model_zoo and --export_dir "
                "(or --router for the fleet router pod)"
            )
        command = [
            "python", "-m", "elasticdl_tpu_torch.serve.main",
            "--serve_id=0",
            "--port=%d" % parsed.port,
            "--model_zoo=%s" % parsed.model_zoo,
            "--export_dir=%s" % parsed.export_dir,
        ]
        for flag in ("model_def", "model_params", "ps_addrs",
                     "master_addr", "compute_dtype", "router_addr"):
            value = getattr(parsed, flag, "")
            if value:
                command.append("--%s=%s" % (flag, value))
        if parsed.max_batch:
            command.append("--max_batch=%d" % parsed.max_batch)
        if parsed.max_delay_ms >= 0:
            command.append("--max_delay_ms=%s" % parsed.max_delay_ms)
        if parsed.queue_depth:
            command.append("--queue_depth=%d" % parsed.queue_depth)
        if parsed.deadline_ms >= 0:
            command.append("--deadline_ms=%s" % parsed.deadline_ms)
        role, index_name = "serve", "serve-0"
    if parsed.metrics_port:
        command.append("--metrics_port=%d" % parsed.metrics_port)

    from elasticdl_tpu_torch.k8s.client import Client

    api = api if api is not None else _make_api(parsed)
    client = Client(
        api,
        parsed.job_name,
        image_name=parsed.image_name,
        cluster_spec=getattr(parsed, "cluster_spec", ""),
    )
    manifest = client.build_pod_manifest(
        "elasticdl-%s-%s" % (parsed.job_name, index_name),
        role,
        0,
        command,
        resource_requests=client_args.parse_resource_string(
            parsed.worker_resource_request
        ),
        resource_limits=client_args.parse_resource_string(
            parsed.worker_resource_limit
        )
        or None,
        env=client_args.parse_envs_string(parsed.envs),
        restart_policy="Always",  # a serving pod is a long-running tier
        priority_class=parsed.worker_pod_priority or None,
        volumes=client_args.parse_volume_string(parsed.volume),
        image_pull_policy=parsed.image_pull_policy or None,
    )
    return _emit_or_submit(
        parsed, api, manifest, "serve",
        "Submitted serving role for job %s on port %d"
        % (parsed.job_name, parsed.port),
    )


def _submit_job(parsed, job_kind, api=None):
    """Build the master pod manifest; submit it or dump YAML."""
    if os.path.exists(getattr(parsed, "cluster_spec", "") or ""):
        # a cluster_spec FILE path is client-local; the master runs
        # inside the zoo image, where `zoo init` placed the module
        # under /cluster_spec/ — forward THAT path (the client-side
        # master-pod hook below still loads the local file). A dotted
        # module name passes through untouched: it resolves by import
        # inside the image.
        import argparse as _argparse

        forwarded = _argparse.Namespace(**vars(parsed))
        forwarded.cluster_spec = "/cluster_spec/%s" % os.path.basename(
            parsed.cluster_spec
        )
        master_args = client_args.build_master_arguments(forwarded)
    else:
        master_args = client_args.build_master_arguments(parsed)
    command = [
        "python",
        "-m",
        "elasticdl_tpu_torch.master.main",
    ] + master_args

    from elasticdl_tpu_torch.k8s.client import Client

    api = api if api is not None else _make_api(parsed)
    client = Client(
        api,
        parsed.job_name,
        image_name=parsed.image_name,
        cluster_spec=getattr(parsed, "cluster_spec", ""),
    )
    manifest = client.build_pod_manifest(
        client.get_master_pod_name(),
        "master",
        0,
        command,
        resource_requests=client_args.parse_resource_string(
            parsed.master_resource_request
        ),
        resource_limits=client_args.parse_resource_string(
            parsed.master_resource_limit
        )
        or None,
        env=dict(
            client_args.parse_envs_string(parsed.envs),
            EDL_JOB_KIND=job_kind,
        ),
        restart_policy=parsed.restart_policy,
        priority_class=parsed.master_pod_priority or None,
        volumes=client_args.parse_volume_string(parsed.volume),
        image_pull_policy=parsed.image_pull_policy or None,
    )
    return _emit_or_submit(
        parsed, api, manifest, "master",
        "Submitted %s job %s (master pod %s)"
        % (job_kind, parsed.job_name, client.get_master_pod_name()),
    )


def _emit_or_submit(parsed, api, manifest, what, submitted_msg):
    """Shared tail of every pod-submitting command: dump the manifest
    (--dry_run prints, --yaml writes) or create the pod for real."""
    if parsed.dry_run or parsed.yaml:
        import yaml

        text = yaml.safe_dump(manifest, sort_keys=False)
        if parsed.yaml:
            with open(parsed.yaml, "w") as f:
                f.write(text)
            logger.info("Wrote %s pod manifest to %s", what, parsed.yaml)
        else:
            print(text)
        return manifest
    api.create_pod(manifest)
    logger.info(submitted_msg)
    return manifest


def _make_api(parsed):
    """In-cluster/kubeconfig-less API, or an inert stub for dry runs."""
    if parsed.dry_run or parsed.yaml:
        class _DryRunApi:
            namespace = parsed.namespace

        return _DryRunApi()
    from elasticdl_tpu_torch.k8s.api import K8sApi

    return K8sApi(namespace=parsed.namespace)
