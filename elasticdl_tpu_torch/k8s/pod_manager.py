"""K8sPodManager: the master's pod-provisioning seam, backed by
Kubernetes (port of elasticdl_tpu/k8s/pod_manager.py).

The master stays cluster-agnostic; this adapter owns the wiring: the
k8s API -> ``Client`` -> ``InstanceManager``, the worker and PS command
lines marshalled from the master's parsed args (the port's own mains,
``elasticdl_tpu_torch.worker.main`` and ``elasticdl_tpu_torch.ps.server``),
the pod-spec flags, and the status label patched at the job's end. It
is also the elastic controller's scaler (master/autoscaler.py).

The PS command carries ``--port`` equal to its Service's port (2222):
without it the PS would listen on its own default, 50002, where no
worker's ``--ps_addrs`` points. The JAX package's command leaves it
out; this is the one place the two packages' commands differ.
"""

from elasticdl_tpu_torch.common.args import SYMBOL_OVERRIDE_KEYS
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.k8s.client import PS_PORT, Client
from elasticdl_tpu_torch.k8s.instance_manager import InstanceManager

logger = _logger_factory("elasticdl_tpu_torch.k8s.pod_manager")

_FORWARDED_WORKER_FLAGS = (
    "model_zoo",
    "model_def",
    "model_params",
    "training_data",
    "validation_data",
    "prediction_data",
    "minibatch_size",
    "data_reader_params",
    "compute_dtype",
    "checkpoint_dir",
    "checkpoint_steps",
    "async_checkpoint",
    "grad_accum_steps",
    "keep_checkpoint_max",
    "checkpoint_dir_for_init",
    "mesh",
    "consensus_interval",
    "log_level",
    "log_file_path",
) + SYMBOL_OVERRIDE_KEYS

# forwarded even when falsy: 0 is meaningful (--log_loss_steps=0
# disables loss logging) and must not be eaten by the skip-empty filter
_ALWAYS_FORWARDED_WORKER_FLAGS = ("log_loss_steps",)


def build_worker_command(args, master_addr, ps_addrs=()):
    """Marshal the master's args into the worker pods' command line;
    ``{worker_id}`` is filled in per pod (k8s/instance_manager.py)."""
    command = [
        "python",
        "-m",
        "elasticdl_tpu_torch.worker.main",
        "--master_addr=%s" % master_addr,
        "--worker_id={worker_id}",
    ]
    for flag in _FORWARDED_WORKER_FLAGS:
        value = getattr(args, flag, "")
        if value not in ("", None, 0):  # 0 = disabled for *_steps/max
            command.append("--%s=%s" % (flag, value))
    for flag in _ALWAYS_FORWARDED_WORKER_FLAGS:
        value = getattr(args, flag, None)
        if value is not None:
            command.append("--%s=%s" % (flag, value))
    if ps_addrs:
        command.append("--ps_addrs=%s" % ",".join(ps_addrs))
    return command


def build_ps_command(args, master_addr, num_ps, ps_optimizer=None):
    """The PS pods' command line; ``{ps_id}`` is filled in per pod.
    The PS listens on its Service's port (``PS_PORT``), the port every
    worker's ``--ps_addrs`` names (k8s/client.py)."""
    command = [
        "python",
        "-m",
        "elasticdl_tpu_torch.ps.server",
        "--ps_id={ps_id}",
        "--num_ps_pods=%d" % num_ps,
        "--master_addr=%s" % master_addr,
        "--port=%d" % PS_PORT,
    ]
    if ps_optimizer is not None:
        opt_type, opt_args = ps_optimizer
        command.append("--opt_type=%s" % opt_type)
        if opt_args:
            command.append("--opt_args=%s" % opt_args)
    for flag in (
        "checkpoint_dir",
        "checkpoint_steps",
        "keep_checkpoint_max",
        "checkpoint_dir_for_init",
    ):
        value = getattr(args, flag, "")
        if value not in ("", None, 0):
            command.append("--%s=%s" % (flag, value))
    # PS mode flags: always forwarded, 0 is meaningful (sync mode,
    # modulation off), so the skip-empty filter above must not apply
    for flag in (
        "use_async",
        "grads_to_wait",
        "sync_version_tolerance",
        "lr_staleness_modulation",
    ):
        value = getattr(args, flag, None)
        if value is not None:
            command.append("--%s=%s" % (flag, value))
    return command


class K8sPodManager:
    """Implements the Master's pod_manager protocol: start/stop,
    all_workers_failed, on_worker_presumed_dead."""

    def __init__(
        self,
        args,
        task_dispatcher,
        rendezvous,
        api=None,
        envs=None,
    ):
        if api is None:
            from elasticdl_tpu_torch.k8s.api import K8sApi

            api = K8sApi()
        # the pod-spec strings ride the forwarded master args
        from elasticdl_tpu_torch.client.args import (
            parse_resource_string,
            parse_volume_string,
        )

        def _arg(name, default=""):
            return getattr(args, name, default) or default

        worker_resources = parse_resource_string(
            _arg("worker_resource_request")
        )
        ps_resources = parse_resource_string(_arg("ps_resource_request"))
        tpu_resource = (
            parse_resource_string(_arg("tpu_resource")) or None
        )
        # the watch starts once the instance manager it feeds exists: a
        # watch opens with an ADDED event of every pod already there (the
        # master's own)
        self._client = Client(
            api,
            args.job_name,
            image_name=getattr(args, "image_name", ""),
            cluster_spec=_arg("cluster_spec"),
        )
        master_addr = self._client.get_master_service_address()
        num_ps = getattr(args, "num_ps_pods", 0)
        ps_addrs = [
            self._client.get_ps_service_address(i) for i in range(num_ps)
        ]
        self._manager = InstanceManager(
            self._client,
            num_workers=getattr(args, "num_workers", 1),
            num_ps=num_ps,
            worker_command=build_worker_command(
                args, master_addr, ps_addrs
            ),
            ps_command=build_ps_command(args, master_addr, num_ps),
            worker_resources=worker_resources,
            ps_resources=ps_resources,
            tpu_resource=tpu_resource,
            worker_resource_limits=parse_resource_string(
                _arg("worker_resource_limit")
            )
            or None,
            ps_resource_limits=parse_resource_string(
                _arg("ps_resource_limit")
            )
            or None,
            worker_priority=_arg("worker_pod_priority") or None,
            ps_priority=_arg("ps_pod_priority") or None,
            volumes=parse_volume_string(_arg("volume")),
            image_pull_policy=_arg("image_pull_policy") or None,
            restart_policy=_arg("restart_policy", "Never"),
            task_dispatcher=task_dispatcher,
            rendezvous=rendezvous,
            envs=envs,
        )
        self._client.start_watch(self._event_cb)

    def _event_cb(self, event_type, pod):
        self._manager._event_cb(event_type, pod)

    # -- Master protocol ----------------------------------------------
    def start(self):
        self._manager.start_parameter_servers()
        self._manager.start_workers()

    def stop(self):
        self._client.stop_watch()
        try:
            # the job is over: a PS pod may poll this label
            # (k8s/job_monitor.py)
            self._client.update_master_status_label("Finished")
        except Exception:
            logger.warning("could not patch master status label")

    def all_workers_failed(self):
        return self._manager.all_workers_failed

    # -- scaler protocol (master/autoscaler.py ElasticController) -----
    def worker_ids(self):
        return self._manager.worker_ids()

    def scale_up(self, count):
        return self._manager.scale_up(count)

    def remove_worker(self, worker_id):
        """Scale-down eviction: pod delete -> SIGTERM -> the worker's
        graceful-drain hook; the DELETED event is marked intentional so
        no replacement launches."""
        return self._manager.remove_worker(worker_id)

    def on_worker_presumed_dead(self, worker_id):
        """Liveness-timeout kill: reclaim the pod so K8s emits the
        DELETED event that relaunches a replacement."""
        try:
            self._client.delete_worker(worker_id)
        except Exception:
            logger.warning(
                "presumed-dead worker %s already gone", worker_id
            )
