"""The job's pods and Services, and the pod watch (port of
elasticdl_tpu/k8s/client.py).

Pods are named ``elasticdl-<job>-{master,worker-<id>,ps-<id>}``, each
with a headless Service of its own name, so its address is
``<pod>.<namespace>.svc:<port>``: 50001 for the master, 3333 for a
worker, 2222 for a PS. The ``elasticdl-tpu-*`` labels and these ports
are a contract with ``manifests/`` and stay the JAX package's. The
master pod's manifest may own the job's pods (``owner``), so deleting it
collects them. A worker pod's resources take an accelerator resource
(``tpu_resource``, e.g. {"nvidia.com/gpu": "1"}) among the limits. The
watch is a daemon thread feeding the pod events to a callback
(k8s/instance_manager.py) and re-establishing the stream when it drops.
"""

import threading
import traceback

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.k8s.client")

ELASTICDL_APP_NAME = "elasticdl-tpu"
ELASTICDL_JOB_KEY = "elasticdl-tpu-job-name"
ELASTICDL_REPLICA_TYPE_KEY = "elasticdl-tpu-replica-type"
ELASTICDL_REPLICA_INDEX_KEY = "elasticdl-tpu-replica-index"

WORKER_PORT = 3333
PS_PORT = 2222
MASTER_PORT = 50001


class Client:
    def __init__(
        self,
        api,
        job_name,
        image_name="",
        event_callback=None,
        cluster_spec="",
    ):
        self._api = api
        self.job_name = job_name
        self._image = image_name
        self._event_cb = event_callback
        self._watch_thread = None
        self._stopped = threading.Event()
        # the cluster customization plugin: a module exporting
        # ``cluster`` whose with_pod/with_service hooks take and return
        # every manifest this job builds, as plain dicts
        self._cluster = None
        if cluster_spec:
            from elasticdl_tpu_torch.models.registry import load_module

            self._cluster = getattr(
                load_module(cluster_spec), "cluster", None
            )
            if self._cluster is None:
                raise ValueError(
                    "cluster_spec module %r exports no `cluster` object"
                    % (cluster_spec,)
                )
        if event_callback:
            self.start_watch()

    def _with_pod(self, manifest):
        if self._cluster and hasattr(self._cluster, "with_pod"):
            return self._cluster.with_pod(manifest) or manifest
        return manifest

    def _with_service(self, manifest):
        if self._cluster and hasattr(self._cluster, "with_service"):
            return self._cluster.with_service(manifest) or manifest
        return manifest

    # ------------------------------------------------------------------
    def start_watch(self, event_callback=None):
        """Start the pod watch, feeding ``event_callback`` (or the one
        given at construction)."""
        if event_callback is not None:
            self._event_cb = event_callback
        self._watch_thread = threading.Thread(
            target=self._watch_loop,
            name="k8s_pod_watch",
            daemon=True,
        )
        self._watch_thread.start()

    def stop_watch(self):
        self._stopped.set()

    def _watch_loop(self):
        selector = "%s=%s" % (ELASTICDL_JOB_KEY, self.job_name)
        while not self._stopped.is_set():
            try:
                for event_type, pod in self._api.watch_pods(
                    label_selector=selector, timeout_seconds=60
                ):
                    if self._stopped.is_set():
                        return
                    try:
                        self._event_cb(event_type, pod)
                    except Exception:
                        logger.error(
                            "event callback failed:\n%s",
                            traceback.format_exc(),
                        )
            except Exception:
                if self._stopped.is_set():
                    return
                logger.warning(
                    "pod watch disconnected; re-establishing:\n%s",
                    traceback.format_exc(),
                )

    # ------------------------------------------------------------------
    def get_master_pod_name(self):
        return "elasticdl-%s-master" % self.job_name

    def get_worker_pod_name(self, worker_id):
        return "elasticdl-%s-worker-%s" % (self.job_name, worker_id)

    def get_ps_pod_name(self, ps_id):
        return "elasticdl-%s-ps-%s" % (self.job_name, ps_id)

    def get_worker_service_address(self, worker_id):
        return "%s.%s.svc:%d" % (
            self.get_worker_pod_name(worker_id),
            self._api.namespace,
            WORKER_PORT,
        )

    def get_ps_service_address(self, ps_id):
        return "%s.%s.svc:%d" % (
            self.get_ps_pod_name(ps_id),
            self._api.namespace,
            PS_PORT,
        )

    def get_master_service_address(self):
        return "%s.%s.svc:%d" % (
            self.get_master_pod_name(),
            self._api.namespace,
            MASTER_PORT,
        )

    # ------------------------------------------------------------------
    def _labels(self, replica_type, replica_index):
        return {
            "app": ELASTICDL_APP_NAME,
            ELASTICDL_JOB_KEY: self.job_name,
            ELASTICDL_REPLICA_TYPE_KEY: replica_type,
            ELASTICDL_REPLICA_INDEX_KEY: str(replica_index),
        }

    def build_pod_manifest(
        self,
        name,
        replica_type,
        replica_index,
        command,
        resource_requests=None,
        resource_limits=None,
        tpu_resource=None,
        env=None,
        image=None,
        restart_policy="Never",
        priority_class=None,
        volumes=None,
        owner=None,
        image_pull_policy=None,
    ):
        resources = {
            "requests": dict(resource_requests or {}),
            "limits": dict(resource_limits or resource_requests or {}),
        }
        if tpu_resource:
            # accelerators are limits-only resources
            resources["limits"].update(tpu_resource)
        container = {
            "name": "main",
            "image": image or self._image,
            "command": command,
            "resources": resources,
            "env": [
                {"name": k, "value": str(v)}
                for k, v in (env or {}).items()
            ],
        }
        if image_pull_policy:
            container["imagePullPolicy"] = image_pull_policy
        spec = {
            "containers": [container],
            "restartPolicy": restart_policy,
        }
        if priority_class:
            spec["priorityClassName"] = priority_class
        if volumes:
            spec["volumes"] = [v["volume"] for v in volumes]
            container["volumeMounts"] = [v["mount"] for v in volumes]
        manifest = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "labels": self._labels(replica_type, replica_index),
            },
            "spec": spec,
        }
        if owner:
            # deleting the master garbage-collects every job pod
            manifest["metadata"]["ownerReferences"] = [
                {
                    "apiVersion": "v1",
                    "kind": "Pod",
                    "name": owner["name"],
                    "uid": owner["uid"],
                    "controller": True,
                    "blockOwnerDeletion": True,
                }
            ]
        return self._with_pod(manifest)

    def _service_manifest(self, name, port, replica_type, replica_index,
                          service_type=None):
        spec = {
            "selector": self._labels(replica_type, replica_index),
            "ports": [{"port": port, "targetPort": port}],
        }
        if service_type is None:
            spec["clusterIP"] = "None"  # headless: DNS -> pod IP
        else:
            spec["type"] = service_type
        return self._with_service({
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name},
            "spec": spec,
        })

    # ------------------------------------------------------------------
    def create_worker(self, worker_id, command, **kwargs):
        name = self.get_worker_pod_name(worker_id)
        pod = self._api.create_pod(
            self.build_pod_manifest(
                name, "worker", worker_id, command, **kwargs
            )
        )
        self._api.create_service(
            self._service_manifest(name, WORKER_PORT, "worker", worker_id)
        )
        return pod

    def create_ps(self, ps_id, command, **kwargs):
        name = self.get_ps_pod_name(ps_id)
        pod = self._api.create_pod(
            self.build_pod_manifest(name, "ps", ps_id, command, **kwargs)
        )
        self._api.create_service(
            self._service_manifest(name, PS_PORT, "ps", ps_id)
        )
        return pod

    def create_master(self, command, **kwargs):
        name = self.get_master_pod_name()
        pod = self._api.create_pod(
            self.build_pod_manifest(name, "master", 0, command, **kwargs)
        )
        self._api.create_service(
            self._service_manifest(name, MASTER_PORT, "master", 0)
        )
        return pod

    def get_tensorboard_service_name(self):
        return "tensorboard-%s" % self.job_name

    def create_tensorboard_service(self, port=6006):
        """LoadBalancer service exposing the master pod's tensorboard.
        Deleted by delete_master."""
        return self._api.create_service(
            self._service_manifest(
                self.get_tensorboard_service_name(), port, "master", 0,
                service_type="LoadBalancer",
            )
        )

    def delete_worker(self, worker_id, grace_period_seconds=0):
        """``grace_period_seconds`` None leaves the pod its own
        termination grace (a scale-down's drain runs inside it); 0
        deletes it at once."""
        self._delete_pod_and_service(self.get_worker_pod_name(worker_id),
                                     grace_period_seconds)

    def delete_ps(self, ps_id):
        self._delete_pod_and_service(self.get_ps_pod_name(ps_id))

    def delete_master(self):
        try:
            self._delete_pod_and_service(self.get_master_pod_name())
        finally:
            # a LoadBalancer is a billed cloud resource; delete it even
            # when the pod delete raises (e.g. pod already gone)
            try:
                self._api.delete_service(
                    self.get_tensorboard_service_name()
                )
            except Exception as e:
                logger.warning(
                    "tensorboard service delete failed (often just "
                    "never created): %s", e
                )

    def _delete_pod_and_service(self, name, grace_period_seconds=0):
        try:
            self._api.delete_pod(
                name, grace_period_seconds=grace_period_seconds)
        finally:
            try:
                self._api.delete_service(name)
            except Exception:
                logger.warning("service %s not deleted", name)

    def get_master_pod(self):
        return self._api.get_pod(self.get_master_pod_name())

    def update_master_status_label(self, status):
        """Surface the job's status as a label of the master pod, which
        a PS pod may poll to know when to exit (k8s/job_monitor.py)."""
        self._api.patch_pod_labels(
            self.get_master_pod_name(), {"status": status}
        )
