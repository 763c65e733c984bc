"""Instance manager: launches and heals the job's worker and PS pods
(port of elasticdl_tpu/k8s/instance_manager.py).

The pod event callback: a worker pod that failed has its tasks
recovered and is relaunched under a NEW worker id, unless it was
OOM-killed (a bigger pod is an operator's decision); a worker pod
deleted while alive is relaunched the same way; when no worker pod is
left, ``all_workers_failed`` aborts the job. A PS pod is relaunched
under the SAME id, so its Service address holds. ``scale_up`` and
``remove_worker`` are the elastic controller's scaler
(master/autoscaler.py): a worker removed on purpose is neither
recovered nor relaunched nor counted as failed. Every membership change
hands the rendezvous the live workers' addresses sorted by pod start
time, so ranks stay stable across a scale-out.

One departure from the JAX package, on purpose: ``remove_worker``
deletes the pod with its own termination grace, where the JAX
package's delete asks for grace 0, a force delete the kubelet ends
within its 2-second floor, often before the drain has finished its
task.
"""

import itertools
import threading

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.k8s.instance_manager")

_MAX_MEMORY_EXIT_CODE = 137


class InstanceManager:
    def __init__(
        self,
        client,
        num_workers=1,
        num_ps=0,
        worker_command=None,
        ps_command=None,
        worker_resources=None,
        ps_resources=None,
        tpu_resource=None,
        restart_policy="Never",
        worker_resource_limits=None,
        ps_resource_limits=None,
        worker_priority=None,
        ps_priority=None,
        volumes=None,
        image_pull_policy=None,
        task_dispatcher=None,
        rendezvous=None,
        envs=None,
    ):
        self._client = client
        self._num_workers = num_workers
        self._num_ps = num_ps
        self._worker_command = worker_command or ["true"]
        self._ps_command = ps_command or ["true"]
        self._worker_resources = worker_resources or {}
        self._ps_resources = ps_resources or {}
        self._tpu_resource = tpu_resource
        self._restart_policy = restart_policy
        self._worker_resource_limits = worker_resource_limits
        self._ps_resource_limits = ps_resource_limits
        self._worker_priority = worker_priority
        self._ps_priority = ps_priority
        self._volumes = volumes
        self._image_pull_policy = image_pull_policy
        self._task_d = task_dispatcher
        self._rendezvous = rendezvous
        self._envs = envs or {}

        self._lock = threading.Lock()
        self._next_worker_id = itertools.count().__next__
        # pod name -> phase; wiped on DELETED
        self._worker_pods_phase = {}
        self._ps_pods_phase = {}
        # pod name -> (worker_id, start_time)
        self._worker_pod_info = {}
        self._relaunch_deleted_live_worker = True
        self._relaunch_deleted_live_ps = True
        # pods removed ON PURPOSE (autoscaler scale-down / drained
        # victims): their DELETED event must neither relaunch a
        # replacement nor count toward all_workers_failed
        self._removed_on_purpose = set()
        self.all_workers_failed = False

    # ------------------------------------------------------------------
    def start_workers(self):
        for _ in range(self._num_workers):
            self._start_worker(self._next_worker_id())

    # -- the scaler protocol (master/autoscaler.py ElasticController) --
    def scale_up(self, count=1):
        """Add ``count`` fresh workers (new ids, as relaunches get);
        returns the started ids. Membership recomputes so the
        rendezvous alive-host list is current before the pods run."""
        started = []
        for _ in range(max(0, count)):
            worker_id = self._next_worker_id()
            self._start_worker(worker_id)
            started.append(worker_id)
        if started:
            self._update_membership()
        return started

    def remove_worker(self, worker_id):
        """Intentional scale-down removal: the pod delete delivers
        SIGTERM, and the worker's graceful drain runs inside the pod's
        own termination grace (30 s unless its spec says otherwise);
        the kubelet's SIGKILL after it is the hard deadline. The delete
        leaves that grace in place: a delete with grace 0 is a force
        delete, which the kubelet ends within its 2-second floor. The DELETED event that follows must NOT relaunch —
        this worker is leaving on purpose. Returns False when no live
        pod holds ``worker_id``."""
        with self._lock:
            name = next(
                (
                    pod_name
                    for pod_name, (wid, _) in self._worker_pod_info.items()
                    if wid == worker_id
                ),
                None,
            )
            if name is None:
                return False
            self._removed_on_purpose.add(name)
        try:
            self._client.delete_worker(worker_id,
                                       grace_period_seconds=None)
        except Exception as e:
            # log-and-degrade, but KEEP the intentional mark: the
            # victim is condemned either way (its get_task gate answers
            # WAIT, so it does no further work), and the master's drain
            # deadline / liveness fallback will delete the pod again —
            # that later delete (or any genuine death meanwhile) is
            # this scale-down completing late. Dropping the mark here
            # would make the fallback's DELETED event relaunch a
            # replacement, undoing the shrink in a loop.
            logger.warning(
                "scale-down delete of worker %d failed: %s", worker_id, e
            )
        return True

    def worker_ids(self):
        """Live worker ids (pods not yet observed dead/removed) — the
        autoscaler's fleet-size input."""
        with self._lock:
            return [wid for wid, _ in self._worker_pod_info.values()]

    def _start_worker(self, worker_id):
        logger.info("Starting worker %d", worker_id)
        command = [
            str(c).replace("{worker_id}", str(worker_id))
            for c in self._worker_command
        ]
        pod = self._client.create_worker(
            worker_id,
            command,
            resource_requests=self._worker_resources,
            resource_limits=self._worker_resource_limits,
            tpu_resource=self._tpu_resource,
            restart_policy=self._restart_policy,
            priority_class=self._worker_priority,
            volumes=self._volumes,
            image_pull_policy=self._image_pull_policy,
            env=dict(self._envs, WORKER_ID=str(worker_id)),
        )
        name = self._client.get_worker_pod_name(worker_id)
        with self._lock:
            self._worker_pods_phase[name] = "Pending"
            self._worker_pod_info[name] = (
                worker_id,
                _start_time_of(pod),
            )

    def start_parameter_servers(self):
        for ps_id in range(self._num_ps):
            self._start_ps(ps_id)

    def _start_ps(self, ps_id):
        logger.info("Starting PS %d", ps_id)
        command = [
            str(c).replace("{ps_id}", str(ps_id))
            for c in self._ps_command
        ]
        self._client.create_ps(
            ps_id,
            command,
            resource_requests=self._ps_resources,
            resource_limits=self._ps_resource_limits,
            restart_policy=self._restart_policy,
            priority_class=self._ps_priority,
            volumes=self._volumes,
            image_pull_policy=self._image_pull_policy,
            env=dict(self._envs, PS_ID=str(ps_id)),
        )
        name = self._client.get_ps_pod_name(ps_id)
        with self._lock:
            self._ps_pods_phase[name] = "Pending"

    # ------------------------------------------------------------------
    def _event_cb(self, event_type, pod):
        meta = pod.get("metadata", {})
        name = meta.get("name", "")
        labels = meta.get("labels", {})
        replica_type = labels.get(
            "elasticdl-tpu-replica-type", _infer_type(name)
        )
        if replica_type == "worker":
            self._worker_event(event_type, name, pod)
        elif replica_type == "ps":
            self._ps_event(event_type, name, pod)

    # -- workers -------------------------------------------------------
    def _worker_event(self, event_type, name, pod):
        phase = pod.get("status", {}).get("phase", "")
        with self._lock:
            info = self._worker_pod_info.get(name)
        if info is None:
            return
        worker_id, _ = info
        relaunch = False
        if event_type == "MODIFIED":
            with self._lock:
                self._worker_pods_phase[name] = phase
                if phase == "Running":
                    self._worker_pod_info[name] = (
                        worker_id,
                        _start_time_of(pod),
                    )
            if phase == "Failed":
                with self._lock:
                    intentional = name in self._removed_on_purpose
                    self._removed_on_purpose.discard(name)
                if intentional:
                    # scale-down victim that died non-zero inside the
                    # grace period (wedged drain → watchdog exit, or
                    # kubelet's SIGKILL): still an intentional removal.
                    # No replacement, no all-failed — the master's
                    # drain deadline, not this sweep, requeues whatever
                    # the failed drain stranded.
                    logger.info(
                        "Worker pod %s failed during scale-down "
                        "removal", name,
                    )
                    self._forget_worker(name, failed=False)
                else:
                    logger.warning("Worker pod %s failed", name)
                    self._recover(worker_id)
                    relaunch = not _was_oom_killed(pod)
                    if not relaunch:
                        logger.warning(
                            "Worker pod %s was OOM-killed; NOT "
                            "relaunching (a bigger pod is an operator "
                            "decision)",
                            name,
                        )
                    self._forget_worker(name)
        elif event_type == "DELETED":
            with self._lock:
                intentional = name in self._removed_on_purpose
                self._removed_on_purpose.discard(name)
            if intentional:
                # scale-down victim: its tasks drained (or the drain
                # deadline requeued them) — no recovery sweep, no
                # replacement, and an empty fleet here is a scaling
                # decision, not a failure
                logger.info(
                    "Worker pod %s removed by scale-down", name
                )
                self._forget_worker(name, failed=False)
            else:
                logger.warning("Worker pod %s deleted", name)
                self._recover(worker_id)
                relaunch = self._relaunch_deleted_live_worker and (
                    phase not in ("Succeeded",)
                )
                self._forget_worker(name)
        self._update_membership()
        if relaunch:
            # a replacement worker gets a NEW id: the dead worker's tasks
            # were already re-queued under the old id
            self._start_worker(self._next_worker_id())
            self._update_membership()

    def _forget_worker(self, name, failed=True):
        with self._lock:
            self._worker_pods_phase.pop(name, None)
            self._worker_pod_info.pop(name, None)
            if failed and not self._worker_pods_phase:
                self.all_workers_failed = True

    def _recover(self, worker_id):
        if self._task_d is not None:
            self._task_d.recover_tasks(worker_id)

    def _update_membership(self):
        """Alive workers sorted by pod start time -> rendezvous. Rank
        stability across scale-out is what keeps re-init cheap."""
        if self._rendezvous is None:
            return
        with self._lock:
            alive = [
                (start, self._client.get_worker_service_address(wid))
                for name, (wid, start) in self._worker_pod_info.items()
                if self._worker_pods_phase.get(name) == "Running"
            ]
        hosts = [addr for _, addr in sorted(alive)]
        self._rendezvous.set_worker_hosts(hosts, reason="pod_watch")

    # -- parameter servers ---------------------------------------------
    def _ps_event(self, event_type, name, pod):
        phase = pod.get("status", {}).get("phase", "")
        ps_id = _replica_index(pod, name)
        relaunch = False
        if event_type == "MODIFIED":
            with self._lock:
                self._ps_pods_phase[name] = phase
            if phase == "Failed":
                relaunch = not _was_oom_killed(pod)
        elif event_type == "DELETED":
            with self._lock:
                self._ps_pods_phase.pop(name, None)
            relaunch = self._relaunch_deleted_live_ps and phase not in (
                "Succeeded",
            )
        if relaunch and ps_id is not None:
            # SAME id and service address: workers keep their partition
            # map; parameters come back from the PS checkpoint
            logger.warning("Relaunching PS %d", ps_id)
            try:
                self._client.delete_ps(ps_id)
            except Exception as e:
                # log-and-degrade: the pod being already gone is the
                # common case here (we are reacting to its death event)
                logger.warning(
                    "pre-relaunch delete of PS %d failed: %s", ps_id, e
                )
            self._start_ps(ps_id)

    # ------------------------------------------------------------------
    def worker_phases(self):
        with self._lock:
            return dict(self._worker_pods_phase)

    def ps_phases(self):
        with self._lock:
            return dict(self._ps_pods_phase)

    def stop_all(self):
        with self._lock:
            worker_ids = [
                wid for wid, _ in self._worker_pod_info.values()
            ]
        for wid in worker_ids:
            try:
                self._client.delete_worker(wid)
            except Exception as e:
                # log-and-degrade: stop_all is best-effort teardown, but
                # a pod we failed to delete will outlive the job — the
                # operator needs to hear about it
                logger.warning("delete of worker %d failed: %s", wid, e)
        for ps_id in range(self._num_ps):
            try:
                self._client.delete_ps(ps_id)
            except Exception as e:
                logger.warning("delete of PS %d failed: %s", ps_id, e)


def _start_time_of(pod):
    return pod.get("status", {}).get("startTime") or ""


def _was_oom_killed(pod):
    """Reason OOMKilled, or exit 137 with no reason."""
    statuses = pod.get("status", {}).get("containerStatuses", []) or []
    for cs in statuses:
        terminated = cs.get("state", {}).get("terminated") or {}
        if terminated.get("reason") == "OOMKilled":
            return True
        if (
            terminated.get("exitCode") == _MAX_MEMORY_EXIT_CODE
            and terminated.get("reason") is None
        ):
            return True
    return False


def _replica_index(pod, name):
    labels = pod.get("metadata", {}).get("labels", {})
    index = labels.get("elasticdl-tpu-replica-index")
    if index is not None:
        return int(index)
    try:
        return int(name.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return None


def _infer_type(name):
    if "-worker-" in name:
        return "worker"
    if "-ps-" in name:
        return "ps"
    return ""
