"""The port's cluster layer (``elasticdl_tpu_torch/k8s/`` and
``client/``) against the JAX package's, on the CPU, over an in-memory
fake of the k8s API (no cluster, no docker daemon).

Every scenario of tests/test_k8s.py runs against the port: the instance
manager's recovery and scaling semantics, the pod and Service manifests,
the job monitor's phases, the CLI's dry run parsed back by the master,
the pod manager's pod specs and the cluster-spec hooks. Where a scenario
builds manifests or commands, the JAX package builds them too from the
same arguments, and the two must be equal once its module paths
(``elasticdl_tpu.``) read as the port's (``elasticdl_tpu_torch.``). The
one difference on purpose in what the two build: the port's PS command
carries ``--port`` equal to its Service's port (2222), which the JAX
package's leaves out, so its PS listens on 50002 where no worker looks.
A second one in what they send: a scale-down's pod delete keeps the
pod's termination grace for the drain.
"""

import copy
import os
import queue
import subprocess
import sys

import pytest
import yaml

from elasticdl_tpu.client import main as ref_client_main
from elasticdl_tpu.client.args import build_master_arguments as ref_build_args
from elasticdl_tpu.common.args import parse_master_args as ref_parse_master
from elasticdl_tpu.k8s import client as ref_k8s_client
from elasticdl_tpu.k8s import pod_manager as ref_pod_manager
from elasticdl_tpu.ps.server import parse_ps_args as ref_parse_ps
from elasticdl_tpu_torch.client import main as client_main
from elasticdl_tpu_torch.client.args import build_master_arguments
from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.k8s import client as k8s_client
from elasticdl_tpu_torch.k8s import pod_manager
from elasticdl_tpu_torch.k8s.client import Client
from elasticdl_tpu_torch.k8s.instance_manager import InstanceManager
from elasticdl_tpu_torch.k8s.job_monitor import PodMonitor
from elasticdl_tpu_torch.master.rendezvous import MeshRendezvous
from elasticdl_tpu_torch.ps.server import parse_ps_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeApi:
    """In-memory stand-in implementing the K8sApi surface."""

    def __init__(self, namespace="default"):
        self.namespace = namespace
        self.pods = {}
        self.services = {}
        self.events = queue.Queue()

    def create_pod(self, manifest):
        name = manifest["metadata"]["name"]
        if name in self.pods:
            raise RuntimeError("pod %s exists" % name)
        manifest.setdefault("status", {"phase": "Pending"})
        self.pods[name] = manifest
        return manifest

    def delete_pod(self, name, grace_period_seconds=0):
        return self.pods.pop(name, {})

    def get_pod(self, name):
        if name not in self.pods:
            raise RuntimeError("pod %s not found" % name)
        return self.pods[name]

    def patch_pod_labels(self, name, labels):
        self.pods[name]["metadata"].setdefault("labels", {}).update(labels)
        return self.pods[name]

    def create_service(self, manifest):
        self.services[manifest["metadata"]["name"]] = manifest
        return manifest

    def delete_service(self, name):
        return self.services.pop(name, {})

    def watch_pods(self, label_selector=None, timeout_seconds=None):
        while True:
            item = self.events.get()
            if item is None:
                return
            yield item


class FakeDispatcher:
    def __init__(self):
        self.recovered = []

    def recover_tasks(self, worker_id):
        self.recovered.append(worker_id)


def as_port(obj):
    """The JAX package's manifest or command with its module paths read
    as the port's."""
    if isinstance(obj, str):
        return obj.replace("elasticdl_tpu.", "elasticdl_tpu_torch.")
    if isinstance(obj, dict):
        return {as_port(k): as_port(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [as_port(v) for v in obj]
    return obj


def without_ps_port(command):
    """The port's PS command less its ``--port`` (the one departure)."""
    ps_port = "--port=%d" % k8s_client.PS_PORT
    assert command.count(ps_port) == 1, command
    return [c for c in command if c != ps_port]


def _manager(api, num_workers=2, num_ps=1, rendezvous=None,
             client_cls=Client, manager_cls=InstanceManager):
    client = client_cls(api, "job1", image_name="img:latest")
    dispatcher = FakeDispatcher()
    manager = manager_cls(
        client,
        num_workers=num_workers,
        num_ps=num_ps,
        worker_command=["python", "-m", "worker", "--worker_id={worker_id}"],
        ps_command=["python", "-m", "ps", "--ps_id={ps_id}"],
        task_dispatcher=dispatcher,
        rendezvous=rendezvous,
    )
    return client, dispatcher, manager


def _running(pod, start_time="t0"):
    pod["status"] = {"phase": "Running", "startTime": start_time}
    return pod


def test_manifests_and_services():
    from elasticdl_tpu.k8s.instance_manager import (
        InstanceManager as RefInstanceManager,
    )

    api = FakeApi()
    client, dispatcher, manager = _manager(api)
    manager.start_workers()
    manager.start_parameter_servers()
    assert set(api.pods) == {
        "elasticdl-job1-worker-0",
        "elasticdl-job1-worker-1",
        "elasticdl-job1-ps-0",
    }
    # a Service of each pod's name: stable DNS names
    assert set(api.services) == set(api.pods)
    pod = api.pods["elasticdl-job1-worker-0"]
    assert pod["spec"]["containers"][0]["command"][-1] == "--worker_id=0"
    labels = pod["metadata"]["labels"]
    assert labels["elasticdl-tpu-job-name"] == "job1"
    assert labels["elasticdl-tpu-replica-type"] == "worker"
    assert client.get_ps_service_address(0).startswith(
        "elasticdl-job1-ps-0.default.svc:"
    )
    # the JAX package's pods and Services from the same arguments
    ref_api = FakeApi()
    _, _, ref_manager = _manager(
        ref_api, client_cls=ref_k8s_client.Client,
        manager_cls=RefInstanceManager)
    ref_manager.start_workers()
    ref_manager.start_parameter_servers()
    assert api.pods == ref_api.pods
    assert api.services == ref_api.services
    for fn in ("get_worker_service_address", "get_ps_service_address"):
        assert getattr(client, fn)(3) == getattr(
            ref_k8s_client.Client(ref_api, "job1"), fn)(3)
    assert client.get_master_service_address() == ref_k8s_client.Client(
        ref_api, "job1").get_master_service_address()


def test_worker_failure_recovers_tasks_and_relaunches():
    api = FakeApi()
    client, dispatcher, manager = _manager(api, num_workers=2, num_ps=0)
    manager.start_workers()
    pod = api.pods["elasticdl-job1-worker-0"]
    pod["status"] = {
        "phase": "Failed",
        "containerStatuses": [
            {"state": {"terminated": {"exitCode": 1, "reason": "Error"}}}
        ],
    }
    manager._event_cb("MODIFIED", pod)
    # the dead worker's tasks requeue under its id; the replacement has
    # a new id
    assert dispatcher.recovered == [0]
    assert "elasticdl-job1-worker-2" in api.pods
    assert "elasticdl-job1-worker-0" not in manager.worker_phases()


def test_oom_killed_worker_not_relaunched():
    api = FakeApi()
    client, dispatcher, manager = _manager(api, num_workers=1, num_ps=0)
    manager.start_workers()
    pod = api.pods["elasticdl-job1-worker-0"]
    pod["status"] = {
        "phase": "Failed",
        "containerStatuses": [
            {
                "state": {
                    "terminated": {"exitCode": 137, "reason": "OOMKilled"}
                }
            }
        ],
    }
    manager._event_cb("MODIFIED", pod)
    assert dispatcher.recovered == [0]  # tasks still recovered
    assert len(api.pods) == 1  # no replacement pod
    assert manager.all_workers_failed


def test_ps_relaunch_keeps_id_and_address():
    api = FakeApi()
    client, dispatcher, manager = _manager(api, num_workers=0, num_ps=2)
    manager.start_parameter_servers()
    pod = api.pods["elasticdl-job1-ps-1"]
    pod["status"] = {
        "phase": "Failed",
        "containerStatuses": [
            {"state": {"terminated": {"exitCode": 1, "reason": "Error"}}}
        ],
    }
    manager._event_cb("MODIFIED", pod)
    # same pod name, so the same Service address
    assert "elasticdl-job1-ps-1" in api.pods
    assert api.pods["elasticdl-job1-ps-1"]["status"]["phase"] == "Pending"


def test_membership_feeds_rendezvous_sorted_by_start_time():
    api = FakeApi()
    rendezvous = MeshRendezvous()
    client, dispatcher, manager = _manager(
        api, num_workers=2, num_ps=0, rendezvous=rendezvous
    )
    manager.start_workers()
    # worker 1 started earlier than worker 0
    manager._event_cb(
        "MODIFIED", _running(api.pods["elasticdl-job1-worker-1"], "t1")
    )
    manager._event_cb(
        "MODIFIED", _running(api.pods["elasticdl-job1-worker-0"], "t2")
    )
    epoch_before = rendezvous.mesh_epoch
    assert rendezvous.hosts() == [
        client.get_worker_service_address(1),
        client.get_worker_service_address(0),
    ]
    # a death bumps the mesh epoch and shrinks the host list
    pod = api.pods["elasticdl-job1-worker-1"]
    pod["status"]["phase"] = "Failed"
    pod["status"]["containerStatuses"] = [
        {"state": {"terminated": {"exitCode": 1, "reason": "Error"}}}
    ]
    manager._event_cb("MODIFIED", pod)
    assert rendezvous.mesh_epoch > epoch_before
    assert client.get_worker_service_address(0) in rendezvous.hosts()


def test_scale_up_mid_job_recomputes_rendezvous():
    api = FakeApi()
    rendezvous = MeshRendezvous()
    client, dispatcher, manager = _manager(
        api, num_workers=2, num_ps=0, rendezvous=rendezvous
    )
    manager.start_workers()
    manager._event_cb(
        "MODIFIED", _running(api.pods["elasticdl-job1-worker-0"], "t0")
    )
    manager._event_cb(
        "MODIFIED", _running(api.pods["elasticdl-job1-worker-1"], "t1")
    )
    epoch_before = rendezvous.mesh_epoch
    started = manager.scale_up(2)
    assert started == [2, 3]
    assert "elasticdl-job1-worker-2" in api.pods
    assert sorted(manager.worker_ids()) == [0, 1, 2, 3]
    # new pods join the host list as they reach Running, sorted by start
    # time: stable ranks for the incumbents
    manager._event_cb(
        "MODIFIED", _running(api.pods["elasticdl-job1-worker-2"], "t2")
    )
    manager._event_cb(
        "MODIFIED", _running(api.pods["elasticdl-job1-worker-3"], "t3")
    )
    assert rendezvous.mesh_epoch > epoch_before
    assert rendezvous.hosts() == [
        client.get_worker_service_address(i) for i in range(4)
    ]


def _removed_pod(phase):
    return {
        "metadata": {
            "name": "elasticdl-job1-worker-1",
            "labels": {"elasticdl-tpu-replica-type": "worker"},
        },
        "status": {"phase": phase, "startTime": "t1"},
    }


def _two_running(api, manager):
    manager.start_workers()
    for idx in (0, 1):
        manager._event_cb(
            "MODIFIED",
            _running(api.pods["elasticdl-job1-worker-%d" % idx],
                     "t%d" % idx),
        )


def test_scale_down_drained_pod_not_relaunched():
    """A worker removed on purpose is not relaunched by its own DELETED
    event, does not trip all_workers_failed while peers live, and
    leaves the rendezvous' host list."""
    api = FakeApi()
    rendezvous = MeshRendezvous()
    client, dispatcher, manager = _manager(
        api, num_workers=2, num_ps=0, rendezvous=rendezvous
    )
    _two_running(api, manager)
    assert manager.remove_worker(1)
    assert "elasticdl-job1-worker-1" not in api.pods  # deleted
    # the watch delivers the DELETED event of the removed pod
    manager._event_cb("DELETED", _removed_pod("Running"))
    # no replacement, no recovery sweep (the drain handled the tasks),
    # no all-failed abort, and the host left the mesh
    assert set(api.pods) == {"elasticdl-job1-worker-0"}
    assert dispatcher.recovered == []
    assert not manager.all_workers_failed
    assert rendezvous.hosts() == [client.get_worker_service_address(0)]
    assert manager.worker_ids() == [0]
    # removing an unknown id is a no-op
    assert not manager.remove_worker(99)


def test_scale_down_victim_that_dies_nonzero_is_still_intentional():
    """A wedged drain ends in the watchdog's exit 1 or the kubelet's
    SIGKILL, so MODIFIED phase=Failed may come before DELETED: still an
    intentional removal (no recovery, no replacement, no
    all_workers_failed), and the later DELETED changes nothing."""
    api = FakeApi()
    client, dispatcher, manager = _manager(api, num_workers=2, num_ps=0)
    _two_running(api, manager)
    assert manager.remove_worker(1)
    pod = _removed_pod("Failed")
    manager._event_cb("MODIFIED", pod)
    assert set(api.pods) == {"elasticdl-job1-worker-0"}  # no relaunch
    assert dispatcher.recovered == []
    assert not manager.all_workers_failed
    assert manager.worker_ids() == [0]
    manager._event_cb("DELETED", pod)
    assert set(api.pods) == {"elasticdl-job1-worker-0"}
    assert dispatcher.recovered == []


def test_failed_scale_down_delete_keeps_mark_for_fallback_delete():
    """A failed scale-down delete keeps the intentional mark: the
    drain-deadline fallback deletes the pod again later, and that
    DELETED event must not relaunch a replacement (which would undo the
    shrink, in a loop)."""
    api = FakeApi()
    client, dispatcher, manager = _manager(api, num_workers=2, num_ps=0)
    _two_running(api, manager)
    real_delete = api.delete_pod

    def flaky_delete(name, grace_period_seconds=0):
        raise RuntimeError("transient apiserver error")

    api.delete_pod = flaky_delete
    assert manager.remove_worker(1)
    assert "elasticdl-job1-worker-1" in api.pods  # delete failed
    api.delete_pod = real_delete
    # the presumed-dead fallback deletes the pod through the client (no
    # mark of its own), then the watch delivers DELETED
    client.delete_worker(1)
    manager._event_cb("DELETED", _removed_pod("Running"))
    assert set(api.pods) == {"elasticdl-job1-worker-0"}
    assert dispatcher.recovered == []
    assert not manager.all_workers_failed
    assert manager.worker_ids() == [0]


def test_oom_killed_pod_never_relaunched_after_scale_events():
    """After a scale_up an OOM-killed pod still gets no replacement while
    its tasks recover."""
    api = FakeApi()
    client, dispatcher, manager = _manager(api, num_workers=1, num_ps=0)
    manager.start_workers()
    manager.scale_up(1)
    pods_before = set(api.pods)
    pod = api.pods["elasticdl-job1-worker-1"]
    pod["status"] = {
        "phase": "Failed",
        "containerStatuses": [
            {
                "state": {
                    "terminated": {"exitCode": 137, "reason": "OOMKilled"}
                }
            }
        ],
    }
    manager._event_cb("MODIFIED", pod)
    assert dispatcher.recovered == [1]
    assert set(api.pods) == pods_before
    assert manager.worker_ids() == [0]
    assert not manager.all_workers_failed  # worker 0 lives


def test_job_monitor_phases():
    api = FakeApi()
    api.create_pod(
        {"metadata": {"name": "m", "labels": {}}, "status": {"phase": "Running"}}
    )
    monitor = PodMonitor(api, "m", poll_secs=0)
    assert not monitor.pod_finished()
    api.pods["m"]["status"]["phase"] = "Succeeded"
    assert monitor.pod_finished()
    assert monitor.wait(timeout_secs=1) == "Succeeded"
    # the Finished label counts too
    api.pods["m"]["status"]["phase"] = "Running"
    api.patch_pod_labels("m", {"status": "Finished"})
    assert monitor.pod_finished()
    # a vanished pod counts as finished
    api.delete_pod("m")
    assert monitor.pod_finished()
    assert monitor.pod_phase() is None


CENSUS_ARGV = [
    "train",
    "--job_name=census1",
    "--image_name=registry/edl:latest",
    "--model_zoo=elasticdl_tpu_torch.models.census_wide_deep",
    "--training_data=/data/train",
    "--validation_data=/data/valid",
    "--num_workers=4",
    "--num_ps_pods=2",
    "--minibatch_size=128",
    "--num_epochs=3",
    "--evaluation_steps=100",
    "--checkpoint_dir=/ckpt",
    "--checkpoint_steps=50",
    "--tpu_resource=nvidia.com/gpu=1",
    "--mesh=dp=4,fsdp=2",
    "--use_async=0",
    "--grads_to_wait=2",
    "--volume=claim_name=data-pvc,mount_path=/data",
    "--envs=A=1,B=x",
]


def test_cli_dry_run_roundtrips_master_args(tmp_path):
    out_yaml = tmp_path / "master.yaml"
    ref_yaml = tmp_path / "ref_master.yaml"
    client_main.main(CENSUS_ARGV + ["--yaml=%s" % out_yaml])
    manifest = yaml.safe_load(out_yaml.read_text())
    assert manifest["kind"] == "Pod"
    assert manifest["metadata"]["name"] == "elasticdl-census1-master"
    command = manifest["spec"]["containers"][0]["command"]
    assert command[:3] == ["python", "-m", "elasticdl_tpu_torch.master.main"]
    # the forwarded command line parses master-side with its values
    master_parsed = parse_master_args(command[3:])
    assert (master_parsed.model_zoo
            == "elasticdl_tpu_torch.models.census_wide_deep")
    assert master_parsed.num_workers == 4
    assert master_parsed.num_ps_pods == 2
    assert master_parsed.minibatch_size == 128
    assert master_parsed.checkpoint_steps == 50
    assert master_parsed.mesh == "dp=4,fsdp=2"
    # a meaningful zero survives the round trip (0 == False in Python)
    assert master_parsed.use_async == 0
    assert master_parsed.grads_to_wait == 2
    mounts = manifest["spec"]["containers"][0]["volumeMounts"]
    assert mounts[0]["mountPath"] == "/data"
    # the JAX package's manifest from the same argv
    ref_client_main.main(CENSUS_ARGV + ["--yaml=%s" % ref_yaml])
    ref_manifest = yaml.safe_load(ref_yaml.read_text())
    assert manifest == as_port(ref_manifest)
    # and both masters parse the command to the same flags
    ref_parsed = ref_parse_master(
        ref_manifest["spec"]["containers"][0]["command"][3:])
    assert vars(master_parsed) == {
        k: v for k, v in vars(ref_parsed).items()
        if k in vars(master_parsed)}


def test_ps_command_forwards_mode_flags():
    master_args = parse_master_args(
        [
            "--model_zoo=elasticdl_tpu_torch.models.deepfm",
            "--use_async=0",
            "--grads_to_wait=3",
            "--sync_version_tolerance=1",
            "--lr_staleness_modulation=0",
        ]
    )
    command = pod_manager.build_ps_command(master_args, "master:50001",
                                           num_ps=2)
    rendered = [c.format(ps_id=1) for c in command]
    # the PS binary parses the marshalled command with its values
    ps_parsed = parse_ps_args(rendered[3:])
    assert ps_parsed.use_async == 0
    assert ps_parsed.grads_to_wait == 3
    assert ps_parsed.sync_version_tolerance == 1
    assert ps_parsed.lr_staleness_modulation == 0
    assert ps_parsed.ps_id == 1 and ps_parsed.num_ps_pods == 2


def test_ps_listens_on_its_service_port():
    """The departure on purpose: the JAX package's PS command has no
    --port, so its PS listens on 50002 while its Service and every
    worker's --ps_addrs name 2222; the port's PS listens on 2222."""
    argv = ["--model_zoo=elasticdl_tpu_torch.models.deepfm",
            "--num_ps_pods=2", "--job_name=ps1"]
    ref_args, args = ref_parse_master(argv), parse_master_args(argv)
    ref_command = ref_pod_manager.build_ps_command(ref_args, "m:50001", 2)
    command = pod_manager.build_ps_command(args, "m:50001", 2)
    ref_ps = ref_parse_ps([c.format(ps_id=0) for c in ref_command[3:]])
    ps = parse_ps_args([c.format(ps_id=0) for c in command[3:]])

    def service_port(client_cls, api):
        client_cls(api, "ps1").create_ps(0, ["true"])
        (service,) = api.services.values()
        (port,) = service["spec"]["ports"]
        assert port["port"] == port["targetPort"]
        return port["targetPort"]

    ref_service = service_port(ref_k8s_client.Client, FakeApi())
    assert ref_service == 2222 and ref_ps.port == 50002  # the fault
    assert service_port(Client, FakeApi()) == ps.port == 2222
    assert ref_k8s_client.Client(FakeApi(), "ps1").get_ps_service_address(
        0).endswith(":%d" % ps.port)
    assert without_ps_port(command) == as_port(ref_command)


@pytest.mark.parametrize("argv", [
    ["--model_zoo=elasticdl_tpu_torch.models.deepfm"],
    ["--model_zoo=z", "--num_ps_pods=2", "--use_async=1",
     "--checkpoint_dir=/c", "--checkpoint_steps=7", "--log_loss_steps=0",
     "--mesh=dp=2", "--minibatch_size=512", "--training_data=/t",
     "--validation_data=/v", "--log_level=DEBUG", "--loss=my_loss",
     "--grads_to_wait=4", "--keep_checkpoint_max=0"],
    ["--model_zoo=z", "--model_def=a.b", "--model_params=x=1;y=2",
     "--data_reader_params=k=v", "--compute_dtype=float32",
     "--async_checkpoint=1", "--grad_accum_steps=4",
     "--consensus_interval=3", "--checkpoint_dir_for_init=/i",
     "--lr_staleness_modulation=1", "--sync_version_tolerance=2"],
])
def test_worker_and_ps_commands_match_reference(argv):
    ref_args, args = ref_parse_master(argv), parse_master_args(argv)
    ps_addrs = ["p0.ns.svc:2222", "p1.ns.svc:2222"]
    worker = pod_manager.build_worker_command(args, "m:50001", ps_addrs)
    assert worker[2] == "elasticdl_tpu_torch.worker.main"
    assert worker == as_port(ref_pod_manager.build_worker_command(
        ref_args, "m:50001", ps_addrs))
    for ps_optimizer in (None, ("adam", "lr=0.001")):
        ps = pod_manager.build_ps_command(args, "m:50001", 2, ps_optimizer)
        assert ps[2] == "elasticdl_tpu_torch.ps.server"
        assert without_ps_port(ps) == as_port(ref_pod_manager.build_ps_command(
            ref_args, "m:50001", 2, ps_optimizer))
    # the port's worker and PS parse what they are given
    from elasticdl_tpu_torch.common.args import parse_worker_args

    parse_worker_args([c.format(worker_id=3) for c in worker[3:]])
    parse_ps_args([c.format(ps_id=1) for c in ps[3:]])


def test_cli_zoo_init(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    client_main.main(["zoo", "init", "--base_image=python:3.12-slim"])
    dockerfile = (tmp_path / "Dockerfile").read_text()
    assert "FROM python:3.12-slim" in dockerfile
    assert "COPY . /model_zoo" in dockerfile
    # the image installs this distribution with the port's extra
    assert '"elasticdl_tpu[torch]"' in dockerfile


def test_tensorboard_loadbalancer_service():
    """A LoadBalancer Service selecting the master pod on the
    TensorBoard port, deleted with the master."""
    api = FakeApi()
    client = Client(api, "job1", image_name="img")
    client.create_tensorboard_service(port=6006)
    service = api.services["tensorboard-job1"]
    assert service["spec"]["type"] == "LoadBalancer"
    assert service["spec"]["ports"][0]["port"] == 6006
    selector = service["spec"]["selector"]
    assert selector["elasticdl-tpu-replica-type"] == "master"
    ref_api = FakeApi()
    ref_k8s_client.Client(ref_api, "job1", image_name="img") \
        .create_tensorboard_service(port=6006)
    assert api.services == ref_api.services
    client.delete_master()
    assert "tensorboard-job1" not in api.services


POD_SPEC_ARGV = [
    "train",
    "--job_name=rs1",
    "--image_name=registry/edl:v1",
    "--model_zoo=elasticdl_tpu_torch.models.mnist",
    "--training_data=/data/train",
    "--num_workers=1",
    "--num_ps_pods=1",
    "--worker_resource_request=cpu=4,memory=8192Mi",
    "--worker_resource_limit=cpu=8,memory=16384Mi",
    "--ps_resource_request=cpu=2,memory=4096Mi",
    "--worker_pod_priority=high-priority",
    "--tpu_resource=nvidia.com/gpu=1",
    "--volume=claim_name=data-pvc,mount_path=/data",
    "--image_pull_policy=IfNotPresent",
]


def _pod_manager_pods(argv, port):
    """Start the workers and PS of the pod manager of the master that
    ``argv`` submits, in the port or the JAX package; the fake API."""
    if port:
        parsed = client_main.build_parser().parse_args(argv)
        args = parse_master_args(build_master_arguments(parsed))
        manager_cls = pod_manager.K8sPodManager
    else:
        parsed = ref_client_main.build_parser().parse_args(argv)
        args = ref_parse_master(ref_build_args(parsed))
        manager_cls = ref_pod_manager.K8sPodManager
    api = FakeApi()
    pm = manager_cls(args, FakeDispatcher(), rendezvous=None, api=api)
    pm._manager.start_workers()
    pm._manager.start_parameter_servers()
    pm._client.stop_watch()
    return api


def test_pod_manager_applies_pod_spec_flags_from_args():
    """The whole flag path: the client's train args -> the forwarded
    master args -> K8sPodManager -> the worker and PS pod specs."""
    api = _pod_manager_pods(POD_SPEC_ARGV, port=True)
    worker = api.pods["elasticdl-rs1-worker-0"]
    container = worker["spec"]["containers"][0]
    assert container["image"] == "registry/edl:v1"
    assert container["imagePullPolicy"] == "IfNotPresent"
    assert container["resources"]["requests"] == {
        "cpu": "4", "memory": "8192Mi"
    }
    assert container["resources"]["limits"] == {
        "cpu": "8", "memory": "16384Mi", "nvidia.com/gpu": "1"
    }
    assert worker["spec"]["priorityClassName"] == "high-priority"
    assert container["volumeMounts"][0]["mountPath"] == "/data"
    assert worker["spec"]["volumes"][0]["persistentVolumeClaim"] == {
        "claimName": "data-pvc"
    }
    assert container["command"][2] == "elasticdl_tpu_torch.worker.main"
    ps = api.pods["elasticdl-rs1-ps-0"]
    ps_container = ps["spec"]["containers"][0]
    assert ps_container["resources"]["requests"] == {
        "cpu": "2", "memory": "4096Mi"
    }
    # the accelerator belongs to worker pods only
    assert "nvidia.com/gpu" not in ps_container["resources"]["limits"]
    assert "priorityClassName" not in ps["spec"]
    # the JAX package's pod manager on the same argv: the same pods and
    # Services but for the PS command's --port
    ref_api = _pod_manager_pods(POD_SPEC_ARGV, port=False)
    pods = copy.deepcopy(api.pods)
    ps_command = pods["elasticdl-rs1-ps-0"]["spec"]["containers"][0]
    ps_command["command"] = without_ps_port(ps_command["command"])
    assert pods == as_port(ref_api.pods)
    assert api.services == ref_api.services


def test_zoo_build_honors_docker_connection_flags(monkeypatch):
    """--docker_base_url / --docker_tlscert/key reach the docker
    invocation, for build and for push."""
    from elasticdl_tpu_torch.client import api as client_api

    calls = []
    monkeypatch.setattr(
        client_api.subprocess, "run",
        lambda command, check: calls.append(command),
    )
    client_main.main([
        "zoo", "build", ".", "--image=r/edl:v1",
        "--docker_base_url=tcp://build-host:2376",
        "--docker_tlscert=/certs/cert.pem",
        "--docker_tlskey=/certs/key.pem",
    ])
    (command,) = calls
    assert command[:2] == ["docker", "--host"]
    assert "tcp://build-host:2376" in command
    assert "--tls" in command and "/certs/key.pem" in command
    assert command[-4:] == ["build", "-t", "r/edl:v1", "."]

    # push reaches the same daemon
    calls.clear()
    client_main.main([
        "zoo", "push", "r/edl:v1",
        "--docker_base_url=tcp://build-host:2376",
    ])
    (command,) = calls
    assert command[:3] == ["docker", "--host", "tcp://build-host:2376"]
    assert command[-2:] == ["push", "r/edl:v1"]

    # one of the two TLS flags is a loud error, not silent plaintext
    with pytest.raises(ValueError, match="both required"):
        client_main.main([
            "zoo", "build", ".", "--image=r/edl:v1",
            "--docker_tlscert=/certs/cert.pem",
        ])


def test_cluster_spec_hooks_apply_to_all_manifests(tmp_path):
    """--cluster_spec names a module exporting ``cluster`` whose
    with_pod/with_service hooks customize every pod and Service
    manifest, the client's master pod included."""
    spec_py = tmp_path / "my_cluster.py"
    spec_py.write_text(
        "class _C:\n"
        "    def with_pod(self, pod):\n"
        "        pod['spec'].setdefault('tolerations', []).append(\n"
        "            {'key': 'gpu', 'operator': 'Exists'})\n"
        "        return pod\n"
        "    def with_service(self, service):\n"
        "        service['metadata'].setdefault('labels', {})[\n"
        "            'team'] = 'ads'\n"
        "        return service\n"
        "cluster = _C()\n"
    )
    argv = [
        "train",
        "--job_name=cs1",
        "--image_name=img:1",
        "--model_zoo=elasticdl_tpu_torch.models.mnist",
        "--cluster_spec=%s" % spec_py,
        "--num_workers=1",
    ]
    api = _pod_manager_pods(argv, port=True)
    worker = api.pods["elasticdl-cs1-worker-0"]
    assert worker["spec"]["tolerations"] == [
        {"key": "gpu", "operator": "Exists"}
    ]
    service = api.services["elasticdl-cs1-worker-0"]
    assert service["metadata"]["labels"]["team"] == "ads"
    assert api.pods == as_port(_pod_manager_pods(argv, port=False).pods)

    # the client-side master pod gets the hook too
    dry = ["train", "--job_name=cs2", "--image_name=img:1",
           "--model_zoo=elasticdl_tpu_torch.models.mnist",
           "--cluster_spec=%s" % spec_py, "--dry_run"]
    manifest = client_main.main(dry)
    assert manifest["spec"]["tolerations"] == [
        {"key": "gpu", "operator": "Exists"}
    ]
    # the master command carries the in-image path (zoo init copies the
    # module to /cluster_spec/), not the client-local one
    command = manifest["spec"]["containers"][0]["command"]
    assert "--cluster_spec=/cluster_spec/my_cluster.py" in command
    assert manifest == as_port(ref_client_main.main(dry))

    # a module without a `cluster` export fails loudly
    bad = tmp_path / "bad_cluster.py"
    bad.write_text("x = 1\n")
    with pytest.raises(ValueError, match="cluster"):
        client_main.main([
            "train", "--job_name=cs3", "--image_name=img:1",
            "--model_zoo=elasticdl_tpu_torch.models.mnist",
            "--cluster_spec=%s" % bad, "--dry_run",
        ])


def _cli(module, argv):
    return subprocess.run(
        [sys.executable, "-m", module] + argv,
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=120,
    )


@pytest.mark.parametrize("argv", [
    ["train", "--job_name=rc0", "--image_name=i", "--model_zoo=m",
     "--dry_run"],
    ["evaluate", "--job_name=rc1", "--image_name=i", "--model_zoo=m",
     "--validation_data=/v", "--checkpoint_dir_for_init=/c", "--dry_run"],
    ["serve", "--job_name=rc2", "--image_name=i", "--model_zoo=m",
     "--export_dir=/e", "--dry_run"],
])
def test_cli_dry_run_exit_code_is_zero(argv):
    """`edl-torch train --dry_run` exits 0 (main() returns the manifest,
    and sys.exit(<dict>) would exit 1) and prints the JAX package's
    manifest with the port's module paths."""
    proc = _cli("elasticdl_tpu_torch.client.main", argv)
    assert proc.returncode == 0, proc.stderr[-500:]
    ref = _cli("elasticdl_tpu.client.main", argv)
    assert ref.returncode == 0, ref.stderr[-500:]
    assert proc.stdout == as_port(ref.stdout)
    manifest = yaml.safe_load(proc.stdout)
    assert manifest["spec"]["containers"][0]["command"][2].startswith(
        "elasticdl_tpu_torch.")


def test_reference_ci_command_lines_parse():
    """The reference CI's submissions (scripts/client_test.sh:24-90)
    parse against the port's client verbatim, bool spellings and the
    evaluate and predict flag groups included, to the JAX client's
    values."""
    train_argv = [
        "train", "--image_name=elasticdl:ci", "--model_zoo=model_zoo",
        "--model_def=deepfm_functional_api.deepfm_functional_api"
        ".custom_model",
        "--training_data=/data/frappe/train",
        "--validation_data=/data/frappe/test", "--num_epochs=1",
        "--master_resource_request=cpu=0.2,memory=1024Mi",
        "--master_resource_limit=cpu=1,memory=2048Mi",
        "--worker_resource_request=cpu=0.4,memory=2048Mi",
        "--worker_resource_limit=cpu=1,memory=3072Mi",
        "--ps_resource_request=cpu=0.2,memory=1024Mi",
        "--ps_resource_limit=cpu=1,memory=2048Mi",
        "--minibatch_size=64", "--num_minibatches_per_task=2",
        "--num_workers=2", "--num_ps_pods=2", "--checkpoint_steps=500",
        "--evaluation_steps=500",
        "--tensorboard_log_dir=/tmp/tensorboard-log",
        "--grads_to_wait=1", "--use_async=True",
        "--job_name=test-train", "--log_level=INFO",
        "--image_pull_policy=Never",
        "--output=/data/saved_model/model_output",
        "--volume=host_path=/d,mount_path=/data",
    ]
    evaluate_argv = [
        "evaluate", "--image_name=elasticdl:ci",
        "--model_zoo=model_zoo",
        "--model_def=mnist.mnist_functional_api.custom_model",
        "--checkpoint_dir_for_init=/ckpt/version-100",
        "--validation_data=/data/mnist/test", "--num_epochs=1",
        "--minibatch_size=64", "--num_minibatches_per_task=2",
        "--num_workers=2", "--num_ps_pods=2", "--evaluation_steps=15",
        "--tensorboard_log_dir=/tmp/tensorboard-log",
        "--job_name=test-evaluate", "--log_level=INFO",
        "--image_pull_policy=Never",
        "--volume=host_path=/d,mount_path=/data",
    ]
    predict_argv = [
        "predict", "--image_name=elasticdl:ci",
        "--model_zoo=model_zoo",
        "--model_def=mnist.mnist_functional_api.custom_model",
        "--checkpoint_dir_for_init=/ckpt/version-100",
        "--prediction_data=/data/mnist/test", "--minibatch_size=64",
        "--num_minibatches_per_task=2", "--num_workers=2",
        "--num_ps_pods=2", "--job_name=test-predict",
    ]
    p, ref = client_main.build_parser(), ref_client_main.build_parser()
    train = p.parse_args(train_argv)
    assert train.use_async == 1  # "True" -> 1
    assert p.parse_args(evaluate_argv).num_minibatches_per_task == 2
    assert p.parse_args(predict_argv).prediction_data == "/data/mnist/test"
    for argv in (train_argv, evaluate_argv, predict_argv):
        ours, theirs = vars(p.parse_args(argv)), vars(ref.parse_args(argv))
        ours.pop("func"), theirs.pop("func")
        assert ours == theirs
        # the master command each forwards parses on the port's master
        forwarded = build_master_arguments(p.parse_args(argv))
        assert forwarded == ref_build_args(ref.parse_args(argv))
        parse_master_args(forwarded)


def test_bool_flag_defaults_and_bare_spelling_match_reference():
    """--use_async / --lr_staleness_modulation default to 0, and the
    bare spelling (no value) flips the default, on the client, the
    master and the PS surfaces."""
    base = [
        "train", "--image_name=i", "--model_zoo=m", "--job_name=j",
    ]
    p = client_main.build_parser()
    omitted = p.parse_args(base)
    assert omitted.use_async == 0
    assert omitted.lr_staleness_modulation == 0

    bare = p.parse_args(
        base + ["--use_async", "--lr_staleness_modulation"]
    )
    assert bare.use_async == 1
    assert bare.lr_staleness_modulation == 1

    explicit = p.parse_args(
        base + ["--use_async=False", "--lr_staleness_modulation=0"]
    )
    assert explicit.use_async == 0
    assert explicit.lr_staleness_modulation == 0

    m = parse_master_args(["--model_zoo=m"])
    assert m.use_async == 0 and m.lr_staleness_modulation == 0
    ps = parse_ps_args(["--use_async"])
    assert ps.use_async == 1 and ps.lr_staleness_modulation == 0


def test_master_flags_cover_the_reference_masters():
    """The port's master takes every flag of the JAX package's master,
    with the same defaults, so every forwarded command parses on both."""
    argv = ["--model_zoo=m"]
    ours, theirs = vars(parse_master_args(argv)), vars(ref_parse_master(argv))
    assert set(theirs) <= set(ours)
    assert {k: ours[k] for k in theirs} == theirs


class RecordingApi(FakeApi):
    def __init__(self):
        super().__init__()
        self.deletes = []

    def delete_pod(self, name, grace_period_seconds=0):
        self.deletes.append((name, grace_period_seconds))
        return super().delete_pod(name)


def test_scale_down_delete_leaves_the_pod_its_grace():
    """The second departure on purpose: the JAX package's scale-down
    deletes the victim with grace 0, a force delete the kubelet ends
    within its 2-second floor, often before the drain finished its
    task; the port's leaves the pod its own termination grace (None:
    the API's default). Every other delete stays immediate."""
    from elasticdl_tpu.k8s.instance_manager import (
        InstanceManager as RefInstanceManager,
    )

    for manager_cls, client_cls, grace in (
            (RefInstanceManager, ref_k8s_client.Client, 0),
            (InstanceManager, Client, None)):
        api = RecordingApi()
        client, _, manager = _manager(api, num_workers=2, num_ps=1,
                                      client_cls=client_cls,
                                      manager_cls=manager_cls)
        _two_running(api, manager)
        manager.start_parameter_servers()
        assert manager.remove_worker(1)
        assert api.deletes == [("elasticdl-job1-worker-1", grace)]
        client.delete_worker(0)  # a presumed-dead worker
        manager.stop_all()
        assert len(api.deletes) > 2
        assert all(g == 0 for _, g in api.deletes[1:])


def test_a_failed_worker_pod_leaves_the_masters_roll():
    """The master's pod manager takes a dead pod as the worker's death:
    its tasks requeue, the failed pod is deleted, a replacement starts
    under a new id, and the finished job no longer waits to tell the
    dead worker "job over"."""
    from elasticdl_tpu_torch.master.main import build_master
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

    args = parse_master_args([
        "--model_zoo=elasticdl_tpu_torch.models.deepfm", "--job_name=j",
        "--num_workers=1", "--port=0"])
    api = FakeApi()
    master = build_master(args, api=api)
    recovered = []
    recover = master.task_dispatcher.recover_tasks
    master.task_dispatcher.recover_tasks = lambda wid: (
        recovered.append(wid), recover(wid))
    pm = master.pod_manager
    try:
        pm._manager.start_workers()
        master.servicer.get_comm_info(pb.GetCommInfoRequest(worker_id=0))
        assert master.servicer.workers_not_told_job_over() == [0]
        pod = api.pods["elasticdl-j-worker-0"]
        pod["status"] = {"phase": "Failed", "containerStatuses": [
            {"state": {"terminated": {"exitCode": 137, "reason": "Error"}}}]}
        pm._event_cb("MODIFIED", pod)
        assert recovered == [0]
        assert master.servicer.workers_not_told_job_over() == []
        assert set(api.pods) == {"elasticdl-j-worker-1"}
        assert pm.worker_ids() == [1]
    finally:
        pm._client.stop_watch()
        api.events.put(None)
