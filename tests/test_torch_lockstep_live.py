"""N workers share ONE model: live worker processes of the port
(``python -m elasticdl_tpu_torch.worker.main --multihost 1``) on the
CPU, the scenarios of the reference's tests/test_sparse_multiworker.py,
tests/test_worker_distributed.py (the mesh-epoch restart) and
tests/test_multihost_e2e.py.

The DeepFM jobs run through ``chip_smoke.lockstep_job`` (phase 9's
lockstep arm, at a small size: 1 of 4 files of 4096 records, 8 fields,
batch 64, tasks of 1024): the master in process, two PS processes (sync
with grads_to_wait 2, or async), two workers with their own
``--worker_host`` and one checkpoint directory. Each holds: both
workers and both PS exit 0, every record is done once, the two dense
digests at exit are equal, no push was version-rejected, the final
AUC reaches 0.70; with the SIGKILL, the survivor exits 3 and both
relaunched workers rejoin at a new epoch from the checkpoint. The
sync arm with the SIGKILL is the card's own arm, rehearsed in
tests/test_torch_chip_smoke_lockstep.py.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
from elasticdl_tpu_torch.common.grpc_utils import build_server, find_free_port
from elasticdl_tpu_torch.data.readers import RecordIODataReader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.proto.services import add_master_servicer_to_server
from elasticdl_tpu_torch.train.metrics import Accuracy
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.worker import MeshEpochChanged, Worker
from tests.test_utils import create_mnist_recordio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(device="cpu", per_task=1024, batch=64, eval_steps=24,
             report_version_steps=4)


@pytest.fixture(scope="module")
def job_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lockstep_live"))
    chip_smoke.job_data(np, d, records=16384, valid=2048, fields=8)
    return d


def _hold(record, kill):
    assert record["final_rcs"] == [0, 0]
    assert record["ps_exit_codes"] == [0, 0]
    assert record["done_training_records"] == record["dataset_records"]
    assert record["digests"][0] == record["digests"][1] is not None
    assert record["ps_stale_push_rejected"] == 0
    assert record["final_auc"] >= chip_smoke.JOB_AUC_FLOOR
    assert record["versions"][0] == record["versions"][1] > 0
    if kill:
        exits = record["kill"]["exits"]
        assert exits[0][:2] == (1, -9) or list(exits[0][:2]) == [1, -9]
        assert list(exits[1][:2]) == [0, 3]
        assert all(record["kill"]["resumed"])


@pytest.mark.parametrize("use_async", [True, False],
                         ids=["async_ps", "sync_ps_wait2"])
def test_two_workers_share_one_model(job_dir, use_async, tmp_path):
    torch.set_num_threads(1)
    record = chip_smoke.lockstep_job(torch, np, job_dir, kill=False,
                                     use_async=use_async,
                                     out_dir=str(tmp_path / "out"), **SMALL)
    _hold(record, kill=False)
    assert record["backends"] == ["gloo: a rank runs on the CPU"]


def test_sigkill_worker_mid_training_recovers_async_ps(job_dir, tmp_path):
    """The deliberate-failure arm against the async PS (grads_to_wait
    1): worker 1 SIGKILLed once it reported a task, the survivor's exit
    3, both relaunched, the job ends with the same guarantees."""
    torch.set_num_threads(1)
    record = chip_smoke.lockstep_job(torch, np, job_dir, kill=True,
                                     use_async=True,
                                     out_dir=str(tmp_path / "out"), **SMALL)
    _hold(record, kill=True)


def _mnist_master(train_dir):
    reader = RecordIODataReader(data_dir=train_dir)
    dispatcher = TaskDispatcher(training_shards=reader.create_shards(),
                                records_per_task=64, num_epochs=2, seed=0)
    evals = EvaluationService(dispatcher,
                              lambda: {"accuracy": Accuracy()},
                              eval_steps=8)
    server = build_server()
    add_master_servicer_to_server(MasterServicer(dispatcher, evals), server)
    port = find_free_port()
    server.add_insecure_port("localhost:%d" % port)
    server.start()
    return server, dispatcher, port


def test_mesh_epoch_change_aborts_for_restart(tmp_path):
    """A mesh-epoch bump mid-training raises MeshEpochChanged out of the
    worker (worker/main.py then exits 3 for the relaunch) with every
    task it held handed back."""
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    create_mnist_recordio(str(train_dir / "f0.rec"), num_records=256, seed=0)
    server, dispatcher, port = _mnist_master(str(train_dir))

    class EpochFlipRuntime:
        def __init__(self):
            self.calls = 0

        def epoch_moved(self, seen_epoch):
            self.calls += 1
            return self.calls >= 2  # the second probe sees a new epoch

    runtime = EpochFlipRuntime()
    try:
        worker = Worker(MasterClient("localhost:%d" % port, worker_id=0),
                        "elasticdl_tpu_torch.models.mnist",
                        RecordIODataReader(data_dir=str(train_dir)),
                        minibatch_size=32, report_version_steps=2,
                        wait_sleep_secs=0.1, multihost_runtime=runtime,
                        device="cpu")
        with pytest.raises(MeshEpochChanged):
            worker.run()
        assert runtime.calls >= 2
        # a task fetched in the failure window is handed back by the
        # prefetch thread: poll briefly
        deadline = time.time() + 5
        while dispatcher.doing_tasks() and time.time() < deadline:
            time.sleep(0.05)
        assert not dispatcher.finished()
        assert not dispatcher.doing_tasks(), "tasks left orphaned"
    finally:
        server.stop(0)


def _spawn_worker(idx, master_port, coordinator_port, train_dir, ckpt_dir,
                  log_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    log = open(log_path, "ab")
    log.write(b"\n===== incarnation spawn =====\n")
    log.flush()
    return subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
         "--master_addr", "localhost:%d" % master_port,
         "--worker_id", str(idx),
         "--model_zoo", "elasticdl_tpu_torch.models.mnist",
         "--training_data", train_dir, "--minibatch_size", "32",
         "--multihost", "1", "--coordinator_port", str(coordinator_port),
         "--worker_host", "localhost:%d" % (61000 + idx),
         "--checkpoint_dir", ckpt_dir, "--checkpoint_steps", "2",
         "--device", "cpu"],
        env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)


def test_kill_one_host_epoch_bump_reinit_restore_completes(tmp_path):
    """Two dense mnist workers in lockstep over gloo; worker 1 is
    SIGKILLed and never relaunched; the master's liveness scan evicts
    it and bumps the mesh epoch; the survivor (its collective failed,
    exit 3) is relaunched by the supervisor, forms the group at world
    1 and the new epoch, restores the checkpoint and drains the job."""
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    # enough rounds that the job outlasts the kill's detection
    create_mnist_recordio(str(train_dir / "f0.rec"), num_records=16384,
                          seed=0)
    master = Master("elasticdl_tpu_torch.models.mnist",
                    training_data=str(train_dir), records_per_task=256,
                    num_epochs=1, port=find_free_port(),
                    task_timeout_secs=8.0, seed=0,
                    mesh_restart_grace_secs=4.0,
                    mesh_rejoin_timeout_secs=12.0)
    master.prepare()
    master.task_monitor._scan_interval = 0.3
    # the pod manager's two pods: both join one world of 2 (a worker
    # that came up alone would first train a world of 1)
    master.rendezvous.set_worker_hosts(["localhost:61000",
                                        "localhost:61001"])
    import threading

    result = {}
    thread = threading.Thread(
        target=lambda: result.setdefault("rc", master.run(poll_secs=0.3)),
        daemon=True)
    thread.start()
    rendezvous, dispatcher = master.rendezvous, master.task_dispatcher
    coordinator_port = find_free_port()
    ckpt_dir = str(tmp_path / "ckpt")
    logs = {i: str(tmp_path / ("worker%d.log" % i)) for i in (0, 1)}
    procs, relaunches, killed = {}, {0: 0, 1: 0}, set()
    try:
        for i in (0, 1):
            procs[i] = _spawn_worker(i, master._port, coordinator_port,
                                     str(train_dir), ckpt_dir, logs[i])

        def supervise():
            for i, proc in list(procs.items()):
                if i in killed or proc.poll() is None:
                    continue
                relaunches[i] += 1
                assert relaunches[i] < 8, open(logs[i]).read()[-3000:]
                procs[i] = _spawn_worker(i, master._port, coordinator_port,
                                         str(train_dir), ckpt_dir, logs[i])

        def committed():
            return os.path.isdir(ckpt_dir) and any(
                name.isdigit() for name in os.listdir(ckpt_dir))

        deadline = time.time() + 120
        while time.time() < deadline:
            supervise()
            if (all("/2 (epoch" in open(logs[i]).read() for i in (0, 1))
                    and committed() and len(rendezvous.hosts()) == 2):
                break
            time.sleep(0.2)
        assert len(rendezvous.hosts()) == 2, "the second host never joined"
        assert committed(), "no checkpoint written before the kill"
        epoch_before = rendezvous.mesh_epoch
        killed.add(1)
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=30)
        deadline = time.time() + 150
        while time.time() < deadline and not dispatcher.finished():
            supervise()
            time.sleep(0.3)
        assert dispatcher.finished(), open(logs[0]).read()[-3000:]
        assert not dispatcher.job_failed()
        assert rendezvous.mesh_epoch > epoch_before
        assert rendezvous.hosts() == ["localhost:61000"]
        log0 = open(logs[0]).read()
        assert "rank 0/2" in log0 or "rank 1/2" in log0, log0[-2000:]
        assert "rank 0/1" in log0, log0[-3000:]
        assert "Resumed from checkpoint" in log0, log0[-3000:]
        assert relaunches[0] >= 1, "the survivor was never relaunched"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        master.stop()
