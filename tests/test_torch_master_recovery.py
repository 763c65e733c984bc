"""The port's master outlives a SIGKILL (tests/test_chaos.py's master
scenario on the port, on the CPU).

``python -m elasticdl_tpu_torch.master.main`` with ``EDL_STATE_DIR``
runs a DeepFM job (10 id fields, vocab 1000, data made with numpy from
a seed) for a worker of the port in this process over two in-process PS
servicers. Mid-epoch the master is SIGKILLed; relaunched with the same
flags and state directory, it replays its journal and finishes the job,
the train-end export included. Checked from the journal: every task
created is done exactly once across both lifetimes, two boots, worker 0
granted a relaunch epoch in each lifetime (the second above the first),
one train-end task; the worker re-registered and exited, the master 0.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from elasticdl_tpu_torch.common.grpc_utils import (
    build_server,
    find_free_port,
    reserve_port,
)
from elasticdl_tpu_torch.data.readers import RecordIODataReader
from elasticdl_tpu_torch.master import state_store
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.services import add_pserver_servicer_to_server
from elasticdl_tpu_torch.ps import embedding_store
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.worker import master_client
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.worker import Worker
from tests.test_utils import create_ctr_recordio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ZOO = "elasticdl_tpu_torch.models.deepfm"
TASKS = 40


def _wait_for_line(proc, log_path, text, timeout=60):
    deadline = time.monotonic() + timeout
    while True:
        with open(log_path) as f:
            if text in f.read():
                return
        assert proc.poll() is None, open(log_path).read()[-3000:]
        assert time.monotonic() < deadline, open(log_path).read()[-3000:]
        time.sleep(0.05)


def _journal_ops(path):
    ops = []
    if not os.path.isfile(path):
        return ops
    with open(path) as f:
        for line in f:
            try:
                ops.append(json.loads(line))
            except ValueError:
                pass  # a torn tail (SIGKILL mid-write)
    return ops


def test_master_sigkill_mid_epoch_replay_every_task_done_once(
        tmp_path, monkeypatch):
    # the outage is seconds; the worker's get_task retries through it
    monkeypatch.setattr(master_client, "MASTER_RETRY_BUDGET_SECS", 30.0)
    state_dir, train_dir = tmp_path / "state", tmp_path / "train"
    train_dir.mkdir()
    create_ctr_recordio(str(train_dir / "f0.rec"), num_records=TASKS * 32,
                        num_features=10, seed=0)
    export_dir = str(tmp_path / "export")
    sock, port = reserve_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **{state_store.STATE_DIR_ENV: str(state_dir)})

    def spawn_master(tag):
        log_path = str(tmp_path / ("master-%s.log" % tag))
        with open(log_path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
                 "--model_zoo", PORT_ZOO, "--training_data", str(train_dir),
                 "--records_per_task", "32", "--port", str(port),
                 "--task_timeout_secs", "60", "--output", export_dir],
                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
        _wait_for_line(proc, log_path, "Master serving on")
        return proc, log_path

    servers, ps_addrs = [], []
    for ps_id in range(2):
        store = embedding_store.create_store(seed=ps_id)
        store.set_optimizer("adam", lr=0.01)
        server = build_server()
        add_pserver_servicer_to_server(PserverServicer(store, ps_id=ps_id),
                                       server)
        ps_port = find_free_port()
        server.add_insecure_port("localhost:%d" % ps_port)
        server.start()
        servers.append(server)
        ps_addrs.append("localhost:%d" % ps_port)
    journal_path = str(state_dir / state_store.JOURNAL_NAME)
    master, first_log = spawn_master("first")
    runner = None
    try:
        mc = MasterClient("localhost:%d" % port, worker_id=0)
        mc.reset_worker()
        worker = Worker(mc, PORT_ZOO,
                        RecordIODataReader(data_dir=str(train_dir)),
                        minibatch_size=16, wait_sleep_secs=0.1,
                        ps_addrs=ps_addrs, device="cpu")
        runner = threading.Thread(target=worker.run, daemon=True)
        runner.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            done = [op for op in _journal_ops(journal_path)
                    if op["op"] == "done"]
            if len(done) >= 3:
                break
            time.sleep(0.02)
        assert len(done) >= 3, "the job made no progress before the kill"
        master.send_signal(signal.SIGKILL)
        master.wait(timeout=30)
        killed_at = len([op for op in _journal_ops(journal_path)
                         if op["op"] == "done"])
        assert killed_at < TASKS, "the epoch ended before the kill"
        time.sleep(1.0)  # the worker is inside the outage

        master, relaunch_log = spawn_master("relaunch")
        try:
            rc = master.wait(timeout=120)
        except subprocess.TimeoutExpired:
            pytest.fail("relaunched master did not finish the job:\n%s"
                        % open(relaunch_log).read()[-3000:])
        assert rc == 0, open(relaunch_log).read()[-3000:]
        runner.join(timeout=60)
        assert not runner.is_alive(), "the worker never finished"
    finally:
        if master.poll() is None:
            master.kill()
            master.wait()
        if runner is not None:
            runner.join(timeout=10)
        for server in servers:
            server.stop(None)
        sock.close()

    relaunch_text = open(relaunch_log).read()
    assert "Recovered master state" in relaunch_text
    ops = _journal_ops(journal_path)
    created = {task[0]: task[1] for op in ops if op["op"] == "tasks_created"
               for task in op["tasks"]}
    done_ids = [op["task"] for op in ops if op["op"] == "done"]
    assert sorted(done_ids) == sorted(created)
    training = [t for t, kind in created.items() if kind == pb.TRAINING]
    assert len(training) == TASKS
    assert [kind for kind in created.values()].count(
        pb.TRAIN_END_CALLBACK) == 1
    assert [op["master_epoch"] for op in ops
            if op["op"] == "master_restarted"] == [1, 2]
    # worker 0 registered with both lifetimes, the second epoch higher
    base, epochs = None, []
    for op in ops:
        if op["op"] == "epoch_base":
            base = op["base"]
        elif op["op"] == "grant" and op["worker"] == 0:
            epochs.append(base + op["count"])
    assert len(epochs) == 2 and epochs[1] > epochs[0]
    assert all(op["retries"] == 0 for op in ops if op["op"] == "requeue")
    with open(os.path.join(export_dir, "manifest.json")) as f:
        assert json.load(f)["step"] == worker.model_version
