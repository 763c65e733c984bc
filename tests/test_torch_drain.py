"""The port's graceful drain (``master/autoscaler.py`` DrainManager, the
servicer's gate and ``deregister_worker``, ``worker/drain.py`` and the
worker's ``begin_drain``/``_finish_drain``) on the CPU.

(a) the drain scenarios of tests/test_autoscaler.py: the ack cleans up
without a counted requeue; an expired drain falls back to
requeue-on-death through the task monitor; the servicer's gate answers
WAIT(draining=true) and a bare servicer still honours the ack; a worker
asked to drain mid-job finishes its task, flushes its device tier and
deregisters, and a second worker finishes the job; ``_drain_fast``
honours a drain; (b) the port's servicer and DrainManager answer a
seeded operation sequence with drains in it as the reference's do; (c)
``python -m elasticdl_tpu_torch.worker.main --device cpu`` with the
tier on, sent SIGTERM mid-job, exits 0 after its drain ack, with no
counted retry, and the rows its drain flushed read back from the PS bit
for bit. DeepFM at small sizes (10 id fields, vocab 1000), data made
with numpy from a seed.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu.master import autoscaler as ref_autoscaler
from elasticdl_tpu.master import servicer as ref_servicer
from elasticdl_tpu.master import task_dispatcher as ref_disp
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as ref_pb
from elasticdl_tpu_torch.common.grpc_utils import build_server, find_free_port
from elasticdl_tpu_torch.data.readers import RecordIODataReader
from elasticdl_tpu_torch.master import autoscaler
from elasticdl_tpu_torch.master import servicer
from elasticdl_tpu_torch.master import task_dispatcher
from elasticdl_tpu_torch.master.autoscaler import DrainManager
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.master.task_monitor import TaskMonitor
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.services import (
    add_master_servicer_to_server,
    add_pserver_servicer_to_server,
)
from elasticdl_tpu_torch.ps import embedding_store
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.worker import master_client
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.worker import Worker
from tests.test_utils import create_ctr_recordio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ZOO = "elasticdl_tpu_torch.models.deepfm"
TIER_ENV = {
    "EDL_DEVICE_TIER": "1",
    "EDL_DEVICE_TIER_ROWS": "512",
    "EDL_DEVICE_TIER_PROMOTE": "1",
    "EDL_DEVICE_TIER_STAGE": "128",
    "EDL_DEVICE_TIER_OPT_ARGS": "lr=0.01",
    "EDL_ASYNC_PUSH": "1",
}


@pytest.fixture(autouse=True)
def _short_master_retry(monkeypatch):
    monkeypatch.setattr(master_client, "MASTER_RETRY_BUDGET_SECS", 5.0)


class FakeDispatcher:
    def __init__(self):
        self.recovered = []

    def recover_tasks(self, worker_id):
        self.recovered.append(worker_id)


def _ctr_dir(tmp_path, records):
    train = tmp_path / "train"
    train.mkdir()
    create_ctr_recordio(str(train / "f0.rec"), num_records=records,
                        num_features=10, seed=0)
    return str(train)


# ---------------------------------------------------------------------
# (a) the scenarios of tests/test_autoscaler.py


def test_drain_ack_cleans_up_without_requeue():
    dispatcher = FakeDispatcher()
    drain = DrainManager(dispatcher, deadline_secs=60)
    assert drain.begin_drain(3, reason="scale_down")
    assert not drain.begin_drain(3)  # idempotent
    assert drain.is_draining(3) and set(drain.state()) == {"3"}
    drain.deregister(pb.DeregisterWorkerRequest(
        worker_id=3, reason="scale_down", pushes_joined=True,
        tier_flushed=True))
    assert not drain.is_draining(3)
    assert dispatcher.recovered == [3]  # leftovers requeue (uncounted)
    assert drain.departed_ids() == {3}
    assert drain.departed_ids(current_ids=[]) == set()
    # a worker SIGTERMed directly acks without a begin_drain
    drain.deregister(pb.DeregisterWorkerRequest(worker_id=4,
                                                reason="sigterm"))
    assert dispatcher.recovered == [3, 4] and drain.departed_ids() == {4}


def test_drain_expiry_falls_back_to_requeue_on_death():
    dispatcher = TaskDispatcher({"f": (0, 8)}, records_per_task=4,
                                num_epochs=1, seed=0)
    srv = MasterServicer(dispatcher)
    drain = DrainManager(dispatcher, servicer=srv, deadline_secs=0.0)
    monitor = TaskMonitor(dispatcher, srv, drain_manager=drain)
    held = srv.get_task(pb.GetTaskRequest(worker_id=5))
    assert held.task_id and dispatcher.doing_tasks()
    drain.begin_drain(5, reason="scale_down")
    assert drain.take_expired(time.time() - 10.0) == []
    monitor._scan()  # the expired drain joins the dead
    assert not drain.is_draining(5)
    assert dispatcher.doing_tasks() == {}
    assert 5 not in srv.worker_liveness()
    assert dispatcher.stats()["queue_depth"]["training"] == 2
    # a worker evicted for its own reasons drops its drain entry
    drain.begin_drain(6)
    monitor.mark_worker_dead(6)
    assert not drain.is_draining(6)
    assert drain.take_expired(time.time() + 10.0) == []


def test_servicer_gate_and_inline_deregister():
    dispatcher = TaskDispatcher({"f": (0, 64)}, records_per_task=32,
                                num_epochs=1, seed=0)
    srv = MasterServicer(dispatcher)
    drain = DrainManager(dispatcher, servicer=srv, deadline_secs=60)
    srv.drain_manager = drain

    task = srv.get_task(pb.GetTaskRequest(worker_id=7))
    assert task.task_id != 0 and not task.draining
    drain.begin_drain(7)
    gated = srv.get_task(pb.GetTaskRequest(worker_id=7))
    assert gated.task_id == 0 and gated.type == pb.WAIT
    assert gated.draining is True
    srv.deregister_worker(
        pb.DeregisterWorkerRequest(worker_id=7, reason="scale_down"))
    assert 7 not in srv.worker_liveness()
    assert dispatcher.stats()["doing"] == {}
    assert srv.workers_not_told_job_over() == []

    # a bare servicer builds its DrainManager on the first ack
    srv.drain_manager = None
    task = srv.get_task(pb.GetTaskRequest(worker_id=8))
    assert task.task_id != 0
    srv.deregister_worker(
        pb.DeregisterWorkerRequest(worker_id=8, reason="sigterm"))
    assert isinstance(srv.drain_manager, DrainManager)
    assert 8 not in srv.worker_liveness()
    assert dispatcher.stats()["doing"] == {}


def _ps_pair():
    """Two in-process PS servicers on the numpy store (seed = ps_id);
    each store records, in one sequence for both, its gradient pushes
    and the rows written back to it."""
    servers, addrs, stores, events = [], [], [], []
    lock = threading.Lock()
    for ps_id in range(2):
        store = embedding_store.create_store(seed=ps_id,
                                             prefer_native=False)
        store.set_optimizer("adam", lr=0.01)
        push, rows = store.push_gradients, store.import_table

        def recorded_push(name, ids, grads, lr_scale=1.0, _push=push,
                          _ps=ps_id):
            with lock:
                events.append(("push", _ps, name, None, None))
            return _push(name, ids, grads, lr_scale=lr_scale)

        def recorded_rows(name, ids, values, shard_id=0, shard_num=0,
                          _rows=rows, _ps=ps_id):
            with lock:
                events.append(("rows", _ps, name, np.array(ids),
                               np.array(values, np.float32)))
            return _rows(name, ids, values, shard_id=shard_id,
                         shard_num=shard_num)

        store.push_gradients, store.import_table = recorded_push, recorded_rows
        server = build_server()
        add_pserver_servicer_to_server(PserverServicer(store, ps_id=ps_id),
                                       server)
        port = find_free_port()
        server.add_insecure_port("localhost:%d" % port)
        server.start()
        servers.append(server)
        addrs.append("localhost:%d" % port)
        stores.append(store)
    return servers, addrs, stores, events


def _master_server(dispatcher, srv):
    server = build_server()
    add_master_servicer_to_server(srv, server)
    port = find_free_port()
    server.add_insecure_port("localhost:%d" % port)
    server.start()
    return server, "localhost:%d" % port


def test_worker_graceful_drain_finishes_task_and_deregisters(
        tmp_path, monkeypatch):
    """begin_drain mid-job (a master-initiated drain): the worker
    finishes its current task (reported done, never requeued), flushes
    its device tier (every resident row then equals the PS's, bit for
    bit), sends the ack and leaves its run loop; a second worker
    finishes the job, every task done exactly once."""
    for key, value in TIER_ENV.items():
        monkeypatch.setenv(key, value)
    train_dir = _ctr_dir(tmp_path, 512)
    dispatcher = TaskDispatcher(
        training_shards=RecordIODataReader(
            data_dir=train_dir).create_shards(),
        records_per_task=64, num_epochs=1, seed=0)
    reports = []
    report = dispatcher.report

    def recorded(task_id, success, worker_id=None, count_failure=True):
        reports.append((task_id, success, worker_id, count_failure))
        return report(task_id, success, worker_id=worker_id,
                      count_failure=count_failure)

    dispatcher.report = recorded
    srv = MasterServicer(dispatcher)
    drain = DrainManager(dispatcher, servicer=srv, deadline_secs=90)
    srv.drain_manager = drain
    acks = []
    deregister = drain.deregister
    drain.deregister = lambda request: (acks.append(request),
                                        deregister(request))
    master_server, addr = _master_server(dispatcher, srv)
    ps_servers, ps_addrs, stores, _ = _ps_pair()
    try:
        worker = Worker(MasterClient(addr, worker_id=0), PORT_ZOO,
                        RecordIODataReader(data_dir=train_dir),
                        minibatch_size=16, wait_sleep_secs=0.1,
                        ps_addrs=ps_addrs, device="cpu")
        assert worker.trainer.device_tier is not None
        runner = threading.Thread(target=worker.run, daemon=True)
        runner.start()
        deadline = time.time() + 60
        while time.time() < deadline and not dispatcher.doing_tasks():
            time.sleep(0.01)
        assert dispatcher.doing_tasks(), "worker never took a task"
        drain.begin_drain(0, reason="scale_down")
        runner.join(timeout=90)
        assert not runner.is_alive(), "draining worker never exited"
        assert worker._drain_done
        assert all(w != 0 for w, _ in dispatcher.doing_tasks().values())
        assert 0 not in srv.worker_liveness()
        assert not dispatcher.finished()  # work remains for a peer
        (ack,) = acks
        assert (ack.worker_id, ack.pushes_joined, ack.tier_flushed,
                ack.tasks_reported) == (0, True, True, 0)
        # the flush left every resident tier row on its PS shard
        tier = worker.trainer.device_tier
        for name in ("deepfm_emb", "deepfm_linear"):
            ids, rows = tier.table_rows(name)
            assert ids.size
            for shard in range(2):
                mine = ids % 2 == shard
                np.testing.assert_array_equal(
                    stores[shard].lookup(name, ids[mine]), rows[mine])

        worker2 = Worker(MasterClient(addr, worker_id=1), PORT_ZOO,
                         RecordIODataReader(data_dir=train_dir),
                         minibatch_size=16, wait_sleep_secs=0.1,
                         ps_addrs=ps_addrs, device="cpu")
        worker2.run()
        assert dispatcher.finished() and not dispatcher.job_failed()
    finally:
        master_server.stop(None)
        for server in ps_servers:
            server.stop(None)
    # done exactly once, and no report was a failure
    done = [r[0] for r in reports if r[1]]
    assert len(done) == len(set(done)) == 8
    assert all(r[1] for r in reports), reports


def test_drain_fast_honors_drain_request():
    """A drain during the MaxSteps tail goes to _finish_drain: the gate
    answers WAIT(draining=true) forever once this worker drains."""

    class FakeMC:
        def __init__(self):
            self.calls = 0

        def get_task(self, task_type=None):
            self.calls += 1
            if self.calls > 5:
                raise AssertionError("fast-drain looped on WAIT(draining)")
            return pb.Task(task_id=0, type=pb.WAIT, draining=True)

    class Stub:
        pass

    finished = []
    victim = Stub()
    victim._draining = False
    victim._mc = FakeMC()
    victim._finish_drain = lambda: finished.append("master")
    Worker._drain_fast(victim)
    assert finished == ["master"] and victim._mc.calls == 1

    sigtermed = Stub()
    sigtermed._draining = True
    sigtermed._mc = None  # must not be consulted
    sigtermed._finish_drain = lambda: finished.append("sigterm")
    Worker._drain_fast(sigtermed)
    assert finished == ["master", "sigterm"]


def test_task_mode_loop_honors_drain_request():
    """The evaluation/prediction loop ends in _finish_drain too: on the
    worker's own flag before any RPC, and on the gate's answer."""

    class Stub:
        pass

    finished = []
    stub = Stub()
    stub._draining = True
    stub._mc = None
    stub._finish_drain = lambda: finished.append("flag")
    Worker._run_task_mode(stub, pb.EVALUATION, None)
    stub._draining = False
    stub._mc = type("MC", (), {"get_task": lambda self, t=None: pb.Task(
        type=pb.WAIT, draining=True)})()
    stub._finish_drain = lambda: finished.append("gate")
    Worker._run_task_mode(stub, pb.EVALUATION, None)
    assert finished == ["flag", "gate"]


# ---------------------------------------------------------------------
# (b) the gate's answers against the reference's


def _pair(seed):
    kwargs = dict(training_shards={"f": (0, 24), "g": (0, 9)},
                  records_per_task=4, num_epochs=2, seed=seed)
    out = []
    for disp, srv_mod, scaler in ((ref_disp, ref_servicer, ref_autoscaler),
                                  (task_dispatcher, servicer, autoscaler)):
        dispatcher = disp.TaskDispatcher(**kwargs)
        srv = srv_mod.MasterServicer(dispatcher)
        srv.drain_manager = scaler.DrainManager(
            dispatcher, servicer=srv, deadline_secs=60)
        out.append((srv, dispatcher))
    return out


def _answer(response, base=None):
    copy = type(response)()
    copy.CopyFrom(response)
    if "master_epoch" in copy.DESCRIPTOR.fields_by_name:
        copy.master_epoch = 0
    if copy.DESCRIPTOR.name == "ResetWorkerResponse":
        copy.restart_count -= base
    return copy.SerializeToString(deterministic=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_answers_match_reference(seed):
    (ref, ref_d), (port, port_d) = _pair(seed)
    rng = np.random.RandomState(seed)
    held = {id(ref): [], id(port): []}
    kinds = ["task"] * 6 + ["done"] * 4 + ["drain", "deregister", "reset",
                                           "fail"]
    for step in range(120):
        op = kinds[rng.randint(len(kinds))]
        worker = int(rng.randint(3))
        pick = int(rng.randint(30))
        answers = []
        for srv, mod in ((ref, ref_pb), (port, pb)):
            if op == "task":
                task = srv.get_task(mod.GetTaskRequest(worker_id=worker))
                if task.task_id:
                    held[id(srv)].append((task.task_id, worker))
                answers.append(_answer(task))
            elif op == "drain":
                answers.append(srv.drain_manager.begin_drain(worker))
            elif op == "deregister":
                held[id(srv)] = [h for h in held[id(srv)] if h[1] != worker]
                answers.append(_answer(srv.deregister_worker(
                    mod.DeregisterWorkerRequest(worker_id=worker,
                                                reason="sigterm"))))
            elif op == "reset":
                held[id(srv)] = [h for h in held[id(srv)] if h[1] != worker]
                answers.append(_answer(srv.reset_worker(
                    mod.GetTaskRequest(worker_id=worker)),
                    srv._restart_epoch_base))
            else:
                queue = held[id(srv)]
                if not queue:
                    answers.append(None)
                    continue
                task_id, holder = queue.pop(pick % len(queue))
                answers.append(_answer(srv.report_task_result(
                    mod.ReportTaskResultRequest(
                        task_id=task_id, worker_id=holder,
                        err_message="" if op == "done" else "boom"))))
        assert answers[0] == answers[1], (step, op)
        assert port_d.stats() == ref_d.stats(), (step, op)
        assert set(port.drain_manager.state()) == set(
            ref.drain_manager.state()), step
        assert (port.drain_manager.departed_ids()
                == ref.drain_manager.departed_ids()), step
        assert sorted(port.worker_liveness()) == sorted(
            ref.worker_liveness()), step


# ---------------------------------------------------------------------
# (c) the worker main as a process, SIGTERMed mid-job

_DRAINED_RE = re.compile(
    r"Worker 0 drained at version (\d+) \(sigterm; acked=True "
    r"pushes_joined=True tier_flushed=True handed_back=0\)")
_FLUSH_RE = re.compile(
    r"Worker 0 drain tier flush: (\d+) rows written back, (\d+) K1 "
    r"launches, (\d+) row reads")


def test_sigterm_worker_process_drains_and_its_rows_reach_the_ps(tmp_path):
    train_dir = _ctr_dir(tmp_path, 1024)
    port = find_free_port()
    master = Master(PORT_ZOO, training_data=train_dir, records_per_task=64,
                    port=port, seed=0).prepare()
    dispatcher = master.task_dispatcher
    reports, acks = [], []
    report, deregister = dispatcher.report, master.drain_manager.deregister

    def recorded(task_id, success, worker_id=None, count_failure=True):
        reports.append((task_id, success, count_failure, time.monotonic()))
        return report(task_id, success, worker_id=worker_id,
                      count_failure=count_failure)

    dispatcher.report = recorded
    master.drain_manager.deregister = lambda request: (
        acks.append(request), deregister(request))
    ps_servers, ps_addrs, stores, events = _ps_pair()
    log_path = str(tmp_path / "worker.log")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               EDL_DRAIN_DEADLINE_SECS="60", **TIER_ENV)
    proc = None
    try:
        with open(log_path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
                 "--model_zoo", PORT_ZOO, "--training_data", train_dir,
                 "--minibatch_size", "16", "--master_addr",
                 "localhost:%d" % port, "--worker_id", "0", "--ps_addrs",
                 ",".join(ps_addrs), "--device", "cpu"],
                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 90
        while not reports:
            assert proc.poll() is None and time.monotonic() < deadline, (
                open(log_path).read()[-3000:])
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        sigterm_t = time.monotonic()
        rc = proc.wait(timeout=60)
        log = open(log_path).read()
        assert rc == 0, log[-3000:]
        assert time.monotonic() - sigterm_t < 60
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        master.stop()
        for server in ps_servers:
            server.stop(None)
    (ack,) = acks
    assert (ack.worker_id, ack.reason, ack.pushes_joined, ack.tier_flushed,
            ack.tasks_reported) == (0, "sigterm", True, True, 0)
    assert _DRAINED_RE.search(log), log[-3000:]
    rows, k1, reads = (int(g) for g in _FLUSH_RE.search(log).groups())
    # the CPU path launches no K1; the card's counts it per row read
    assert rows > 0 and reads >= 1 and k1 == 0
    # no counted retry, no task left behind, work left for a peer
    assert all(success for _, success, _, _ in reports), reports
    assert dispatcher.doing_tasks() == {}
    assert not dispatcher.finished()
    # the rows written back after the last gradient push (the drain's
    # flush) are on the PS bit for bit
    last_push = max(i for i, e in enumerate(events) if e[0] == "push")
    flushed = [e for e in events[last_push + 1:] if e[0] == "rows"]
    assert sum(e[3].size for e in flushed) >= rows
    last = {}
    for _, shard, name, ids, values in flushed:
        for i, row in zip(ids.tolist(), values):
            last[shard, name, i] = row
    for (shard, name, i), row in last.items():
        np.testing.assert_array_equal(
            stores[shard].lookup(name, np.array([i]))[0], row)
