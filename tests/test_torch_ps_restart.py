"""A port PS process killed mid-job comes back from its own checkpoints,
on the CPU: tests/test_chaos.py's
``test_ps_sigkill_auto_restore_and_worker_resync`` on the port, and a
SIGTERM'd PS's final checkpoint against the state it stopped with.

(a) A DeepFM job (the port's master in this process, one
``python -m elasticdl_tpu_torch.ps.server`` with ``--checkpoint_dir``
and ``--checkpoint_steps 3``, one in-process ``Worker`` on the CPU),
over the reference's three cases: sync push, async push, async push with
the device tier. Inside the worker's 12th push the PS gets SIGKILL (at
version 11, its checkpoints of versions 3, 6 and 9 requested, the
newest of them on disk by then, as the checkpoint thread saves), and
it is relaunched with the same flags and no ``--checkpoint_dir_for_init``.
Checks: the relaunch logs the newest complete checkpoint's version and
stamps it on its answers; the worker's PS client saw the stamp and
resynced once; the job finishes; the worker's version for the shard
equals the PS's store version (each accepted push bumps it by one from
the restored base), read from the final full checkpoint the PS saves on
SIGTERM; with the tier, every row the tier flushed at the restart is
served back by the relaunched PS bit for bit, and at the end every
resident row equals the PS's. (b) A PS driven by a fixed request
sequence, SIGTERM'd: its final full checkpoint restores, offline and by
a relaunch, to a store bit-identical to an in-process servicer's that
took the same requests. (c) The relaunch's port: a ``reserve_port``
socket holds it from the first launch to the end (no other process's
``bind`` to port 0 can take it in between, while the PS still binds
it), and a PS whose port is taken exits non-zero, naming the port.
"""

import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from chip_smoke import RestartFlushes
from elasticdl_tpu_torch.common.grpc_utils import (
    build_channel,
    find_free_port,
    reserve_port,
)
from elasticdl_tpu_torch.common.tensor_utils import (
    pack_ids,
    serialize_indexed_slices,
)
from elasticdl_tpu_torch.data.readers import RecordIODataReader
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.services import PserverStub
from elasticdl_tpu_torch.ps import embedding_store
from elasticdl_tpu_torch.ps.checkpoint import SparseCheckpointSaver
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.worker import master_client
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.ps_client import PSClient
from elasticdl_tpu_torch.worker.worker import Worker
from tests.test_utils import create_ctr_recordio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ZOO = "elasticdl_tpu_torch.models.deepfm"
KILL_AT_PUSH = 12
CKPT_STEPS = 3
WAIT_S = 180


@pytest.fixture(autouse=True)
def _short_master_retry(monkeypatch):
    """A worker that polls a master which already stopped reads the job
    as over after 5 s, not the deployment's 120 s relaunch window."""
    monkeypatch.setattr(master_client, "MASTER_RETRY_BUDGET_SECS", 5.0)


def _spawn_ps(port, ckpt_dir, log_path, *extra):
    """The PS with the reference test's flags: shard 0 of 1, sync, adam
    lr 0.01, a checkpoint every CKPT_STEPS versions, no restore flag."""
    with open(log_path, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.ps.server",
             "--ps_id", "0", "--num_ps_pods", "1", "--port", str(port),
             "--opt_type", "adam", "--opt_args", "lr=0.01",
             "--checkpoint_dir", ckpt_dir,
             "--checkpoint_steps", str(CKPT_STEPS), *extra],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                               OMP_NUM_THREADS="1"),
            stdout=out, stderr=subprocess.STDOUT)


def _wait_serving(proc, log_path, port):
    deadline = time.monotonic() + WAIT_S
    while True:
        with open(log_path) as f:
            text = f.read()
        if "serving on :%d " % port in text:
            return text
        assert proc.poll() is None, text[-3000:]
        assert time.monotonic() < deadline, text[-3000:]
        time.sleep(0.1)


def _restored(log_path):
    with open(log_path) as f:
        match = re.search(r"auto-restored checkpoint version (\d+)", f.read())
    return int(match[1]) if match else None


@pytest.mark.parametrize("async_push,device_tier", [
    (False, False), (True, False), (True, True)],
    ids=["sync", "async", "async-tier"])
def test_ps_sigkill_auto_restore_and_worker_resync(tmp_path, monkeypatch,
                                                   async_push, device_tier):
    if async_push:
        monkeypatch.setenv("EDL_ASYNC_PUSH", "1")
    if device_tier:
        # a partial hot set over the 1000-id vocabulary: misses keep
        # reaching the PS, and evictions keep writebacks going
        for key, value in (("EDL_DEVICE_TIER", "1"),
                           ("EDL_DEVICE_TIER_ROWS", "256"),
                           ("EDL_DEVICE_TIER_PROMOTE", "2"),
                           ("EDL_DEVICE_TIER_OPT", "adam"),
                           ("EDL_DEVICE_TIER_OPT_ARGS", "lr=0.01")):
            monkeypatch.setenv(key, value)
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    create_ctr_recordio(str(train_dir / "f0.rec"), num_records=1152, seed=0)
    master = Master(PORT_ZOO, training_data=str(train_dir),
                    records_per_task=128, num_epochs=2,
                    port=find_free_port(), task_timeout_secs=60.0,
                    seed=0).prepare()
    result = {}
    master_thread = threading.Thread(
        target=lambda: result.setdefault("rc", master.run(poll_secs=0.2)),
        daemon=True)
    master_thread.start()
    # the relaunch binds the same port: held from now on, so no other
    # test process can take it between the kill and the relaunch
    reservation, ps_port = reserve_port()
    ckpt_dir = str(tmp_path / "ckpt")
    logs = [str(tmp_path / "ps.log"), str(tmp_path / "ps-relaunch.log")]
    procs = [_spawn_ps(ps_port, ckpt_dir, logs[0])]
    killed, pushes, resyncs = threading.Event(), [0], []
    runner = None
    try:
        _wait_serving(procs[0], logs[0], ps_port)
        worker = Worker(
            MasterClient("localhost:%d" % master._port, worker_id=0),
            PORT_ZOO, RecordIODataReader(data_dir=str(train_dir)),
            minibatch_size=64, wait_sleep_secs=0.1,
            ps_addrs=["localhost:%d" % ps_port], device="cpu")
        trainer = worker.trainer
        client = trainer.preparer._ps
        push, hook = client.push_gradients, client.resync_hook

        def push_and_kill(*args, **kwargs):
            pushes[0] += 1
            if pushes[0] == KILL_AT_PUSH:
                procs[0].kill()
                procs[0].wait()
                killed.set()
            return push(*args, **kwargs)

        client.push_gradients = push_and_kill
        client.resync_hook = lambda shard: (resyncs.append(shard),
                                            hook(shard))
        probe = PSClient(["localhost:%d" % ps_port])
        flushes = None
        if device_tier:
            assert trainer.device_tier is not None
            flushes = RestartFlushes(np, trainer.device_tier, probe)
        runner = threading.Thread(target=worker.run, daemon=True)
        runner.start()
        assert killed.wait(WAIT_S), "the job never reached push %d" % (
            KILL_AT_PUSH)
        assert procs[0].returncode == -signal.SIGKILL
        restored_floor = SparseCheckpointSaver.latest_version(ckpt_dir)
        assert restored_floor is not None, "the PS never checkpointed"
        assert restored_floor % CKPT_STEPS == 0
        procs.append(_spawn_ps(ps_port, ckpt_dir, logs[1]))
        _wait_serving(procs[1], logs[1], ps_port)
        runner.join(timeout=WAIT_S)
        assert not runner.is_alive(), "worker never finished after the PS"
        master_thread.join(timeout=WAIT_S)
        assert not master_thread.is_alive()
        assert result["rc"] == 0
        dispatcher = master.task_dispatcher
        assert dispatcher.finished() and not dispatcher.job_failed()
        restored = _restored(logs[1])
        assert restored == restored_floor
        assert client._shard_restored[0] == restored + 1
        assert resyncs == [0]
        assert trainer._version >= restored_floor
        if device_tier:
            dtier = trainer.device_tier
            assert dtier.epoch >= 1, "the relaunch never invalidated the tier"
            assert flushes.rows, "the restart flush wrote nothing back"
            for name, rows in flushes.rows.items():
                np.testing.assert_array_equal(flushes.served[name],
                                              np.stack(list(rows.values())))
            for name in ("deepfm_emb", "deepfm_linear"):
                ids, rows = dtier.table_rows(name)
                if ids.size:
                    np.testing.assert_array_equal(
                        probe.pull_embedding_vectors(name, ids), rows)
        probe.close()
        # the accounting: the SIGTERM drain saves a full checkpoint at
        # the PS's store version, which the worker saw last
        procs[1].send_signal(signal.SIGTERM)
        assert procs[1].wait(timeout=60) == 0
        final = SparseCheckpointSaver.latest_version(ckpt_dir)
        assert final == client._shard_versions[0]
        assert final > restored
    finally:
        master.stop()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if runner is not None:
            runner.join(timeout=10)
        reservation.close()


TABLES = (("t", 4, "0.05"), ("w", 1, "zeros"))


def _requests(seed=0, pushes=7):
    """A fixed sequence: table registration, unique-id pushes over both
    tables, a tier writeback and a pull that creates rows."""
    rng = np.random.RandomState(seed)
    model = pb.Model()
    for name, dim, init in TABLES:
        model.embedding_table_infos.add(name=name, dim=dim, initializer=init)
    out = [("push_embedding_table_infos", model)]
    for version in range(pushes):
        request = pb.PushGradientsRequest()
        request.gradients.version = version
        for name, dim, _ in TABLES:
            ids = np.unique(rng.randint(0, 200, size=24)).astype(np.int64)
            serialize_indexed_slices(
                rng.randn(ids.size, dim).astype(np.float32), ids,
                request.gradients.embedding_tables[name])
        out.append(("push_gradients", request))
        if version == 3:
            rows = pb.Model()
            ids = np.arange(300, 306, dtype=np.int64)
            serialize_indexed_slices(rng.randn(6, 4).astype(np.float32), ids,
                                     rows.embedding_tables["t"])
            out.append(("push_embedding_rows", rows))
    pull = pb.BatchedSlices()
    for name, _, _ in TABLES:
        pull.tables[name].ids_blob = pack_ids(np.arange(400, 410))
    out.append(("pull_embedding_batch", pull))
    return out


@pytest.mark.parametrize("kind", ["numpy", "native"])
def test_sigterm_ps_restores_its_pre_stop_state_bit_for_bit(tmp_path, kind):
    # held across the SIGTERM and the relaunch on the same port
    reservation, port = reserve_port()
    ckpt_dir = str(tmp_path / "ckpt")
    logs = [str(tmp_path / "ps.log"), str(tmp_path / "ps-relaunch.log")]
    flags = ("--use_async", "1",
             "--use_native_store", "1" if kind == "native" else "0")
    replica_store = embedding_store.create_store(
        seed=0, prefer_native=kind == "native")
    replica_store.set_optimizer("adam", lr=0.01)
    replica = PserverServicer(replica_store, ps_id=0,
                              staleness_modulation=False, use_async=True)
    procs = [_spawn_ps(port, ckpt_dir, logs[0], *flags)]
    try:
        text = _wait_serving(procs[0], logs[0], port)
        assert "(%s store, async)" % type(replica_store).__name__ in text
        stub = PserverStub(build_channel("localhost:%d" % port))
        for method, request in _requests():
            got = getattr(stub, method)(request, timeout=30)
            want = getattr(replica, method)(request)
            # deterministic: map fields (a pull answer's tables) in key
            # order; a map parsed off the wire serializes in an order of
            # this process's hashing, not the insertion order
            assert got.SerializeToString(deterministic=True) == (
                want.SerializeToString(deterministic=True))
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(timeout=60) == 0
        version = replica_store.version
        assert SparseCheckpointSaver.latest_version(ckpt_dir) == version == 7
        assert os.path.exists(os.path.join(
            ckpt_dir, "version-%d" % version, "embeddings-0-of-1.npz"))
        restored = embedding_store.create_store(
            seed=5, prefer_native=kind == "native")
        restored.set_optimizer("adam", lr=0.01)
        assert SparseCheckpointSaver(ckpt_dir).restore(restored) == version
        for name, _, _ in TABLES:
            want, got = (s.export_table_full(name)
                         for s in (replica_store, restored))
            order_w, order_g = np.argsort(want[0]), np.argsort(got[0])
            for w, g in zip(want, got):
                np.testing.assert_array_equal(w[order_w], g[order_g])
        # the relaunch restores the same state by itself and stamps it
        procs.append(_spawn_ps(port, ckpt_dir, logs[1], *flags))
        _wait_serving(procs[1], logs[1], port)
        assert _restored(logs[1]) == version
        pull = pb.BatchedSlices()
        ids = np.arange(0, 410, dtype=np.int64)
        for name, _, _ in TABLES:
            pull.tables[name].ids_blob = pack_ids(ids)
        stub = PserverStub(build_channel("localhost:%d" % port))
        answer = stub.pull_embedding_batch(pull, timeout=30)
        assert answer.restored_version == version + 1
        for name, dim, _ in TABLES:
            resident = np.sort(replica_store.export_table_full(name)[0])
            served = np.frombuffer(answer.tables[name].content,
                                   np.float32).reshape(-1, dim)
            np.testing.assert_array_equal(
                served[resident], replica_store.lookup(name, resident))
        procs[1].send_signal(signal.SIGTERM)
        assert procs[1].wait(timeout=60) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        reservation.close()


def test_reserved_port_stays_out_of_other_binds_and_the_ps_binds_it(
        tmp_path):
    reservation, port = reserve_port()
    try:
        squatter = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        with pytest.raises(OSError):
            squatter.bind(("localhost", port))
        squatter.close()
        log_path = str(tmp_path / "ps.log")
        proc = _spawn_ps(port, str(tmp_path / "ckpt"), log_path)
        try:
            _wait_serving(proc, log_path, port)
            stub = PserverStub(build_channel("localhost:%d" % port))
            model = pb.Model()
            model.embedding_table_infos.add(name="t", dim=2,
                                            initializer="zeros")
            stub.push_embedding_table_infos(model, timeout=30)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    finally:
        reservation.close()


def test_ps_on_a_taken_port_exits_nonzero_naming_it(tmp_path):
    taken = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    taken.bind(("0.0.0.0", 0))
    taken.listen()
    port = taken.getsockname()[1]
    log_path = str(tmp_path / "ps.log")
    try:
        proc = _spawn_ps(port, str(tmp_path / "ckpt"), log_path)
        assert proc.wait(timeout=WAIT_S) != 0
        with open(log_path) as f:
            assert "PS 0 cannot bind port %d" % port in f.read()
    finally:
        taken.close()
