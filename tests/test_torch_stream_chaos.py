"""Streaming chaos on the port's roles as CPU processes: the three
scenarios of tests/test_stream_chaos.py.

- A lifecycle PS (``python -m elasticdl_tpu_torch.ps.server``) dies
  mid-stream, here through the fault injector's ``kill-once`` on a pull,
  and relaunches on its port and checkpoint directory: admitted rows
  restore trained, LFU-evicted rows stay tombstoned, the admission
  sketch re-anchors empty, so a novel id's first push is dropped.
- A PS with incremental checkpoints is SIGKILLed, its newest delta torn,
  a newer base torn and a stray ``.tmp`` left: the relaunch serves the
  newest complete chain prefix bit for bit (an offline restore of the
  doctored directory), and a SIGTERM drain then lands a full base at
  the final version.
- A streaming master (``python -m elasticdl_tpu_torch.master.main`` with
  ``EDL_STREAM=synthetic`` and ``EDL_STATE_DIR``) is SIGKILLed
  mid-stream: the relaunch replays the journal, seeks the source to the
  journaled position and finishes, every window minted exactly once
  across both lifetimes and the watermark covering every record.

Every wait has its own bound (``WAIT_S``).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import grpc
import numpy as np
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
from elasticdl_tpu_torch.proto.services import (
    PserverStub,
    add_pserver_servicer_to_server,
)
from elasticdl_tpu_torch.ps.checkpoint import SparseCheckpointSaver
from elasticdl_tpu_torch.ps.embedding_store import NumpyEmbeddingStore
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.worker import master_client
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.ps_client import PSClient
from elasticdl_tpu_torch.worker.worker import Worker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120
LIFECYCLE_KNOBS = ("EDL_EMB_ADMIT_K", "EDL_EMB_MAX_ROWS", "EDL_EMB_TTL_SECS",
                   "EDL_EMB_SWEEP_SECS", "EDL_FAULT_SPEC")


def _spawn_ps(port, log_path, extra=(), env=None):
    """Shard 0 of 1, async, sgd lr 1.0, seed 0, numpy store."""
    with open(log_path, "a") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.ps.server",
             "--ps_id", "0", "--num_ps_pods", "1", "--port", str(port),
             "--opt_type", "sgd", "--opt_args", "lr=1.0",
             "--use_async", "1", "--seed", "0", "--use_native_store", "0",
             *extra],
            cwd=REPO, env=dict(env or os.environ, PYTHONPATH=REPO,
                               OMP_NUM_THREADS="1"),
            stdout=out, stderr=subprocess.STDOUT)


def _wait_serving(proc, log_path, port, after=0):
    deadline = time.monotonic() + WAIT_S
    while True:
        with open(log_path) as f:
            text = f.read()[after:]
        if "serving on :%d " % port in text:
            return
        assert proc.poll() is None, text[-3000:]
        assert time.monotonic() < deadline, text[-3000:]
        time.sleep(0.1)


def _clean_env(**knobs):
    env = {k: v for k, v in os.environ.items() if k not in LIFECYCLE_KNOBS}
    env.update(knobs)
    return env


def test_ps_killed_midstream_restores_and_reanchors_the_lifecycle(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    log_path = str(tmp_path / "ps.log")
    held, port = reserve_port()
    extra = ("--checkpoint_dir", ckpt_dir, "--checkpoint_steps", "3")
    lifecycle = dict(EDL_EMB_ADMIT_K="2", EDL_EMB_MAX_ROWS="6",
                     EDL_EMB_SWEEP_SECS="0.3")
    # the fifth pull kills the PS inside its handler, before it runs
    proc = _spawn_ps(port, log_path, extra, _clean_env(
        EDL_FAULT_SPEC="ps-0:pull_embedding_vectors:kill-once:5",
        **lifecycle))
    hot = np.arange(4, dtype=np.int64)
    cold = np.arange(10, 16, dtype=np.int64)
    client = client2 = None
    try:
        _wait_serving(proc, log_path, port)
        client = PSClient(["localhost:%d" % port], worker_id=0)
        client.push_embedding_table_infos([("t", 4, "zeros")])

        def push(c, ids, value=0.5):
            grads = {"t": (np.full((ids.size, 4), value, np.float32), ids)}
            assert c.push_gradients(grads, model_version=0).accepted

        for _ in range(6):
            push(client, hot)
        for _ in range(2):
            push(client, cold)
        # pulls 1 and 2
        assert not np.allclose(client.pull_embedding_vectors("t", hot), 0)
        assert not np.allclose(client.pull_embedding_vectors("t", cold), 0)
        # resident 10 > 6: a sweep LFU-evicts the four coldest rows
        # (pull 3 sees them gone)
        time.sleep(1.5)
        assert np.allclose(client.pull_embedding_vectors("t", cold)[:4], 0)
        for _ in range(4):
            push(client, hot)
        deadline = time.monotonic() + WAIT_S
        while (SparseCheckpointSaver.latest_version(ckpt_dir) or 0) < 9:
            assert time.monotonic() < deadline, "no post-sweep checkpoint"
            time.sleep(0.2)
        # pull 4, then pull 5 dies with the process
        assert (client.pull_embedding_vectors("t", hot) < 0).all()
        channel = grpc.insecure_channel("localhost:%d" % port)
        request = pb.PullEmbeddingVectorsRequest(name="t")
        request.ids_blob = hot.astype("<i8").tobytes()
        with pytest.raises(grpc.RpcError):
            PserverStub(channel).pull_embedding_vectors(request, timeout=10)
        channel.close()
        assert proc.wait(timeout=WAIT_S) == -signal.SIGKILL
        with open(log_path) as f:
            assert "fault injection: SIGKILL self on " \
                   "pull_embedding_vectors" in f.read()
        size = os.path.getsize(log_path)
        proc = _spawn_ps(port, log_path, extra, _clean_env(**lifecycle))
        _wait_serving(proc, log_path, port, after=size)
        client2 = PSClient(["localhost:%d" % port], worker_id=1)
        client2.push_embedding_table_infos([("t", 4, "zeros")])
        # no lost admitted rows: restored trained, served at once
        restored_hot = client2.pull_embedding_vectors("t", hot)
        assert not np.allclose(restored_hot, 0) and (restored_hot <= 0).all()
        # no phantom rows: the tombstones did not resurrect
        assert np.allclose(client2.pull_embedding_vectors("t", cold[:4]), 0)
        # the sketch restarted empty: a novel id's first push is
        # dropped, its pull (the second sighting) shows no trace of it
        novel = np.array([999], np.int64)
        grads = {"t": (np.full((1, 4), 0.5, np.float32), novel)}
        client2.push_gradients(grads, model_version=0)
        assert np.allclose(client2.pull_embedding_vectors("t", novel), 0)
        for _ in range(4):
            client2.push_gradients(grads, model_version=0)
            if not np.allclose(client2.pull_embedding_vectors("t", novel),
                               0):
                break
        assert not np.allclose(client2.pull_embedding_vectors("t", novel),
                               0), "novel id never re-admitted"
        with open(log_path) as f:
            text = f.read()
        assert "lifecycle re-anchored on restored store" in text
    finally:
        for c in (client, client2):
            if c is not None:
                c.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
        held.close()


def test_ps_sigkill_torn_chain_restores_newest_complete_then_sigterm_full_save(
        tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    log_path = str(tmp_path / "ps.log")
    held, port = reserve_port()
    extra = ("--checkpoint_dir", str(ckpt_dir), "--checkpoint_steps", "2")
    env = _clean_env(EDL_CKPT_COMPACT_EVERY="6")
    proc = _spawn_ps(port, log_path, extra, env)
    ids = np.arange(8, dtype=np.int64)
    client = client2 = None
    try:
        _wait_serving(proc, log_path, port)
        client = PSClient(["localhost:%d" % port], worker_id=0)
        client.push_embedding_table_infos([("t", 4, "zeros")])

        def push(c, value=0.25):
            grads = {"t": (np.full((ids.size, 4), value, np.float32), ids)}
            assert c.push_gradients(grads, model_version=0).accepted

        for _ in range(8):
            push(client)
        deadline = time.monotonic() + WAIT_S
        while (SparseCheckpointSaver.latest_version(str(ckpt_dir))
               or 0) < 4:
            assert time.monotonic() < deadline, "no delta chain landed"
            time.sleep(0.2)
        chains = sorted(d for d in os.listdir(str(ckpt_dir))
                        if d.startswith("version-"))
        assert any(f.startswith("delta-")
                   for f in os.listdir(str(ckpt_dir / chains[0])))
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        # the crash windows: a torn newest delta, a torn newer base, a
        # stray .tmp of the atomic writer
        vdir = ckpt_dir / chains[-1]
        newest = sorted((f for f in os.listdir(str(vdir))
                         if f.startswith("delta-")),
                        key=lambda f: int(f.split("-")[1]))[-1]
        torn = vdir / newest
        torn.write_bytes(torn.read_bytes()[:100])
        comp = ckpt_dir / "version-9999"
        comp.mkdir()
        (comp / "embeddings-0-of-1.npz").write_bytes(b"torn-base")
        (vdir / "delta-99-embeddings-0-of-1.npz.tmp").write_bytes(b"x")
        offline = NumpyEmbeddingStore(seed=0)
        offline.set_optimizer("sgd", lr=1.0)
        assert SparseCheckpointSaver(str(ckpt_dir)).restore(offline) \
            is not None
        expected = offline.lookup("t", ids)
        assert not np.allclose(expected, 0)
        size = os.path.getsize(log_path)
        proc = _spawn_ps(port, log_path, extra, env)
        _wait_serving(proc, log_path, port, after=size)
        client2 = PSClient(["localhost:%d" % port], worker_id=1)
        client2.push_embedding_table_infos([("t", 4, "zeros")])
        np.testing.assert_array_equal(
            client2.pull_embedding_vectors("t", ids), expected)
        for _ in range(3):
            push(client2, value=0.125)
        final_rows = client2.pull_embedding_vectors("t", ids)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, "SIGTERM drain failed"
        final = SparseCheckpointSaver.latest_version(str(ckpt_dir))
        assert (ckpt_dir / ("version-%d" % final)
                / "embeddings-0-of-1.npz").exists()
        offline2 = NumpyEmbeddingStore(seed=0)
        offline2.set_optimizer("sgd", lr=1.0)
        assert SparseCheckpointSaver(str(ckpt_dir)).restore(offline2) \
            == final
        np.testing.assert_array_equal(offline2.lookup("t", ids), final_rows)
    finally:
        for c in (client, client2):
            if c is not None:
                c.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
        held.close()


def _journal(state_dir):
    """Snapshot plus journal tail, as a relaunch replays them, and the
    tail's raw ops."""
    store = state_store.MasterStateJournal(state_dir)
    state, _, seq = store._read_snapshot()
    ops, _, _ = store._read_journal(seq)
    state = state if state is not None else state_store.empty_state()
    for op in ops:
        state_store.apply_op(state, op)
    return state, ops


def test_master_sigkill_midstream_resumes_watermark_no_reminted_windows(
        tmp_path, monkeypatch):
    state_dir, events_dir, spool_dir = (str(tmp_path / d) for d in
                                        ("state", "events", "spool"))
    for d in (state_dir, events_dir, spool_dir):
        os.makedirs(d)
    total, window = 3072, 128
    env = dict(_clean_env(), PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               EDL_STATE_DIR=state_dir, EDL_EVENTS_DIR=events_dir,
               EDL_STREAM="synthetic", EDL_STREAM_TOTAL_RECORDS=str(total),
               EDL_STREAM_WINDOW_RECORDS=str(window),
               EDL_STREAM_FEATURES="6", EDL_STREAM_HOT_VOCAB="400",
               EDL_STREAM_DRIFT="20", EDL_STREAM_MAX_BACKLOG="512")
    monkeypatch.setattr(master_client, "MASTER_RETRY_BUDGET_SECS", 60.0)
    held, master_port = reserve_port()

    def spawn_master(tag):
        with open(str(tmp_path / ("master-%s.log" % tag)), "w") as log:
            return subprocess.Popen(
                [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
                 "--model_zoo", "elasticdl_tpu_torch.models.deepfm",
                 "--training_data", spool_dir,
                 "--records_per_task", str(window), "--num_epochs", "1",
                 "--port", str(master_port), "--task_timeout_secs", "60"],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)

    # the worker's PS: one in-process shard
    store = NumpyEmbeddingStore(seed=0)
    store.set_optimizer("adam", lr=0.01)
    ps_server = build_server()
    add_pserver_servicer_to_server(PserverServicer(store), ps_server)
    ps_port = find_free_port()
    ps_server.add_insecure_port("localhost:%d" % ps_port)
    ps_server.start()
    master = spawn_master("first")
    runner = None
    try:
        mc = MasterClient("localhost:%d" % master_port, worker_id=0)
        mc.reset_worker()
        worker = Worker(mc, "elasticdl_tpu_torch.models.deepfm",
                        RecordIODataReader(data_dir=spool_dir),
                        minibatch_size=32, wait_sleep_secs=0.1,
                        ps_addrs=["localhost:%d" % ps_port], device="cpu")
        runner = threading.Thread(target=worker.run, daemon=True)
        runner.start()
        deadline = time.monotonic() + WAIT_S
        while True:
            _, ops = _journal(state_dir)
            if sum(1 for op in ops if op.get("op") == "done"
                   and op.get("records")) >= 3:
                break
            assert time.monotonic() < deadline, "no progress before kill"
            time.sleep(0.1)
        master.send_signal(signal.SIGKILL)
        master.wait(timeout=30)
        time.sleep(1.0)
        master = spawn_master("relaunch")
        try:
            rc = master.wait(timeout=240)
        except subprocess.TimeoutExpired:
            master.kill()
            raise AssertionError(open(str(
                tmp_path / "master-relaunch.log")).read()[-4000:])
        assert rc == 0, open(str(tmp_path / "master-relaunch.log")).read()[
            -4000:]
        runner.join(timeout=WAIT_S)
        assert not runner.is_alive(), "worker never finished"
    finally:
        if master.poll() is None:
            master.kill()
            master.wait(timeout=15)
        ps_server.stop(0)
        held.close()
    state, _ = _journal(state_dir)
    windows = total // window
    assert state["stream"] == {"open": False, "pos": windows,
                               "minted_records": total,
                               "done_records": total}
    assert state["done_counts"].get(pb.TRAINING) == windows
    assert not [t for t in state["tasks"].values()
                if int(t[1]) == pb.TRAINING]
    # both lifetimes' journals: every window file minted once
    minted = []
    for name in sorted(os.listdir(events_dir)):
        if name.endswith(".events.ndjson"):
            with open(os.path.join(events_dir, name)) as f:
                minted.extend(json.loads(line) for line in f if line.strip())
    boots = [e for e in minted if e.get("event") == "master_restarted"]
    assert len(boots) == 1
    spool = sorted(f for f in os.listdir(spool_dir) if f.endswith(".rec"))
    assert spool == ["stream-%08d.rec" % i for i in range(windows)]
