"""The port's streaming dispatcher (master/task_dispatcher.py stream
mode), stream feeder (stream/feeder.py) and the master's CommInfo
watermark, held against the reference on the CPU.

(a) the reference's scenarios of tests/test_stream.py on both packages:
the watermark and drain contract, journal replay with no window
re-minted, the deferred export when the stream closes on an empty queue,
the feeder's backlog flow control and export cadence; (b) parity: on
the same fake source, the same seeded schedule of feeder ticks, task
gets, reports and failures goes through both packages, and after every
operation the feeder's mint and export decisions, the tasks handed out,
``stream_state()`` and the journal's ops are equal.
"""

import importlib
import json
import os
import types

import numpy as np
import pytest

PACKAGES = {"ref": "elasticdl_tpu", "port": "elasticdl_tpu_torch"}


def modules(side):
    root = PACKAGES[side]

    def mod(name):
        return importlib.import_module("%s.%s" % (root, name))

    return types.SimpleNamespace(
        side=side,
        pb=mod("proto.elasticdl_tpu_pb2"),
        dispatcher=mod("master.task_dispatcher"),
        state_store=mod("master.state_store"),
        feeder=mod("stream.feeder"),
        source=mod("stream.source"),
        servicer=mod("master.servicer"),
    )


@pytest.fixture(params=sorted(PACKAGES))
def m(request):
    return modules(request.param)


def test_stream_dispatcher_watermark_and_drain_contract(m):
    td = m.dispatcher.TaskDispatcher({}, num_epochs=0, stream=True)
    assert not td.finished()
    for w in range(3):
        td.add_stream_window("w%d.rec" % w, 0, 100)
    assert td.stream_pos() == 3
    assert td.stream_watermark() == 0
    task = td.get(worker_id=1)
    td.report(task.task_id, True, worker_id=1)
    assert td.stream_watermark() == 100
    assert td.stream_state()["backlog_records"] == 200
    while True:
        task = td.get(worker_id=1)
        if task is None:
            break
        td.report(task.task_id, True, worker_id=1)
    assert not td.finished()
    td.close_stream()
    assert td.finished()
    with pytest.raises(RuntimeError):
        td.add_stream_window("late.rec", 0, 10)


def test_stream_journal_replay_no_reminted_windows(m, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("EDL_STATE_DIR", str(tmp_path))
    journal = m.state_store.MasterStateJournal.maybe_create()
    journal.load()
    td = m.dispatcher.TaskDispatcher({}, num_epochs=0,
                                     state_journal=journal, stream=True)
    for w in range(5):
        td.add_stream_window("w%d.rec" % w, 0, 64)
    for _ in range(2):
        task = td.get(worker_id=1)
        td.report(task.task_id, True, worker_id=1)
    journal2 = m.state_store.MasterStateJournal.maybe_create()
    recovered = journal2.load()
    assert recovered is not None
    td2 = m.dispatcher.TaskDispatcher({}, num_epochs=0,
                                      state_journal=journal2,
                                      recovered=recovered, stream=True)
    assert td2.stream_pos() == 5
    assert td2.stream_watermark() == 128
    shards = []
    while True:
        task = td2.get(worker_id=2)
        if task is None:
            break
        shards.append(task.shard_name)
        td2.report(task.task_id, True, worker_id=2)
    assert sorted(shards) == ["w2.rec", "w3.rec", "w4.rec"]
    assert td2.stream_watermark() == 5 * 64
    journal2.close()


def test_stream_close_fires_deferred_export_on_empty_queue(m):
    td = m.dispatcher.TaskDispatcher({}, num_epochs=0, stream=True)
    td.add_deferred_callback_create_train_end_task(
        {"saved_model_path": "/tmp/m"})
    td.add_stream_window("w0.rec", 0, 10)
    task = td.get(worker_id=1)
    td.report(task.task_id, True, worker_id=1)
    assert td.get(worker_id=1) is None
    assert not td.finished()
    td.close_stream()
    task = td.get(worker_id=1)
    assert task is not None and task.type == m.pb.TRAIN_END_CALLBACK
    td.report(task.task_id, True, worker_id=1)
    assert td.finished()


class ListSource:
    """A fake source of ``n`` windows of ``size`` records."""

    def __init__(self, m, n, size=100):
        self._window = m.source.StreamWindow
        self._n = n
        self._size = size
        self._pos = 0

    @property
    def exhausted(self):
        return self._pos >= self._n

    def seek(self, pos):
        self._pos = pos

    def next_window(self):
        if self.exhausted:
            return None
        window = self._window("w%d.rec" % self._pos, 0, self._size)
        self._pos += 1
        return window


def test_feeder_backlog_flow_control_and_export_cadence(m):
    td = m.dispatcher.TaskDispatcher({}, num_epochs=0, stream=True)
    feeder = m.feeder.StreamFeeder(
        td, ListSource(m, 10), saved_model_path="/tmp/model",
        export_every=300, max_backlog_records=250)
    feeder._source.seek(td.stream_pos())
    assert feeder.tick() == 3
    assert td.stream_state()["backlog_records"] == 300
    for _ in range(2):
        task = td.get(worker_id=1)
        td.report(task.task_id, True, worker_id=1)
    assert feeder.tick() >= 2
    assert feeder._exports_minted == 0
    drained = 0
    while drained < 2:
        task = td.get(worker_id=1)
        if task is None or task.type != m.pb.TRAINING:
            break
        td.report(task.task_id, True, worker_id=1)
        drained += 1
    feeder.tick()
    assert feeder._exports_minted == 1
    types_seen = []
    while True:
        task = td.get(worker_id=1)
        if task is None:
            break
        types_seen.append(task.type)
        if task.type == m.pb.TRAIN_END_CALLBACK:
            assert task.extended_config["saved_model_path"] == "/tmp/model"
        td.report(task.task_id, True, worker_id=1)
    assert m.pb.TRAIN_END_CALLBACK in types_seen
    state = feeder.state()
    assert state["exports_minted"] == 1 and state["open"]


def test_comm_info_carries_the_watermark(m):
    td = m.dispatcher.TaskDispatcher({}, num_epochs=0, stream=True)
    servicer = m.servicer.MasterServicer(td, None, None)
    request = m.pb.GetCommInfoRequest(worker_id=0)
    assert servicer.get_comm_info(request).stream_watermark == 0
    td.add_stream_window("w0.rec", 0, 77)
    task = td.get(worker_id=0)
    td.report(task.task_id, True, worker_id=0)
    assert servicer.get_comm_info(request).stream_watermark == 77


def test_source_from_env_reads_the_same_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("EDL_STREAM", "synthetic")
    monkeypatch.setenv("EDL_STREAM_WINDOW_RECORDS", "64")
    monkeypatch.setenv("EDL_STREAM_TOTAL_RECORDS", "640")
    monkeypatch.setenv("EDL_STREAM_FEATURES", "7")
    monkeypatch.setenv("EDL_STREAM_HOT_VOCAB", "900")
    monkeypatch.setenv("EDL_STREAM_DRIFT", "9")
    monkeypatch.setenv("EDL_STREAM_ZIPF_A", "1.4")
    monkeypatch.setenv("EDL_STREAM_SEED", "5")
    made = {}
    for side in PACKAGES:
        m = modules(side)
        source = m.feeder.source_from_env(str(tmp_path / side))
        made[side] = [source.window_examples(i) for i in range(3)]
        assert source.next_window().records == 64
    for got, want in zip(made["port"], made["ref"]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    monkeypatch.setenv("EDL_STREAM", "0")
    assert modules("port").feeder.source_from_env("x") is None
    monkeypatch.setenv("EDL_STREAM", "bogus")
    with pytest.raises(ValueError):
        modules("port").feeder.source_from_env("x")


def _journal_ops(path):
    ops = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".jsonl") or name.endswith(".ndjson"):
            with open(os.path.join(path, name)) as f:
                ops.extend(json.loads(line) for line in f if line.strip())
    # the wall-clock stamp is the only field two runs may not share
    for op in ops:
        op.pop("ts", None)
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mint_and_export_decisions_equal_across_packages(
        seed, tmp_path, monkeypatch):
    """A seeded schedule over 24 fake windows: feeder ticks, gets by
    two workers, successful and failed reports, a worker's tasks
    recovered, and the close. Both packages make the same decisions
    after every operation, and journal the same ops."""
    sides = {}
    for side in PACKAGES:
        m = modules(side)
        state_dir = tmp_path / side
        state_dir.mkdir()
        monkeypatch.setenv("EDL_STATE_DIR", str(state_dir))
        journal = m.state_store.MasterStateJournal.maybe_create()
        journal.load()
        td = m.dispatcher.TaskDispatcher({}, num_epochs=0,
                                         state_journal=journal,
                                         stream=True)
        td.add_deferred_callback_create_train_end_task(
            {"saved_model_path": "/tmp/model"})
        feeder = m.feeder.StreamFeeder(
            td, ListSource(m, 24, size=128), saved_model_path="/tmp/model",
            export_every=512, max_backlog_records=640)
        feeder._source.seek(td.stream_pos())
        sides[side] = (m, td, feeder, journal, state_dir)
    rng = np.random.RandomState(seed)
    held = {1: [], 2: []}
    trace = {side: [] for side in PACKAGES}
    for step in range(400):
        op = rng.randint(0, 10)
        worker = int(rng.randint(1, 3))
        fail = rng.rand() < 0.1
        for side, (m, td, feeder, _j, _d) in sides.items():
            if op < 3:
                result = ("tick", feeder.tick(), feeder._exports_minted)
            elif op < 6:
                task = td.get(worker_id=worker)
                result = ("get", None if task is None else (
                    task.task_id, task.type, task.shard_name))
                if side == "port" and task is not None:
                    held[worker].append(task.task_id)
            elif op < 9:
                queue = held[worker]
                if not queue:
                    result = ("idle",)
                else:
                    task_id = queue[0]
                    result = ("report", task_id, not fail,
                              td.report(task_id, not fail,
                                        worker_id=worker)[0])
            else:
                result = ("recover", td.recover_tasks(worker))
            if feeder._source.exhausted:
                td.close_stream()
            trace[side].append((result, td.stream_state(), td.finished()))
        if op in (6, 7, 8) and held[worker]:
            held[worker].pop(0)
        if op == 9:
            held[worker] = []
        assert trace["port"][-1] == trace["ref"][-1], step
    for side, (m, td, feeder, journal, _d) in sides.items():
        journal.close()
    ops = {side: _journal_ops(str(v[4])) for side, v in sides.items()}
    assert ops["port"] == ops["ref"]
    assert any(op.get("op") == "stream_window" for op in ops["port"])
