"""The port's master state journal (``elasticdl_tpu_torch/master/
state_store.py`` and the dispatcher's and servicer's journal calls)
against the JAX package's, on the CPU.

(a) the eight scenarios of tests/test_state_store.py on the port; (b)
the reference's and the port's dispatcher and servicer, each with a
journal in its own directory, driven through the same seeded operation
sequences (gets, successful and failed reports, uncounted hand-backs,
recoveries, evaluation passes, relaunch grants, version reports, the
train-end task, prediction shards and compactions) write the same
journal ops, line for line without the wall-clock ``ts``, and the same
snapshot; (c) each package's ``load`` of the other's journal and
snapshot (and of its own) gives the same recovered state, and
dispatchers resumed from them hand out the same tasks next; a torn
last line is skipped by both. The operations are drawn with numpy from
a seed; the wall clock is fixed so the servicers' epoch bases agree.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

from elasticdl_tpu.master import servicer as ref_servicer
from elasticdl_tpu.master import state_store as ref_store
from elasticdl_tpu.master import task_dispatcher as ref_disp
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as ref_pb
from elasticdl_tpu_torch.master import servicer
from elasticdl_tpu_torch.master import state_store
from elasticdl_tpu_torch.master import task_dispatcher
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.state_store import MasterStateJournal
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

SHARDS = {"f0": (0, 256)}  # 4 tasks at 64 records each

PACKAGES = {
    "ref": (ref_disp, ref_servicer, ref_store, ref_pb),
    "port": (task_dispatcher, servicer, state_store, pb),
}


# ---------------------------------------------------------------------
# (a) the scenarios of tests/test_state_store.py


def make_dispatcher(journal, recovered=None, num_epochs=1):
    return TaskDispatcher(
        training_shards=SHARDS,
        records_per_task=64,
        num_epochs=num_epochs,
        seed=0,
        state_journal=journal,
        recovered=recovered,
    )


def reload_journal(tmp_path):
    journal = MasterStateJournal(str(tmp_path))
    recovered = journal.load()
    return journal, recovered


def drain(dispatcher, worker_id=9):
    """Complete every remaining task; returns the completed ids."""
    done = []
    while True:
        task = dispatcher.get(worker_id)
        if task is None:
            break
        dispatcher.report(task.task_id, True, worker_id=worker_id)
        done.append(task.task_id)
    return done


def test_fresh_boot_returns_none(tmp_path):
    journal = MasterStateJournal(str(tmp_path))
    assert journal.load() is None
    assert journal.master_epoch == 1


def test_replay_resumes_mid_epoch_no_task_lost_or_doubled(tmp_path):
    journal = MasterStateJournal(str(tmp_path))
    journal.load()
    dispatcher = make_dispatcher(journal)
    first = dispatcher.get(1)
    dispatcher.report(first.task_id, True, worker_id=1)
    second = dispatcher.get(1)
    dispatcher.report(second.task_id, True, worker_id=1)
    inflight = dispatcher.get(1)
    journal.close()  # the crash: nothing else flushed

    journal2, recovered = reload_journal(tmp_path)
    assert recovered is not None
    assert journal2.master_epoch == 2
    dispatcher2 = make_dispatcher(journal2, recovered=recovered)
    stats = dispatcher2.stats()
    assert stats["done"]["training"] == 2
    assert stats["queue_depth"]["training"] == 2  # 1 untouched + 1 requeued
    completed = drain(dispatcher2)
    assert inflight.task_id in completed
    assert first.task_id not in completed and second.task_id not in completed
    assert dispatcher2.finished()
    assert len(set(completed)) == len(completed)
    assert stats["done"]["training"] + len(completed) == 4


def test_pre_restart_assignee_completion_accepted_once(tmp_path):
    journal = MasterStateJournal(str(tmp_path))
    journal.load()
    dispatcher = make_dispatcher(journal)
    held = dispatcher.get(7)
    journal.close()

    journal2, recovered = reload_journal(tmp_path)
    dispatcher2 = make_dispatcher(journal2, recovered=recovered)
    dispatcher2.report(held.task_id, True, worker_id=7)
    assert dispatcher2.stats()["done"]["training"] == 1
    dispatcher2.report(held.task_id, True, worker_id=7)  # stale
    assert dispatcher2.stats()["done"]["training"] == 1
    remaining = drain(dispatcher2)
    assert held.task_id not in remaining
    assert dispatcher2.finished()


def test_requeued_task_redispatch_makes_old_report_stale(tmp_path):
    journal = MasterStateJournal(str(tmp_path))
    journal.load()
    dispatcher = make_dispatcher(journal)
    held = dispatcher.get(7)
    journal.close()

    journal2, recovered = reload_journal(tmp_path)
    dispatcher2 = make_dispatcher(journal2, recovered=recovered)
    assigned = {}
    while True:
        task = dispatcher2.get(8)
        if task is None:
            break
        assigned[task.task_id] = task
    assert held.task_id in assigned
    dispatcher2.report(held.task_id, True, worker_id=7)  # stale, ignored
    assert dispatcher2.stats()["done"].get("training", 0) == 0
    for task_id in assigned:
        dispatcher2.report(task_id, True, worker_id=8)
    assert dispatcher2.stats()["done"]["training"] == 4
    assert dispatcher2.finished()


def test_epoch_rollover_and_retry_counts_survive_restart(tmp_path):
    journal = MasterStateJournal(str(tmp_path))
    journal.load()
    dispatcher = make_dispatcher(journal, num_epochs=2)
    task = dispatcher.get(1)
    dispatcher.report(task.task_id, False, worker_id=1)
    journal.close()

    journal2, recovered = reload_journal(tmp_path)
    assert recovered["epochs_left"] == 1
    assert recovered["retries"].get(task.task_id) == 1
    dispatcher2 = make_dispatcher(journal2, recovered=recovered, num_epochs=2)
    completed = drain(dispatcher2)
    assert len(completed) == 8  # 4 first-epoch + 4 lazily created
    assert dispatcher2.finished()


def test_compaction_truncates_journal_and_replays_identically(tmp_path):
    journal = MasterStateJournal(str(tmp_path), compact_every=4)
    journal.load()
    dispatcher = make_dispatcher(journal)
    journal.register_section("dispatcher", dispatcher.export_state)
    done = drain(dispatcher, worker_id=3)
    assert len(done) == 4
    assert os.path.isfile(journal.snapshot_path)
    with open(journal.journal_path) as f:
        tail_lines = [line for line in f if line.strip()]
    assert len(tail_lines) < 9  # 1 boot + 4 dispatch + 4 done pre-compaction
    journal.close()

    journal2, recovered = reload_journal(tmp_path)
    dispatcher2 = make_dispatcher(journal2, recovered=recovered)
    assert dispatcher2.finished()
    assert dispatcher2.stats()["done"]["training"] == 4


def test_relaunch_epoch_base_reanchors_above_old_grants(tmp_path):
    journal = MasterStateJournal(str(tmp_path))
    journal.load()
    dispatcher = make_dispatcher(journal)
    servicer_ = MasterServicer(dispatcher, state_journal=journal)
    reply = servicer_.reset_worker(pb.GetTaskRequest(worker_id=0))
    old_epoch = reply.restart_count
    assert reply.master_epoch == journal.master_epoch
    journal.close()

    journal2, recovered = reload_journal(tmp_path)
    dispatcher2 = make_dispatcher(journal2, recovered=recovered)
    servicer2 = MasterServicer(
        dispatcher2, state_journal=journal2, recovered=recovered
    )
    reply2 = servicer2.reset_worker(pb.GetTaskRequest(worker_id=0))
    assert reply2.restart_count > old_epoch
    assert reply2.master_epoch != reply.master_epoch


def test_done_ops_in_journal_are_unique(tmp_path):
    journal = MasterStateJournal(str(tmp_path))
    journal.load()
    dispatcher = make_dispatcher(journal)
    drain(dispatcher)
    journal.close()
    done_ids = []
    with open(journal.journal_path) as f:
        for line in f:
            op = json.loads(line)
            if op["op"] == "done":
                done_ids.append(op["task"])
    assert len(done_ids) == len(set(done_ids)) == 4


# ---------------------------------------------------------------------
# (b) the same operations write the same journal


CONFIGS = {
    # name: dispatcher kwargs, train-end task, compact_every
    "train_eval_end": (dict(training_shards={"f": (0, 40), "g": (3, 17)},
                            evaluation_shards={"e": (0, 12)},
                            records_per_task=6, num_epochs=2, seed=5),
                       True, 512),
    "compacting": (dict(training_shards={"a": (0, 30), "b": (0, 30)},
                        evaluation_shards={"e": (0, 8)},
                        records_per_task=5, num_epochs=2, seed=1),
                   True, 16),
    "prediction": (dict(training_shards=None,
                        prediction_shards={"p": (0, 33), "q": (4, 20)},
                        records_per_task=7),
                   False, 512),
}
OPS = (["task"] * 8 + ["done"] * 6 + ["fail", "requeue", "recover",
                                       "reset", "version", "eval"])


@pytest.fixture
def fixed_clock(monkeypatch):
    """The servicers' epoch base is the startup wall clock: fix it so
    both packages' servicers journal the same base."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def _build(side, directory, config, recovered=None, journal=None):
    disp, srv, store, mod = PACKAGES[side]
    kwargs, train_end, compact_every = CONFIGS[config]
    if journal is None:
        journal = store.MasterStateJournal(str(directory),
                                           compact_every=compact_every)
        recovered = journal.load()
    dispatcher = disp.TaskDispatcher(state_journal=journal,
                                     recovered=recovered, **kwargs)
    if train_end:
        dispatcher.add_deferred_callback_create_train_end_task(
            {"saved_model_path": "/export"})
    master = srv.MasterServicer(dispatcher, state_journal=journal,
                                recovered=recovered)
    journal.register_section("dispatcher", dispatcher.export_state)
    journal.register_section("workers", master.export_worker_state)
    return journal, dispatcher, master, mod


def _task(task):
    return (task.task_id, task.type, task.shard_name, task.start,
            task.end, task.model_version, task.master_epoch, task.draining)


def _step(dispatcher, master, mod, op, worker, pick):
    """One operation through the servicer (the dispatcher directly for
    recoveries and evaluation passes); the task a report names is
    picked from the dispatcher's doing set in task-id order."""
    if op == "task":
        return _task(master.get_task(mod.GetTaskRequest(worker_id=worker)))
    if op == "reset":
        return master.reset_worker(
            mod.GetTaskRequest(worker_id=worker)).restart_count
    if op == "version":
        return master.report_version(
            mod.ReportVersionRequest(model_version=pick)).SerializeToString()
    if op == "recover":
        return dispatcher.recover_tasks(worker)
    if op == "eval":
        return dispatcher.create_evaluation_tasks(model_version=pick)
    doing = sorted(dispatcher.doing_tasks().items())
    if not doing:
        return None
    task_id, (holder, _) = doing[pick % len(doing)]
    message = {"done": "", "fail": "boom",
               "requeue": "requeue: stream closed"}[op]
    master.report_task_result(mod.ReportTaskResultRequest(
        task_id=task_id, worker_id=holder, err_message=message))
    return task_id


def _ops(journal):
    """The journal's ops without the wall-clock ``ts``."""
    ops = []
    with open(journal.journal_path) as f:
        for line in f:
            op = json.loads(line)
            op.pop("ts")
            ops.append(op)
    return ops


def _snapshot(journal):
    if not os.path.isfile(journal.snapshot_path):
        return None
    with open(journal.snapshot_path) as f:
        payload = json.load(f)
    payload.pop("saved_at")
    return payload


def _drive(tmp_path, config, seed, n_ops=160):
    """Both packages through one seeded sequence; returns their
    directories, after checking every answer, the journals and the
    snapshots are equal."""
    sides = {}
    for side in PACKAGES:
        directory = tmp_path / side
        sides[side] = (directory,) + _build(side, directory, config)
    rng = np.random.RandomState(seed)
    for step in range(n_ops):
        op, worker, pick = (OPS[rng.randint(len(OPS))],
                            int(rng.randint(3)), int(rng.randint(1, 60)))
        answers = [_step(*sides[side][2:], op, worker, pick)
                   for side in PACKAGES]
        assert answers[0] == answers[1], (step, op)
    journals = [sides[side][1] for side in PACKAGES]
    ref_ops, port_ops = (_ops(j) for j in journals)
    assert port_ops == ref_ops
    assert _snapshot(journals[1]) == _snapshot(journals[0])
    for journal in journals:
        journal.close()
    return ref_ops, {side: sides[side][0] for side in PACKAGES}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_journal_ops_match_reference_line_for_line(tmp_path, fixed_clock,
                                                   config, seed):
    ops, dirs = _drive(tmp_path, config, seed)
    kinds = {op["op"] for op in ops}
    assert {"dispatch", "done"} <= kinds
    if config == "compacting":
        # the journal was truncated behind a snapshot
        assert ops[0]["seq"] > 1
        assert os.path.isfile(os.path.join(str(dirs["port"]),
                                           state_store.SNAPSHOT_NAME))
    else:
        assert {"master_restarted", "epoch_base", "tasks_created",
                "requeue", "grant", "version"} <= kinds


def _load(side, directory, copy_to):
    """``side``'s load of a copy of ``directory``."""
    shutil.copytree(str(directory), str(copy_to))
    journal = PACKAGES[side][2].MasterStateJournal(str(copy_to))
    return journal, journal.load()


def _normal(state):
    return json.loads(json.dumps(state, sort_keys=True))


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_each_package_loads_the_others_journal_to_the_same_state(
        tmp_path, fixed_clock, config, seed):
    _, dirs = _drive(tmp_path, config, seed, n_ops=24)
    loaded = {}
    for writer, directory in dirs.items():
        for reader in PACKAGES:
            loaded[writer, reader] = _load(
                reader, directory, tmp_path / ("%s-by-%s" % (writer, reader)))
    states = {key: _normal(state) for key, (_, state) in loaded.items()}
    first = states["ref", "ref"]
    assert first is not None
    for key, state in states.items():
        assert state == first, key
    assert len({j.master_epoch for j, _ in loaded.values()}) == 1
    # dispatchers resumed across the packages hand out the same tasks
    # (the train-end task registered again, as a relaunched master does)
    resumed = {}
    for writer, reader in (("port", "ref"), ("ref", "port")):
        journal, state = loaded[writer, reader]
        resumed[reader] = _build(reader, None, config, recovered=state,
                                 journal=journal)
    for worker in (0, 1):
        answers = [resumed[side][2].reset_worker(
            resumed[side][3].GetTaskRequest(worker_id=worker)).restart_count
            for side in ("ref", "port")]
        assert answers[0] == answers[1]
    count = 0
    while True:
        handed = [_step(*resumed[side][1:], "task", 1, 0)
                  for side in ("ref", "port")]
        assert handed[0] == handed[1]
        if handed[0][0] == 0:
            break
        count += 1
        for side in ("ref", "port"):
            _step(*resumed[side][1:], "done", 1, 0)
    assert count > 0
    for side in ("ref", "port"):
        assert resumed[side][1].finished() or resumed[side][1].job_failed()
        resumed[side][0].close()
    ref_tail, port_tail = (_ops(resumed[side][0]) for side in ("ref", "port"))
    assert port_tail == ref_tail
    if CONFIGS[config][1]:
        # one train-end task across both lifetimes
        created = [task for op in ref_tail if op["op"] == "tasks_created"
                   for task in op["tasks"]
                   if task[1] == pb.TRAIN_END_CALLBACK]
        ends = [op for op in ref_tail if op["op"] == "done"
                and op["type"] == pb.TRAIN_END_CALLBACK]
        assert len(ends) == 1 and len(created) <= 1


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_a_torn_last_line_is_skipped_by_both(tmp_path, fixed_clock, writer):
    _, dirs = _drive(tmp_path, "train_eval_end", 7, n_ops=60)
    path = os.path.join(str(dirs[writer]), state_store.JOURNAL_NAME)
    with open(path, "a") as f:
        f.write('{"op": "done", "task": 3, "ty')  # SIGKILL mid-write
    states = [_normal(_load(reader, dirs[writer],
                            tmp_path / ("read-" + reader))[1])
              for reader in PACKAGES]
    assert states[0] == states[1] and states[0] is not None
