"""The train-end task on the port, on the CPU: the dispatcher's deferred
TRAIN_END_CALLBACK task and prediction shards against the reference's
(tests/test_task_dispatcher.py's ``test_train_end_callback_task_created_
after_last_epoch`` and ``test_prediction_only_job``, then seeded
operation sequences through both dispatchers compared after every
operation), and the worker's side of it (tests/test_worker_distributed
.py's ``test_output_exports_without_declared_callbacks``,
``test_stateless_worker_restores_checkpoint_for_export`` and
``test_worker_checkpoint_resume_and_fatal_restore``) on DeepFM over
in-process PS servicers. Small sizes (10 id fields, vocab 1000, batch
32); data made with numpy from a seed. The export a port worker writes
loads in the reference's ``load_exported`` under the reference's flax
names, array for array.
"""

import os

import numpy as np
import pytest
import torch

from elasticdl_tpu.master import task_dispatcher as ref_disp
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as ref_pb
from elasticdl_tpu.train import export as ref_export
from elasticdl_tpu_torch.common.grpc_utils import build_server, find_free_port
from elasticdl_tpu_torch.data.readers import RecordIODataReader
from elasticdl_tpu_torch.master import task_dispatcher
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.services import add_master_servicer_to_server
from elasticdl_tpu_torch.train.checkpoint import DenseCheckpointManager
from elasticdl_tpu_torch.train.export import load_exported
from elasticdl_tpu_torch.worker import master_client
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.worker import CheckpointRestoreError, Worker
from tests.test_torch_job import (
    PORT_ZOO,
    _ctr_dirs,
    _join,
    _master,
    _ps_pair,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _short_master_retry(monkeypatch):
    """A worker that polls a master which already stopped reads the job
    as over after 5 s, not the deployment's 120 s relaunch window."""
    monkeypatch.setattr(master_client, "MASTER_RETRY_BUDGET_SECS", 5.0)


# ---------------------------------------------------------------------
# the dispatcher, against the reference's


def _task(task):
    if task is None:
        return None
    return (task.task_id, task.type, task.shard_name, task.start, task.end,
            task.model_version, dict(task.extended_config))


def _observe(dispatcher):
    return (dispatcher.finished(), dispatcher.job_failed(),
            dispatcher.stats())


def _drain(dispatcher):
    tasks = []
    while True:
        task = dispatcher.get(0)
        if task is None:
            return tasks
        tasks.append(task)


def _both(**kwargs):
    return (ref_disp.TaskDispatcher(**kwargs),
            task_dispatcher.TaskDispatcher(**kwargs))


def test_train_end_callback_task_created_after_last_epoch():
    for d in _both(training_shards={"f1": (0, 10), "f2": (0, 10)},
                   evaluation_shards={"e1": (0, 10)}, records_per_task=3,
                   num_epochs=1, seed=0):
        d.add_deferred_callback_create_train_end_task(
            {"saved_model_path": "/tmp/m"})
        tasks = _drain(d)
        assert all(t.type == ref_pb.TRAINING for t in tasks)
        for t in tasks:
            assert not d.finished()
            d.report(t.task_id, True)
        end_task = d.get(0)
        assert end_task is not None
        assert end_task.type == ref_pb.TRAIN_END_CALLBACK
        assert end_task.extended_config["saved_model_path"] == "/tmp/m"
        assert not d.finished()
        d.report(end_task.task_id, True)
        assert d.finished()
        assert d.stats()["done"]["train_end_callback"] == 1
        # registered again after it ran: no second train-end task
        d.add_deferred_callback_create_train_end_task({})
        assert d.get(0) is None and d.finished()


def test_prediction_only_job():
    ref, port = _both(training_shards={}, prediction_shards={"p": (0, 7)},
                      records_per_task=3, num_epochs=1)
    r_tasks, p_tasks = _drain(ref), _drain(port)
    assert len(p_tasks) == 3
    assert all(t.type == pb.PREDICTION for t in p_tasks)
    assert [_task(t) for t in p_tasks] == [_task(t) for t in r_tasks]
    for r, p in zip(r_tasks, p_tasks):
        assert not port.finished()
        ref.report(r.task_id, True)
        port.report(p.task_id, True)
    assert port.finished() and ref.finished()
    assert _observe(port) == _observe(ref)


CONFIGS = {
    # name: (dispatcher kwargs, register a train-end task)
    "train_end_two_epochs": (dict(
        training_shards={"a": (0, 10), "b": (3, 9)},
        evaluation_shards={"e": (0, 6)}, records_per_task=4, num_epochs=2,
        seed=1, max_task_retries=2), True),
    "train_end_unshuffled": (dict(
        training_shards={"x": (0, 12)}, records_per_task=5, num_epochs=1,
        shuffle=False, max_task_retries=3), True),
    "prediction_only": (dict(
        training_shards={}, prediction_shards={"p": (0, 11), "q": (2, 7)},
        records_per_task=3, num_epochs=1, max_task_retries=3), False),
    "prediction_with_output": (dict(
        training_shards={}, prediction_shards={"p": (0, 9)},
        records_per_task=2, num_epochs=1, max_task_retries=1), True),
}


def _script(seed, n_ops=300):
    rng = np.random.RandomState(seed)
    kinds = (["get"] * 8 + ["done"] * 7 + ["fail", "requeue", "stale",
                                           "recover", "eval", "fire"])
    return [(kinds[rng.randint(len(kinds))], int(rng.randint(3)),
             int(rng.randint(1 << 30))) for _ in range(n_ops)]


def _apply(dispatcher, op, worker, pick):
    doing = sorted(dispatcher.doing_tasks().items())
    if op == "get":
        return _task(dispatcher.get(worker))
    if op == "eval":
        return dispatcher.create_evaluation_tasks(model_version=pick % 50)
    if op == "recover":
        return dispatcher.recover_tasks(worker)
    if op == "fire":
        return dispatcher.fire_deferred_callbacks()
    if not doing:
        return None
    task_id, (holder, _) = doing[pick % len(doing)]
    if op == "done":
        ok, task = dispatcher.report(task_id, True, worker_id=holder)
    elif op == "fail":
        ok, task = dispatcher.report(task_id, False, worker_id=holder)
    elif op == "requeue":
        ok, task = dispatcher.report(task_id, False, worker_id=holder,
                                     count_failure=False)
    else:
        ok, task = dispatcher.report(task_id, True, worker_id=holder + 10)
    return ok, _task(task)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_dispatcher_sequence_with_train_end_matches_reference(config, seed):
    kwargs, output = CONFIGS[config]
    ref, port = _both(**kwargs)
    if output:
        for d in (ref, port):
            d.add_deferred_callback_create_train_end_task(
                {"saved_model_path": "/out/%s" % config})
    assert _observe(port) == _observe(ref)
    # "fire" (an early fire_deferred_callbacks) is rare: most sequences
    # reach the train-end task the regular way
    script = [(op, w, p) for op, w, p in _script(seed)
              if op != "fire" or p % 4 == 0]
    for op, worker, pick in script:
        assert _apply(port, op, worker, pick) == _apply(ref, op, worker,
                                                        pick), (op, worker)
        assert _observe(port) == _observe(ref), (op, worker)
    while True:
        r_task, p_task = ref.get(0), port.get(0)
        assert _task(p_task) == _task(r_task)
        if r_task is None:
            break
        assert port.report(p_task.task_id, True, worker_id=0)[0] == (
            ref.report(r_task.task_id, True, worker_id=0)[0])
    assert _observe(port) == _observe(ref)
    done = port.stats()["done"]
    if output and not port.job_failed():
        assert done.get("train_end_callback") == 1


# ---------------------------------------------------------------------
# the worker's side


def _worker(addr, data_dir, ps_addrs, **kwargs):
    return Worker(MasterClient(addr, worker_id=0), PORT_ZOO,
                  RecordIODataReader(data_dir=data_dir), minibatch_size=32,
                  wait_sleep_secs=0.1, ps_addrs=ps_addrs, device="cpu",
                  **kwargs)


def _assert_export_is_state(export_path, state):
    """The bundle loads in the reference's load_exported, array for
    array equal to the state's params under the flax names."""
    params, model_state, step = ref_export.load_exported(export_path)
    assert model_state == {} and step == int(state.step)
    flat = ref_export._flatten(params)
    want = deepfm.params_to_flax(state.params)
    assert sorted(flat) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(flat[name], want[name])


def test_output_exports_without_declared_callbacks(tmp_path):
    """--output exports a model that declares no callbacks (the default
    SavedModelExporter), after the last training task, once."""
    train_dir, _ = _ctr_dirs(tmp_path, sizes=(128,))
    export_path = str(tmp_path / "export")
    assert not hasattr(deepfm, "callbacks")
    master, addr, thread, result = _master(
        train_dir, saved_model_path=export_path, num_epochs=2)
    servers, ps_addrs = _ps_pair()
    try:
        worker = _worker(addr, train_dir, ps_addrs)
        worker.run()
        _join([thread])
        assert result["rc"] == 0
        stats = master.task_dispatcher.stats()
        assert stats["done"] == {"training": 2, "train_end_callback": 1}
        assert os.path.exists(os.path.join(export_path, "manifest.json"))
        assert worker.model_version == 8
        _assert_export_is_state(export_path, worker.state)
        # the port's loader reads it back too
        params, _, step = load_exported(export_path)
        assert step == 8 and sorted(params) == sorted(
            deepfm.params_to_flax(worker.state.params))
    finally:
        master.stop()
        for server in servers:
            server.stop(None)


def _train_with_checkpoints(tmp_path, ckpt_dir, ps_addrs, steps=2,
                            async_checkpoint=False):
    (tmp_path / "data").mkdir()
    train_dir, valid_dir = _ctr_dirs(tmp_path / "data", sizes=(128,))
    master, addr, thread, result = _master(train_dir, num_epochs=2)
    try:
        worker = _worker(addr, train_dir, ps_addrs,
                         checkpoint_dir=ckpt_dir, checkpoint_steps=steps,
                         async_checkpoint=async_checkpoint)
        worker.run()
        _join([thread])
        assert result["rc"] == 0
    finally:
        master.stop()
    return worker, train_dir, valid_dir


def test_stateless_worker_restores_checkpoint_for_export(tmp_path):
    """A relaunched worker that only ever sees the train-end task
    restores from the checkpoint and exports the TRAINED weights."""
    servers, ps_addrs = _ps_pair()
    ckpt_dir = str(tmp_path / "ckpt")
    try:
        trained, train_dir, _ = _train_with_checkpoints(tmp_path, ckpt_dir,
                                                        ps_addrs)
        assert DenseCheckpointManager(
            ckpt_dir, create=False).latest_version() == 8
        dispatcher = task_dispatcher.TaskDispatcher(
            training_shards={}, records_per_task=64, num_epochs=0)
        export_path = str(tmp_path / "export2")
        dispatcher.add_deferred_callback_create_train_end_task(
            {"saved_model_path": export_path})
        dispatcher.fire_deferred_callbacks()
        server = build_server()
        add_master_servicer_to_server(MasterServicer(dispatcher), server)
        port = find_free_port()
        server.add_insecure_port("localhost:%d" % port)
        server.start()
        try:
            worker = _worker("localhost:%d" % port, train_dir, ps_addrs,
                             checkpoint_dir_for_init=ckpt_dir,
                             resume_optional=True)
            worker.run()
            assert dispatcher.finished()
            assert worker.model_version == 8
            _assert_export_is_state(export_path, trained.state)
        finally:
            server.stop(None)
        # a worker with no state and no checkpoint fails the task, so a
        # worker that trained can take it
        dispatcher = task_dispatcher.TaskDispatcher(
            training_shards={}, records_per_task=64, num_epochs=0,
            max_task_retries=0)
        dispatcher.add_deferred_callback_create_train_end_task(
            {"saved_model_path": str(tmp_path / "export3")})
        dispatcher.fire_deferred_callbacks()
        server = build_server()
        add_master_servicer_to_server(MasterServicer(dispatcher), server)
        port = find_free_port()
        server.add_insecure_port("localhost:%d" % port)
        server.start()
        try:
            _worker("localhost:%d" % port, train_dir, ps_addrs,
                    checkpoint_dir_for_init=str(tmp_path / "empty"),
                    resume_optional=True).run()
            assert dispatcher.job_failed()
            assert not os.path.exists(str(tmp_path / "export3"))
        finally:
            server.stop(None)
    finally:
        for server in servers:
            server.stop(None)


def test_worker_checkpoint_resume_and_fatal_restore(tmp_path):
    """Save during a run; a fresh worker resumes from
    --checkpoint_dir_for_init (its version fast-forwards, its evaluation
    scores the resumed weights); an empty or missing restore directory
    is fatal and the job does not finish."""
    servers, ps_addrs = _ps_pair()
    ckpt_dir = str(tmp_path / "ckpt")
    try:
        # the saves' writes on the background thread (--async_checkpoint)
        trained, train_dir, valid_dir = _train_with_checkpoints(
            tmp_path, ckpt_dir, ps_addrs, async_checkpoint=True)
        saved_version = trained.model_version
        assert saved_version == 8
        # saved at 2, 4, 6 and 8; the newest three kept
        assert sorted(os.listdir(ckpt_dir)) == ["4", "6", "8"]

        master, addr, thread, result = _master(
            train_dir, valid_dir, num_epochs=2, eval_steps=4)
        try:
            resumed = _worker(addr, train_dir, ps_addrs,
                              report_version_steps=4,
                              checkpoint_dir_for_init=ckpt_dir)
            resumed.run()
            _join([thread])
            assert result["rc"] == 0
            assert resumed.model_version == saved_version + 8
            _, summary = master.evaluation_service.completed_summaries[-1]
            assert summary["auc"] > 0.6  # resumed weights, not random
        finally:
            master.stop()

        empty = tmp_path / "empty_ckpt"
        empty.mkdir()
        for bad_dir in (str(empty), str(tmp_path / "typo_ckpt")):
            master, addr, thread, result = _master(train_dir, num_epochs=1)
            try:
                worker = _worker(addr, train_dir, ps_addrs,
                                 checkpoint_dir_for_init=bad_dir)
                with pytest.raises(CheckpointRestoreError):
                    worker.run()
                assert worker.model_version == 0
                assert not master.task_dispatcher.finished()
                # the held task went back to the queue
                assert not master.task_dispatcher.doing_tasks()
            finally:
                master.stop()
            assert not os.path.exists(bad_dir) or os.listdir(bad_dir) == []
    finally:
        for server in servers:
            server.stop(None)


MAX_STEPS_ZOO = """
from elasticdl_tpu_torch.models.deepfm import (  # noqa: F401
    custom_model, dataset_fn, eval_metrics_fn, loss, optimizer,
    params_from_flax, sparse_embedding_specs)
from elasticdl_tpu_torch.train.callbacks import MaxStepsStopping


def callbacks():
    return [MaxStepsStopping(3)]
"""


def test_declared_callbacks_stop_training_and_still_export(tmp_path):
    """A model's ``callbacks()`` reach the worker: MaxStepsStopping(3)
    stops training at version 3, the remaining tasks are taken without
    training so the job finishes, and the default exporter (the model
    declares none) still runs the train-end export."""
    zoo = tmp_path / "deepfm_max_steps.py"
    zoo.write_text(MAX_STEPS_ZOO)
    train_dir, _ = _ctr_dirs(tmp_path, sizes=(128,))
    export_path = str(tmp_path / "export")
    master, addr, thread, result = _master(
        train_dir, saved_model_path=export_path, num_epochs=2,
        records_per_task=32)
    servers, ps_addrs = _ps_pair()
    try:
        worker = Worker(MasterClient(addr, worker_id=0), str(zoo),
                        RecordIODataReader(data_dir=train_dir),
                        minibatch_size=32, wait_sleep_secs=0.1,
                        ps_addrs=ps_addrs, device="cpu")
        assert [type(cb).__name__ for cb in worker._callbacks] == [
            "MaxStepsStopping", "SavedModelExporter"]
        worker.run()
        _join([thread])
        assert result["rc"] == 0
        assert worker.stop_training and worker.model_version == 3
        assert master.task_dispatcher.stats()["done"] == {
            "training": 8, "train_end_callback": 1}
        _assert_export_is_state(export_path, worker.state)
    finally:
        master.stop()
        for server in servers:
            server.stop(None)
