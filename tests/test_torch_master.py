"""The port's master (``elasticdl_tpu_torch/master/``) against the JAX
package's, on the CPU, with no card and no training.

(a) the task dispatcher: for the same shards, ``records_per_task``,
epochs and seed, the same scripted sequence of gets, reports (done,
counted failures, ``"requeue:"``-style uncounted hand-backs, stale
reports), ``recover_tasks`` and evaluation passes gives the same tasks
(id, type, shard, start, end, model version) and the same ``finished``,
``job_failed`` and ``stats`` after every operation; the retry cap fails
the job at the same failure; (b) the evaluation service: the same
reported outputs and labels give the same summary; (c) the servicer:
the same RPC sequence, in-process, gives the same answers; (d) the task
monitor: a worker that holds a task and goes silent has it requeued
within its liveness timeout. The operations are drawn with numpy from a
seed.
"""

import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.common.tensor_utils import ndarray_to_blob as ref_blob
from elasticdl_tpu.master import evaluation_service as ref_eval
from elasticdl_tpu.master import rendezvous as ref_rdv
from elasticdl_tpu.master import servicer as ref_servicer
from elasticdl_tpu.master import task_dispatcher as ref_disp
from elasticdl_tpu.models import deepfm as ref_deepfm
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as ref_pb
from elasticdl_tpu_torch.common.tensor_utils import ndarray_to_blob
from elasticdl_tpu_torch.master import evaluation_service
from elasticdl_tpu_torch.master import rendezvous
from elasticdl_tpu_torch.master import servicer
from elasticdl_tpu_torch.master import task_dispatcher
from elasticdl_tpu_torch.master.task_monitor import TaskMonitor
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

CONFIGS = {
    # name: (training shards, evaluation shards, records_per_task,
    #        epochs, shuffle seed, max_task_retries)
    "two_shards_two_epochs": ({"f1": (0, 10), "f2": (0, 10)},
                              {"e1": (0, 10)}, 3, 2, 0, 3),
    "ragged_offset_shards": ({"a": (5, 17), "b": (0, 4), "c": (2, 9)},
                             {"e": (0, 7), "g": (1, 3)}, 4, 3, 7, 2),
    "one_shard_exact": ({"only": (0, 64)}, {}, 16, 1, 11, 1),
    "unshuffled": ({"x": (0, 25), "y": (0, 8)}, {"e": (0, 5)}, 5, 2,
                   None, 3),
}


def _pair(config):
    train, evals, per_task, epochs, seed, retries = CONFIGS[config]
    kwargs = dict(training_shards=train, evaluation_shards=evals,
                  records_per_task=per_task, num_epochs=epochs,
                  max_task_retries=retries, shuffle=seed is not None,
                  seed=seed)
    return (ref_disp.TaskDispatcher(**kwargs),
            task_dispatcher.TaskDispatcher(**kwargs))


def _task(task):
    if task is None:
        return None
    return (task.task_id, task.type, task.shard_name, task.start, task.end,
            task.model_version)


def _observe(dispatcher):
    return (dispatcher.finished(), dispatcher.job_failed(),
            dispatcher.stats())


def _script(seed, n_ops=400):
    """A seeded operation sequence over workers 0-2."""
    rng = np.random.RandomState(seed)
    kinds = ["get"] * 8 + ["done"] * 6 + ["fail", "requeue", "stale",
                                          "recover", "eval", "get_eval"]
    return [(kinds[rng.randint(len(kinds))], int(rng.randint(3)),
             int(rng.randint(1 << 30))) for _ in range(n_ops)]


def _apply(dispatcher, op, worker, pick):
    """One operation; the task a report names is picked from the
    dispatcher's own doing set, in task-id order."""
    doing = sorted(dispatcher.doing_tasks().items())
    if op == "get":
        return _task(dispatcher.get(worker))
    if op == "get_eval":
        return _task(dispatcher.get(worker, task_type=ref_pb.EVALUATION))
    if op == "eval":
        return dispatcher.create_evaluation_tasks(model_version=pick % 50)
    if op == "recover":
        return dispatcher.recover_tasks(worker)
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
    else:  # a report from a worker that does not hold the task
        ok, task = dispatcher.report(task_id, True, worker_id=holder + 10)
    return ok, _task(task)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_dispatcher_sequence_matches_reference(config, seed):
    ref, port = _pair(config)
    assert _observe(port) == _observe(ref)
    for op, worker, pick in _script(seed):
        got = _apply(port, op, worker, pick)
        want = _apply(ref, op, worker, pick)
        assert got == want, (op, worker)
        assert _observe(port) == _observe(ref), (op, worker)
    # drain what is left: every task completes on both
    while True:
        r_task, p_task = ref.get(0), port.get(0)
        assert _task(p_task) == _task(r_task)
        if r_task is None:
            break
        assert port.report(p_task.task_id, True, worker_id=0)[0] == (
            ref.report(r_task.task_id, True, worker_id=0)[0])
    assert _observe(port) == _observe(ref)


@pytest.mark.parametrize("retries", [0, 1, 3])
def test_retry_cap_fails_the_job_like_reference(retries):
    """Counted failures past the cap fail the job at the same report;
    uncounted hand-backs and recoveries never do."""
    kwargs = dict(training_shards={"f": (0, 6)}, records_per_task=3,
                  num_epochs=1, max_task_retries=retries, shuffle=False)
    ref = ref_disp.TaskDispatcher(**kwargs)
    port = task_dispatcher.TaskDispatcher(**kwargs)
    for dispatcher in (ref, port):
        task = dispatcher.get(0)
        for _ in range(5):  # uncounted: never fails the job
            dispatcher.report(task.task_id, False, worker_id=0,
                              count_failure=False)
            while dispatcher.get(0).task_id != task.task_id:
                pass
            dispatcher.recover_tasks(0)
            while dispatcher.get(0).task_id != task.task_id:
                pass
        assert not dispatcher.job_failed()
    history = []
    for attempt in range(retries + 1):
        for dispatcher in (ref, port):
            dispatcher.report(1, False, worker_id=0)
        history.append((ref.job_failed(), port.job_failed()))
        if attempt < retries:
            for dispatcher in (ref, port):
                while dispatcher.get(0).task_id != 1:
                    pass
    assert [p for _, p in history] == [r for r, _ in history]
    assert history[-1] == (True, True)
    assert not port.finished() and not ref.finished()


def test_task_completed_callbacks_see_the_same_tasks():
    ref, port = _pair("two_shards_two_epochs")
    seen = {"ref": [], "port": []}
    ref.add_task_completed_callback(lambda t: seen["ref"].append(_task(t)))
    port.add_task_completed_callback(lambda t: seen["port"].append(_task(t)))
    for dispatcher in (ref, port):
        dispatcher.create_evaluation_tasks(model_version=3)
        while True:
            task = dispatcher.get(1)
            if task is None:
                break
            dispatcher.report(task.task_id, True, worker_id=1)
        assert dispatcher.finished()
    assert seen["port"] == seen["ref"] and len(seen["ref"]) == 8 * 2 + 4


# ---------------------------------------------------------------------
# (b) the evaluation service


@pytest.mark.parametrize("eval_steps", [4, 10])
def test_evaluation_summaries_match_reference(eval_steps):
    """The step trigger, the dropped overlapping trigger and the summary
    of deepfm's metrics (AUC and accuracy from logits) over the same
    reported chunks."""
    rng = np.random.RandomState(eval_steps)
    kwargs = dict(training_shards={"t": (0, 8)},
                  evaluation_shards={"e": (0, 9)}, records_per_task=3,
                  num_epochs=1, shuffle=False)
    sides = {
        "ref": (ref_disp.TaskDispatcher(**kwargs), ref_eval, ref_deepfm,
                ref_blob),
        "port": (task_dispatcher.TaskDispatcher(**kwargs),
                 evaluation_service, deepfm, ndarray_to_blob),
    }
    chunks = [(rng.randn(n).astype(np.float32),
               rng.randint(0, 2, n).astype(np.float32))
              for n in (5, 7, 3)]
    results = {}
    for name, (dispatcher, module, zoo, to_blob) in sides.items():
        service = module.EvaluationService(
            dispatcher, zoo.eval_metrics_fn, eval_steps=eval_steps)
        triggers = [service.add_evaluation_task_if_needed(v)
                    for v in range(0, 25, 2)]
        done = 0
        while True:
            task = dispatcher.get(0)
            if task is None:
                break
            if task.type == ref_pb.EVALUATION:
                logits, labels = chunks[done % len(chunks)]
                service.report_evaluation_metrics(
                    {"output": to_blob(logits)}, to_blob(labels))
                done += 1
            dispatcher.report(task.task_id, True)
        results[name] = (triggers, service.completed_summaries)
    assert results["port"][0] == results["ref"][0]
    (r_version, r_summary), = results["ref"][1]
    (p_version, p_summary), = results["port"][1]
    assert p_version == r_version
    assert p_summary.keys() == r_summary.keys() == {"auc", "accuracy"}
    for key in r_summary:
        assert p_summary[key] == pytest.approx(r_summary[key], abs=1e-12)


# ---------------------------------------------------------------------
# (c) the servicer, in-process


def _servicer_pair(seed):
    kwargs = dict(training_shards={"f": (0, 12), "g": (0, 5)},
                  evaluation_shards={"e": (0, 6)}, records_per_task=4,
                  num_epochs=2, seed=seed)
    out = []
    for disp, evals, rdv, srv, zoo in (
            (ref_disp, ref_eval, ref_rdv, ref_servicer, ref_deepfm),
            (task_dispatcher, evaluation_service, rendezvous, servicer,
             deepfm)):
        dispatcher = disp.TaskDispatcher(**kwargs)
        service = evals.EvaluationService(dispatcher, zoo.eval_metrics_fn,
                                          eval_steps=4)
        out.append((srv.MasterServicer(dispatcher, service,
                                       rdv.MeshRendezvous()),
                    dispatcher, service))
    return out


def _answer(response, base=None):
    """A response with the per-process epochs taken out: master_epoch
    cleared, a relaunch epoch as its offset from the base."""
    copy = type(response)()
    copy.CopyFrom(response)
    if copy.DESCRIPTOR.fields_by_name.get("master_epoch") is not None:
        copy.master_epoch = 0
    if copy.DESCRIPTOR.name == "ResetWorkerResponse":
        copy.restart_count -= base
    return copy.SerializeToString(deterministic=True)


@pytest.mark.parametrize("seed", [0, 3])
def test_servicer_answers_match_reference(seed):
    (ref, ref_d, ref_s), (port, port_d, port_s) = _servicer_pair(seed)
    rng = np.random.RandomState(seed)
    logits = rng.randn(4).astype(np.float32)
    labels = np.array([0, 1, 1, 0], np.float32)

    def requests(mod):
        return {
            "reset": lambda w: mod.GetTaskRequest(worker_id=w),
            "task": lambda w: mod.GetTaskRequest(worker_id=w),
            "eval_task": lambda w: mod.GetTaskRequest(
                worker_id=w, task_type=mod.EVALUATION),
            "comm": lambda w: mod.GetCommInfoRequest(
                worker_id=w, worker_host="host-%d" % w),
            "comm_ps": lambda w: mod.GetCommInfoRequest(worker_id=-1),
            "version": lambda v: mod.ReportVersionRequest(model_version=v),
        }

    sides = []
    for srv, mod, blob in ((ref, ref_pb, ref_blob), (port, pb,
                                                     ndarray_to_blob)):
        sides.append((srv, mod, blob, requests(mod),
                      srv._restart_epoch_base))
    held = {}
    for step in range(60):
        op = ["reset", "task", "task", "done", "fail", "requeue", "comm",
              "comm_ps", "version", "eval_task", "metrics"][
                  rng.randint(11)]
        worker = int(rng.randint(3))
        arg = int(rng.randint(1, 30))
        answers = []
        for srv, mod, blob, req, base in sides:
            if op in ("reset",):
                answers.append(_answer(srv.reset_worker(req[op](worker)),
                                       base))
            elif op in ("task", "eval_task"):
                task = srv.get_task(req[op](worker))
                if task.task_id:
                    held.setdefault(id(srv), []).append(
                        (task.task_id, worker))
                answers.append(_answer(task))
            elif op in ("comm", "comm_ps"):
                answers.append(_answer(srv.get_comm_info(req[op](worker))))
            elif op == "version":
                answers.append(_answer(srv.report_version(req[op](arg))))
            elif op == "metrics":
                request = mod.ReportEvaluationMetricsRequest(
                    worker_id=worker, model_version=arg)
                blob(logits, request.model_outputs["output"])
                blob(labels, request.labels)
                answers.append(_answer(srv.report_evaluation_metrics(
                    request)))
            else:
                queue = held.get(id(srv), [])
                if not queue:
                    answers.append(None)
                    continue
                task_id, holder = queue.pop(arg % len(queue))
                message = {"done": "", "fail": "boom",
                           "requeue": "requeue: stream closed"}[op]
                answers.append(_answer(srv.report_task_result(
                    mod.ReportTaskResultRequest(
                        task_id=task_id, worker_id=holder,
                        err_message=message))))
        assert answers[0] == answers[1], (step, op)
        assert _observe(port_d) == _observe(ref_d), (step, op)
    assert sorted(port.worker_liveness()) == sorted(ref.worker_liveness())
    assert port.mesh_worker_ids() == ref.mesh_worker_ids()
    assert [v for v, _ in port_s.completed_summaries] == [
        v for v, _ in ref_s.completed_summaries]


def test_requeue_hand_back_is_uncounted_through_the_servicer():
    dispatcher = task_dispatcher.TaskDispatcher(
        {"f": (0, 4)}, records_per_task=4, num_epochs=1, max_task_retries=0)
    srv = servicer.MasterServicer(dispatcher)
    for message, failed in (("requeue: stream closed", False),
                            ("boom", True)):
        task = srv.get_task(pb.GetTaskRequest(worker_id=0))
        srv.report_task_result(pb.ReportTaskResultRequest(
            task_id=task.task_id, worker_id=0, err_message=message))
        assert dispatcher.job_failed() is failed
    answer = srv.get_task(pb.GetTaskRequest(worker_id=0))
    assert answer.task_id == 0 and answer.type == pb.TRAINING  # job over


# ---------------------------------------------------------------------
# (d) the task monitor


def test_silent_task_holder_is_requeued_within_the_timeout():
    """Worker 7 takes a task and goes silent; worker 0 keeps polling.
    Within the liveness timeout (plus one scan) the monitor requeues
    7's task, uncounted, and 0 picks it up."""
    dispatcher = task_dispatcher.TaskDispatcher(
        {"f": (0, 8)}, records_per_task=4, num_epochs=1, shuffle=False,
        max_task_retries=0)
    srv = servicer.MasterServicer(dispatcher, None,
                                  rendezvous.MeshRendezvous())
    monitor = TaskMonitor(dispatcher, srv, srv._rendezvous,
                          liveness_timeout_secs=0.5,
                          scan_interval_secs=0.05).start()
    try:
        held = srv.get_task(pb.GetTaskRequest(worker_id=7))
        silent_at = time.monotonic()
        mine = srv.get_task(pb.GetTaskRequest(worker_id=0))
        srv.report_task_result(pb.ReportTaskResultRequest(
            task_id=mine.task_id, worker_id=0))
        while True:
            task = srv.get_task(pb.GetTaskRequest(worker_id=0))
            if task.task_id:
                break
            assert time.monotonic() - silent_at < 5.0
            time.sleep(0.02)
        requeued_after = time.monotonic() - silent_at
        assert task.task_id == held.task_id
        assert 0.5 <= requeued_after < 0.5 + 0.5
        srv.report_task_result(pb.ReportTaskResultRequest(
            task_id=task.task_id, worker_id=0))
        # the dead worker's late report is stale and changes nothing
        srv.report_task_result(pb.ReportTaskResultRequest(
            task_id=held.task_id, worker_id=7, err_message="boom"))
        assert dispatcher.finished() and not dispatcher.job_failed()
    finally:
        monitor.stop()


def test_master_serves_until_every_live_worker_heard_job_over():
    """Master.run keeps the server up after the last report until each
    live worker has been answered "job over" (bounded by the liveness
    timeout); a PS's negative id is not waited for."""
    from elasticdl_tpu_torch.master.master import Master

    master = Master("elasticdl_tpu_torch.models.deepfm",
                    task_timeout_secs=5.0)
    srv = master.servicer
    srv.get_comm_info(pb.GetCommInfoRequest(worker_id=-1))
    srv.get_comm_info(pb.GetCommInfoRequest(worker_id=3))
    assert master.task_dispatcher.finished()
    assert srv.workers_not_told_job_over() == [3]
    result = {}
    runner = threading.Thread(
        target=lambda: result.setdefault("rc", master.run(poll_secs=0.01)))
    runner.start()
    time.sleep(0.3)
    assert runner.is_alive()
    answer = srv.get_task(pb.GetTaskRequest(worker_id=3))
    assert answer.task_id == 0 and answer.type == pb.TRAINING
    runner.join(timeout=5)
    assert not runner.is_alive() and result["rc"] == 0
    assert srv.workers_not_told_job_over() == []
