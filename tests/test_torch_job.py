"""The port's elastic job on the CPU: master, PS and workers over real
gRPC on localhost, small sizes (DeepFM over 10 id fields, vocab 1000;
a 2-layer narrow TransformerLM), data made with numpy from a seed.

(a) parity: one DeepFM job (a master, two in-process PS servicers on
the native store with seed = ps_id, one sequential worker, tier off)
on each package, the port's dense params carried across from the
reference worker's initial ones through ``trainer_factory`` and
``params_from_flax``; the PS tables and the final evaluation summary
agree; (b) the port's jobs: the pipelined job with the hot-row cache
learns (AUC > 0.75), two workers share the queue, a record tail smaller
than one minibatch does not hang the job, a worker that takes a task
and goes silent has it requeued by the task monitor while the other
worker finishes every range, and a dense model trains through the
worker exactly as a ``TorchTrainer`` on the same batches; (c) the
command lines: ``master.main``, two ``ps.server --master_addr`` and
``worker.main --device cpu`` as processes, the PS exiting on their own
once the master is gone.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.data.readers import RecordIODataReader as RefReader
from elasticdl_tpu.master import evaluation_service as ref_eval
from elasticdl_tpu.master import servicer as ref_servicer
from elasticdl_tpu.master import task_dispatcher as ref_disp
from elasticdl_tpu.proto.services import (
    add_master_servicer_to_server as ref_add_master,
    add_pserver_servicer_to_server as ref_add_pserver,
)
from elasticdl_tpu.ps import embedding_store as ref_store
from elasticdl_tpu.ps import servicer as ref_ps
from elasticdl_tpu.train import export as ref_export
from elasticdl_tpu.train import optimizers as ref_opt
from elasticdl_tpu.train import sparse as ref_sparse
from elasticdl_tpu.worker import master_client as ref_mc
from elasticdl_tpu.worker import worker as ref_worker
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.grpc_utils import build_server, find_free_port
from elasticdl_tpu_torch.data import recordio
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.readers import RecordIODataReader
from elasticdl_tpu_torch.master import evaluation_service
from elasticdl_tpu_torch.master import servicer
from elasticdl_tpu_torch.master import task_dispatcher
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.models import transformer
from elasticdl_tpu_torch.proto.services import (
    add_master_servicer_to_server,
    add_pserver_servicer_to_server,
)
from elasticdl_tpu_torch.ps import embedding_store as port_store
from elasticdl_tpu_torch.ps import servicer as port_ps
from elasticdl_tpu_torch.train import optimizers as port_opt
from elasticdl_tpu_torch.train.sparse import SparseTrainer
from elasticdl_tpu_torch.worker import master_client
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.trainer import TorchTrainer
from elasticdl_tpu_torch.worker.worker import Worker
from tests.test_torch_sparse import STATE_ATOL, STATE_RTOL
from tests.test_utils import create_ctr_recordio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ZOO = "elasticdl_tpu_torch.models.deepfm"
FIELDS = 10
TABLES = ("deepfm_emb", "deepfm_linear")
# the multi-step state tolerance of the native-store parity
# (tests/test_torch_native_store.py, 12 steps): adam eps 1e-3 on the
# dense params and the PS keeps fp32 summation noise from being
# amplified by 1 / eps; the job below takes 8 steps
ADAM_EPS = 1e-3
# the summary's AUC and accuracy from logits that differ by that noise:
# a flipped rank or threshold would move them by >= 1 / 128
SUMMARY_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _short_master_retry(monkeypatch):
    """A worker that polls a master which already stopped reads the job
    as over after 5 s, not the deployment's 120 s relaunch window."""
    monkeypatch.setattr(master_client, "MASTER_RETRY_BUDGET_SECS", 5.0)


def _ctr_dirs(tmp_path, sizes=(160, 96), valid=128, valid_seed=9):
    train, valid_dir = tmp_path / "train", tmp_path / "valid"
    train.mkdir()
    valid_dir.mkdir()
    for i, n in enumerate(sizes):
        create_ctr_recordio(str(train / ("f%d.rec" % i)), num_records=n,
                            num_features=FIELDS, seed=i)
    create_ctr_recordio(str(valid_dir / "f0.rec"), num_records=valid,
                        num_features=FIELDS, seed=valid_seed)
    return str(train), str(valid_dir)


def _serve(add, servicer_obj):
    server = build_server()
    add(servicer_obj, server)
    port = find_free_port()
    server.add_insecure_port("localhost:%d" % port)
    server.start()
    return server, "localhost:%d" % port


# ---------------------------------------------------------------------
# (a) one DeepFM job on each package


def _ref_initial_params(train_dir):
    """What the reference worker's trainer initialises (seed 0) from
    its first batch, as the flat flax names."""
    reader = RefReader(data_dir=train_dir)
    name, (start, _) = sorted(reader.create_shards().items())[0]
    from elasticdl_tpu.data.pipeline import Dataset
    from elasticdl_tpu.models import deepfm as ref_deepfm
    from elasticdl_tpu.proto import elasticdl_tpu_pb2 as ref_pb
    from elasticdl_tpu.ps.local_client import LocalPSClient

    task = ref_pb.Task(shard_name=name, start=start, end=start + 32)
    batch = next(iter(ref_deepfm.dataset_fn(
        Dataset(lambda: reader.read_records(task))).batch(32)))
    trainer = ref_sparse.SparseTrainer(
        model=ref_deepfm.custom_model(), loss_fn=ref_deepfm.loss,
        optimizer=ref_deepfm.optimizer(),
        specs=ref_deepfm.sparse_embedding_specs(batch_size=32),
        ps_client=LocalPSClient(), seed=0, device_tier=False, health=False)
    state = trainer.ensure_state(None, batch)
    trainer.close()
    return ref_export._flatten(jax.device_get(state.params))


def _job(side, train_dir, valid_dir, flat_params):
    """One DeepFM job: returns (final eval summary, the two PS stores,
    the worker's initial flat params on the reference side)."""
    ref = side == "ref"
    disp_mod, eval_mod, srv_mod = (
        (ref_disp, ref_eval, ref_servicer) if ref
        else (task_dispatcher, evaluation_service, servicer))
    reader_cls = RefReader if ref else RecordIODataReader
    dispatcher = disp_mod.TaskDispatcher(
        training_shards=reader_cls(data_dir=train_dir).create_shards(),
        evaluation_shards=reader_cls(data_dir=valid_dir).create_shards(),
        records_per_task=64, num_epochs=1, seed=0)
    zoo = "elasticdl_tpu.models.deepfm" if ref else PORT_ZOO
    evals = eval_mod.EvaluationService(
        dispatcher,
        (__import__(zoo, fromlist=["x"])).eval_metrics_fn)
    servers, ps_addrs, stores = [], [], []
    master, addr = _serve(ref_add_master if ref else
                          add_master_servicer_to_server,
                          srv_mod.MasterServicer(dispatcher, evals))
    servers.append(master)
    for ps_id in range(2):
        store = (ref_store if ref else port_store).NativeEmbeddingStore(
            seed=ps_id)
        store.set_optimizer("adam", lr=0.01, epsilon=ADAM_EPS)
        server, ps_addr = _serve(
            ref_add_pserver if ref else add_pserver_servicer_to_server,
            (ref_ps if ref else port_ps).PserverServicer(store,
                                                         ps_id=ps_id))
        servers.append(server)
        ps_addrs.append(ps_addr)
        stores.append(store)
    initial = {}

    def ref_factory(model, loss_fn, optimizer, specs, ps_client, **kw):
        trainer = ref_sparse.SparseTrainer(
            model=model, loss_fn=loss_fn,
            optimizer=ref_opt.create_optimizer(
                "Adam", learning_rate=0.001, epsilon=ADAM_EPS),
            specs=specs, ps_client=ps_client, health=False,
            device_tier=False, **kw)
        create = trainer.create_state

        def create_state(features):
            state = create(features)
            initial.setdefault("params", ref_export._flatten(
                jax.device_get(state.params)))
            return state

        trainer.create_state = create_state
        return trainer

    def port_factory(model, loss_fn, optimizer, specs, ps_client, **kw):
        model.load_state_dict(deepfm.params_from_flax(flat_params))
        return SparseTrainer(
            model=model, loss_fn=loss_fn,
            optimizer=port_opt.create_optimizer(
                "Adam", learning_rate=0.001, epsilon=ADAM_EPS),
            specs=specs, ps_client=ps_client, health=False,
            device_tier=False, **kw)

    try:
        if ref:
            worker = ref_worker.Worker(
                ref_mc.MasterClient(addr, worker_id=0), zoo,
                RefReader(data_dir=train_dir), minibatch_size=32,
                wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                trainer_factory=ref_factory)
        else:
            worker = Worker(
                MasterClient(addr, worker_id=0), zoo,
                RecordIODataReader(data_dir=train_dir), minibatch_size=32,
                wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                trainer_factory=port_factory, device="cpu")
        worker.run()
        assert dispatcher.finished() and worker.model_version == 8
        # the final evaluation, of the trained model: one pass queued
        # after training, served by the same worker in evaluation mode
        assert evals.add_evaluation_task(worker.model_version)
        worker._mode = Mode.EVALUATION
        worker.run()
        assert dispatcher.finished()
        (version, summary), = evals.completed_summaries
        assert version == 8
    finally:
        for server in servers:
            server.stop(None)
    return summary, stores, initial.get("params")


def test_deepfm_job_matches_reference(tmp_path):
    train_dir, valid_dir = _ctr_dirs(tmp_path)
    flat = _ref_initial_params(train_dir)
    ref_summary, ref_stores, ref_initial = _job("ref", train_dir,
                                                valid_dir, flat)
    # the carried params are what the reference worker started from
    assert ref_initial.keys() == flat.keys()
    for name in flat:
        np.testing.assert_array_equal(ref_initial[name], flat[name])
    port_summary, port_stores, _ = _job("port", train_dir, valid_dir, flat)
    for ref_s, port_s in zip(ref_stores, port_stores):
        for table in TABLES:
            r_ids, r_rows, r_steps = ref_s.export_table_full(table)
            p_ids, p_rows, p_steps = port_s.export_table_full(table)
            r_order, p_order = np.argsort(r_ids), np.argsort(p_ids)
            assert r_ids.size > 0
            np.testing.assert_array_equal(p_ids[p_order], r_ids[r_order])
            np.testing.assert_array_equal(p_steps[p_order],
                                          r_steps[r_order])
            np.testing.assert_allclose(p_rows[p_order], r_rows[r_order],
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       err_msg=table)
    assert port_summary.keys() == ref_summary.keys() == {"auc", "accuracy"}
    for key in ref_summary:
        assert port_summary[key] == pytest.approx(ref_summary[key],
                                                  abs=SUMMARY_ATOL)


# ---------------------------------------------------------------------
# (b) the port's jobs


def _ps_pair(opt_args=None):
    servers, addrs = [], []
    for ps_id in range(2):
        store = port_store.create_store(seed=ps_id)
        store.set_optimizer("adam", **(opt_args or {"lr": 0.01}))
        server, addr = _serve(add_pserver_servicer_to_server,
                              port_ps.PserverServicer(store, ps_id=ps_id))
        servers.append(server)
        addrs.append(addr)
    return servers, addrs


def _master(train_dir, valid_dir=None, **kwargs):
    kwargs.setdefault("records_per_task", 128)
    master = Master(PORT_ZOO, training_data=train_dir,
                    validation_data=valid_dir, port=find_free_port(),
                    seed=0, **kwargs).prepare()
    result = {}
    thread = threading.Thread(
        target=lambda: result.setdefault("rc", master.run(poll_secs=0.2)),
        daemon=True)
    thread.start()
    return master, "localhost:%d" % master._port, thread, result


def _join(threads, timeout=120):
    for thread in threads:
        thread.join(timeout=timeout)
        assert not thread.is_alive()


def test_pipelined_job_learns_with_the_hot_row_cache(tmp_path):
    """tests/test_sparse_distributed.py's pipelined job on the port."""
    train_dir, valid_dir = _ctr_dirs(tmp_path, sizes=(512,), valid_seed=1)
    master, addr, thread, result = _master(
        train_dir, valid_dir, num_epochs=2, eval_steps=12)
    servers, ps_addrs = _ps_pair()
    try:
        worker = Worker(MasterClient(addr, worker_id=0), PORT_ZOO,
                        RecordIODataReader(data_dir=train_dir),
                        minibatch_size=64, report_version_steps=4,
                        wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                        sparse_pipeline=True, sparse_cache_staleness=4,
                        device="cpu")
        worker.run()
        _join([thread])
        assert result["rc"] == 0
        assert master.task_dispatcher.finished()
        _, summary = master.evaluation_service.completed_summaries[-1]
        assert summary["auc"] > 0.75
        assert worker._sparse_pipeline
        cache = worker.trainer.preparer.cache
        assert cache is not None and cache.hits > 0
    finally:
        master.stop()
        for server in servers:
            server.stop(None)


def _done_ranges(dispatcher):
    done = []
    dispatcher.add_task_completed_callback(
        lambda t: done.append((t.shard_name, t.start, t.end, t.type)))
    return done


def _assert_every_range_done(done, train_dir, epochs=1):
    shards = RecordIODataReader(data_dir=train_dir).create_shards()
    covered = {}
    for shard, start, end, kind in done:
        if kind == 0:  # TRAINING
            covered.setdefault(shard, []).append((start, end))
    for shard, (start, count) in shards.items():
        ranges = sorted(covered[shard])
        assert sum(e - s for s, e in ranges) == count * epochs
        assert ranges[0][0] == start and ranges[-1][1] == start + count


def test_two_workers_share_the_queue(tmp_path):
    train_dir, _ = _ctr_dirs(tmp_path, sizes=(128, 128))
    master, addr, thread, result = _master(train_dir, records_per_task=32)
    done = _done_ranges(master.task_dispatcher)
    servers, ps_addrs = _ps_pair()
    try:
        workers = [Worker(MasterClient(addr, worker_id=i), PORT_ZOO,
                          RecordIODataReader(data_dir=train_dir),
                          minibatch_size=32, wait_sleep_secs=0.1,
                          ps_addrs=ps_addrs, device="cpu")
                   for i in range(2)]
        threads = [threading.Thread(target=w.run, daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        _join(threads + [thread])
        assert result["rc"] == 0
        assert all(w.model_version > 0 for w in workers)
        assert sum(w.model_version for w in workers) == 8
        _assert_every_range_done(done, train_dir)
    finally:
        master.stop()
        for server in servers:
            server.stop(None)


def test_job_completes_when_dataset_not_batch_divisible(tmp_path):
    """70 records, tasks of 32, minibatch 64: the last stream segment is
    6 records, smaller than one minibatch; the master's WAIT flushes it
    out as a masked batch instead of hanging the job."""
    train_dir, valid_dir = _ctr_dirs(tmp_path, sizes=(70,), valid=64)
    master, addr, thread, result = _master(train_dir, valid_dir,
                                           records_per_task=32)
    done = _done_ranges(master.task_dispatcher)
    servers, ps_addrs = _ps_pair()
    try:
        worker = Worker(MasterClient(addr, worker_id=0), PORT_ZOO,
                        RecordIODataReader(data_dir=train_dir),
                        minibatch_size=64, report_version_steps=4,
                        wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                        device="cpu")
        runner = threading.Thread(target=worker.run, daemon=True)
        runner.start()
        _join([runner, thread])
        assert result["rc"] == 0
        assert not master.task_dispatcher.job_failed()
        _assert_every_range_done(done, train_dir)
    finally:
        master.stop()
        for server in servers:
            server.stop(None)


def test_silent_worker_task_is_requeued_and_the_job_finishes(tmp_path):
    """Worker 5 takes a task and goes silent (as a killed process does);
    the task monitor requeues it within the liveness timeout and worker
    0 finishes every training range."""
    train_dir, _ = _ctr_dirs(tmp_path, sizes=(128, 64))
    master, addr, thread, result = _master(
        train_dir, records_per_task=32, task_timeout_secs=1.0)
    done = _done_ranges(master.task_dispatcher)
    recovered = []
    recover = master.task_dispatcher.recover_tasks

    def recover_tasks(worker_id):
        if worker_id == 5:
            recovered.append(time.monotonic())
        recover(worker_id)

    master.task_dispatcher.recover_tasks = recover_tasks
    servers, ps_addrs = _ps_pair()
    try:
        ghost = MasterClient(addr, worker_id=5)
        held = ghost.get_task()
        silent_at = time.monotonic()
        assert held.task_id > 0
        ghost.close()
        worker = Worker(MasterClient(addr, worker_id=0), PORT_ZOO,
                        RecordIODataReader(data_dir=train_dir),
                        minibatch_size=32, wait_sleep_secs=0.1,
                        ps_addrs=ps_addrs, device="cpu")
        worker.HEARTBEAT_SECS = 0.2
        runner = threading.Thread(target=worker.run, daemon=True)
        runner.start()
        _join([runner, thread])
        assert result["rc"] == 0
        assert len(recovered) == 1
        # liveness timeout 1 s, scanned every 1 s
        assert 1.0 <= recovered[0] - silent_at < 1.0 + 1.5
        assert worker.model_version == 6
        _assert_every_range_done(done, train_dir)
    finally:
        master.stop()
        for server in servers:
            server.stop(None)


def _write_tokens(directory, n_files=2, per_file=8, seq=16, vocab=64,
                  seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(directory)
    for i in range(n_files):
        recordio.write_records(
            os.path.join(directory, "part-%d.rec" % i),
            [encode_example({"tokens": rng.randint(
                0, vocab, size=seq).astype(np.int32)})
             for _ in range(per_file)])
    return directory


def test_dense_model_trains_through_the_worker(tmp_path):
    """A model without sparse specs trains through TorchTrainer: the
    worker's per-step losses equal a TorchTrainer's on the batches of
    its tasks, in the order the master handed them out."""
    widths = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32)
    params = ";".join("%s=%d" % kv for kv in sorted(widths.items()))
    data = _write_tokens(str(tmp_path / "train"))
    master = Master("elasticdl_tpu_torch.models.transformer",
                    training_data=data, records_per_task=4,
                    port=find_free_port(), seed=0,
                    model_params=params).prepare()
    done = _done_ranges(master.task_dispatcher)
    losses = []

    def factory(**kwargs):
        trainer = TorchTrainer(**kwargs)
        step = trainer.train_step

        def train_step(state, batch):
            state, loss = step(state, batch)
            losses.append(float(loss))
            return state, loss

        trainer.train_step = train_step
        return trainer

    try:
        worker = Worker(MasterClient("localhost:%d" % master._port, 0),
                        "elasticdl_tpu_torch.models.transformer",
                        RecordIODataReader(data_dir=data), minibatch_size=4,
                        wait_sleep_secs=0.1, seed=3, model_params=params,
                        trainer_factory=factory, device="cpu")
        assert isinstance(worker.trainer, TorchTrainer)
        worker.run()
        assert master.task_dispatcher.finished()
    finally:
        master.stop()
    assert worker.model_version == 4 and len(done) == 4
    torch.manual_seed(3)
    twin = TorchTrainer(transformer.custom_model(**widths), transformer.loss,
                        transformer.optimizer(), device="cpu")
    reader = RecordIODataReader(data_dir=data)
    from elasticdl_tpu_torch.data.pipeline import Dataset
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

    def records():
        for shard, start, end, _ in done:
            yield from reader.read_records(
                pb.Task(shard_name=shard, start=start, end=end))

    state, expected = None, []
    for batch in transformer.dataset_fn(Dataset(records)).batch(4):
        state, loss = twin.train_step(state, batch)
        expected.append(float(loss))
    assert losses == expected and all(np.isfinite(losses))


def test_worker_defaults_to_the_card_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    from elasticdl_tpu_torch.common.args import parse_worker_args

    args = parse_worker_args(["--model_zoo", PORT_ZOO, "--master_addr",
                              "localhost:1", "--worker_id", "0"])
    assert args.device == "cuda"
    train_dir, _ = _ctr_dirs(tmp_path, sizes=(8,), valid=8)
    with pytest.raises(RuntimeError, match="cuda"):
        Worker(MasterClient("localhost:1", worker_id=0), PORT_ZOO,
               RecordIODataReader(data_dir=train_dir), ps_addrs=["x:1"])


# ---------------------------------------------------------------------
# (c) the command lines


def _spawn(args, log_path, env):
    with open(log_path, "w") as out:
        return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO,
                                env=env, stdout=out,
                                stderr=subprocess.STDOUT)


def _wait_for_line(proc, log_path, text, timeout=60):
    deadline = time.monotonic() + timeout
    while True:
        with open(log_path) as f:
            if text in f.read():
                return
        assert proc.poll() is None, open(log_path).read()[-2000:]
        assert time.monotonic() < deadline, open(log_path).read()[-2000:]
        time.sleep(0.1)


def test_master_ps_and_worker_processes_run_a_job(tmp_path):
    """python -m master.main, two ps.server --master_addr and
    worker.main --device cpu on a tiny job: the master exits 0, the
    worker exits 0, and both PS exit 0 on their own once the master is
    gone (polled every 0.5 s, gone after 1 s unanswered)."""
    train_dir, _ = _ctr_dirs(tmp_path, sizes=(96,), valid=8)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               EDL_PS_MASTER_GONE_SECS="1")
    logs = {name: str(tmp_path / ("%s.log" % name))
            for name in ("master", "ps0", "ps1", "worker")}
    master_port = find_free_port()
    addr = "localhost:%d" % master_port
    procs = {}
    try:
        procs["master"] = _spawn(
            ["elasticdl_tpu_torch.master.main", "--model_zoo", PORT_ZOO,
             "--training_data", train_dir, "--records_per_task", "32",
             "--minibatch_size", "16", "--port", str(master_port),
             "--task_timeout_secs", "20"], logs["master"], env)
        _wait_for_line(procs["master"], logs["master"], "Master serving")
        ps_addrs = []
        for ps_id in range(2):
            port = find_free_port()
            procs["ps%d" % ps_id] = _spawn(
                ["elasticdl_tpu_torch.ps.server", "--ps_id", str(ps_id),
                 "--num_ps_pods", "2", "--port", str(port), "--opt_type",
                 "adam", "--opt_args", "lr=0.01", "--use_async", "1",
                 "--master_addr", addr], logs["ps%d" % ps_id], env)
            ps_addrs.append("localhost:%d" % port)
        for ps_id in range(2):
            _wait_for_line(procs["ps%d" % ps_id], logs["ps%d" % ps_id],
                           "serving on")
        procs["worker"] = _spawn(
            ["elasticdl_tpu_torch.worker.main", "--model_zoo", PORT_ZOO,
             "--training_data", train_dir, "--minibatch_size", "16",
             "--master_addr", addr, "--worker_id", "0", "--ps_addrs",
             ",".join(ps_addrs), "--device", "cpu"], logs["worker"], env)
        assert procs["worker"].wait(timeout=120) == 0, (
            open(logs["worker"]).read()[-3000:])
        assert procs["master"].wait(timeout=30) == 0, (
            open(logs["master"]).read()[-3000:])
        master_gone = time.monotonic()
        for ps_id in range(2):
            assert procs["ps%d" % ps_id].wait(timeout=30) == 0
        assert time.monotonic() - master_gone < 30
        for ps_id in range(2):
            assert "Master gone" in open(logs["ps%d" % ps_id]).read()
        assert "Job finished" in open(logs["master"]).read()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
