"""The stream checkpoint on the port's worker and PS, and the lifecycle's
events in the postmortem, on the CPU.

(a) tests/test_stream.py's worker scenario: with the device tier and
the async push on, a watermark boundary joins the in-flight push and
flushes the tier, after which every tier-resident row equals its PS row
bit for bit; the first boundary only anchors; the same watermark
sequence makes the port's worker fire where the reference's fires, and
a reported task refreshes the watermark before the next boundary check;
(b) tests/test_stream.py's postmortem scenario on the port's journal;
(c) the three ``stream_boundary`` cases of tests/test_checkpoint_delta.py
on the port's servicer, and the same watermark sequence making the same
save decisions on both packages' servicers.
"""

import collections
import importlib
import os
import sys
import types

import numpy as np
import pytest

from elasticdl_tpu_torch.common.tensor_utils import serialize_indexed_slices
from elasticdl_tpu_torch.data.readers import RecordIODataReader
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.ps.checkpoint import SparseCheckpointSaver
from elasticdl_tpu_torch.ps.embedding_store import NumpyEmbeddingStore
from elasticdl_tpu_torch.ps.local_client import LocalPSClient
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.stream.lifecycle import EmbeddingLifecycle
from elasticdl_tpu_torch.train.device_tier import DeviceTierConfig
from elasticdl_tpu_torch.train.sparse import SparseTrainer
from elasticdl_tpu_torch.worker.worker import Worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE_ZOO = "elasticdl_tpu_torch.models.iris_dnn"


class FakeMasterClient:
    worker_id = 0
    telemetry_provider = None

    def __init__(self, watermarks=()):
        self.watermarks = list(watermarks)
        self.comm_calls = 0

    def get_comm_info(self):
        self.comm_calls += 1
        watermark = self.watermarks.pop(0) if self.watermarks else 0
        return pb.CommInfo(rank=0, world_size=1, mesh_epoch=0,
                           stream_watermark=watermark)

    def report_version(self, version):
        pass

    def report_task_result(self, task_id, err):
        pass


def _worker(monkeypatch, every, master=None):
    monkeypatch.setenv("EDL_STREAM_CHECKPOINT_EVERY", str(every))
    return Worker(master or FakeMasterClient(), DENSE_ZOO,
                  RecordIODataReader(data_dir="/nonexistent"),
                  minibatch_size=8, device="cpu")


def test_worker_stream_checkpoint_joins_pushes_and_flushes_tier(
        monkeypatch):
    worker = _worker(monkeypatch, 1000)
    assert worker._stream_ckpt_every == 1000
    fields, batch = 4, 16
    trainer = SparseTrainer(
        model=deepfm.custom_model(), loss_fn=deepfm.loss,
        optimizer=deepfm.optimizer(),
        specs=deepfm.sparse_embedding_specs(num_features=fields,
                                            batch_size=batch),
        ps_client=LocalPSClient(seed=0, opt_type="adam", lr=0.01),
        seed=0,
        device_tier=DeviceTierConfig(
            capacity=128, promote_hits=1, ttl=1000, stage_budget=64,
            opt_type="adam", opt_args={"lr": 0.01},
            writeback_steps=10_000),
        async_push=True, device="cpu",
    )
    worker.trainer = trainer
    rng = np.random.RandomState(0)
    state = None
    for _ in range(6):
        ids = (rng.zipf(1.8, size=(batch, fields)) % 200).astype(np.int64)
        state, _ = trainer.train_step(state, {
            "features": {"ids": ids},
            "labels": (ids.sum(1) % 2).astype(np.float32),
            "_mask": np.ones(batch, np.float32),
        })
    tier = trainer.device_tier
    pre_ids, _ = tier.table_rows("deepfm_emb")
    assert pre_ids.size > 0
    assert trainer._push_future is not None, "no push in flight"
    store = trainer.preparer._ps.store
    worker._seen_stream_watermark = 500
    assert worker.maybe_stream_checkpoint() is False
    worker._seen_stream_watermark = 1500
    assert worker.maybe_stream_checkpoint() is True
    assert trainer._push_future is None, "async push not joined"
    # a stream job's flushes re-assert the whole resident set
    assert tier.reassert is True
    for table in ("deepfm_emb", "deepfm_linear"):
        ids_after, rows_after = tier.table_rows(table)
        np.testing.assert_array_equal(rows_after,
                                      store.lookup(table, ids_after))
    record = worker.stream_barriers[-1]
    assert record["watermark"] == 1500
    assert record["written_back_rows"] > 0
    assert worker.maybe_stream_checkpoint() is False
    worker._seen_stream_watermark = 2500
    assert worker.maybe_stream_checkpoint() is True
    assert len(worker.stream_barriers) == 2
    trainer.close()


class _NullTrainer:
    def __init__(self):
        self.joins = self.flushes = 0
        self.device_tier = types.SimpleNamespace(
            reassert=False, stats=lambda: collections.defaultdict(int))

    def join_pushes(self):
        self.joins += 1

    def flush_device_tier(self):
        self.flushes += 1


WATERMARKS = [0, 300, 900, 1000, 1000, 1999, 2000, 4500, 4600, 6000,
              6001, 12000, 0, 12001]


def test_boundary_decisions_equal_the_reference(monkeypatch):
    """The same watermark sequence fires the port's worker barrier where
    it fires the reference's."""
    from elasticdl_tpu.worker import worker as ref_worker

    monkeypatch.setenv("EDL_STREAM_CHECKPOINT_EVERY", "1000")
    ref = ref_worker.Worker(FakeMasterClient(), "tests.models.mnist_with_export",
                            RecordIODataReader(data_dir="/nonexistent"),
                            minibatch_size=8)
    port = _worker(monkeypatch, 1000)
    fired = {}
    for name, worker in (("ref", ref), ("port", port)):
        worker.trainer = _NullTrainer()
        decisions = []
        for watermark in WATERMARKS:
            worker._seen_stream_watermark = watermark
            decisions.append(worker.maybe_stream_checkpoint())
        fired[name] = (decisions, worker.trainer.joins,
                       worker.trainer.flushes)
    assert fired["port"] == fired["ref"]
    assert fired["port"][1] == sum(fired["port"][0]) > 0
    # in a stream job the port's tier flushes re-assert the whole
    # resident set (a stream PS may have evicted clean rows it holds)
    assert port.trainer.device_tier.reassert is True


def test_a_reported_task_refreshes_the_watermark(monkeypatch):
    """After each reported window task the worker reads the watermark
    off a fresh CommInfo, so a boundary fires at the report that
    crossed it, not at the next heartbeat."""
    master = FakeMasterClient(watermarks=[256, 512, 768, 1024])
    worker = _worker(monkeypatch, 512, master=master)
    worker.trainer = _NullTrainer()
    reported = iter([1, 0, 1, 0, 1, 0, 1])
    worker.tds = types.SimpleNamespace(
        report_record_done=lambda n: next(reported))
    fired = []
    for _ in range(7):
        before = len(worker.stream_barriers)
        worker._after_train_batch({"_mask": np.ones(8, np.float32)},
                                  loss=0.0)
        fired.append(len(worker.stream_barriers) - before)
    assert master.comm_calls == 4
    # 256 anchors boundary 0; 512 and 1024 cross boundaries 1 and 2
    assert fired == [0, 0, 1, 0, 0, 0, 1]
    assert [r["watermark"] for r in worker.stream_barriers] == [512, 1024]


def test_lifecycle_events_thread_through_postmortem(tmp_path, monkeypatch):
    monkeypatch.setenv(events.EVENTS_DIR_ENV, str(tmp_path))
    events.configure("ps-0")
    try:
        clock = [0.0]
        store = NumpyEmbeddingStore(seed=0)
        store.set_optimizer("sgd", lr=1.0)
        lc = EmbeddingLifecycle(store, admit_k=1, ttl_secs=5.0,
                                clock=lambda: clock[0])
        servicer = PserverServicer(store, use_async=True, lifecycle=lc,
                                   staleness_modulation=False)
        infos = pb.Model()
        infos.embedding_table_infos.add(name="t", dim=2,
                                        initializer="zeros")
        servicer.push_embedding_table_infos(infos)
        request = pb.PushGradientsRequest()
        serialize_indexed_slices(np.ones((2, 2), np.float32),
                                 np.array([1, 2], np.int64),
                                 request.gradients.embedding_tables["t"])
        servicer.push_gradients(request)
        clock[0] = 50.0
        servicer.lifecycle_tick()
        events.emit("stream_watermark", watermark=1024, kind="checkpoint")
        events.flush()
    finally:
        events._reset_for_tests()
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        postmortem = importlib.import_module("postmortem")
    finally:
        sys.path.pop(0)
    report = postmortem.postmortem(str(tmp_path))
    summary = report["summary"]
    assert summary["lifecycle"]["rows_admitted"] == 2
    assert summary["lifecycle"]["rows_evicted_ttl"] == 2
    assert summary["evicted_ids"].get("t/1") == "ttl"
    assert summary["stream"]["watermark"] == 1024
    assert summary["stream"]["checkpoints"] == 1
    text = postmortem.render_text(report["timeline"], summary,
                                  report["dumps"], report["alert_counters"])
    assert "embedding lifecycle" in text
    assert "watermark=1024" in text


# ---------------------------------------------------------------------
# (c) the PS's stream checkpoint boundary


def make_servicer(tmp_path, monkeypatch, restored_version=None, pkg=None):
    monkeypatch.setenv("EDL_CKPT_ASYNC", "0")
    if pkg is None:
        store_mod = importlib.import_module(
            "elasticdl_tpu_torch.ps.embedding_store")
        saver_cls, servicer_cls = SparseCheckpointSaver, PserverServicer
    else:
        store_mod = importlib.import_module(pkg + ".ps.embedding_store")
        saver_cls = importlib.import_module(
            pkg + ".ps.checkpoint").SparseCheckpointSaver
        servicer_cls = importlib.import_module(
            pkg + ".ps.servicer").PserverServicer
    store = store_mod.NumpyEmbeddingStore(seed=0)
    store.set_optimizer("sgd", lr=1.0)
    store.create_table("t", 4, initializer="zeros")
    servicer = servicer_cls(store, use_async=True,
                            checkpoint_saver=saver_cls(str(tmp_path)),
                            restored_version=restored_version)
    return servicer, store


def _push(servicer, ids, pbm=pb, serialize=serialize_indexed_slices):
    ids = np.asarray(ids, np.int64)
    request = pbm.PushGradientsRequest()
    serialize(np.ones((ids.size, 4), np.float32), ids,
              request.gradients.embedding_tables["t"])
    return servicer.push_gradients(request)


def test_stream_boundary_fresh_boot_saves_from_first_crossing(
        tmp_path, monkeypatch):
    servicer, store = make_servicer(tmp_path, monkeypatch)
    _push(servicer, [0])
    assert not servicer.maybe_stream_checkpoint(50, 100)
    assert servicer._stream_ckpt_boundary == 0
    assert servicer.maybe_stream_checkpoint(250, 100)
    assert servicer._stream_ckpt_boundary == 2
    assert not servicer.maybe_stream_checkpoint(260, 100)
    assert servicer.maybe_stream_checkpoint(300, 100)
    assert servicer._stream_ckpt_boundary == 3
    assert SparseCheckpointSaver.latest_version(str(tmp_path)) == \
        store.version


def test_stream_boundary_restored_boot_anchors_at_first_watermark(
        tmp_path, monkeypatch):
    servicer, store = make_servicer(tmp_path, monkeypatch,
                                    restored_version=5)
    _push(servicer, [0])
    assert not servicer.maybe_stream_checkpoint(250, 100)
    assert servicer._stream_ckpt_boundary == 2
    assert SparseCheckpointSaver.latest_version(str(tmp_path)) is None
    assert not servicer.maybe_stream_checkpoint(299, 100)
    assert servicer.maybe_stream_checkpoint(300, 100)
    assert SparseCheckpointSaver.latest_version(str(tmp_path)) == \
        store.version


def test_stream_boundary_guards(tmp_path, monkeypatch):
    servicer, _ = make_servicer(tmp_path, monkeypatch)
    assert not servicer.maybe_stream_checkpoint(0, 100)
    assert not servicer.maybe_stream_checkpoint(100, 0)
    store = NumpyEmbeddingStore(seed=0)
    store.set_optimizer("sgd", lr=1.0)
    saverless = PserverServicer(store, use_async=True)
    assert not saverless.maybe_stream_checkpoint(100, 10)


@pytest.mark.parametrize("restored", [None, 3])
def test_stream_boundary_decisions_equal_the_reference(
        tmp_path, monkeypatch, restored):
    rng = np.random.RandomState(4)
    watermarks = np.cumsum(rng.randint(0, 90, size=60)).tolist()
    runs = {}
    for pkg in ("elasticdl_tpu", "elasticdl_tpu_torch"):
        pbm = importlib.import_module(pkg + ".proto.elasticdl_tpu_pb2")
        tu = importlib.import_module(pkg + ".common.tensor_utils")
        directory = tmp_path / pkg
        servicer, store = make_servicer(directory, monkeypatch,
                                        restored_version=restored, pkg=pkg)
        decisions = []
        for i, watermark in enumerate(watermarks):
            _push(servicer, [i % 7], pbm=pbm,
                  serialize=tu.serialize_indexed_slices)
            decisions.append((servicer.maybe_stream_checkpoint(
                watermark, 250), servicer._stream_ckpt_boundary))
        saves = sorted(name for name in os.listdir(directory))
        runs[pkg] = (decisions, saves)
    assert runs["elasticdl_tpu_torch"] == runs["elasticdl_tpu"]
    assert sum(d for d, _ in runs["elasticdl_tpu"][0]) > 2


def test_version_reports_leave_the_push_path():
    """The PS reports its store's versions to the master from a thread
    of their own: a push returns while a slow report is in flight, the
    reports come in rising order, later ones coalesce, and the newest
    version always reaches the master (the evaluation trigger needs only
    the crossings of eval_steps)."""
    import threading
    import time

    gate = threading.Event()
    reported = []

    class SlowMaster:
        def report_version(self, version):
            gate.wait(5.0)
            reported.append(version)

    store = NumpyEmbeddingStore(seed=0)
    store.set_optimizer("sgd", lr=1.0)
    servicer = PserverServicer(store, use_async=True,
                               master_client=SlowMaster())
    infos = pb.Model()
    infos.embedding_table_infos.add(name="t", dim=4, initializer="zeros")
    servicer.push_embedding_table_infos(infos)
    t0 = time.monotonic()
    for i in range(20):
        _push(servicer, [i % 5])
    assert time.monotonic() - t0 < 2.0, "a push waited on its report"
    assert reported == []
    gate.set()
    deadline = time.monotonic() + 5.0
    while (not reported or reported[-1] != store.version) and (
            time.monotonic() < deadline):
        time.sleep(0.01)
    assert reported[-1] == store.version == 20
    assert reported == sorted(set(reported)) and len(reported) < 20
