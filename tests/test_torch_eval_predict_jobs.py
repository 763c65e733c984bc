"""Evaluation-only and prediction-only jobs on the port, on the CPU:
tests/test_eval_predict_jobs.py's three job tests on DeepFM. The port's
``Master`` (EVALUATION_ONLY and PREDICTION_ONLY job types) over live
gRPC, a ``Worker`` in evaluation or prediction mode restoring the dense
state from ``--checkpoint_dir_for_init``, the embedding rows from
in-process PS servicers that the training run left behind; the
evaluation summary lands in the master's books, the predictions go
through ``models/deepfm_predictions.py``'s processor into a file. Small
sizes (10 id fields, vocab 1000, batch 32); data made with numpy from a
seed. The scored outputs are checked bit for bit against the trained
worker's own ``eval_step`` on the same batches (one process, the same
PS rows and weights, the same batch shapes).

The reference's client dry run (``test_client_dry_run_evaluate_and_
predict``) waits for the port's client (ROADMAP Queue 1 item 9).
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.common.constants import JobType, Mode
from elasticdl_tpu_torch.common.grpc_utils import find_free_port
from elasticdl_tpu_torch.data.pipeline import Dataset, batch_real_count
from elasticdl_tpu_torch.data.readers import RecordIODataReader
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.models.deepfm_predictions import (
    PREDICTION_DIR_ENV,
    read_predictions,
)
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.worker import master_client
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.worker import CheckpointRestoreError, Worker
from tests.test_torch_job import PORT_ZOO, _ctr_dirs, _ps_pair
from tests.test_torch_train_end import _train_with_checkpoints

torch.set_num_threads(1)

PRED_ZOO = "elasticdl_tpu_torch.models.deepfm_predictions"


@pytest.fixture(autouse=True)
def _short_master_retry(monkeypatch):
    monkeypatch.setattr(master_client, "MASTER_RETRY_BUDGET_SECS", 5.0)


@pytest.fixture
def trained(tmp_path):
    """A DeepFM run (2 epochs of 128 records, 8 steps) with a dense
    checkpoint every 2 versions, over a PS pair that stays up."""
    servers, ps_addrs = _ps_pair()
    ckpt_dir = str(tmp_path / "ckpt")
    try:
        worker, train_dir, valid_dir = _train_with_checkpoints(
            tmp_path, ckpt_dir, ps_addrs)
        yield worker, ckpt_dir, ps_addrs, valid_dir
    finally:
        for server in servers:
            server.stop(None)


def _scoring_worker(port, zoo, data_dir, ps_addrs, mode, init_dir):
    return Worker(MasterClient("localhost:%d" % port, worker_id=0), zoo,
                  RecordIODataReader(data_dir=data_dir), minibatch_size=32,
                  mode=mode, wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                  checkpoint_dir_for_init=init_dir, device="cpu")


def _outputs_of(worker, state, data_dir, per_task):
    """The trained worker's eval_step outputs over ``data_dir`` in the
    jobs' batches (tasks of ``per_task`` records, minibatches of 32),
    with the labels."""
    reader = RecordIODataReader(data_dir=data_dir)
    outputs, labels = [], []
    for name, (start, count) in sorted(reader.create_shards().items()):
        for lo in range(start, start + count, per_task):
            task = pb.Task(shard_name=name, start=lo,
                           end=min(lo + per_task, start + count))
            batches = deepfm.dataset_fn(
                Dataset(lambda task=task: reader.read_records(task)),
                Mode.PREDICTION).batch(32)
            for batch in batches:
                real = batch_real_count(batch)
                outputs.append(np.asarray(
                    worker.trainer.eval_step(state, batch))[:real])
                labels.append(np.asarray(batch["labels"])[:real])
    return np.concatenate(outputs), np.concatenate(labels)


def test_evaluation_only_job_end_to_end(trained):
    worker, ckpt_dir, ps_addrs, valid_dir = trained
    port = find_free_port()
    master = Master(PORT_ZOO, validation_data=valid_dir,
                    records_per_task=64, port=port, task_timeout_secs=60.0)
    assert master.job_type == JobType.EVALUATION_ONLY
    master.prepare()
    try:
        scorer = _scoring_worker(port, PORT_ZOO, valid_dir, ps_addrs,
                                 Mode.EVALUATION, ckpt_dir)
        scorer.run()
        # it scored the checkpointed model, not random init
        assert scorer._restore_attempted and scorer.state is not None
        assert int(scorer.state.step) == worker.model_version == 8
        assert master.task_dispatcher.finished()
        (version, summary), = master.evaluation_service.completed_summaries
        assert set(summary) == {"auc", "accuracy"}
        outputs, labels = _outputs_of(worker, worker.state, valid_dir, 64)
        auc = metrics.AUC(from_logits=True)
        auc.update_state(labels, outputs)
        # the same outputs, ranked the same: the AUC to fp64 summation
        assert summary["auc"] == pytest.approx(auc.result(), abs=1e-9)
        assert summary["auc"] > 0.6
    finally:
        master.stop()


def test_evaluation_only_job_requires_restorable_checkpoint(tmp_path):
    """An evaluation job pointed at a missing init directory fails
    loudly instead of scoring random weights."""
    train_dir, valid_dir = _ctr_dirs(tmp_path, sizes=(64,), valid=64)
    servers, ps_addrs = _ps_pair()
    port = find_free_port()
    master = Master(PORT_ZOO, validation_data=valid_dir,
                    records_per_task=64, port=port,
                    task_timeout_secs=60.0).prepare()
    try:
        scorer = _scoring_worker(port, PORT_ZOO, valid_dir, ps_addrs,
                                 Mode.EVALUATION,
                                 str(tmp_path / "nonexistent"))
        with pytest.raises(CheckpointRestoreError):
            scorer.run()
        assert not master.evaluation_service.completed_summaries
        assert not master.task_dispatcher.finished()
    finally:
        master.stop()
        for server in servers:
            server.stop(None)


def test_prediction_only_job_end_to_end(trained, tmp_path, monkeypatch):
    worker, ckpt_dir, ps_addrs, valid_dir = trained
    pred_dir = tmp_path / "predictions"
    monkeypatch.setenv(PREDICTION_DIR_ENV, str(pred_dir))
    port = find_free_port()
    master = Master(PRED_ZOO, prediction_data=valid_dir,
                    records_per_task=64, port=port, task_timeout_secs=60.0)
    assert master.job_type == JobType.PREDICTION_ONLY
    done = []
    master.task_dispatcher.add_task_completed_callback(
        lambda t: done.append((t.type, t.start, t.end)))
    master.prepare()
    try:
        scorer = _scoring_worker(port, PRED_ZOO, valid_dir, ps_addrs,
                                 Mode.PREDICTION, ckpt_dir)
        scorer.run()
        assert master.task_dispatcher.finished()
        assert int(scorer.state.step) == 8
        # every record predicted once, the rows written before each
        # task was reported done
        assert sorted(done) == [(pb.PREDICTION, lo, lo + 64)
                                for lo in range(0, 128, 64)]
        predictions = read_predictions(str(pred_dir))
        assert list(predictions) == [0]
        rows = predictions[0]
        assert rows.shape == (128,) and np.isfinite(rows).all()
        want, _ = _outputs_of(worker, worker.state, valid_dir, 64)
        np.testing.assert_array_equal(rows, want)
    finally:
        master.stop()
