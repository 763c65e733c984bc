"""Run the model-zoo contract locally, no master or cluster (port of
elasticdl_tpu/train/local_executor.py).

``LocalExecutor`` reads RecordIO data through the module's
``dataset_fn``, batches it with padding masks and trains, evaluates or
predicts on ``device`` (``cuda`` unless the caller asks for the CPU).
A dense model trains through ``TorchTrainer``. A model with sparse
embedding specs (DeepFM) trains through ``SparseTrainer`` over an
in-process embedding store (``LocalPSClient``), with the device tier
when ``EDL_DEVICE_TIER`` turns it on. The weights are initialised from
``seed``. Observability as in the distributed roles, under role
``local``: ``EDL_TRACE_DIR`` makes each step a ``train_batch`` root span,
``EDL_EVENTS_DIR`` opens the journal, ``EDL_PROF_HZ`` starts the host
stack sampler and ``EDL_METRICS_PORT`` serves ``/metrics``,
``/healthz`` and ``/readyz``.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.data.pipeline import (
    Dataset,
    batch_real_count,
    normalize_outputs,
)
from elasticdl_tpu_torch.data.readers import create_data_reader
from elasticdl_tpu_torch.models.registry import get_model_spec
from elasticdl_tpu_torch.observability import (
    events,
    http_server,
    profiler,
    trace,
)
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.ps.local_client import LocalPSClient
from elasticdl_tpu_torch.train.metrics import EvaluationMetrics
from elasticdl_tpu_torch.train.sparse import SparseTrainer
from elasticdl_tpu_torch.worker.trainer import TorchTrainer

logger = _logger_factory("elasticdl_tpu_torch.train.local_executor")


class LocalExecutor:
    def __init__(
        self,
        model_zoo_module,
        training_data=None,
        validation_data=None,
        minibatch_size=32,
        num_epochs=1,
        data_reader_params=None,
        compute_dtype=None,
        seed=0,
        model_def="",
        model_params="",
        symbol_overrides=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.spec = get_model_spec(
            model_zoo_module, model_def=model_def,
            model_params=model_params,
            symbol_overrides=symbol_overrides,
        )
        self.spec.require_training()
        self._minibatch_size = minibatch_size
        self._num_epochs = num_epochs
        reader_params = data_reader_params or {}
        self._train_reader = (
            create_data_reader(training_data, **reader_params)
            if training_data
            else None
        )
        self._valid_reader = (
            create_data_reader(validation_data, **reader_params)
            if validation_data
            else None
        )
        # the weights come from ``seed`` without touching the caller's
        # global RNG stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = self.spec.custom_model()
        if self.spec.sparse_embedding_specs:
            # sparse model locally: in-process embedding store, no gRPC
            self.trainer = SparseTrainer(
                model=model,
                loss_fn=self.spec.loss,
                optimizer=self.spec.optimizer(),
                specs=self.spec.sparse_embedding_specs(
                    batch_size=minibatch_size
                ),
                ps_client=LocalPSClient(seed=seed),
                compute_dtype=compute_dtype,
                seed=seed,
                device=self.device,
            )
        else:
            self.trainer = TorchTrainer(
                model=model,
                loss_fn=self.spec.loss,
                optimizer=self.spec.optimizer(),
                compute_dtype=compute_dtype,
                device=self.device,
                seed=seed,
            )
        self.state = None
        # observability: opt-in through the distributed roles' knobs
        trace.configure("local")
        events.configure("local")
        profiler.maybe_start("local")
        self.observability = http_server.maybe_start("local")
        if self.observability is not None:
            # a local run is ready as soon as the trainer exists
            self.observability.add_readiness_check(
                "trainer_constructed", lambda: self.trainer is not None
            )

    # ------------------------------------------------------------------
    def _records(self, reader):
        def gen():
            for shard_name, (start, count) in reader.create_shards().items():
                task = pb.Task(
                    task_id=0,
                    shard_name=shard_name,
                    start=start,
                    end=start + count,
                )
                yield from reader.read_records(task)

        return Dataset(gen)

    def _batches(self, reader, mode):
        dataset = self.spec.dataset_fn(
            self._records(reader), mode, reader.metadata
        )
        return dataset.batch(self._minibatch_size).prefetch(2)

    # ------------------------------------------------------------------
    def train(self):
        """Train for ``num_epochs``; returns the per-step losses."""
        losses = []
        step = 0
        for epoch in range(self._num_epochs):
            for batch in self._batches(self._train_reader, "training"):
                # each step is a root span, as in the distributed run;
                # the in-process store's spans chain under it
                with trace.root_span("train_batch", role="worker",
                                     step=step):
                    self.state, loss = self.trainer.train_step(
                        self.state, batch)
                losses.append(float(loss))
                step += 1
            logger.info(
                "Epoch %d done; last-batch loss %.4f", epoch, losses[-1]
            )
            if self._valid_reader is not None:
                summary = self.evaluate()
                logger.info("Epoch %d eval: %s", epoch, summary)
        return losses

    def evaluate(self):
        books = EvaluationMetrics(self.spec.eval_metrics_fn())
        for batch in self._batches(self._valid_reader, "evaluation"):
            self.state = self.trainer.ensure_state(self.state, batch)
            outputs = self.trainer.eval_step(self.state, batch)
            real = batch_real_count(batch)
            books.update_evaluation_metrics(
                normalize_outputs(outputs, real),
                np.asarray(batch["labels"])[:real],
            )
        return books.get_evaluation_summary()

    def predict(self, data=None):
        reader = (
            create_data_reader(data) if data is not None else self._valid_reader
        )
        results = []
        for batch in self._batches(reader, "prediction"):
            self.state = self.trainer.ensure_state(self.state, batch)
            outputs = self.trainer.eval_step(self.state, batch)
            real = batch_real_count(batch)
            results.append(normalize_outputs(outputs, real)["output"])
        return results
