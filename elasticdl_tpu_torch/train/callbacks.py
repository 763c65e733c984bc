"""Training callbacks (port of elasticdl_tpu/train/callbacks.py).

``Callback`` is the hook surface the worker drives: ``on_batch_end``
after every training batch, ``on_train_end`` on the job's
TRAIN_END_CALLBACK task. ``MaxStepsStopping`` stops the worker's
training after a step count; ``LearningRateScheduler`` sets the
learning rate from the model version each batch; ``SavedModelExporter``
writes the export bundle to the task's ``saved_model_path``.
"""

import dataclasses

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.train.callbacks")


class Callback:
    def __init__(self):
        self.worker = None  # set by the worker before training

    def set_worker(self, worker):
        self.worker = worker

    def on_batch_end(self, step, loss):
        pass

    def on_task_end(self, task):
        pass

    def on_train_end(self, state, extended_config=None):
        pass


class MaxStepsStopping(Callback):
    """Stop training once ``max_steps`` minibatches have run: the
    worker then drains the remaining tasks without training."""

    def __init__(self, max_steps):
        super().__init__()
        self._max_steps = max_steps

    def on_batch_end(self, step, loss):
        if step >= self._max_steps and self.worker is not None:
            self.worker.stop_training = True


class LearningRateScheduler(Callback):
    """Set the learning rate from the model version each batch: the
    learning rate of an optimizer built by
    ``create_host_schedulable_optimizer`` lives in its state, and this
    rewrites it between steps. With any other optimizer it is a no-op,
    warned once (a schedule given to ``create_optimizer`` as the
    ``learning_rate`` runs inside the update instead)."""

    def __init__(self, schedule):
        super().__init__()
        self.schedule = schedule
        self._warned = False

    def on_batch_end(self, step, loss):
        from elasticdl_tpu_torch.train.optimizers import set_learning_rate

        worker = self.worker
        state = getattr(worker, "state", None)
        if state is None:
            return
        new_opt_state = set_learning_rate(state.opt_state,
                                          self.schedule(step))
        if new_opt_state is None:
            if not self._warned:
                self._warned = True
                logger.warning(
                    "LearningRateScheduler: the optimizer holds no "
                    "learning rate in its state (build it with "
                    "create_host_schedulable_optimizer); schedule ignored")
            return
        worker.state = dataclasses.replace(state, opt_state=new_opt_state)


class SavedModelExporter(Callback):
    """Export the trained state on the TRAIN_END_CALLBACK task (one
    worker receives it). ``export_fn(state, path)`` replaces the
    default ``train.export.export_train_state``."""

    def __init__(self, export_fn=None):
        super().__init__()
        self._export_fn = export_fn

    def on_train_end(self, state, extended_config=None):
        path = (extended_config or {}).get("saved_model_path")
        if not path:
            return
        if state is None:
            # defense in depth: the worker fails the task before this
            raise RuntimeError("no trained state to export")
        if self._export_fn is not None:
            self._export_fn(state, path)
            return
        from elasticdl_tpu_torch.train.export import export_train_state

        spec = getattr(self.worker, "spec", None)
        if spec is not None and getattr(
            spec, "sparse_embedding_specs", None
        ):
            logger.warning(
                "Export holds the DENSE state only; this model's sparse "
                "embedding tables live on the PS: serve them from the "
                "PS (--ps_addrs) and its checkpoints, or use "
                "train/model_handler's promoted export to bundle them"
            )
        export_train_state(state, path)
