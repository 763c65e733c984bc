"""DeepFM with a prediction sink: the zoo's DeepFM contract, plus a
``PredictionOutputsProcessor`` that writes each worker's predictions to
a file, for prediction-only jobs.

    EDL_PREDICTION_DIR=/out python -m elasticdl_tpu_torch.worker.main \\
        --model_zoo elasticdl_tpu_torch.models.deepfm_predictions \\
        --mode prediction --prediction_data ... \\
        --checkpoint_dir_for_init ...

Each prediction batch's real rows of the ``output`` column (the logits)
are appended as float32 to ``<EDL_PREDICTION_DIR>/predictions-worker-
<id>.f32``, in the order the worker takes its tasks; ``close`` flushes
and fsyncs them before the worker reports the task done.
"""

import os
import re

import numpy as np

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.models.deepfm import (  # noqa: F401 (the contract)
    custom_model,
    dataset_fn,
    eval_metrics_fn,
    loss,
    optimizer,
    params_from_flax,
    sparse_embedding_specs,
)

PREDICTION_DIR_ENV = "EDL_PREDICTION_DIR"
_FILE_RE = re.compile(r"^predictions-worker-(\d+)\.f32$")


class PredictionOutputsProcessor:
    """One per prediction task (the worker builds it per task)."""

    def __init__(self):
        self._dir = env_str(PREDICTION_DIR_ENV, "")
        if not self._dir:
            raise ValueError("set %s to the directory the predictions go "
                             "to" % PREDICTION_DIR_ENV)
        os.makedirs(self._dir, exist_ok=True)
        self._file = None

    def process(self, outputs, worker_id):
        if self._file is None:
            self._file = open(os.path.join(
                self._dir, "predictions-worker-%d.f32" % worker_id), "ab")
        np.ascontiguousarray(outputs["output"], np.float32).tofile(
            self._file)

    def close(self):
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
            self._file = None


def read_predictions(directory):
    """{worker id: float32 predictions in write order} under
    ``directory``."""
    out = {}
    for name in sorted(os.listdir(directory)):
        match = _FILE_RE.match(name)
        if match:
            out[int(match[1])] = np.fromfile(os.path.join(directory, name),
                                             np.float32)
    return out
