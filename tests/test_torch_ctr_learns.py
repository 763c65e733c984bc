"""The port's CTR zoo learns: tests/test_model_zoo.py's
test_ctr_family_learns on the port.

Wide&Deep, DCN and xDeepFM at the zoo's defaults (vocab 1M, dim 8)
train through the port's ``LocalExecutor`` on the CPU over the port's
copy of the CTR RecordIO fixture (ten uniform ids a record, a planted
linear signal in the label): the loss falls and the validation AUC
clears the reference test's 0.7.
"""

import os

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.data import recordio
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.train.local_executor import LocalExecutor

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps these small-shape tests from oversubscribing
# the host's cores under other files' timing-sensitive tests
torch.set_num_threads(1)

ZOO = ("wide_deep", "dcn", "xdeepfm")


def create_ctr_recordio(path, num_records=256, num_features=10, vocab=1000,
                        seed=0):
    """The port's copy of tests/test_utils.py:create_ctr_recordio:
    uniform ids, label = 1 when a planted linear score (weights fixed,
    independent of ``seed``) plus 0.1 noise is positive."""
    rng = np.random.RandomState(seed)
    weights = np.random.RandomState(12345).randn(vocab) * 2
    payloads = []
    for _ in range(num_records):
        ids = rng.randint(0, vocab, size=num_features).astype(np.int64)
        score = weights[ids].sum() / np.sqrt(num_features)
        label = np.int64(1 if score + rng.randn() * 0.1 > 0 else 0)
        payloads.append(encode_example({"ids": ids, "label": label}))
    recordio.write_records(path, payloads)
    return path


@pytest.mark.parametrize("variant", ZOO)
def test_ctr_family_learns(tmp_path, variant):
    """tests/test_model_zoo.py::test_ctr_family_learns on the port: the
    zoo's defaults (vocab 1M, dim 8), 2048 records, batch 64, 2 epochs;
    the loss falls and the validation AUC clears the reference's 0.7."""
    dirs = []
    for name, seed in (("train", 0), ("valid", 1)):
        os.makedirs(tmp_path / name)
        create_ctr_recordio(str(tmp_path / name / "f0.rec"), num_records=2048,
                            seed=seed)
        dirs.append(str(tmp_path / name))
    executor = LocalExecutor(
        "elasticdl_tpu_torch.models." + variant, training_data=dirs[0],
        validation_data=dirs[1], minibatch_size=64, num_epochs=2,
        device="cpu",
    )
    losses = executor.train()
    assert len(losses) == 64 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert executor.evaluate()["auc"] > 0.7
