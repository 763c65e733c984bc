"""tests/test_model_zoo.py's learning scenarios of the feature-column
family and iris on the port: iris over CSV, census_wide_deep and heart
through the port's ``LocalExecutor`` on the CPU, at the reference
tests' sizes and floors (census_dnn and census_sqlflow_wide_deep in
tests/test_torch_census_learns.py).

Each model starts from the reference's own initial weights (its
``LocalExecutor`` at seed 0 on the same first batch, carried across by
``params_from_flax``), so the run is the reference test's from the same
start: the port's own draw at seed 0 differs, and the floors were set
on the reference's draw.
"""

import importlib

import numpy as np
import torch
from flax import traverse_util

from elasticdl_tpu.data.example import encode_example
from elasticdl_tpu.data.recordio import write_records
from elasticdl_tpu.train.local_executor import LocalExecutor as RefExecutor
from elasticdl_tpu_torch.data.gen import (
    gen_census_recordio,
    gen_heart_recordio,
)
from elasticdl_tpu_torch.train.local_executor import LocalExecutor

torch.set_num_threads(1)


def create_iris_csv(path, num_records=120, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(num_records):
            label = rng.randint(0, 3)
            base = np.array([4.5, 3.0, 1.5, 0.2]) + label * np.array(
                [1.0, 0.2, 1.8, 0.9]
            )
            row = base + rng.randn(4) * 0.2
            f.write(",".join("%.3f" % v for v in row) + ",%d\n" % label)
    return path


def create_census_recordio(path, num_records=256, seed=0):
    """tests/test_model_zoo.py's census records: high hours + married +
    gov job -> label 1."""
    from elasticdl_tpu_torch.data.census_schema import (
        MARITAL_STATUS_VOCABULARY,
        WORK_CLASS_VOCABULARY,
    )

    rng = np.random.RandomState(seed)
    payloads = []
    educations = ["HS", "BA", "MS", "PhD"]
    occupations = ["eng", "sales", "admin", "exec"]
    for _ in range(num_records):
        age = rng.uniform(17, 80)
        hours = rng.uniform(10, 70)
        work = WORK_CLASS_VOCABULARY[rng.randint(len(WORK_CLASS_VOCABULARY))]
        marital = MARITAL_STATUS_VOCABULARY[
            rng.randint(len(MARITAL_STATUS_VOCABULARY))]
        score = (
            (hours - 40) / 15.0
            + (1.5 if marital == "Married-civ-spouse" else -0.5)
            + (1.0 if "gov" in work.lower() else 0.0)
        )
        label = 1 if score + rng.randn() * 0.3 > 0 else 0
        payloads.append(encode_example({
            "age": np.float32(age),
            "hours_per_week": np.float32(hours),
            "work_class": np.array(work),
            "marital_status": np.array(marital),
            "education": np.array(educations[rng.randint(len(educations))]),
            "occupation": np.array(
                occupations[rng.randint(len(occupations))]),
            "label": np.int64(label),
        }))
    write_records(path, payloads)
    return path


def _learn(name, train_dir, valid_dir, batch, epochs):
    """The port's executor for ``name`` from the reference executor's
    initial weights; returns (losses, evaluation summary)."""
    kwargs = dict(training_data=str(train_dir),
                  validation_data=str(valid_dir), minibatch_size=batch,
                  num_epochs=epochs)
    ref = RefExecutor("elasticdl_tpu.models." + name, **kwargs)
    first = next(iter(ref._batches(ref._train_reader, "training")))
    params = ref.trainer.ensure_state(None, first).params
    flat = {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    executor = LocalExecutor("elasticdl_tpu_torch.models." + name,
                             device="cpu", **kwargs)
    port_mod = importlib.import_module("elasticdl_tpu_torch.models." + name)
    executor.trainer.model.load_state_dict(port_mod.params_from_flax(flat),
                                           strict=True)
    losses = executor.train()
    return losses, executor.evaluate()


def _dirs(tmp_path):
    train_dir, valid_dir = tmp_path / "train", tmp_path / "valid"
    train_dir.mkdir()
    valid_dir.mkdir()
    return train_dir, valid_dir


def test_iris_dnn_learns(tmp_path):
    train_dir, valid_dir = _dirs(tmp_path)
    create_iris_csv(str(train_dir / "iris.csv"), seed=0)
    create_iris_csv(str(valid_dir / "iris.csv"), seed=1)
    losses, summary = _learn("iris_dnn", train_dir, valid_dir, 16, 10)
    assert losses[-1] < losses[0]
    assert summary["accuracy"] > 0.85


def test_census_wide_deep_learns(tmp_path):
    train_dir, valid_dir = _dirs(tmp_path)
    create_census_recordio(str(train_dir / "f0.rec"), 1024, seed=0)
    create_census_recordio(str(valid_dir / "f0.rec"), 1024, seed=1)
    losses, summary = _learn("census_wide_deep", train_dir, valid_dir, 64,
                             10)
    assert losses[-1] < losses[0]
    assert summary["auc"] > 0.75


def learn_generated(tmp_path, name, floor, records, epochs):
    """test_census_dnn_learns, test_census_sqlflow_wide_deep_learns and
    test_heart_learns on the port, over the port's generators."""
    train_dir, valid_dir = _dirs(tmp_path)
    maker = gen_heart_recordio if name == "heart" else gen_census_recordio
    maker(str(train_dir), num_records=records[0], seed=0)
    maker(str(valid_dir), num_records=records[1], seed=1)
    losses, summary = _learn(name, train_dir, valid_dir, 64, epochs)
    assert losses[-1] < losses[0]
    assert summary["auc"] > floor


def test_heart_learns(tmp_path):
    learn_generated(tmp_path, "heart", 0.7, (1024, 256), 10)
