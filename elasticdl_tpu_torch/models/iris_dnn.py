"""Iris DNN over CSV records (port of elasticdl_tpu/models/iris_dnn.py;
the reference's model_zoo/odps_iris_dnn_model): Dense 16, 16, 3 over 4
features, Adam 0.01. ``CSVDataReader`` yields each row as a list of
fields; a bytes or str record is split on commas.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.models.layers import (  # noqa: F401
    Dense,
    FlaxNamed,
    params_from_flax,  # the zoo contract's name
)
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sparse_softmax_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer


class IrisDNN(FlaxNamed):
    def __init__(self, num_classes=3, in_features=4):
        super().__init__()
        self.Dense_0 = Dense(in_features, 16)
        self.Dense_1 = Dense(16, 16)
        self.Dense_2 = Dense(16, num_classes, dtype=torch.float32)
        self.reset_parameters()

    def forward(self, x):
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)


def custom_model():
    return IrisDNN()


def loss(labels, predictions):
    return sparse_softmax_cross_entropy(labels, predictions)


def optimizer():
    return create_optimizer("Adam", learning_rate=0.01)


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(record):
        if isinstance(record, (bytes, bytearray, memoryview)):
            record = bytes(record).decode("utf-8")
        if isinstance(record, str):
            parts = record.strip().split(",")
        else:  # already a sequence of fields
            parts = list(record)
        features = np.array([float(v) for v in parts[:4]], np.float32)
        label = np.int32(float(parts[4])) if len(parts) > 4 else np.int32(0)
        return features, label.reshape(())

    return dataset.map(parse)


def eval_metrics_fn():
    return {"accuracy": metrics.Accuracy()}
