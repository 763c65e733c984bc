"""MNIST CNN, the minimum end-to-end model, port of
elasticdl_tpu/models/mnist.py: two 3x3 convs ("SAME", with bias), a
2x2 max pool, Dense(128) sized by the first batch, dropout 0.25 and a
Dense(10) head. Features are [B, 28, 28] (a channel axis is added) or
NHWC; the flatten before the first Dense is in NHWC order, as the
reference's reshape. Submodules carry flax's scope names
(models/layers.py).
"""

import numpy as np
import torch.nn.functional as F

from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.models.layers import (  # noqa: F401
    Conv,
    Dense,
    Dropout,
    FlaxNamed,
    LazyDense,
    params_from_flax,  # the zoo contract's name
)
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sparse_softmax_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer


class MnistCNN(FlaxNamed):
    def __init__(self, num_classes=10, in_channels=1):
        super().__init__()
        self.Conv_0 = Conv(in_channels, 32, (3, 3))
        self.Conv_1 = Conv(32, 64, (3, 3))
        self.Dense_0 = LazyDense(128)
        self.dropout = Dropout(0.25)
        self.Dense_1 = Dense(128, num_classes)
        self.reset_parameters()

    def forward(self, x):
        if x.dim() == 3:
            x = x[..., None]  # NHW -> NHWC
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = self.dropout(F.relu(self.Dense_0(x)))
        return self.Dense_1(x)


def custom_model(num_classes=10, **kwargs):
    return MnistCNN(num_classes=num_classes, **kwargs)


def loss(labels, predictions):
    return sparse_softmax_cross_entropy(labels, predictions)


def optimizer():
    return create_optimizer("Adam", learning_rate=0.002)


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(payload):
        example = decode_example(payload)
        image = example["image"].astype(np.float32) / 255.0
        label = example["label"].astype(np.int32).reshape(())
        return image, label

    return dataset.map(parse)


def eval_metrics_fn():
    return {"accuracy": metrics.Accuracy()}
