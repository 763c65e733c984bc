"""CIFAR-10 CNN (the reference's "functional API" baseline), port of
elasticdl_tpu/models/cifar10.py: a VGG-style conv stack with BatchNorm
and dropout over 32x32x3 images.

Its BatchNorm is flax's stock ``nn.BatchNorm(dtype=float32)``, not
``TpuBatchNorm``: it normalizes and outputs in float32, so under bf16
compute every conv after the first runs in float32, as flax promotes
(ops/batch_norm.py with ``dtype=torch.float32``; the same one-pass
statistics as flax's default fast variance). The flatten before the
first Dense is in NHWC order, as the reference's reshape, and that
Dense is sized by the first batch. The resnet/mobilenet CIFAR variants
are models/resnet.py (``small_inputs=True``) and models/mobilenet.py.
"""

import numpy as np
import torch
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
from elasticdl_tpu_torch.ops.batch_norm import BatchNorm
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sparse_softmax_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer


class Cifar10CNN(FlaxNamed):
    def __init__(self, num_classes=10, in_channels=3):
        super().__init__()
        width, index = in_channels, 0
        for filters in (32, 64, 128):
            for _ in range(2):
                self.add_module("Conv_%d" % index, Conv(
                    width, filters, (3, 3), padding="SAME", use_bias=False))
                self.add_module("BatchNorm_%d" % index, BatchNorm(
                    filters, momentum=0.9, dtype=torch.float32))
                width, index = filters, index + 1
        self.conv_dropout = Dropout(0.25)
        self.Dense_0 = LazyDense(512)
        self.dense_dropout = Dropout(0.5)
        self.Dense_1 = Dense(512, num_classes, dtype=torch.float32)
        self.reset_parameters()
        self.channels_last_()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, channels_last memory
        for index in range(6):
            x = getattr(self, "Conv_%d" % index)(x)
            x = F.relu(getattr(self, "BatchNorm_%d" % index)(x))
            if index % 2:
                x = self.conv_dropout(F.max_pool2d(x, 2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = self.dense_dropout(F.relu(self.Dense_0(x)))
        return self.Dense_1(x)


def custom_model(num_classes=10, **kwargs):
    return Cifar10CNN(num_classes=num_classes, **kwargs)


def loss(labels, predictions):
    return sparse_softmax_cross_entropy(labels, predictions)


def optimizer():
    return create_optimizer("Adam", learning_rate=0.001)


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(payload):
        example = decode_example(payload)
        image = example["image"].astype(np.float32) / 255.0
        if image.ndim == 2:  # grayscale fixtures -> 3 channels
            image = np.stack([image] * 3, axis=-1)
        return image, example["label"].astype(np.int32).reshape(())

    return dataset.map(parse)


def eval_metrics_fn():
    return {"accuracy": metrics.Accuracy()}
