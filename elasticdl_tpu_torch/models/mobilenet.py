"""MobileNetV2 (inverted residual bottlenecks), port of
elasticdl_tpu/models/mobilenet.py.

NHWC features, NCHW compute in channels_last memory (as
models/resnet.py), depthwise convs as grouped convs (``groups=hidden``;
flax's ``(3, 3, 1, C)`` kernel is the ``(C, 1, 3, 3)`` weight), ReLU6,
widths rounded to multiples of 8, ``TpuBatchNorm``. The 3x3 convs pad
"SAME" as XLA does: a stride-2 window over an even size pads (0, 1),
over an odd size (1, 1).

``small_inputs=True`` keeps the CIFAR stem at stride 1 and the second
stage's first block at stride 1 (32x32 inputs would otherwise collapse
before the deep stages). Submodules carry flax's scope names, so
``params_from_flax`` maps the reference's params and ``batch_stats``
(models/layers.py); the port takes ``in_channels`` where flax infers
it.
"""

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.models.layers import (  # noqa: F401
    Conv,
    Dense,
    FlaxNamed,
    params_from_flax,  # the zoo contract's name
)
from elasticdl_tpu_torch.ops.batch_norm import TpuBatchNorm
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sparse_softmax_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _norm(features):
    return TpuBatchNorm(features, momentum=0.9)


class InvertedResidual(torch.nn.Module):
    def __init__(self, in_features, filters, strides=1, expand_ratio=6):
        super().__init__()
        hidden = in_features * expand_ratio
        self.expand = expand_ratio != 1
        self.residual = strides == 1 and in_features == filters
        layers = []
        if self.expand:
            layers.append(Conv(in_features, hidden, (1, 1), use_bias=False))
        # depthwise: one group per channel
        layers.append(Conv(hidden, hidden, (3, 3), strides=strides,
                           padding="SAME", groups=hidden, use_bias=False))
        layers.append(Conv(hidden, filters, (1, 1), use_bias=False))
        for i, conv in enumerate(layers):
            self.add_module("Conv_%d" % i, conv)
            self.add_module("BatchNorm_%d" % i, _norm(conv.weight.shape[0]))
        self.num_convs = len(layers)

    def forward(self, x):
        residual = x
        for i in range(self.num_convs):
            x = getattr(self, "BatchNorm_%d" % i)(
                getattr(self, "Conv_%d" % i)(x))
            if i < self.num_convs - 1:
                x = F.relu6(x)
        return x + residual if self.residual else x


# (expand_ratio, filters, repeats, first_stride)
_V2_CONFIG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2(FlaxNamed):
    def __init__(self, num_classes=1000, width_multiplier=1.0,
                 small_inputs=False, in_channels=3):
        super().__init__()
        stem = _make_divisible(32 * width_multiplier)
        self.Conv_0 = Conv(in_channels, stem, (3, 3),
                           strides=1 if small_inputs else 2,
                           padding="SAME", use_bias=False)
        self.BatchNorm_0 = _norm(stem)
        width, index = stem, 0
        for i, (expand, filters, repeats, stride) in enumerate(_V2_CONFIG):
            filters = _make_divisible(filters * width_multiplier)
            for r in range(repeats):
                if small_inputs and i == 1 and r == 0:
                    stride_r = 1  # keep 32x32 resolution one stage longer
                else:
                    stride_r = stride if r == 0 else 1
                self.add_module("InvertedResidual_%d" % index,
                                InvertedResidual(width, filters, stride_r,
                                                 expand))
                width, index = filters, index + 1
        self.num_blocks = index
        head = _make_divisible(max(1280 * width_multiplier, 1280))
        self.Conv_1 = Conv(width, head, (1, 1), use_bias=False)
        self.BatchNorm_1 = _norm(head)
        self.Dense_0 = Dense(head, num_classes, dtype=torch.float32)
        self.reset_parameters()
        self.channels_last_()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, channels_last memory
        x = F.relu6(self.BatchNorm_0(self.Conv_0(x)))
        for i in range(self.num_blocks):
            x = getattr(self, "InvertedResidual_%d" % i)(x)
        x = F.relu6(self.BatchNorm_1(self.Conv_1(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))


def mobilenetv2(num_classes=1000, **kwargs):
    return MobileNetV2(num_classes=num_classes, **kwargs)


def custom_model(num_classes=10, small_inputs=True, **kwargs):
    return MobileNetV2(num_classes=num_classes, small_inputs=small_inputs,
                       **kwargs)


def loss(labels, predictions):
    return sparse_softmax_cross_entropy(labels, predictions)


def optimizer():
    return create_optimizer(
        "Momentum", learning_rate=0.02, momentum=0.9, nesterov=True
    )


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(payload):
        example = decode_example(payload)
        image = example["image"].astype(np.float32) / 255.0
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        return image, example["label"].astype(np.int32).reshape(())

    return dataset.map(parse)


def eval_metrics_fn():
    return {"accuracy": metrics.Accuracy()}
