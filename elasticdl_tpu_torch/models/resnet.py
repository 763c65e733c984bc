"""ResNet v1.5 family (ResNet18/34/50/101/152), port of
elasticdl_tpu/models/resnet.py.

Features are NHWC, as the zoo's ``dataset_fn`` yields them. The model
permutes them once to NCHW, which for a contiguous NHWC batch is a
channels_last tensor, and keeps its conv weights channels_last: cuDNN's
fast bf16 path. ``TpuBatchNorm`` (ops/batch_norm.py) keeps the
reference's f32 single-pass statistics with the stream in the compute
dtype; the last BatchNorm of each block starts with scale 0, and the
head is ``Dense(dtype=float32)``, so under bf16 compute the logits are
fp32.

The stems: "conv7" (7x7/2, then a 3x3/2 max pool), "space_to_depth"
(the input packed 2x2 into channels, then a 4x4/1 conv whose "SAME"
padding is (1, 2) on each spatial axis, applied by an explicit pad),
and ``small_inputs`` (the cifar 3x3/1 stem, no pool).

Submodules carry flax's scope names (``Conv_0``, ``BatchNorm_0``,
``BottleneckBlock_0``, ..., ``Dense_0``), so ``params_from_flax`` maps
the reference's params and ``batch_stats`` by layout alone
(models/layers.py). flax infers the input's channels; the port takes
``in_channels`` (3, or 1 for a grayscale [B, H, W] batch).
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


def _norm(features, scale_init=1.0):
    return TpuBatchNorm(features, momentum=0.9, epsilon=1e-5,
                        scale_init=scale_init)


class BottleneckBlock(torch.nn.Module):
    expansion = 4

    def __init__(self, in_features, filters, strides=1):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_features, filters, (1, 1), use_bias=False)
        self.BatchNorm_0 = _norm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides=strides,
                           padding=((1, 1), (1, 1)), use_bias=False)
        self.BatchNorm_1 = _norm(filters)
        self.Conv_2 = Conv(filters, out, (1, 1), use_bias=False)
        self.BatchNorm_2 = _norm(out, scale_init=0.0)
        self.project = in_features != out or strides != 1
        if self.project:
            self.Conv_3 = Conv(in_features, out, (1, 1), strides=strides,
                               use_bias=False)
            self.BatchNorm_3 = _norm(out)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, in_features, filters, strides=1):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides=strides,
                           padding=((1, 1), (1, 1)), use_bias=False)
        self.BatchNorm_0 = _norm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3),
                           padding=((1, 1), (1, 1)), use_bias=False)
        self.BatchNorm_1 = _norm(filters, scale_init=0.0)
        self.project = in_features != filters or strides != 1
        if self.project:
            self.Conv_2 = Conv(in_features, filters, (1, 1), strides=strides,
                               use_bias=False)
            self.BatchNorm_2 = _norm(filters)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(y + residual)


def space_to_depth(x, block=2):
    """[B, H, W, C] -> [B, H/b, W/b, C*b*b]: each output pixel packs a
    b x b spatial block into channels (the reference's reshape and
    transpose)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


class ResNet(FlaxNamed):
    def __init__(self, stage_sizes, block_cls=BottleneckBlock,
                 num_classes=1000, num_filters=64, small_inputs=False,
                 stem="conv7", in_channels=3):
        super().__init__()
        if stem not in ("conv7", "space_to_depth"):
            raise ValueError(
                "unknown stem %r (conv7 | space_to_depth)" % stem)
        if small_inputs and stem != "conv7":
            raise ValueError(
                "small_inputs uses the cifar 3x3 stem; stem=%r conflicts"
                % stem)
        self.small_inputs = small_inputs
        self.stem = stem
        if small_inputs:
            self.Conv_0 = Conv(in_channels, num_filters, (3, 3),
                               padding=((1, 1), (1, 1)), use_bias=False)
        elif stem == "space_to_depth":
            self.Conv_0 = Conv(in_channels * 4, num_filters, (4, 4),
                               padding="SAME", use_bias=False)
        else:
            self.Conv_0 = Conv(in_channels, num_filters, (7, 7), strides=2,
                               padding=((3, 3), (3, 3)), use_bias=False)
        self.BatchNorm_0 = _norm(num_filters)
        width = num_filters
        index = 0
        for stage, num_blocks in enumerate(stage_sizes):
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                filters = num_filters * 2 ** stage
                self.add_module("%s_%d" % (block_cls.__name__, index),
                                block_cls(width, filters, strides))
                width = filters * block_cls.expansion
                index += 1
        self.num_blocks = index
        self.block_name = block_cls.__name__
        self.Dense_0 = Dense(width, num_classes, dtype=torch.float32)
        self.reset_parameters()
        self.channels_last_()

    def forward(self, x):
        if x.dim() == 3:
            x = x[..., None]
        if self.stem == "space_to_depth" and not self.small_inputs:
            x = space_to_depth(x, 2)
        # NHWC -> NCHW in channels_last memory (no copy)
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        if not self.small_inputs:
            x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.num_blocks):
            x = getattr(self, "%s_%d" % (self.block_name, i))(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def resnet18(num_classes=1000, **kwargs):
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes, **kwargs)


def resnet34(num_classes=1000, **kwargs):
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes, **kwargs)


def resnet50(num_classes=1000, **kwargs):
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes, **kwargs)


def resnet101(num_classes=1000, **kwargs):
    return ResNet([3, 4, 23, 3], BottleneckBlock, num_classes, **kwargs)


def resnet152(num_classes=1000, **kwargs):
    return ResNet([3, 8, 36, 3], BottleneckBlock, num_classes, **kwargs)


# ---------------------------------------------------------------------
# model-zoo contract (imagenet_resnet50 equivalent)

NUM_CLASSES = 1000


def custom_model(num_classes=NUM_CLASSES, **kwargs):
    """ResNet-50; ``--model_params`` may set ``num_classes``, ``stem``,
    ``num_filters``, ``small_inputs`` or ``in_channels``."""
    return resnet50(num_classes=num_classes, **kwargs)


def loss(labels, predictions):
    return sparse_softmax_cross_entropy(labels, predictions)


def optimizer():
    return create_optimizer(
        "Momentum", learning_rate=0.1, momentum=0.9, nesterov=True
    )


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(payload):
        example = decode_example(payload)
        image = example["image"].astype(np.float32) / 255.0
        label = example["label"].astype(np.int32).reshape(())
        return image, label

    return dataset.map(parse)


def eval_metrics_fn():
    return {"accuracy": metrics.Accuracy()}
