"""DeepFM over host-PS embedding tables, the CTR model of the zoo (port
of elasticdl_tpu/models/deepfm.py).

Ids are swapped for (rows, indices) before the step
(train/sparse.py), so the model on the card is dense math: gather, FM
interaction, MLP. Expected raw features: {"ids": int64 [B, F]} and
labels in {0, 1}.

The module is field-count agnostic, as the flax module is: its first
dense layer is sized by the first batch it sees (``nn.LazyLinear``),
and ``reset_parameters`` then draws every dense layer as flax's
``Dense`` does (lecun-normal kernel, truncated at two standard
deviations; zero bias). ``params_from_flax`` carries the reference's
dense params across, and ``params_to_flax`` (the module's
``flax_params``) writes them back under the reference's flat flax
names, so an export or a dense checkpoint of either package loads in
either.
"""

import math

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.env_utils import env_int
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sigmoid_binary_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer
from elasticdl_tpu_torch.train.sparse import (
    SparseEmbeddingSpec,
    embedding_lookup,
)

_logger = _logger_factory("elasticdl_tpu_torch.models.deepfm")

EMBEDDING_DIM = 8
# criteo-dac: 39 raw columns (the reference's model_zoo/dac_ctr feature
# config); the model is field-count agnostic, this sizes the id buffers
NUM_FIELDS = 39
# measured ceiling on the padded unique-id buffer for Zipfian id
# streams: an opt-in deployment tuning (the bench config uses it); the
# library default stays the always-safe batch * fields worst case
MAX_ID_CAPACITY = 8192

# flax's truncated-normal variance scaling divides the stddev by the
# stddev of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class DeepFM(nn.Module):
    def __init__(self, embedding_dim=EMBEDDING_DIM, hidden=(64, 32)):
        super().__init__()
        self.embedding_dim = embedding_dim
        widths = list(hidden) + [1]
        # flax's Dense_0, Dense_1, ...: the first takes fields x dim
        # inputs, known at the first batch
        self.dense = nn.ModuleList(
            [nn.LazyLinear(widths[0])]
            + [nn.Linear(a, b) for a, b in zip(widths, widths[1:])]
        )

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax Dense init from ``generator`` (drawn on the CPU, so a
        seed gives the same weights on any device): kernel ~ truncated
        normal with stddev sqrt(1 / fan_in) / 0.8796 cut at two
        stddevs, bias 0."""
        for layer in self.dense:
            fan_in = layer.weight.shape[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            weight = torch.empty(layer.weight.shape)
            nn.init.trunc_normal_(weight, mean=0.0, std=std, a=-2.0 * std,
                                  b=2.0 * std, generator=generator)
            layer.weight.copy_(weight)
            layer.bias.zero_()

    def forward(self, features):
        # [B, F, d] second-order embeddings + [B, 1] first-order sum
        emb = embedding_lookup(features, "deepfm_emb", combiner=None)
        linear = embedding_lookup(features, "deepfm_linear", combiner="sum")
        # FM second-order: 0.5 * ((sum v)^2 - sum v^2)
        summed = emb.sum(dim=1)
        fm = 0.5 * (torch.square(summed) - torch.square(emb).sum(dim=1))
        fm_term = fm.sum(dim=-1, keepdim=True)
        # deep tower over flattened field embeddings
        deep = emb.reshape(emb.shape[0], -1)
        for layer in self.dense[:-1]:
            deep = torch.relu(layer(deep))
        deep_term = self.dense[-1](deep)
        logit = linear.reshape(-1, 1) + fm_term + deep_term
        return logit.squeeze(-1)

    def flax_params(self, state):
        """``{name: tensor}`` in this module's names -> the export's flat
        flax names (train/export.py and the dense checkpoints read
        it)."""
        return params_to_flax(state)

    def params_from_flax(self, flat):
        return params_from_flax(flat)


def custom_model():
    return DeepFM()


def params_from_flax(flat):
    """``{flax name: array}`` (``Dense_<i>/kernel`` [in, out] and
    ``Dense_<i>/bias``; an export's ``params/`` prefix allowed) ->
    state_dict (``dense.<i>.weight`` [out, in], ``dense.<i>.bias``)."""
    state = {}
    for name, value in flat.items():
        name = name[len("params/"):] if name.startswith("params/") else name
        layer, leaf = name.split("/")
        index = int(layer[len("Dense_"):])
        value = np.asarray(value, np.float32)
        if leaf == "kernel":
            state["dense.%d.weight" % index] = torch.from_numpy(
                np.array(value.T, order="C"))
        elif leaf == "bias":
            state["dense.%d.bias" % index] = torch.from_numpy(
                np.array(value))
        else:
            raise ValueError("unknown DeepFM parameter %r" % name)
    return state


def params_to_flax(state):
    """state_dict (``dense.<i>.weight`` [out, in], ``dense.<i>.bias``)
    -> ``{flax name: fp32 ndarray}`` (``Dense_<i>/kernel`` [in, out],
    ``Dense_<i>/bias``; the export's names without the ``params/``
    prefix): the inverse of ``params_from_flax``. Every array is a
    copy."""
    flat = {}
    for name, tensor in state.items():
        parts = name.split(".")
        if len(parts) != 3 or parts[0] != "dense":
            raise ValueError("unknown DeepFM parameter %r" % name)
        value = tensor.detach().to("cpu", torch.float32).numpy()
        if parts[2] == "weight":
            flat["Dense_%s/kernel" % parts[1]] = np.array(value.T,
                                                          order="C")
        elif parts[2] == "bias":
            flat["Dense_%s/bias" % parts[1]] = np.array(value)
        else:
            raise ValueError("unknown DeepFM parameter %r" % name)
    return flat


def loss(labels, predictions):
    return sigmoid_binary_cross_entropy(labels, predictions)


def optimizer():
    return create_optimizer("Adam", learning_rate=0.001)


# capacity-warning dedup: one line per distinct (capacity, batch,
# fields) shape per process
_warned_capacities = set()


def sparse_embedding_specs(num_features=NUM_FIELDS, batch_size=64,
                           capacity=None):
    """Host-PS tables this model trains against. The capacity default
    is the always-safe worst case ``batch_size * num_features``;
    Zipfian CTR streams may opt into ``min(batch * fields,
    MAX_ID_CAPACITY)`` or EDL_SPARSE_ID_CAPACITY, as the deployment
    configuration does (overflow raises a ValueError naming the
    capacity)."""
    if capacity is None:
        capacity = env_int(
            "EDL_SPARSE_ID_CAPACITY", batch_size * num_features
        )
    shape_key = (capacity, batch_size, num_features)
    if (
        capacity < batch_size * num_features
        and shape_key not in _warned_capacities
    ):
        _warned_capacities.add(shape_key)
        _logger.info(
            "deepfm id-buffer capacity %d < worst case %d (batch %d x "
            "%d fields): fine for Zipfian id streams; a near-uniform "
            "stream will raise a capacity ValueError naming this knob",
            capacity, batch_size * num_features, batch_size, num_features,
        )
    return [
        # small second-order init: a barely trained id contributes ~no
        # noise through the FM and deep towers
        SparseEmbeddingSpec(
            "deepfm_emb",
            EMBEDDING_DIM,
            feature_key="ids",
            capacity=capacity,
            init_scale=0.001,
        ),
        # the wide term starts at exactly no-op: a zero row is the right
        # prior for an unseen id
        SparseEmbeddingSpec(
            "deepfm_linear", 1, feature_key="ids", capacity=capacity,
            initializer="zeros",
        ),
    ]


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(payload):
        example = decode_example(payload)
        return (
            {"ids": example["ids"].astype(np.int64)},
            example["label"].astype(np.float32).reshape(()),
        )

    return dataset.map(parse)


def eval_metrics_fn():
    return {
        "auc": metrics.AUC(from_logits=True),
        "accuracy": metrics.BinaryAccuracy(from_logits=True),
    }
