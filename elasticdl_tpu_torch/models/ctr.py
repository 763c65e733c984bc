"""Criteo-style CTR family: Wide&Deep, DCN, xDeepFM (port of
elasticdl_tpu/models/ctr.py).

One shared embedding backbone (one id space over every field, a gather
by id) with a head per model: linear + DNN for Wide&Deep, CrossNet +
DNN for DCN, linear + CIN + DNN for xDeepFM. The tables stay on the
device and their gradient is dense, as ``jnp.take``'s is in the
reference: Adam decays every row's moments each step, so a sparse
gradient would be another optimizer.

Expected raw features: ``{"ids": int64 [B, F]}`` (one id per field) and
labels in {0, 1}. ``custom_model`` selects the variant
(``EDL_CTR_VARIANT`` overrides it); the zoo modules ``wide_deep``,
``dcn`` and ``xdeepfm`` pin one each.

The models are field-count agnostic, as the flax modules are: the
layers whose shapes depend on the field count (the DNN's first Dense,
CrossNet's vectors, CIN's projections) are sized by the first batch,
and ``reset_parameters`` then draws every weight with flax's
initializers. Submodules and parameters carry the reference's flax
scope names (``deep/embeddings``, ``CrossNet_0/w0``, ``CIN_0/cin1``,
``DNN_0/Dense_1/kernel``), so ``params_from_flax`` maps every leaf.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.env_utils import env_int, env_str
from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.models.layers import (  # noqa: F401
    Dense,
    FlaxNamed,
    LazyDense,
    params_from_flax,  # the zoo contract's name
)
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sigmoid_binary_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer

# criteo-dac scale (the reference's model_zoo/dac_ctr feature config: 39
# columns hashed into one id space); a [1M, 8] fp32 table is 32 MB
VOCAB = 1_000_000
NUM_FIELDS = 39
EMBED_DIM = 8


@torch.no_grad()
def _truncated_normal_(param, stddev, generator):
    """flax's ``truncated_normal(stddev)``: a unit normal cut at two
    standard deviations, times ``stddev`` (drawn on the CPU)."""
    values = torch.empty(param.shape)
    nn.init.trunc_normal_(values, mean=0.0, std=stddev, a=-2.0 * stddev,
                          b=2.0 * stddev, generator=generator)
    param.copy_(values)


class FieldEmbeddings(nn.Module):
    """[B, F] ids -> [B, F, dim] from one ``[vocab, dim]`` table that
    every field shares."""

    def __init__(self, vocab=VOCAB, dim=EMBED_DIM):
        super().__init__()
        self.embeddings = nn.Parameter(torch.zeros(vocab, dim))

    def reset_parameters(self, generator=None):
        # small-normal init: logits start near 0 (BCE ~ ln 2)
        _truncated_normal_(self.embeddings, 0.01, generator)

    def forward(self, ids):
        return F.embedding(ids.long(), self.embeddings)


class CrossNet(nn.modules.lazy.LazyModuleMixin, nn.Module):
    """DCN's cross layers, x_{l+1} = x0 * (x_l . w_l) + b_l + x_l; w_l
    and b_l are sized by the first batch."""

    def __init__(self, num_layers=2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter("w%d" % i, nn.UninitializedParameter())
            self.register_parameter("b%d" % i, nn.UninitializedParameter())

    def initialize_parameters(self, x0):
        with torch.no_grad():
            for i in range(self.num_layers):
                for name in ("w%d" % i, "b%d" % i):
                    getattr(self, name).materialize(
                        (x0.shape[-1],), device=x0.device)
                    getattr(self, name).zero_()

    def reset_parameters(self, generator=None):
        for i in range(self.num_layers):
            _truncated_normal_(getattr(self, "w%d" % i), 0.02, generator)
            with torch.no_grad():
                getattr(self, "b%d" % i).zero_()

    def forward(self, x0):
        x = x0
        for i in range(self.num_layers):
            xw = (x @ getattr(self, "w%d" % i))[:, None]  # [B, 1]
            x = x0 * xw + getattr(self, "b%d" % i) + x
        return x


class CIN(nn.modules.lazy.LazyModuleMixin, nn.Module):
    """xDeepFM's Compressed Interaction Network: layer k takes the outer
    product of x^k and x^0 over fields, per embedding column, compresses
    it with a ``[H_k * F0, H_{k+1}]`` projection and a ReLU, and
    sum-pools each layer's output over the embedding axis."""

    def __init__(self, layer_sizes=(16, 16)):
        super().__init__()
        self.layer_sizes = tuple(layer_sizes)
        for k in range(len(self.layer_sizes)):
            self.register_parameter("cin%d" % k, nn.UninitializedParameter())

    def initialize_parameters(self, x0):
        fields = x0.shape[1]
        width = fields
        with torch.no_grad():
            for k, size in enumerate(self.layer_sizes):
                param = getattr(self, "cin%d" % k)
                param.materialize((width * fields, size), device=x0.device)
                param.zero_()
                width = size

    def reset_parameters(self, generator=None):
        for k in range(len(self.layer_sizes)):
            _truncated_normal_(getattr(self, "cin%d" % k), 0.02, generator)

    def forward(self, x0):
        batch, fields, dim = x0.shape
        x = x0
        pooled = []
        for k in range(len(self.layer_sizes)):
            # [B, Hk, F0, D] outer product over the field axes
            z = torch.einsum("bhd,bfd->bhfd", x, x0)
            z = z.reshape(batch, x.shape[1] * fields, dim)
            x = torch.relu(torch.einsum("bzd,zh->bhd", z,
                                        getattr(self, "cin%d" % k)))
            pooled.append(x.sum(dim=-1))  # [B, Hk]
        return torch.cat(pooled, dim=-1)


class DNN(nn.Module):
    """The deep tower: Dense + ReLU per width, the first sized by the
    first batch."""

    def __init__(self, hidden=(64, 32)):
        super().__init__()
        self.hidden = tuple(hidden)
        self.Dense_0 = LazyDense(self.hidden[0])
        for i, (a, b) in enumerate(zip(self.hidden, self.hidden[1:]), 1):
            setattr(self, "Dense_%d" % i, Dense(a, b))

    def forward(self, x):
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, "Dense_%d" % i)(x))
        return x


class _CTRModel(FlaxNamed):
    """flax's initializers on every leaf: lecun-normal Dense kernels,
    truncated-normal tables, cross vectors and CIN projections."""

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        for module in self.modules():
            if isinstance(module, (FieldEmbeddings, CrossNet, CIN)):
                module.reset_parameters(generator)


class WideDeep(_CTRModel):
    """wide = the sum of per-field 1-d embeddings; deep = the DNN over
    the concatenated field embeddings, through Dense(1)."""

    def __init__(self, vocab=VOCAB, embed_dim=EMBED_DIM):
        super().__init__()
        self.wide = FieldEmbeddings(vocab, 1)
        self.deep = FieldEmbeddings(vocab, embed_dim)
        self.DNN_0 = DNN()
        self.Dense_0 = Dense(self.DNN_0.hidden[-1], 1)

    def forward(self, features):
        ids = features["ids"]
        wide = self.wide(ids)  # [B, F, 1]
        deep_emb = self.deep(ids)  # [B, F, D]
        deep = self.DNN_0(deep_emb.reshape(ids.shape[0], -1))
        logit = wide.sum(dim=(1, 2))[:, None] + self.Dense_0(deep)
        return logit.squeeze(-1)


class DCN(_CTRModel):
    """CrossNet and DNN over the flattened embeddings, concatenated,
    through Dense(1)."""

    def __init__(self, vocab=VOCAB, embed_dim=EMBED_DIM):
        super().__init__()
        self.FieldEmbeddings_0 = FieldEmbeddings(vocab, embed_dim)
        self.CrossNet_0 = CrossNet(num_layers=2)
        self.DNN_0 = DNN()
        self.Dense_0 = LazyDense(1)

    def forward(self, features):
        ids = features["ids"]
        flat = self.FieldEmbeddings_0(ids).reshape(ids.shape[0], -1)
        cross = self.CrossNet_0(flat)
        deep = self.DNN_0(flat)
        both = torch.cat([deep, cross], dim=1)
        return self.Dense_0(both).squeeze(-1)


class XDeepFM(_CTRModel):
    """linear (per-field 1-d embeddings) + CIN + DNN, each of the last
    two through its own Dense(1)."""

    def __init__(self, vocab=VOCAB, embed_dim=EMBED_DIM):
        super().__init__()
        self.linear = FieldEmbeddings(vocab, 1)
        self.deep = FieldEmbeddings(vocab, embed_dim)
        self.CIN_0 = CIN()
        self.DNN_0 = DNN()
        self.Dense_0 = Dense(sum(self.CIN_0.layer_sizes), 1)
        self.Dense_1 = Dense(self.DNN_0.hidden[-1], 1)

    def forward(self, features):
        ids = features["ids"]
        linear = self.linear(ids)
        emb = self.deep(ids)
        cin_out = self.CIN_0(emb)
        deep = self.DNN_0(emb.reshape(ids.shape[0], -1))
        logit = (linear.sum(dim=(1, 2))[:, None] + self.Dense_0(cin_out)
                 + self.Dense_1(deep))
        return logit.squeeze(-1)


VARIANTS = {"wide_deep": WideDeep, "dcn": DCN, "xdeepfm": XDeepFM}


def custom_model(variant="dcn", vocab=None, embed_dim=None):
    variant = env_str("EDL_CTR_VARIANT", variant)
    vocab = env_int("EDL_CTR_VOCAB", vocab or VOCAB)
    embed_dim = env_int("EDL_CTR_EMBED_DIM", embed_dim or EMBED_DIM)
    return VARIANTS[variant](vocab=vocab, embed_dim=embed_dim)


def loss(labels, predictions):
    return sigmoid_binary_cross_entropy(labels, predictions)


def optimizer():
    return create_optimizer("Adam", learning_rate=0.01)


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
