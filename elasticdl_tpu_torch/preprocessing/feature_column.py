"""Feature columns: declarative feature -> dense-input mapping (port of
elasticdl_tpu/preprocessing/feature_column.py).

A column is a small object with ``output_dim`` and ``__call__(features)
-> [batch, output_dim] tensor`` (dense), or ``ids(features) ->
PaddedSparse`` (categorical): numeric, bucketized, identity,
vocabulary, hash and concatenated columns, and the embedding and
indicator columns over a categorical one. String-consuming columns run
on the host (numpy); the others run on tensors, on the device of their
input. ``DenseFeatures`` is the ``nn.Module`` that owns one embedding
table per ``EmbeddingColumn`` and concatenates every column's output
(tf.keras.layers.DenseFeatures). Its tables carry the flax names
``<column>_embedding``, so ``models.layers.params_from_flax`` maps
them.

Tables over the PS threshold are moved to the host PS by
train/model_handler.py, not here.
"""

import math

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.preprocessing import layers as pp
from elasticdl_tpu_torch.preprocessing.layers import _tensor
from elasticdl_tpu_torch.preprocessing.sparse import (
    PaddedSparse,
    to_padded_sparse,
)


class NumericColumn:
    def __init__(self, key, shape=(1,), normalizer_fn=None):
        self.key = key
        self.shape = tuple(shape)
        self.normalizer_fn = normalizer_fn
        self.output_dim = int(np.prod(self.shape))

    @property
    def name(self):
        return self.key

    def __call__(self, features):
        x = _tensor(features[self.key], torch.float32)
        if x.dim() == 1:
            x = x[:, None]
        x = x.reshape((x.shape[0], self.output_dim))
        if self.normalizer_fn is not None:
            x = self.normalizer_fn(x)
        return x


class BucketizedColumn:
    """numeric -> bucket ids (categorical with len(boundaries)+1 buckets)."""

    def __init__(self, source: NumericColumn, boundaries):
        self.source = source
        self.boundaries = list(boundaries)
        self._disc = pp.Discretization(self.boundaries)
        self.num_buckets = len(self.boundaries) + 1

    @property
    def name(self):
        return self.source.name + "_bucketized"

    def ids(self, features):
        ids = self._disc(self.source(features)).to(torch.int64)
        return PaddedSparse(ids, torch.ones_like(ids, dtype=torch.bool))


class IdentityCategoricalColumn:
    def __init__(self, key, num_buckets, default_value=None):
        self.key = key
        self.num_buckets = num_buckets
        self.default_value = default_value

    @property
    def name(self):
        return self.key

    def ids(self, features):
        raw = features[self.key]
        if isinstance(raw, PaddedSparse):
            sp = raw
        else:
            # -1 is the pad sentinel: it drops out of the mask
            sp = to_padded_sparse(_tensor(raw), ignore_value=-1)
        values = _tensor(sp.values)
        mask = _tensor(sp.mask, device=values.device)
        in_range = (values >= 0) & (values < self.num_buckets)
        if self.default_value is not None:
            # out-of-range ids are rerouted to default_value
            values = torch.where(
                in_range, values,
                torch.full_like(values, self.default_value))
        else:
            # out-of-range ids drop out of the mask
            mask = mask & in_range
            values = torch.where(in_range, values, torch.zeros_like(values))
        return PaddedSparse(values.to(torch.int64), mask, sp.weights)


class VocabularyCategoricalColumn:
    def __init__(self, key, vocabulary_list, num_oov_buckets=0):
        self.key = key
        self.vocabulary_list = list(vocabulary_list)
        self._lookup = pp.IndexLookup(
            self.vocabulary_list, num_oov_tokens=max(1, num_oov_buckets)
        )
        self._keep_oov = num_oov_buckets > 0
        self.num_buckets = len(self.vocabulary_list) + max(
            0, num_oov_buckets
        )

    @property
    def name(self):
        return self.key

    def ids(self, features):
        raw = features[self.key]
        sp = raw if isinstance(raw, PaddedSparse) else to_padded_sparse(
            np.asarray(raw)
        )
        ids = self._lookup(np.asarray(sp.values))
        mask = np.asarray(sp.mask)
        if not self._keep_oov:
            mask = mask & (ids < len(self.vocabulary_list))
            ids = np.where(mask, ids, 0)
        return PaddedSparse(ids, mask, sp.weights)


class HashCategoricalColumn:
    def __init__(self, key, hash_bucket_size):
        self.key = key
        self.num_buckets = hash_bucket_size
        self._hashing = pp.Hashing(hash_bucket_size)

    @property
    def name(self):
        return self.key

    def ids(self, features):
        raw = features[self.key]
        sp = raw if isinstance(raw, PaddedSparse) else to_padded_sparse(
            np.asarray(raw) if _host_array(raw) else _tensor(raw)
        )
        return sp.with_values(self._hashing(sp.values))


def _host_array(x):
    return isinstance(x, (np.ndarray, list, tuple))


class ConcatenatedCategoricalColumn:
    """Merge N categorical columns into one id space by offsetting: one
    big embedding table instead of N small ones (offsets are exclusive
    prefix sums of num_buckets)."""

    def __init__(self, categorical_columns):
        self.columns = list(categorical_columns)
        self.offsets = [int(off) for off in np.cumsum(
            [0] + [c.num_buckets for c in self.columns])[:-1]]
        self.num_buckets = int(sum(c.num_buckets for c in self.columns))

    @property
    def name(self):
        return "_C_".join(c.name for c in self.columns)

    def ids(self, features):
        parts = [c.ids(features) for c in self.columns]
        return pp.ConcatenateWithOffset(self.offsets, axis=1)(parts)


class EmbeddingColumn:
    """categorical ids -> combined embedding vector. The table lives in
    DenseFeatures; this object only describes the mapping."""

    def __init__(self, categorical, dimension, combiner="mean"):
        self.categorical = categorical
        self.dimension = dimension
        self.combiner = combiner
        self.output_dim = dimension

    @property
    def name(self):
        return self.categorical.name + "_embedding"

    @property
    def table_shape(self):
        return (self.categorical.num_buckets, self.dimension)


class IndicatorColumn:
    """categorical ids -> multi-hot counts (the wide half of wide&deep)."""

    def __init__(self, categorical):
        self.categorical = categorical
        self.output_dim = categorical.num_buckets

    @property
    def name(self):
        return self.categorical.name + "_indicator"

    def __call__(self, features):
        return _multi_hot(self.categorical.ids(features), self.output_dim)


def _multi_hot(sp: PaddedSparse, num_buckets, device=None):
    """Scatter-add of the mask: multi-hot with counts."""
    ids = _tensor(sp.values, torch.int64, device)
    mask = _tensor(sp.mask, device=ids.device)
    safe = torch.where(mask, ids, torch.zeros_like(ids))
    out = torch.zeros((ids.shape[0], num_buckets), dtype=torch.float32,
                      device=ids.device)
    return out.scatter_add_(1, safe, mask.to(torch.float32))


# the tf.feature_column names the model zoo uses
def numeric_column(key, shape=(1,), normalizer_fn=None):
    return NumericColumn(key, shape, normalizer_fn)


def bucketized_column(source, boundaries):
    return BucketizedColumn(source, boundaries)


def categorical_column_with_identity(key, num_buckets, default_value=None):
    return IdentityCategoricalColumn(key, num_buckets, default_value)


def categorical_column_with_vocabulary_list(
    key, vocabulary_list, num_oov_buckets=0
):
    return VocabularyCategoricalColumn(key, vocabulary_list, num_oov_buckets)


def categorical_column_with_hash_bucket(key, hash_bucket_size):
    return HashCategoricalColumn(key, hash_bucket_size)


def concatenated_categorical_column(categorical_columns):
    return ConcatenatedCategoricalColumn(categorical_columns)


def embedding_column(categorical, dimension, combiner="mean"):
    return EmbeddingColumn(categorical, dimension, combiner)


def indicator_column(categorical):
    return IndicatorColumn(categorical)


class DenseFeatures(nn.Module):
    """Apply a list of columns to a features dict and concatenate. Owns
    one table per EmbeddingColumn, a parameter named after the column
    (flax's ``variance_scaling(1.0, "fan_out", "uniform")`` by
    ``reset_parameters``).

    String-consuming columns (vocabulary and hash over numpy arrays)
    run on the host before the step: ``preprocess(features)`` from the
    dataset_fn materializes their ids, after which the forward sees
    tensors only.
    """

    def __init__(self, columns):
        super().__init__()
        self.columns = tuple(columns)
        for col in self.columns:
            if isinstance(col, EmbeddingColumn):
                self.register_parameter(
                    col.name, nn.Parameter(torch.empty(col.table_shape)))
        self.output_dim = sum(col.output_dim for col in self.columns)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for col in self.columns:
            if isinstance(col, EmbeddingColumn):
                table = getattr(self, col.name)
                limit = math.sqrt(3.0 / col.table_shape[-1])
                values = torch.rand(table.shape, generator=generator)
                table.copy_(values * (2 * limit) - limit)

    def preprocess(self, features):
        """Host-side stage: resolve string-consuming categorical columns
        to PaddedSparse ids and DROP the raw string keys, so the step
        sees only numeric arrays."""
        out = dict(features)
        consumed = set()
        for col in self.columns:
            cat = getattr(col, "categorical", None)
            if cat is not None and _consumes_strings(cat):
                out[_ids_key(cat)] = cat.ids(features)
                consumed.update(_feature_keys(cat))
        for key in consumed:
            out.pop(key, None)
        return out

    def forward(self, features):
        outputs = []
        for col in self.columns:
            if isinstance(col, EmbeddingColumn):
                table = getattr(self, col.name)
                sp = _resolve_ids(col.categorical, features)
                outputs.append(_combine(table, sp, col.combiner))
            elif isinstance(col, IndicatorColumn):
                sp = _resolve_ids(col.categorical, features)
                outputs.append(_multi_hot(sp, col.output_dim))
            else:
                outputs.append(col(features))
        return torch.cat(outputs, dim=-1)


def _ids_key(categorical):
    return "__ids__" + categorical.name


def _consumes_strings(categorical):
    return isinstance(
        categorical,
        (VocabularyCategoricalColumn, HashCategoricalColumn),
    ) or (
        isinstance(categorical, ConcatenatedCategoricalColumn)
        and any(_consumes_strings(c) for c in categorical.columns)
    )


def _feature_keys(categorical):
    """Raw feature keys consumed by STRING-consuming leaves only: a
    numeric key (a bucketized column's source) may be shared with dense
    columns and must survive preprocess()."""
    if isinstance(categorical, ConcatenatedCategoricalColumn):
        keys = set()
        for c in categorical.columns:
            keys.update(_feature_keys(c))
        return keys
    if isinstance(
        categorical, (VocabularyCategoricalColumn, HashCategoricalColumn)
    ):
        return {categorical.key}
    return set()


def _resolve_ids(categorical, features):
    key = _ids_key(categorical)
    if key in features:
        return features[key]
    return categorical.ids(features)


def combine_gathered(gathered, w, combiner):
    """Weighted sum/mean/sqrtn over the slot axis: gathered is [batch,
    len, dim], w is [batch, len] (0 on padded slots). Shared by the
    device-table path (``_combine``) and the host-PS path
    (train/model_handler.PSEmbeddingColumn)."""
    summed = torch.einsum("blh,bl->bh", gathered, w)
    if combiner == "sum":
        return summed
    denom = torch.sum(w, dim=1, keepdim=True)
    if combiner == "sqrtn":
        denom = torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))
    return summed / torch.clamp(denom, min=1e-12)


def _combine(table, sp: PaddedSparse, combiner):
    ids = _tensor(sp.values, device=table.device)
    mask = _tensor(sp.mask, device=table.device)
    safe = torch.where(mask, ids, torch.zeros_like(ids)).long()
    rows = table[safe]
    w = mask.to(rows.dtype)
    if sp.weights is not None:
        w = w * _tensor(sp.weights, rows.dtype, table.device)
    return combine_gathered(rows, w, combiner)
