"""Census Wide&Deep generated from a declarative transform spec (port of
elasticdl_tpu/models/census_sqlflow_wide_deep.py; the reference's
model_zoo/census_model_sqlflow/wide_and_deep).

``TRANSFORMS`` is what a SQLFlow ``COLUMN`` clause compiles to:
vocabulary, hash and bucketize ops, three concatenated id groups with
cumulative offsets, wide dim-1 and deep dim-8 embeddings per group.
The string ops run per record in dataset_fn on the host; the bucketize
ops, the group concatenation and the embeddings run as feature columns
inside the forward.
"""

import numpy as np

from elasticdl_tpu_torch.data.census_schema import (
    MARITAL_STATUS_VOCABULARY,
    WORK_CLASS_VOCABULARY,
)
from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.models.feature_net import (
    FeatureNet,
    run_tower,
    tower,
)
from elasticdl_tpu_torch.models.layers import (  # noqa: F401
    Dense,
    params_from_flax,  # the zoo contract's name
)
from elasticdl_tpu_torch.preprocessing import Hashing, IndexLookup
from elasticdl_tpu_torch.preprocessing import feature_column as fc
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sigmoid_binary_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer

RELATIONSHIP_VOCABULARY = [
    "Wife", "Own-child", "Husband", "Not-in-family", "Other-relative",
    "Unmarried",
]
RACE_VOCABULARY = [
    "White", "Asian-Pac-Islander", "Amer-Indian-Eskimo", "Other", "Black",
]
SEX_VOCABULARY = ["Female", "Male"]
AGE_BOUNDARIES = [0.0, 20.0, 40.0, 60.0, 80.0]
CAPITAL_GAIN_BOUNDARIES = [6000.0, 6500.0, 7000.0, 7500.0, 8000.0]
CAPITAL_LOSS_BOUNDARIES = [2000.0, 2500.0, 3000.0, 3500.0, 4000.0]
HOURS_BOUNDARIES = [10.0, 20.0, 30.0, 40.0, 50.0, 60.0]

# the compiled COLUMN clause: (output, op, input, param). vocab and hash
# rows run on the host per record; bucketize rows become feature
# columns. The cardinalities give the group offsets.
TRANSFORMS = [
    ("workclass_lookup", "vocab", "work_class", WORK_CLASS_VOCABULARY),
    ("marital_status_lookup", "vocab", "marital_status",
     MARITAL_STATUS_VOCABULARY),
    ("relationship_lookup", "vocab", "relationship",
     RELATIONSHIP_VOCABULARY),
    ("race_lookup", "vocab", "race", RACE_VOCABULARY),
    ("sex_lookup", "vocab", "sex", SEX_VOCABULARY),
    ("education_hash", "hash", "education", 30),
    ("occupation_hash", "hash", "occupation", 30),
    ("native_country_hash", "hash", "native_country", 100),
    ("age_bucketize", "bucketize", "age", AGE_BOUNDARIES),
    ("capital_gain_bucketize", "bucketize", "capital_gain",
     CAPITAL_GAIN_BOUNDARIES),
    ("capital_loss_bucketize", "bucketize", "capital_loss",
     CAPITAL_LOSS_BOUNDARIES),
    ("hours_per_week_bucketize", "bucketize", "hours_per_week",
     HOURS_BOUNDARIES),
]

# three concatenated groups over the transform outputs
GROUPS = {
    "group1": ["workclass_lookup", "hours_per_week_bucketize",
               "capital_gain_bucketize", "capital_loss_bucketize"],
    "group2": ["education_hash", "marital_status_lookup",
               "relationship_lookup", "occupation_hash"],
    "group3": ["age_bucketize", "sex_lookup", "race_lookup",
               "native_country_hash"],
}
WIDE_GROUPS = ["group1", "group2"]  # dim-1 embeddings
DEEP_GROUPS = ["group1", "group2", "group3"]  # dim-8
DEEP_DIM = 8


def _cardinality(name):
    for out, op, _, param in TRANSFORMS:
        if out != name:
            continue
        if op == "vocab":
            return len(param) + 1  # +1 OOV slot (IndexLookup)
        if op == "hash":
            return param
        if op == "bucketize":
            return len(param) + 1
    raise KeyError(name)


_host_ops = {}
for _out, _op, _src, _param in TRANSFORMS:
    if _op == "vocab":
        _host_ops[_out] = (_src, IndexLookup(_param, num_oov_tokens=1))
    elif _op == "hash":
        _host_ops[_out] = (_src, Hashing(_param))


def build_columns():
    wide_cols, deep_cols = [], []
    for group_name in sorted(GROUPS):
        parts = []
        for member in GROUPS[group_name]:
            op = next(t[1] for t in TRANSFORMS if t[0] == member)
            if op == "bucketize":
                src = next(t[2] for t in TRANSFORMS if t[0] == member)
                bounds = next(t[3] for t in TRANSFORMS if t[0] == member)
                parts.append(fc.bucketized_column(
                    fc.numeric_column(src), list(bounds)
                ))
            else:
                parts.append(fc.categorical_column_with_identity(
                    member, _cardinality(member)
                ))
        group = fc.concatenated_categorical_column(parts)
        if group_name in WIDE_GROUPS:
            wide_cols.append(
                fc.embedding_column(group, dimension=1, combiner="sum")
            )
        if group_name in DEEP_GROUPS:
            deep_cols.append(
                fc.embedding_column(
                    group, dimension=DEEP_DIM, combiner="sum"
                )
            )
    return tuple(wide_cols), tuple(deep_cols)


class SqlflowWideDeep(FeatureNet):
    def __init__(self, hidden=(16, 8)):
        super().__init__()
        self.hidden = tuple(hidden)
        wide_cols, deep_cols = build_columns()
        self.wide_features = fc.DenseFeatures(columns=wide_cols)
        self.deep_features = fc.DenseFeatures(columns=deep_cols)
        width = tower(self, "deep_layers", self.deep_features.output_dim,
                      self.hidden)
        self.logit = Dense(width, 1)
        self.reset_parameters()

    def forward(self, features):
        wide = self.wide_features(features)
        deep = run_tower(self, "deep_layers", self.hidden,
                         self.deep_features(features))
        logit = wide.sum(dim=-1, keepdim=True) + self.logit(deep)
        return logit.squeeze(-1)


def custom_model():
    return SqlflowWideDeep()


def loss(labels, predictions):
    return sigmoid_binary_cross_entropy(labels, predictions)


def optimizer():
    return create_optimizer("Adam", learning_rate=0.001)


def dataset_fn(dataset, mode=None, metadata=None):
    numeric = [t[2] for t in TRANSFORMS if t[1] == "bucketize"]

    def parse(payload):
        example = decode_example(payload)
        features = {
            key: np.float32(example.get(key, 0.0)).reshape(())
            for key in numeric
        }
        for out, (src, op) in _host_ops.items():
            value = str(example.get(src, ""))
            features[out] = op(np.array([value])).reshape((1,))
        return features, np.float32(example["label"]).reshape(())

    return dataset.map(parse)


def eval_metrics_fn():
    return {
        "auc": metrics.AUC(from_logits=True),
        "accuracy": metrics.BinaryAccuracy(from_logits=True),
    }
