"""Census-income DNN over embedded categorical features (port of
elasticdl_tpu/models/census_dnn.py; the reference's
model_zoo/census_dnn_model): 4 numeric columns and 8 categorical
columns hashed into 64 buckets and embedded at dim 16, DenseFeatures
into a 16-16-1 tower. Hashing runs per record in dataset_fn on the
host; the model sees numeric arrays and identity ids. Logits out; the
sigmoid lives in the loss.
"""

import numpy as np

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
from elasticdl_tpu_torch.preprocessing import Hashing
from elasticdl_tpu_torch.preprocessing import feature_column as fc
from elasticdl_tpu_torch.train import metrics
from elasticdl_tpu_torch.train.losses import sigmoid_binary_cross_entropy
from elasticdl_tpu_torch.train.optimizers import create_optimizer

# the census RecordIO schema spells the raw CSV headers' dashes as
# underscores
CATEGORICAL_KEYS = [
    "work_class",
    "education",
    "marital_status",
    "occupation",
    "relationship",
    "race",
    "sex",
    "native_country",
]
NUMERIC_KEYS = ["age", "capital_gain", "capital_loss", "hours_per_week"]
HASH_BUCKETS = 64
EMBED_DIM = 16

_hashers = {key: Hashing(HASH_BUCKETS) for key in CATEGORICAL_KEYS}


def build_columns():
    columns = [fc.numeric_column(key) for key in NUMERIC_KEYS]
    for key in CATEGORICAL_KEYS:
        columns.append(
            fc.embedding_column(
                fc.categorical_column_with_identity(
                    key + "_id", HASH_BUCKETS
                ),
                dimension=EMBED_DIM,
            )
        )
    return tuple(columns)


class CensusDnn(FeatureNet):
    def __init__(self, hidden=(16, 16)):
        super().__init__()
        self.hidden = tuple(hidden)
        self.features = fc.DenseFeatures(columns=build_columns())
        width = tower(self, "layers", self.features.output_dim, self.hidden)
        self.logit = Dense(width, 1)
        self.reset_parameters()

    def forward(self, features):
        x = run_tower(self, "layers", self.hidden, self.features(features))
        return self.logit(x).squeeze(-1)


def custom_model():
    return CensusDnn()


def loss(labels, predictions):
    return sigmoid_binary_cross_entropy(labels, predictions)


def optimizer():
    return create_optimizer("Adam", learning_rate=0.001)


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(payload):
        example = decode_example(payload)
        features = {
            key: np.float32(example[key]).reshape(())
            for key in NUMERIC_KEYS
        }
        for key in CATEGORICAL_KEYS:
            value = example.get(key, "")
            features[key + "_id"] = _hashers[key](
                np.array([str(value)])
            ).reshape((1,))
        return features, np.float32(example["label"]).reshape(())

    return dataset.map(parse)


def eval_metrics_fn():
    return {
        "auc": metrics.AUC(from_logits=True),
        "accuracy": metrics.BinaryAccuracy(from_logits=True),
    }
