"""Cleveland heart-disease classifier over the feature-column stack (port
of elasticdl_tpu/models/heart.py; the reference's
model_zoo/heart_functional_api): numeric columns, a bucketized age as
an indicator, a hashed and embedded ``thal``, DenseFeatures into a
16-16-1 tower. Hashing runs per record in dataset_fn on the host; the
model sees numeric arrays and identity ids. Logits out; the sigmoid
lives in the loss.
"""

import numpy as np

from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.data.gen.converters import HEART_NUMERIC
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

AGE_BOUNDARIES = [18.0, 25.0, 30.0, 35.0, 40.0, 45.0, 50.0, 55.0, 60.0,
                  65.0]
THAL_BUCKETS = 100
THAL_EMBED_DIM = 8

_thal_hash = Hashing(THAL_BUCKETS)


def build_columns():
    numeric = [
        fc.numeric_column(key)
        for key in ("trestbps", "chol", "thalach", "oldpeak", "slope",
                    "ca")
    ]
    age_buckets = fc.bucketized_column(
        fc.numeric_column("age"), AGE_BOUNDARIES
    )
    thal = fc.embedding_column(
        fc.categorical_column_with_identity("thal_id", THAL_BUCKETS),
        dimension=THAL_EMBED_DIM,
    )
    return tuple(numeric) + (fc.indicator_column(age_buckets), thal)


class HeartNet(FeatureNet):
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
    return HeartNet()


def loss(labels, predictions):
    return sigmoid_binary_cross_entropy(labels, predictions)


def optimizer():
    # the reference zoo ships SGD(1e-6), too cold to learn in a short
    # run over raw-scale clinical features; Adam at 1e-3
    return create_optimizer("Adam", learning_rate=0.001)


# raw clinical value ranges (UCI Cleveland); inputs are standardized to
# about [-0.5, 0.5] in dataset_fn
_RANGES = {
    "age": (29.0, 77.0), "trestbps": (94.0, 200.0),
    "chol": (126.0, 564.0), "thalach": (71.0, 202.0),
    "oldpeak": (0.0, 6.2),
}


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(payload):
        example = decode_example(payload)
        features = {}
        for key in HEART_NUMERIC:
            value = np.float32(example[key])
            if key in _RANGES and key != "age":
                lo, hi = _RANGES[key]
                value = np.float32((value - (lo + hi) / 2) / (hi - lo))
            features[key] = value.reshape(())
        for key in ("slope", "ca"):
            features[key] = np.float32(example[key]).reshape(())
        features["thal_id"] = _thal_hash(
            np.array([str(example["thal"])])
        ).reshape((1,))
        return features, np.float32(example["label"]).reshape(())

    return dataset.map(parse)


def eval_metrics_fn():
    return {
        "auc": metrics.AUC(from_logits=True),
        "accuracy": metrics.BinaryAccuracy(from_logits=True),
    }
