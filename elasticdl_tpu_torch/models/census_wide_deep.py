"""Census-income Wide&Deep over the feature-column stack (port of
elasticdl_tpu/models/census_wide_deep.py; the reference's
model_zoo/census_wide_deep_model): vocabulary lookups for work class
and marital status, hash buckets for education and occupation,
bucketized age and hours, one concatenated id group feeding a wide
indicator and a deep embedding, and a staged learning rate.

String-to-id resolution (IndexLookup, Hashing) runs per record in
dataset_fn on the host; the model sees numeric arrays and identity
columns. The learning rate is set from the host between steps by
``LearningRateScheduler`` over ``create_host_schedulable_optimizer``.
"""

import numpy as np

from elasticdl_tpu_torch.data.census_schema import (  # noqa: F401
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
from elasticdl_tpu_torch.train.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.train.losses import sigmoid_binary_cross_entropy
from elasticdl_tpu_torch.train.optimizers import (
    create_host_schedulable_optimizer,
)

AGE_BOUNDARIES = [18.0, 25.0, 30.0, 35.0, 40.0, 45.0, 50.0, 60.0, 70.0]
HOURS_BOUNDARIES = [20.0, 35.0, 40.0, 45.0, 55.0]
EDUCATION_BUCKETS = 30
OCCUPATION_BUCKETS = 50

_work_lookup = IndexLookup(WORK_CLASS_VOCABULARY, num_oov_tokens=1)
_marital_lookup = IndexLookup(MARITAL_STATUS_VOCABULARY, num_oov_tokens=1)
_education_hash = Hashing(EDUCATION_BUCKETS)
_occupation_hash = Hashing(OCCUPATION_BUCKETS)


def build_columns():
    age = fc.numeric_column("age")
    hours = fc.numeric_column("hours_per_week")
    age_buckets = fc.bucketized_column(age, AGE_BOUNDARIES)
    hours_buckets = fc.bucketized_column(hours, HOURS_BOUNDARIES)
    # the ids were resolved in dataset_fn; identity columns bound them
    work_class = fc.categorical_column_with_identity(
        "work_class_id", _work_lookup.vocab_size()
    )
    marital = fc.categorical_column_with_identity(
        "marital_status_id", _marital_lookup.vocab_size()
    )
    education = fc.categorical_column_with_identity(
        "education_id", EDUCATION_BUCKETS
    )
    occupation = fc.categorical_column_with_identity(
        "occupation_id", OCCUPATION_BUCKETS
    )
    group = fc.concatenated_categorical_column(
        [
            age_buckets,
            hours_buckets,
            work_class,
            marital,
            education,
            occupation,
        ]
    )
    wide_columns = (fc.indicator_column(group),)
    deep_columns = (
        age,
        hours,
        fc.embedding_column(group, dimension=8, combiner="sum"),
    )
    return wide_columns, deep_columns


class CensusWideDeep(FeatureNet):
    def __init__(self, hidden=(64, 32)):
        super().__init__()
        self.hidden = tuple(hidden)
        wide_cols, deep_cols = build_columns()
        self.wide_features = fc.DenseFeatures(columns=wide_cols)
        self.deep_features = fc.DenseFeatures(columns=deep_cols)
        width = tower(self, "deep_layers", self.deep_features.output_dim,
                      self.hidden)
        self.wide_logit = Dense(self.wide_features.output_dim, 1)
        self.deep_logit = Dense(width, 1)
        self.reset_parameters()

    def forward(self, features):
        wide = self.wide_features(features)
        deep = run_tower(self, "deep_layers", self.hidden,
                         self.deep_features(features))
        logit = self.wide_logit(wide) + self.deep_logit(deep)
        return logit.squeeze(-1)


def custom_model():
    return CensusWideDeep()


def loss(labels, predictions):
    return sigmoid_binary_cross_entropy(labels, predictions)


def optimizer():
    return create_host_schedulable_optimizer("Adam", learning_rate=0.0003)


def dataset_fn(dataset, mode=None, metadata=None):
    def parse(payload):
        example = decode_example(payload)

        def s(key):
            value = example[key]
            return value if isinstance(value, str) else str(value)

        features = {
            "age": np.float32(example["age"]).reshape(()),
            "hours_per_week": np.float32(
                example["hours_per_week"]
            ).reshape(()),
            "work_class_id": _work_lookup(
                np.array([s("work_class")])
            ).reshape((1,)),
            "marital_status_id": _marital_lookup(
                np.array([s("marital_status")])
            ).reshape((1,)),
            "education_id": _education_hash(
                np.array([s("education")])
            ).reshape((1,)),
            "occupation_id": _occupation_hash(
                np.array([s("occupation")])
            ).reshape((1,)),
        }
        return features, np.float32(example["label"]).reshape(())

    return dataset.map(parse)


def eval_metrics_fn():
    return {
        "auc": metrics.AUC(from_logits=True),
        "accuracy": metrics.BinaryAccuracy(from_logits=True),
    }


def callbacks():
    # the reference's staged schedule, set from the host between steps
    def _schedule(model_version):
        if model_version < 5000:
            return 0.0003
        elif model_version < 12000:
            return 0.0002
        return 0.0001

    return [LearningRateScheduler(_schedule)]
