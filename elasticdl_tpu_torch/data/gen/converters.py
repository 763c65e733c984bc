"""Converters: arrays / synthetic distributions -> sharded RecordIO
(port of elasticdl_tpu/data/gen/converters.py).

The shard layout is what RecordIODataReader reads: one file per shard,
``<name>-%05d.rec``.
"""

import os

import numpy as np

from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.recordio import write_records

from elasticdl_tpu_torch.data.census_schema import (
    MARITAL_STATUS_VOCABULARY,
    WORK_CLASS_VOCABULARY,
)


def _shard_paths(data_dir, name, num_shards):
    os.makedirs(data_dir, exist_ok=True)
    return [
        os.path.join(data_dir, "%s-%05d.rec" % (name, i))
        for i in range(num_shards)
    ]


def convert_rows(data_dir, rows, name="data", records_per_shard=1024):
    """Encode an iterable of feature dicts into RecordIO shard files.

    The generic converter core (reference image_label.py:convert); every
    dataset-specific generator below reduces to building rows and
    calling this."""
    rows = list(rows)
    num_shards = max(1, (len(rows) + records_per_shard - 1)
                     // records_per_shard)
    paths = _shard_paths(data_dir, name, num_shards)
    for i, path in enumerate(paths):
        chunk = rows[i * records_per_shard : (i + 1) * records_per_shard]
        write_records(path, [encode_example(row) for row in chunk])
    return paths


def convert_image_label(data_dir, images, labels, name="data",
                        records_per_shard=1024):
    """(N,H,W[,C]) images + (N,) labels -> RecordIO shards
    (reference recordio_gen/image_label.py)."""
    images = np.asarray(images)
    labels = np.asarray(labels).astype(np.int64)
    if len(images) != len(labels):
        raise ValueError("images and labels length mismatch")
    rows = (
        {"image": images[i], "label": labels[i]}
        for i in range(len(images))
    )
    return convert_rows(data_dir, rows, name, records_per_shard)


def gen_mnist_recordio(data_dir, num_records=2048, image_size=28,
                       num_classes=10, seed=0, records_per_shard=1024):
    """MNIST-shaped shards: uint8 images whose class-dependent blob
    pattern is learnable (reference mnist path of image_label.py)."""
    rng = np.random.RandomState(seed)
    # fixed per-class template: a bright patch at a class-specific spot
    templates = np.zeros((num_classes, image_size, image_size), np.float32)
    for c in range(num_classes):
        cx = (c * 2 + 3) % (image_size - 4) + 2
        cy = (c * 5 + 3) % (image_size - 4) + 2
        templates[c, cx - 2 : cx + 2, cy - 2 : cy + 2] = 200.0
    labels = rng.randint(0, num_classes, size=num_records)
    noise = rng.rand(num_records, image_size, image_size) * 64
    images = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return convert_image_label(
        data_dir, images, labels, "mnist", records_per_shard
    )


def gen_census_recordio(data_dir, num_records=2048, seed=0,
                        records_per_shard=1024):
    """Census-income-shaped rows matching the census_wide_deep model's
    schema (reference census_recordio_gen.py). Label is a logistic
    function of age/hours/work-class so wide&deep training converges."""
    rng = np.random.RandomState(seed)
    rows = []
    educations = ["Bachelors", "HS-grad", "Masters", "Some-college",
                  "Assoc-acdm", "Doctorate", "11th"]
    occupations = ["Tech-support", "Craft-repair", "Sales",
                   "Exec-managerial", "Prof-specialty", "Other-service"]
    work_scores = np.random.RandomState(7).randn(
        len(WORK_CLASS_VOCABULARY)
    )
    relationships = ["Wife", "Own-child", "Husband", "Not-in-family",
                     "Other-relative", "Unmarried"]
    races = ["White", "Black", "Asian-Pac-Islander",
             "Amer-Indian-Eskimo", "Other"]
    countries = ["United-States", "Mexico", "Philippines", "Germany",
                 "Canada", "India"]
    for _ in range(num_records):
        age = float(rng.randint(17, 80))
        hours = float(rng.randint(10, 70))
        capital_gain = float(rng.exponential(600.0)) if rng.rand() < 0.2 else 0.0
        capital_loss = float(rng.exponential(300.0)) if rng.rand() < 0.1 else 0.0
        wc = rng.randint(0, len(WORK_CLASS_VOCABULARY))
        score = (
            0.08 * (age - 40)
            + 0.07 * (hours - 40)
            # small weight: capital columns are invisible to the legacy
            # wide&deep model, so they must stay a minor label factor
            + 0.0003 * (capital_gain - capital_loss)
            + work_scores[wc]
            + rng.randn() * 0.25
        )
        rows.append({
            "age": np.float32(age),
            "hours_per_week": np.float32(hours),
            "capital_gain": np.float32(capital_gain),
            "capital_loss": np.float32(capital_loss),
            "work_class": WORK_CLASS_VOCABULARY[wc],
            "marital_status": MARITAL_STATUS_VOCABULARY[
                rng.randint(0, len(MARITAL_STATUS_VOCABULARY))
            ],
            "education": educations[rng.randint(0, len(educations))],
            "occupation": occupations[rng.randint(0, len(occupations))],
            "relationship": relationships[
                rng.randint(0, len(relationships))
            ],
            "race": races[rng.randint(0, len(races))],
            "sex": "Male" if rng.rand() < 0.5 else "Female",
            "native_country": countries[rng.randint(0, len(countries))],
            "label": np.int64(1 if score > 0 else 0),
        })
    return convert_rows(data_dir, rows, "census", records_per_shard)


def gen_frappe_recordio(data_dir, num_records=2048, num_features=10,
                        vocab=5382, seed=0, records_per_shard=1024):
    """Frappe-shaped rows: fixed-length sparse id list + binary label
    (reference frappe_recordio_gen.py; vocab 5382 is frappe's feature
    count). Planted linear signal over id weights."""
    rng = np.random.RandomState(seed)
    weights = np.random.RandomState(12345).randn(vocab) * 2
    rows = []
    for _ in range(num_records):
        ids = rng.randint(0, vocab, size=num_features).astype(np.int64)
        score = weights[ids].sum() / np.sqrt(num_features)
        rows.append({
            "ids": ids,
            "label": np.int64(1 if score + rng.randn() * 0.1 > 0 else 0),
        })
    return convert_rows(data_dir, rows, "frappe", records_per_shard)


HEART_NUMERIC = ["age", "trestbps", "chol", "thalach", "oldpeak"]
HEART_CATEGORICAL = {
    "sex": 2, "cp": 4, "fbs": 2, "restecg": 3, "exang": 2,
    "slope": 3, "ca": 4, "thal": 4,
}


def gen_heart_recordio(data_dir, num_records=1024, seed=0,
                       records_per_shard=1024):
    """Cleveland-heart-shaped rows: 5 numeric + 8 categorical columns +
    binary label (reference heart_recordio_gen.py)."""
    rng = np.random.RandomState(seed)
    ranges = {"age": (29, 77), "trestbps": (94, 200), "chol": (126, 564),
              "thalach": (71, 202), "oldpeak": (0.0, 6.2)}
    rows = []
    for _ in range(num_records):
        row = {}
        score = rng.randn() * 0.3
        for col in HEART_NUMERIC:
            lo, hi = ranges[col]
            value = lo + rng.rand() * (hi - lo)
            row[col] = np.float32(value)
            score += (value - (lo + hi) / 2) / (hi - lo)
        for col, cardinality in HEART_CATEGORICAL.items():
            cat = rng.randint(0, cardinality)
            row[col] = np.int64(cat)
            score += 0.3 * (cat - cardinality / 2)
        row["label"] = np.int64(1 if score > 0 else 0)
        rows.append(row)
    return convert_rows(data_dir, rows, "heart", records_per_shard)
