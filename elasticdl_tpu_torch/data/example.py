"""Example (de)serialization for record files (port of
elasticdl_tpu/data/example.py).

An example is a dict of named numpy arrays, serialized as the ``Record``
proto through the port's own pb2 copy and ``common/tensor_utils.py``,
so a record either package writes decodes in the other byte for byte.
"""

import numpy as np

from elasticdl_tpu_torch.common.tensor_utils import (
    blob_to_ndarray,
    ndarray_to_blob,
)
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb


def encode_example(features: dict) -> bytes:
    record = pb.Record()
    for name, value in features.items():
        ndarray_to_blob(np.asarray(value), record.features[name])
    return record.SerializeToString()


def decode_example(payload: bytes) -> dict:
    record = pb.Record.FromString(bytes(payload))
    return {
        name: blob_to_ndarray(blob) for name, blob in record.features.items()
    }
