"""numpy/torch <-> TensorBlob conversion.

Port of elasticdl_tpu/common/tensor_utils.py (ndarray_to_blob,
blob_to_ndarray) plus torch-tensor variants. The wire stays
interchangeable with the JAX package: a blob carries the dtype NAME
("float32", "int32", "bfloat16", ...) beside its dims and raw
little-endian bytes.

bfloat16 has no numpy dtype here (the JAX package resolves it through
``ml_dtypes``, which ships with JAX). The port encodes and decodes it
through torch instead: ``t.view(torch.int16)`` gives the raw bytes, and
``torch.frombuffer(..., dtype=torch.bfloat16)`` reads them back, bit for
bit what ``ml_dtypes.bfloat16`` writes.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

_BF16 = "bfloat16"


def _fill(blob, dtype_name, shape, content):
    if blob is None:
        blob = pb.TensorBlob()
    blob.dtype = dtype_name
    del blob.dims[:]
    blob.dims.extend(shape)
    blob.content = content
    return blob


def ndarray_to_blob(array, blob=None) -> pb.TensorBlob:
    array = np.asarray(array)
    if array.dtype == object:
        # object arrays of python strings: fixed-width unicode has a
        # raw layout
        array = array.astype(str)
    # unicode/bytes need dtype.str ("<U7"); everything else, including
    # an ml_dtypes bfloat16 array handed in by a caller, dtype.name
    name = (
        array.dtype.str if array.dtype.kind in ("U", "S")
        else array.dtype.name
    )
    return _fill(blob, name, array.shape, array.tobytes())


def blob_to_ndarray(blob: pb.TensorBlob) -> np.ndarray:
    """Zero-copy numpy view of a blob. bfloat16 has no numpy dtype
    without ml_dtypes: decode it with ``blob_to_tensor``."""
    if blob.dtype == _BF16:
        raise TypeError(
            "bfloat16 blob has no numpy dtype here; use blob_to_tensor"
        )
    array = np.frombuffer(blob.content, dtype=np.dtype(blob.dtype))
    return array.reshape(tuple(blob.dims))


def as_tensor(value):
    """A tensor as is; an array (or array-like) as a CPU tensor sharing
    its memory where numpy allows."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value))


def tensor_to_blob(tensor, blob=None) -> pb.TensorBlob:
    """A tensor (any device; copied to the host) or an ndarray."""
    if not isinstance(tensor, torch.Tensor):
        return ndarray_to_blob(tensor, blob)
    tensor = tensor.detach().contiguous().cpu()
    if tensor.dtype == torch.bfloat16:
        raw = tensor.view(torch.int16).numpy().tobytes()
        return _fill(blob, _BF16, tensor.shape, raw)
    return ndarray_to_blob(tensor.numpy(), blob)


def blob_to_tensor(blob: pb.TensorBlob) -> torch.Tensor:
    """A CPU tensor owning a copy of the blob's bytes."""
    dims = tuple(blob.dims)
    if blob.dtype == _BF16:
        if not blob.content:
            return torch.empty(dims, dtype=torch.bfloat16)
        flat = torch.frombuffer(bytearray(blob.content), dtype=torch.bfloat16)
        return flat.reshape(dims)
    return torch.from_numpy(blob_to_ndarray(blob).copy())
