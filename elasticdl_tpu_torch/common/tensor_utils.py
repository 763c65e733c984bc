"""numpy/torch <-> TensorBlob conversion, IndexedSlices helpers and the
wire-dtype knob.

Port of elasticdl_tpu/common/tensor_utils.py (ndarray_to_blob,
blob_to_ndarray, deduplicate_indexed_slices, normalize_id_tables,
wire_dtype) plus torch-tensor variants. The wire stays
interchangeable with the JAX package: a blob carries the dtype NAME
("float32", "int32", "bfloat16", ...) beside its dims and raw
little-endian bytes.

bfloat16 has no numpy dtype here (the JAX package resolves it through
``ml_dtypes``, which ships with JAX). The port encodes and decodes it
through torch instead: ``t.view(torch.int16)`` gives the raw bytes, and
``torch.frombuffer(..., dtype=torch.bfloat16)`` reads them back, bit for
bit what ``ml_dtypes.bfloat16`` writes.

``EDL_WIRE_DTYPE`` (float32, bfloat16, float16) names the dtype float32
payloads round to on the wire; ``wire_round_trip`` applies that rounding
through torch (``.to(torch.bfloat16).float()``), never ``ml_dtypes``.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

_BF16 = "bfloat16"

WIRE_DTYPE_ENV = "EDL_WIRE_DTYPE"

# EDL_WIRE_DTYPE values -> torch dtype float32 payloads round to; None =
# leave payloads alone (bit-exact fp32)
_WIRE_DTYPES = {
    "": None,
    "float32": None,
    "fp32": None,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


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


def wire_dtype():
    """The configured wire payload dtype (a torch dtype), or None for
    bit-exact fp32. Read from the environment on every call, so a
    changed knob takes effect at once."""
    value = env_str(WIRE_DTYPE_ENV, "")
    key = value.strip().lower()
    if key not in _WIRE_DTYPES:
        raise ValueError(
            "%s=%r is not a supported wire dtype (float32, bfloat16, "
            "float16)" % (WIRE_DTYPE_ENV, value)
        )
    return _WIRE_DTYPES[key]


def wire_round_trip(values):
    """float32 ``values`` -> wire dtype -> float32 (what serialization at
    EDL_WIRE_DTYPE followed by the receiver's fp32 upcast does); other
    dtypes, and every payload at fp32, pass through."""
    dtype = wire_dtype()
    values = np.asarray(values)
    if dtype is None or values.dtype != np.float32:
        return values
    return torch.from_numpy(values).to(dtype).float().numpy()


def normalize_id_tables(ids_by_table):
    """``{table: ids}`` -> ``{table: int64 ndarray}`` with empty tables
    dropped, one conversion per table."""
    converted = {}
    for name, ids in ids_by_table.items():
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size:
            converted[name] = ids
    return converted


def deduplicate_indexed_slices(values, ids):
    """Sum rows with duplicate ids; returns ``(summed_values,
    unique_ids)`` with the ids sorted.

    Segment sum via sort + ``np.add.reduceat``, as the reference does,
    so the sums are the reference's bit for bit; unique ids are a pure
    permutation."""
    ids = np.asarray(ids, dtype=np.int64)
    values = np.asarray(values)
    unique_ids, index = np.unique(ids, return_inverse=True)
    if unique_ids.size == ids.size:
        # no duplicates: index is a permutation, so invert it
        order = np.argsort(index)
        return values[order], unique_ids
    order = np.argsort(index, kind="stable")
    sorted_values = values[order]
    counts = np.bincount(index, minlength=unique_ids.size)
    # every unique id has >= 1 occurrence, so starts is strictly
    # increasing and reduceat's segments are exactly the id groups
    starts = np.zeros(unique_ids.size, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    summed = np.add.reduceat(sorted_values, starts, axis=0)
    return summed, unique_ids
