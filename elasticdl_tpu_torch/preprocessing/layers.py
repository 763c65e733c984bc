"""Feature-preprocessing transforms (port of
elasticdl_tpu/preprocessing/layers.py): Hashing, IndexLookup,
Discretization, LogRound, RoundIdentity, Normalizer, ToNumber,
ToSparse/ToRagged, ConcatenateWithOffset and SparseEmbedding.

Each transform runs where its input lives:

- **Strings stay on the host** (numpy arrays): Hashing, IndexLookup and
  ToNumber take numpy string arrays and give numpy integer or float
  arrays.
- **Numeric transforms run on tensors**, on the tensor's device:
  Discretization, LogRound, RoundIdentity, Normalizer,
  ConcatenateWithOffset and the integer Hashing of a tensor. A numpy
  input becomes a CPU tensor.
- **Variable-length inputs** ride the fixed-shape ``PaddedSparse``
  (sparse.py); every layer maps over ``values`` and keeps the mask.

Ids come out as int64 tensors (the JAX package, without x64, gives
int32; the values agree below 2**31). Every layer is a plain callable;
``SparseEmbedding``, the one with a trainable weight, is an
``nn.Module``.
"""

import hashlib

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.preprocessing.sparse import (
    PaddedSparse,
    to_padded_sparse,
)

_MASK32 = 0xFFFFFFFF


def _is_string_array(x):
    return isinstance(x, np.ndarray) and x.dtype.kind in ("U", "S", "O")


def _tensor(x, dtype=None, device=None):
    """``x`` as a tensor (numpy and Python values on ``device``, the CPU
    by default), cast to ``dtype`` when given."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=device)
    elif device is not None:
        x = x.to(device)
    return x if dtype is None else x.to(dtype)


def _map_values(inputs, fn):
    """Apply fn to the value tensor, preserving PaddedSparse structure."""
    if isinstance(inputs, PaddedSparse):
        return inputs.with_values(fn(inputs.values))
    return fn(inputs)


def _string_hash(s, num_bins):
    digest = hashlib.md5(str(s).encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") % num_bins


def _int_mix_hash(x, num_bins):
    """The JAX package's uint32 mixer on a tensor. torch's uint32
    arithmetic is incomplete, so the words live in int64: masked to the
    low 32 bits after the cast and after each multiply (a product of
    two 32-bit words may pass 2**63 and wrap; its low 32 bits are still
    right), so every shift is logical."""
    x = x.to(torch.int64) & _MASK32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _MASK32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _MASK32
    x = x ^ (x >> 16)
    return x % num_bins


class Hashing:
    """value -> hash(value) % num_bins.

    Strings (and host numpy ints, so both agree) take a stable md5
    bucket of ``str(value)``; integer tensors take the uint32 mixer.
    Both are the same in every process, which elastic workers need to
    agree on feature buckets.
    """

    def __init__(self, num_bins):
        if not num_bins or num_bins <= 0:
            raise ValueError("num_bins must be a positive integer")
        self.num_bins = num_bins

    def __call__(self, inputs):
        return _map_values(inputs, self._hash)

    def _hash(self, values):
        if _is_string_array(values):
            flat = [
                _string_hash(v, self.num_bins) for v in values.reshape(-1)
            ]
            return np.array(flat, dtype=np.int64).reshape(values.shape)
        if isinstance(values, np.ndarray):
            flat = [
                _string_hash(int(v), self.num_bins)
                for v in values.reshape(-1)
            ]
            return np.array(flat, dtype=np.int64).reshape(values.shape)
        return _int_mix_hash(_tensor(values), self.num_bins)


class IndexLookup:
    """vocabulary term -> zero-based index; OOV -> len(vocab) +
    hash(term) % num_oov_tokens.

    The vocabulary is a list or a file of one term a line; repeated
    terms are refused. Host-side; gives int64 numpy arrays.
    """

    def __init__(self, vocabulary=None, num_oov_tokens=1):
        if isinstance(vocabulary, str):
            with open(vocabulary) as f:
                vocabulary = [line.rstrip("\n") for line in f if line.strip()]
        vocabulary = list(vocabulary or [])
        if len(set(vocabulary)) != len(vocabulary):
            raise ValueError("vocabulary contains repeated terms")
        self.vocabulary = vocabulary
        self.num_oov_tokens = max(1, num_oov_tokens)
        self._table = {term: i for i, term in enumerate(vocabulary)}

    def vocab_size(self):
        return len(self.vocabulary) + self.num_oov_tokens

    def __call__(self, inputs):
        return _map_values(inputs, self._lookup)

    def _lookup(self, values):
        values = np.asarray(values)
        flat = []
        for v in values.reshape(-1):
            key = v if isinstance(v, str) else str(v)
            idx = self._table.get(key)
            if idx is None:
                idx = len(self.vocabulary) + _string_hash(
                    key, self.num_oov_tokens
                )
            flat.append(idx)
        return np.array(flat, dtype=np.int64).reshape(values.shape)


class Discretization:
    """x -> bucket index over sorted boundaries; bins include the left
    boundary and exclude the right (bins=[0,1,2] -> 4 buckets)."""

    def __init__(self, bins):
        self.bins = torch.tensor(list(bins), dtype=torch.float32)

    def num_bins(self):
        return len(self.bins) + 1

    def __call__(self, inputs):
        return _map_values(inputs, self._bucketize)

    def _bucketize(self, values):
        x = _tensor(values, torch.float32)
        return torch.searchsorted(self.bins.to(x.device), x.contiguous(),
                                  right=True)


class LogRound:
    """x -> round(log_base(x)), clipped to [0, num_bins); non-positive
    inputs map to default_value."""

    def __init__(self, num_bins, default_value=0, base=None):
        self.num_bins = num_bins
        self.default_value = default_value
        self.base = base

    def __call__(self, inputs):
        return _map_values(inputs, self._log_round)

    def _log_round(self, values):
        x = _tensor(values, torch.float32)
        logs = torch.log(torch.clamp(x, min=1e-30))
        if self.base is not None:
            logs = logs / torch.log(
                torch.tensor(self.base, dtype=torch.float32, device=x.device))
        out = torch.round(logs).to(torch.int64)
        out = torch.where(x <= 0, torch.full_like(out, self.default_value),
                          out)
        return torch.clamp(out, 0, self.num_bins - 1)


class RoundIdentity:
    """x -> round(x) clipped to [0, num_buckets]: the value is its own
    bucket."""

    def __init__(self, num_buckets, default_value=0):
        self.num_buckets = num_buckets
        self.default_value = default_value

    def __call__(self, inputs):
        return _map_values(
            inputs,
            lambda v: torch.clamp(
                torch.round(_tensor(v, torch.float32)), 0, self.num_buckets
            ).to(torch.int64),
        )


class Normalizer:
    """x -> (x - subtractor) / divisor."""

    def __init__(self, subtractor, divisor):
        if divisor == 0:
            raise ValueError("The divisor cannot be 0")
        self.subtractor = subtractor
        self.divisor = divisor

    def __call__(self, inputs):
        return _map_values(
            inputs,
            lambda v: (_tensor(v, torch.float32) - self.subtractor)
            / self.divisor,
        )


class ToNumber:
    """Parse strings to numbers ("" -> default_value) on the host;
    numeric inputs are cast to a tensor of ``out_dtype``."""

    def __init__(self, out_dtype, default_value=0):
        self.out_dtype = np.dtype(out_dtype)
        self.default_value = default_value

    def __call__(self, inputs):
        return _map_values(inputs, self._convert)

    def _convert(self, values):
        if _is_string_array(values):
            flat = []
            for v in np.asarray(values).reshape(-1):
                if v == "":
                    flat.append(self.default_value)
                elif np.issubdtype(self.out_dtype, np.integer):
                    flat.append(int(float(v)))
                else:
                    flat.append(float(v))
            return np.array(flat, dtype=self.out_dtype).reshape(
                np.asarray(values).shape
            )
        dtype = torch.from_numpy(np.zeros(0, self.out_dtype)).dtype
        return _tensor(values, dtype)


class ToSparse:
    """Dense matrix -> PaddedSparse, dropping ignore_value entries. One
    fixed-shape representation serves as both a sparse and a ragged
    view: the mask carries the raggedness."""

    def __init__(self, ignore_value=None):
        self.ignore_value = ignore_value

    def __call__(self, inputs):
        if isinstance(inputs, PaddedSparse):
            return inputs
        return to_padded_sparse(inputs, self.ignore_value)


ToRagged = ToSparse


def _device_of(parts):
    """The device of the first tensor among ``parts`` (None: all are
    host arrays)."""
    for part in parts:
        if isinstance(part, torch.Tensor):
            return part.device
    return None


class ConcatenateWithOffset:
    """Add offsets[i] to inputs[i], then concatenate along axis: the
    id-space merge behind concatenated_categorical_column.
    PaddedSparse inputs concatenate values AND masks (axis=1)."""

    def __init__(self, offsets, axis=-1):
        self.offsets = offsets
        self.axis = axis

    def __call__(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            return inputs
        if self.offsets is not None and len(self.offsets) != len(inputs):
            raise ValueError(
                "offsets length %d != inputs length %d"
                % (len(self.offsets), len(inputs))
            )
        offsets = [int(off) for off in (self.offsets or [0] * len(inputs))]
        if isinstance(inputs[0], PaddedSparse):
            device = _device_of([x for sp in inputs for x in sp])
            values = torch.cat(
                [_tensor(sp.values, device=device) + off
                 for sp, off in zip(inputs, offsets)],
                dim=1,
            )
            mask = torch.cat(
                [_tensor(sp.mask, device=device) for sp in inputs], dim=1
            )
            weights = None
            if all(sp.weights is not None for sp in inputs):
                weights = torch.cat(
                    [_tensor(sp.weights, device=device) for sp in inputs],
                    dim=1,
                )
            return PaddedSparse(values, mask, weights)
        device = _device_of(inputs)
        return torch.cat(
            [_tensor(x, device=device) + off for x, off in zip(inputs, offsets)],
            dim=self.axis,
        )


class SparseEmbedding(nn.Module):
    """Embedding with a combiner over variable-length ids: a masked
    gather and a weighted sum, mean or sqrtn over the slots. Ids are
    clipped to ``[0, input_dim - 1]`` (the JAX gather clips; torch
    indexing would raise), and pad slots weigh 0.

    ``embeddings``: ``[input_dim, output_dim]``, flax's
    ``uniform(scale=0.05)`` (U[0, 0.05)) by ``reset_parameters``.
    """

    def __init__(self, input_dim, output_dim, combiner="mean"):
        super().__init__()
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError("combiner must be sum, mean or sqrtn")
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner
        self.embeddings = nn.Parameter(torch.empty(input_dim, output_dim))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.embeddings.copy_(
            torch.rand(self.embeddings.shape, generator=generator) * 0.05)

    def forward(self, inputs):
        if not isinstance(inputs, PaddedSparse):
            inputs = to_padded_sparse(inputs, ignore_value=0)
        table = self.embeddings
        ids = _tensor(inputs.values, device=table.device)
        mask = _tensor(inputs.mask, device=table.device)
        safe = torch.where(mask, ids, torch.zeros_like(ids)).long()
        if self.input_dim:
            safe = torch.clamp(safe, 0, self.input_dim - 1)
        rows = table[safe]  # [b, L, dim]
        w = mask.to(rows.dtype)
        if inputs.weights is not None:
            w = w * _tensor(inputs.weights, rows.dtype, table.device)
        summed = torch.einsum("blh,bl->bh", rows, w)
        if self.combiner == "sum":
            return summed
        denom = torch.sum(w, dim=1, keepdim=True)
        if self.combiner == "sqrtn":
            denom = torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))
        return summed / torch.clamp(denom, min=1e-12)
