"""PaddedSparse: the fixed-shape stand-in for tf.SparseTensor/RaggedTensor
(port of elasticdl_tpu/preprocessing/sparse.py).

A variable-length feature is a dense ``[batch, max_len]`` value matrix
plus a boolean validity mask. Python lists of variable length become
padded numpy matrices on the host (``from_row_lists``); the combiners,
embedding lookups and offsets downstream run on tensors. A
``PaddedSparse`` holds numpy arrays or torch tensors, as the JAX
package's holds numpy or jnp arrays.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

PAD_ID = -1


class PaddedSparse(NamedTuple):
    """``values``: [batch, max_len] ids (or numerics), pad slots hold
    ``PAD_ID`` (ids) / 0 (numerics); ``mask``: [batch, max_len] bool,
    True on real entries; ``weights``: optional [batch, max_len] float."""

    values: object
    mask: object
    weights: Optional[object] = None

    @property
    def batch_size(self):
        return self.values.shape[0]

    @property
    def max_len(self):
        return self.values.shape[1]

    def with_values(self, values):
        """Same sparsity pattern, new values (layers transform values,
        keep the mask)."""
        return PaddedSparse(values, self.mask, self.weights)

    def row_lengths(self):
        if isinstance(self.mask, torch.Tensor):
            return self.mask.to(torch.int64).sum(dim=1)
        return np.sum(np.asarray(self.mask).astype(np.int64), axis=1)


def from_row_lists(rows, max_len=None, dtype=np.int64, weights=None):
    """Python lists of variable length -> PaddedSparse (host-side)."""
    max_len = max_len or max((len(r) for r in rows), default=1) or 1
    n = len(rows)
    values = np.zeros((n, max_len), dtype=dtype)
    mask = np.zeros((n, max_len), dtype=bool)
    w = None
    if weights is not None:
        w = np.zeros((n, max_len), dtype=np.float32)
    if np.issubdtype(np.dtype(dtype), np.integer):
        values[:] = PAD_ID
    for i, row in enumerate(rows):
        row = list(row)[:max_len]
        values[i, : len(row)] = row
        mask[i, : len(row)] = True
        if w is not None:
            wr = list(weights[i])[:max_len]
            w[i, : len(wr)] = wr
    return PaddedSparse(values, mask, w)


def to_padded_sparse(dense, ignore_value=None):
    """Dense [batch, len] -> PaddedSparse, dropping ``ignore_value``
    entries from the mask (default "" for strings, -1 for numerics).
    A tensor stays a tensor; anything else becomes a numpy array."""
    if isinstance(dense, torch.Tensor):
        ignore_value = -1 if ignore_value is None else ignore_value
        return PaddedSparse(dense, dense != ignore_value)
    dense = np.asarray(dense)
    if ignore_value is None:
        ignore_value = "" if dense.dtype.kind in ("U", "S", "O") else -1
    return PaddedSparse(dense, dense != ignore_value)


def dense_rows(sp: PaddedSparse):
    """PaddedSparse -> list of python lists (host-side, for tests/IO)."""
    values = _host(sp.values)
    mask = _host(sp.mask)
    return [list(values[i][mask[i]]) for i in range(values.shape[0])]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
