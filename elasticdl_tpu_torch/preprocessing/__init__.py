"""Preprocessing library: feature transforms and feature columns (port of
elasticdl_tpu/preprocessing/)."""

from elasticdl_tpu_torch.preprocessing.layers import (  # noqa: F401
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    IndexLookup,
    LogRound,
    Normalizer,
    RoundIdentity,
    SparseEmbedding,
    ToNumber,
    ToRagged,
    ToSparse,
)
from elasticdl_tpu_torch.preprocessing.sparse import (  # noqa: F401
    PAD_ID,
    PaddedSparse,
    dense_rows,
    from_row_lists,
    to_padded_sparse,
)
