"""Embedding pull stack shared by training and serving: the PS pull
client and its bounded-staleness hot-row cache."""

from elasticdl_tpu_torch.embedding.client import (  # noqa: F401
    EmbeddingClient,
    HotRowCache,
)
