"""Embedding pull stack shared by training and serving (the cache and
its degraded fill are not ported yet)."""

from elasticdl_tpu_torch.embedding.client import EmbeddingClient  # noqa: F401
