"""Embedding pull path shared by training and serving (port of
elasticdl_tpu/embedding/client.py: ``EmbeddingClient``'s pull path).

The reference fronts the pull with an optional bounded-staleness
``HotRowCache`` and a degraded fill for an overloaded PS. Neither is
ported yet: with the device tier on, the tier supersedes the cache
(train/sparse.py), and every pull here goes to the PS client.
"""

import concurrent.futures
import threading

import numpy as np

from elasticdl_tpu_torch.common.tensor_utils import normalize_id_tables


def _rows_f32(values):
    values = np.asarray(values)
    if values.dtype != np.float32:
        return values.astype(np.float32)
    return values


class EmbeddingClient:
    """Pulls embedding rows, riding the fused multi-table pull when the
    PS client serves it.

    ``ps_client`` is anything with ``pull_embedding_vectors(name, ids)``
    (``ps.local_client.LocalPSClient``); a client that also has
    ``pull_embedding_batch`` gets all tables in one call per PS shard.
    """

    def __init__(self, ps_client):
        self._ps = ps_client
        # table-level fan-out pool for clients without the fused batch
        # pull; created only if that path ever runs
        self._table_pool = None
        self._pool_lock = threading.Lock()

    def pull(self, name, unique):
        """Rows for one table's unique ids: [n_unique, dim] float32."""
        unique = np.asarray(unique, dtype=np.int64)
        return _rows_f32(self._ps.pull_embedding_vectors(name, unique))

    def _fan_out(self, ids_by_table):
        """Per-table thread fan-out for clients without the fused batch
        pull, so such a client still gets table-level concurrency."""
        if len(ids_by_table) == 1:
            name, ids = next(iter(ids_by_table.items()))
            return {name: self.pull(name, ids)}
        with self._pool_lock:
            if self._table_pool is None:
                self._table_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=max(4, len(ids_by_table)),
                    thread_name_prefix="emb-table-pull",
                )
            pool = self._table_pool
        futures = {
            name: pool.submit(self.pull, name, ids)
            for name, ids in ids_by_table.items()
        }
        return {name: future.result() for name, future in futures.items()}

    def pull_tables(self, ids_by_table):
        """``{table: unique int64 ids}`` in, ``{table: rows [n, dim]
        float32}`` out (row order matches each table's input ids); one
        fused ``pull_embedding_batch`` against a batch-capable client,
        else the per-table fan-out."""
        ids_by_table = normalize_id_tables(ids_by_table)
        if not ids_by_table:
            return {}
        batch_pull = getattr(self._ps, "pull_embedding_batch", None)
        if batch_pull is None:
            return self._fan_out(ids_by_table)
        fetched = batch_pull(ids_by_table)
        return {name: _rows_f32(fetched[name]) for name in ids_by_table}

    def close(self):
        """Stop the fan-out pool, if the fan-out path ever made one."""
        with self._pool_lock:
            pool, self._table_pool = self._table_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
