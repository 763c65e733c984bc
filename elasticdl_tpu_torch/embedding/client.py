"""Embedding pull/cache stack shared by training and serving (port of
elasticdl_tpu/embedding/client.py).

``EmbeddingClient`` pulls rows through an optional bounded-staleness
``HotRowCache``, riding the fused multi-table pull when the PS client
serves it. Two cache disciplines:

- **Training** (the preparer): a logical clock of prepares. One thread
  ever mutates the cache (the pulling thread; ``train_stream`` runs its
  prepares in order on one lookahead thread), and a PS relaunch's
  invalidation is deferred to that thread
  (``SparseBatchPreparer._cache_dirty``).
- **Serving** (``thread_safe=True`` with ``ttl_secs``): freshness is
  wall-clock, every operation takes the cache's lock, and an
  invalidation may come from any thread.

With ``EDL_BROWNOUT_SKIP_AFTER`` > 0, a pull that fails with an
overload-class error is served degraded (``_degraded_fill``): fresh
cached rows, stale cached rows past the horizon, zeros for ids never
cached.
"""

import concurrent.futures
import contextlib
import threading
import time

import numpy as np

from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.common.tensor_utils import normalize_id_tables
from elasticdl_tpu_torch.observability import events

logger = _logger_factory("elasticdl_tpu_torch.embedding.client")


class HotRowCache:
    """Bounded-staleness host cache of pulled embedding rows.

    A pulled row may be reused for up to ``staleness`` later prepares
    though pushes have since updated it on the PS: CTR ids are Zipfian,
    so the hot ids recur in every batch and most pull bytes go away.
    ``ttl_secs`` switches the clock to wall-clock seconds (``staleness``
    is then ignored); ``thread_safe`` wraps every operation in a lock.
    """

    def __init__(self, staleness=1, capacity=1_000_000, ttl_secs=None,
                 thread_safe=False):
        if ttl_secs is None and staleness < 1:
            raise ValueError("staleness must be >= 1")
        if ttl_secs is not None and ttl_secs <= 0:
            raise ValueError("ttl_secs must be > 0")
        self.staleness = int(staleness)
        self.capacity = int(capacity)
        self.ttl_secs = ttl_secs
        self._clock = 0
        # invalidation epoch: clear() bumps it, and a put() stamped with
        # an older one is dropped (a fill that fetched from a PS that
        # relaunched meanwhile must not re-insert its rows)
        self.generation = 0
        # name -> (sorted ids [n], rows [n, dim], pull stamps [n])
        self._tables = {}
        self.hits = 0
        self.misses = 0
        self._lock = (threading.RLock() if thread_safe
                      else contextlib.nullcontext())

    def _now(self):
        if self.ttl_secs is not None:
            return time.monotonic()
        return self._clock

    def _horizon(self):
        """Oldest stamp still fresh at this instant."""
        if self.ttl_secs is not None:
            return time.monotonic() - self.ttl_secs
        return self._clock - self.staleness

    def advance(self):
        """Tick the logical clock (one call per prepare); no-op under a
        wall-clock TTL."""
        if self.ttl_secs is None:
            self._clock += 1

    def split(self, name, unique):
        """Partition ``unique`` (sorted) ids into fresh-cached and
        to-pull: ``(cached_mask [n] bool, cached_rows [hits, dim] or
        None)``."""
        with self._lock:
            entry = self._tables.get(name)
            if entry is None:
                self.misses += int(unique.size)
                return np.zeros(unique.shape, dtype=bool), None
            ids, rows, stamps = entry
            pos = np.searchsorted(ids, unique)
            pos_clipped = np.minimum(pos, max(ids.size - 1, 0))
            found = (pos < ids.size) & (ids[pos_clipped] == unique)
            # the stamp is the PULL time: a hit must not refresh it. >=
            # so that staleness=1 reuses a row for exactly one later
            # prepare
            fresh = found & (stamps[pos_clipped] >= self._horizon())
            n_hit = int(fresh.sum())
            self.hits += n_hit
            self.misses += int(unique.size) - n_hit
            if n_hit == 0:
                return np.zeros(unique.shape, dtype=bool), None
            return fresh, rows[pos_clipped[fresh]]

    def lookup_any(self, name, unique):
        """Like ``split`` but any cached id qualifies, however stale
        (degraded pulls); tallies untouched. ``(found_mask, rows or
        None)``."""
        with self._lock:
            entry = self._tables.get(name)
            if entry is None:
                return np.zeros(unique.shape, dtype=bool), None
            ids, rows, _stamps = entry
            pos = np.searchsorted(ids, unique)
            pos_clipped = np.minimum(pos, max(ids.size - 1, 0))
            found = (pos < ids.size) & (ids[pos_clipped] == unique)
            if not found.any():
                return found, None
            return found, rows[pos_clipped[found]]

    def clear(self):
        """Invalidate every cached row (the PS relaunched); tallies are
        kept, the generation moves on."""
        with self._lock:
            self._tables.clear()
            self.generation += 1

    def hit_rate(self):
        """Lifetime hit fraction (0.0 before any traffic)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def put(self, name, new_ids, new_rows, if_generation=None):
        """Insert freshly pulled rows; with ``if_generation`` (the
        caller's ``generation`` from before its fetch) only if no
        clear() ran since. Past ``capacity`` the oldest pulls go
        first."""
        new_ids = np.asarray(new_ids, dtype=np.int64)
        new_rows = np.asarray(new_rows, dtype=np.float32)
        if new_ids.size and np.any(np.diff(new_ids) <= 0):
            # callers normally pass np.unique output; normalize otherwise
            new_ids, first = np.unique(new_ids, return_index=True)
            new_rows = new_rows[first]
        stamp_dtype = np.float64 if self.ttl_secs is not None else np.int64
        with self._lock:
            if if_generation is not None and (
                if_generation != self.generation
            ):
                return
            new_stamps = np.full(new_ids.shape, self._now(),
                                 dtype=stamp_dtype)
            entry = self._tables.get(name)
            if entry is not None:
                old_ids, old_rows, old_stamps = entry
                # new entries win on duplicate ids (unique keeps the
                # first occurrence, so concatenate new first)
                all_ids = np.concatenate([new_ids, old_ids])
                merged, first = np.unique(all_ids, return_index=True)
                all_rows = np.concatenate([new_rows, old_rows], axis=0)
                all_stamps = np.concatenate([new_stamps, old_stamps])
                new_ids = merged
                new_rows = all_rows[first]
                new_stamps = all_stamps[first].astype(stamp_dtype)
            if new_ids.size > self.capacity:
                keep = np.argpartition(
                    -new_stamps, self.capacity - 1
                )[: self.capacity]
                keep.sort()  # sorted-id order again
                new_ids = new_ids[keep]
                new_rows = new_rows[keep]
                new_stamps = new_stamps[keep]
            self._tables[name] = (new_ids, new_rows, new_stamps)


def _rows_f32(values):
    values = np.asarray(values)
    if values.dtype != np.float32:
        return values.astype(np.float32)
    return values


class EmbeddingClient:
    """Pulls embedding rows through an optional ``HotRowCache``.

    ``ps_client`` is anything with ``pull_embedding_vectors(name, ids)``
    (``worker.ps_client.PSClient``, ``ps.local_client.LocalPSClient``);
    a client that also has ``pull_embedding_batch`` gets every table's
    cache misses in one call per PS shard.
    """

    def __init__(self, ps_client, cache=None):
        self._ps = ps_client
        self._cache = cache
        # table-level fan-out pool for clients without the fused pull;
        # created only if that path ever runs
        self._table_pool = None
        self._pool_lock = threading.Lock()
        # last row dim seen per table: a degraded pull builds zero rows
        # for ids never cached, and only a PS answer tells the dim
        self._dims = {}

    @property
    def cache(self):
        return self._cache

    def hit_rate(self):
        return self._cache.hit_rate() if self._cache is not None else 0.0

    def advance(self):
        """Tick the cache's logical clock (training: once per prepare)."""
        if self._cache is not None:
            self._cache.advance()

    def invalidate(self):
        """Drop every cached row: the backing PS restarted. The training
        preparer calls this only from its pulling thread."""
        if self._cache is not None:
            self._cache.clear()

    # ------------------------------------------------------------------
    def _assemble(self, name, unique, cached_mask, cached_rows, fetched,
                  generation=None):
        """Cache hits and one fresh fetch merged into [n_unique, dim]
        fp32, the fetched rows recorded in the cache (unless an
        invalidation ran since ``generation``)."""
        if cached_rows is not None:
            dim = cached_rows.shape[1]
        else:
            dim = np.asarray(fetched).shape[1]
        self._dims[name] = dim
        rows = np.empty((unique.size, dim), dtype=np.float32)
        if cached_rows is not None:
            rows[cached_mask] = cached_rows
        missing = unique[~cached_mask]
        if missing.size:
            fetched = _rows_f32(fetched)
            rows[~cached_mask] = fetched
            self._cache.put(name, missing, fetched, if_generation=generation)
        return rows

    def _degraded_fill(self, name, unique, cached_mask, cached_rows, error):
        """Brownout pull: fresh cache hits, stale cached rows past the
        horizon, zeros (the cold-init stand-in) for ids never cached.
        The degraded rows are not put back in the cache. Re-raises
        ``error`` when the row dim cannot be known."""
        missing = unique[~cached_mask]
        if not missing.size and cached_rows is not None:
            return np.asarray(cached_rows, dtype=np.float32)
        found, stale_rows = self._cache.lookup_any(name, missing)
        if stale_rows is not None:
            dim = stale_rows.shape[1]
        elif cached_rows is not None:
            dim = cached_rows.shape[1]
        else:
            dim = self._dims.get(name)
        if dim is None:
            raise error
        rows = np.zeros((unique.size, dim), dtype=np.float32)
        if cached_rows is not None:
            rows[cached_mask] = cached_rows
        if stale_rows is not None:
            stale_full = np.zeros((missing.size, dim), dtype=np.float32)
            stale_full[found] = stale_rows
            rows[~cached_mask] = stale_full
        n_stale = int(found.sum()) if stale_rows is not None else 0
        overload.note_degraded_pull()
        logger.warning(
            "degraded pull for table %s: %d stale cached rows, %d "
            "cold-init zeros (%s)", name, n_stale,
            int(missing.size) - n_stale, error,
        )
        if events.enabled():
            events.emit(
                "degraded_pull", table=name, ids=int(unique.size),
                stale=n_stale, cold=int(missing.size) - n_stale,
            )
        return rows

    def pull(self, name, unique):
        """Rows for one table's unique ids, consulting the cache:
        [n_unique, dim] float32."""
        unique = np.asarray(unique, dtype=np.int64)
        if self._cache is None:
            return _rows_f32(self._ps.pull_embedding_vectors(name, unique))
        generation = self._cache.generation
        cached_mask, cached_rows = self._cache.split(name, unique)
        missing = unique[~cached_mask]
        fetched = None
        if missing.size:
            try:
                fetched = self._ps.pull_embedding_vectors(name, missing)
            except Exception as e:
                if not (overload.brownout_enabled()
                        and overload.is_overload_failure(e)):
                    raise
                return self._degraded_fill(name, unique, cached_mask,
                                           cached_rows, e)
        return self._assemble(name, unique, cached_mask, cached_rows,
                              fetched, generation=generation)

    def _fan_out(self, ids_by_table):
        """Per-table thread fan-out for clients without the fused pull."""
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
        float32}`` out (row order matches each table's ids). Every
        table's cache misses ride one fused ``pull_embedding_batch``
        against a batch-capable client, else the per-table fan-out."""
        ids_by_table = normalize_id_tables(ids_by_table)
        if not ids_by_table:
            return {}
        batch_pull = getattr(self._ps, "pull_embedding_batch", None)
        if batch_pull is None:
            return self._fan_out(ids_by_table)
        if self._cache is None:
            fetched = batch_pull(ids_by_table)
            return {name: _rows_f32(fetched[name]) for name in ids_by_table}
        generation = self._cache.generation
        to_pull = {}
        cache_parts = {}  # name -> (cached_mask, cached_rows)
        for name, unique in ids_by_table.items():
            cached_mask, cached_rows = self._cache.split(name, unique)
            cache_parts[name] = (cached_mask, cached_rows)
            missing = unique[~cached_mask]
            if missing.size:
                to_pull[name] = missing
        try:
            fetched = batch_pull(to_pull) if to_pull else {}
        except Exception as e:
            if not (overload.brownout_enabled()
                    and overload.is_overload_failure(e)):
                raise
            return {
                name: self._degraded_fill(name, unique, *cache_parts[name],
                                          e)
                for name, unique in ids_by_table.items()
            }
        return {
            name: self._assemble(name, unique, *cache_parts[name],
                                 fetched.get(name), generation=generation)
            for name, unique in ids_by_table.items()
        }

    def close(self):
        """Stop the fan-out pool, if the fan-out path ever made one."""
        with self._pool_lock:
            pool, self._table_pool = self._table_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
