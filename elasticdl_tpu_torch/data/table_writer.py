"""Table write path: prediction outputs back into a warehouse table
(port of elasticdl_tpu/data/table_writer.py).

Each worker writes its prediction outputs into its own partition
(``worker=<index>``) of a table, through buffered writer threads. The
writer is built against a small ``WritableTable`` surface, so the
buffering runs against an in-memory table and any warehouse plugs in;
``ODPSWritableTable`` adapts the ``odps`` SDK behind a lazy import.
"""

import queue
import threading

import numpy as np

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.data.table_writer")


class WritableTable:
    """Minimal partitioned-append surface."""

    def write_rows(self, rows, partition=None):
        """Append row tuples to ``partition`` (created on demand)."""
        raise NotImplementedError


class InMemoryWritableTable(WritableTable):
    """Dict-of-partitions sink: the test double, and an in-process
    job's table."""

    def __init__(self, column_names=None):
        self.column_names = list(column_names or [])
        self.partitions = {}
        self._lock = threading.Lock()

    def write_rows(self, rows, partition=None):
        with self._lock:
            self.partitions.setdefault(partition, []).extend(
                tuple(row) for row in rows
            )

    def rows(self, partition=None):
        with self._lock:
            return list(self.partitions.get(partition, []))


class ODPSWritableTable(WritableTable):
    """MaxCompute adapter (the SDK imported when one is built): creates
    the table with a ``worker`` partition column when it does not exist
    and opens a writer per partition."""

    def __init__(self, project, access_id, access_key, table,
                 endpoint=None, columns=None, column_types=None):
        try:
            from odps import ODPS
            from odps.models import Schema
        except ImportError as e:
            raise ImportError(
                "The 'odps' SDK is required for ODPSWritableTable; "
                "install pyodps or use another WritableTable"
            ) from e
        if "." in table:
            project, table = table.split(".", 1)
        self._odps = ODPS(
            access_id=access_id,
            secret_access_key=access_key,
            project=project,
            endpoint=endpoint,
        )
        if self._odps.exist_table(table, project):
            self._table = self._odps.get_table(table, project)
        else:
            if not columns or not column_types:
                raise ValueError(
                    "columns and column_types are required to create "
                    "table %r" % table
                )
            schema = Schema.from_lists(
                list(columns), list(column_types), ["worker"], ["string"]
            )
            self._table = self._odps.create_table(table, schema)

    def write_rows(self, rows, partition=None):
        with self._table.open_writer(
            partition=partition, create_partition=True
        ) as writer:
            writer.write([list(row) for row in rows])


class TableWriter:
    """Buffered parallel writer into a WritableTable.

    Rows accumulate into ``buffer_rows`` chunks; full chunks are handed
    to ``num_parallel`` background writer threads. ``close()`` flushes
    and joins; a failed write surfaces there (or on the next
    ``write``), not silently."""

    def __init__(self, sink, worker_index=0, buffer_rows=1024,
                 num_parallel=2):
        self._sink = sink
        self._partition = "worker=%d" % worker_index
        self._buffer_rows = max(1, buffer_rows)
        self._buffer = []
        self._queue = queue.Queue(maxsize=max(2, 2 * num_parallel))
        self._errors = []
        self._threads = [
            threading.Thread(
                target=self._drain, name="table-writer-%d" % i, daemon=True
            )
            for i in range(max(1, num_parallel))
        ]
        for thread in self._threads:
            thread.start()
        self._closed = False

    def _drain(self):
        while True:
            chunk = self._queue.get()
            if chunk is None:
                return
            try:
                self._sink.write_rows(chunk, partition=self._partition)
            except Exception as e:
                logger.exception("table write failed")
                self._errors.append(e)

    def _raise_pending(self):
        if self._errors:
            raise RuntimeError(
                "table write failed: %s" % self._errors[0]
            ) from self._errors[0]

    def write(self, rows):
        """Append row tuples (or a dict of equal-length column arrays,
        the shape prediction outputs arrive in)."""
        if self._closed:
            raise RuntimeError("TableWriter is closed")
        self._raise_pending()
        if isinstance(rows, dict):
            columns = [np.asarray(v) for v in rows.values()]
            rows = list(zip(*[c.tolist() for c in columns]))
        self._buffer.extend(tuple(row) for row in rows)
        while len(self._buffer) >= self._buffer_rows:
            chunk = self._buffer[: self._buffer_rows]
            del self._buffer[: self._buffer_rows]
            self._queue.put(chunk)

    def from_iterator(self, records_iter):
        """Drain an iterator of row batches, then close."""
        for rows in records_iter:
            self.write(rows)
        self.close()

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._buffer:
            self._queue.put(self._buffer)
            self._buffer = []
        for _ in self._threads:
            self._queue.put(None)
        for thread in self._threads:
            thread.join()
        self._raise_pending()


class TablePredictionOutputsProcessor:
    """A ``PredictionOutputsProcessor`` (models/registry.py contract)
    that lands every prediction batch in its worker's table partition.
    ``close()`` (run before the worker reports its task done) flushes
    every writer.

    Model zoos subclass and set ``sink`` (or override ``make_sink``)."""

    sink = None  # WritableTable; subclass responsibility

    def __init__(self):
        self._writers = {}

    def make_sink(self):
        if self.sink is None:
            raise ValueError(
                "TablePredictionOutputsProcessor needs a sink "
                "(set the class attribute or override make_sink)"
            )
        return self.sink

    def process(self, outputs, worker_id):
        writer = self._writers.get(worker_id)
        if writer is None:
            writer = TableWriter(self.make_sink(), worker_index=worker_id)
            self._writers[worker_id] = writer
        writer.write(outputs)

    def close(self):
        for writer in self._writers.values():
            writer.close()
