"""Table-backed data readers (port of elasticdl_tpu/data/table_reader.py,
the MaxCompute/ODPS role).

Shards are fixed-size ``[start, start + records_per_task)`` ranges of
one table, named ``<table>:shard_<i>``; records stream from a
range-readable table service, and a parallel variant prefetches ranges
on threads. The reader is written against a small ``TableClient``
surface (table_size / read_rows / column_names), so the sharding and
streaming logic runs against an in-memory table and any warehouse
plugs in as a client. ``ODPSTableClient`` adapts the ``odps`` SDK
behind a lazy import: the port never depends on it.
"""

import queue
import threading

import numpy as np

from elasticdl_tpu_torch.data.readers import AbstractDataReader, Metadata


class TableClient:
    """Minimal range-readable table surface."""

    def table_size(self) -> int:
        raise NotImplementedError

    @property
    def column_names(self):
        raise NotImplementedError

    def read_rows(self, start, end, columns=None):
        """Yield row tuples for the [start, end) range."""
        raise NotImplementedError


class InMemoryTableClient(TableClient):
    """Row-list table: the test double, and an in-process job's table."""

    def __init__(self, rows, column_names):
        self._rows = list(rows)
        self._columns = list(column_names)

    def table_size(self):
        return len(self._rows)

    @property
    def column_names(self):
        return self._columns

    def read_rows(self, start, end, columns=None):
        indices = (
            [self._columns.index(c) for c in columns] if columns else None
        )
        for row in self._rows[start:end]:
            yield tuple(row[i] for i in indices) if indices else tuple(row)


class ODPSTableClient(TableClient):
    """MaxCompute adapter over the ``odps`` SDK (imported when one is
    built; an ImportError naming it when it is not installed)."""

    def __init__(self, project, access_id, access_key, table,
                 endpoint=None, partition=None):
        try:
            from odps import ODPS
        except ImportError as e:
            raise ImportError(
                "The 'odps' SDK is required for ODPSTableClient; "
                "install pyodps or use another TableClient"
            ) from e
        self._odps = ODPS(
            access_id=access_id,
            secret_access_key=access_key,
            project=project,
            endpoint=endpoint,
        )
        self._table = self._odps.get_table(table)
        self._partition = partition

    def table_size(self):
        with self._table.open_reader(partition=self._partition) as reader:
            return reader.count

    @property
    def column_names(self):
        return [c.name for c in self._table.table_schema.columns]

    def read_rows(self, start, end, columns=None):
        with self._table.open_reader(partition=self._partition) as reader:
            for record in reader.read(start=start, count=end - start,
                                      columns=columns):
                yield tuple(record.values)


class TableDataReader(AbstractDataReader):
    """Range-sharded reader over any TableClient.

    Shard names are ``<table>:shard_<i>`` with (start, count) ranges;
    records are row tuples, so a model's dataset_fn consumes them like
    CSV rows. Without a ``table_client`` the reader builds an
    ``ODPSTableClient`` from its other kwargs (project, access_id,
    access_key, endpoint, partition).
    """

    def __init__(self, table_client=None, table="table",
                 records_per_task=None, columns=None, **kwargs):
        super().__init__(**kwargs)
        if table_client is None:
            # the MaxCompute client from the kwargs (the factory fills
            # them from the MAXCOMPUTE_* environment)
            table_client = ODPSTableClient(table=table, **kwargs)
        self._client = table_client
        self._table = table
        self._records_per_task = records_per_task or 1024
        self._columns = columns

    def create_shards(self):
        table_size = self._client.table_size()
        per_task = self._records_per_task
        shards = {}
        prefix = self._table + ":shard_"
        num_full = table_size // per_task
        start = 0
        for shard_id in range(num_full):
            shards[prefix + str(shard_id)] = (start, per_task)
            start += per_task
        left = table_size % per_task
        if left:
            shards[prefix + str(num_full)] = (start, left)
        return shards

    def read_records(self, task):
        yield from self._client.read_rows(
            task.start, task.end, self._columns
        )

    @property
    def records_output_types(self):
        return tuple

    @property
    def metadata(self):
        return Metadata(column_names=list(
            self._columns or self._client.column_names
        ))

    def default_dataset_fn(self):
        """Rows -> ({column: float array}, label) with the last column
        as the label (the convention of the iris/table models)."""
        columns = self.metadata.column_names

        def dataset_fn(dataset, mode=None, metadata=None):
            names = (metadata.column_names
                     if metadata and metadata.column_names else columns)

            def parse(row):
                features = {
                    name: np.asarray(value, dtype=np.float32)
                    for name, value in zip(names[:-1], row[:-1])
                }
                return features, np.float32(row[-1])

            return dataset.map(parse)

        return dataset_fn


class ParallelTableDataReader(TableDataReader):
    """Prefetching variant: a task's range is split into page-sized
    sub-ranges fetched by up to ``num_parallel`` threads, the rows
    streamed in order. Once the consumer abandons the generator (a
    worker stopped mid-task) no further page is fetched."""

    def __init__(self, num_parallel=4, page_size=256, **kwargs):
        super().__init__(**kwargs)
        self._num_parallel = max(1, num_parallel)
        self._page_size = page_size

    def read_records(self, task):
        pages = [
            (start, min(start + self._page_size, task.end))
            for start in range(task.start, task.end, self._page_size)
        ]
        if not pages:
            return
        results = {}
        done = queue.Queue()
        sem = threading.Semaphore(self._num_parallel)
        cancelled = threading.Event()  # set when the consumer goes away

        def fetch(index, lo, hi):
            try:
                if cancelled.is_set():
                    done.put((index, [], None))
                    return
                rows = list(self._client.read_rows(lo, hi, self._columns))
                done.put((index, rows, None))
            # surfaced: the consumer re-raises it off the done queue
            except Exception as e:
                done.put((index, None, e))
            finally:
                sem.release()

        def submit_all():
            for index, (lo, hi) in enumerate(pages):
                sem.acquire()
                if cancelled.is_set():
                    sem.release()
                    return
                threading.Thread(
                    target=fetch, args=(index, lo, hi), daemon=True
                ).start()

        threading.Thread(target=submit_all, daemon=True).start()

        next_index = 0
        received = 0
        try:
            while received < len(pages):
                index, rows, error = done.get()
                received += 1
                if error is not None:
                    raise error
                results[index] = rows
                while next_index in results:
                    yield from results.pop(next_index)
                    next_index += 1
        finally:
            # abandoned generator (worker stopped mid-task): stop
            # spawning fetches so no further table I/O happens
            cancelled.set()
