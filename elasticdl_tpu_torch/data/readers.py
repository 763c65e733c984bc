"""Data readers: the contract between storage and the task system (port
of elasticdl_tpu/data/readers.py).

A reader yields the raw records of a task's ``[start, end)`` range of
one shard (``read_records(task)``) and lists its shards
(``create_shards()``). RecordIO (the ``edlrec`` format of
data/recordio.py) makes one shard per file. CSV makes one shard per
file too: the first line is the header, and a line-offset index built
on open lets a task seek to its first row. A table origin goes to
data/table_reader.py (fixed-size row ranges of one table).
"""

import csv
import glob
import io
import os

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.data import recordio

logger = _logger_factory("elasticdl_tpu_torch.data.readers")


class Metadata:
    def __init__(self, column_names=None, column_dtypes=None):
        self.column_names = column_names or []
        self.column_dtypes = column_dtypes or {}


class AbstractDataReader:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def read_records(self, task):
        """Yield raw records for task's [start, end) range of its shard."""
        raise NotImplementedError

    def create_shards(self):
        """Return {shard_name: (start, num_records)}."""
        raise NotImplementedError

    @property
    def records_output_types(self):
        return bytes

    @property
    def metadata(self):
        return Metadata()


class RecordIODataReader(AbstractDataReader):
    """Reads edlrec files under ``data_dir``; shards = one per file."""

    def __init__(self, data_dir=None, **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir

    def _files(self):
        files = sorted(
            f
            for f in glob.glob(os.path.join(self._data_dir, "*"))
            if os.path.isfile(f)
        )
        if not files:
            raise ValueError("No data files under %s" % self._data_dir)
        return files

    def create_shards(self):
        return {
            path: (0, recordio.count_records(path)) for path in self._files()
        }

    def read_records(self, task):
        with recordio.RecordReader(task.shard_name) as reader:
            yield from reader.read_range(task.start, task.end)


class CSVDataReader(AbstractDataReader):
    """CSV with a header row; one shard per file, seekable by line index."""

    def __init__(self, data_dir=None, sep=",", **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir
        self._sep = sep
        self._columns = None
        # path -> [byte offset of each data row]
        self._row_index = {}

    def _files(self):
        if os.path.isfile(self._data_dir):
            return [self._data_dir]
        files = sorted(glob.glob(os.path.join(self._data_dir, "*.csv")))
        if not files:
            raise ValueError("No csv files under %s" % self._data_dir)
        return files

    def _index_file(self, path):
        if path in self._row_index:
            return self._row_index[path]
        offsets = []
        with open(path, "rb") as f:
            header = f.readline()
            if self._columns is None:
                self._columns = (
                    header.decode("utf-8").rstrip("\r\n").split(self._sep)
                )
            off = f.tell()
            for line in f:
                if line.strip():
                    offsets.append(off)
                off += len(line)
        self._row_index[path] = offsets
        return offsets

    def create_shards(self):
        return {
            path: (0, len(self._index_file(path))) for path in self._files()
        }

    def read_records(self, task):
        offsets = self._index_file(task.shard_name)
        with open(task.shard_name, "rb") as f:
            for i in range(task.start, min(task.end, len(offsets))):
                f.seek(offsets[i])
                line = f.readline().decode("utf-8").rstrip("\r\n")
                yield next(csv.reader(io.StringIO(line), delimiter=self._sep))

    @property
    def records_output_types(self):
        return list

    @property
    def metadata(self):
        if self._columns is None:
            self._index_file(self._files()[0])
        return Metadata(column_names=self._columns or [])


def _table_kwargs(data_origin, kwargs):
    """The table reader's (table, kwargs) for ``data_origin``:
    ``odps://<project>/<table>[/<partition>...]`` parsed into project,
    table and partition (partition segments joined by commas, as the
    ODPS SDK's PartitionSpec takes them); without a ``table_client``,
    the credentials from the ``MAXCOMPUTE_*`` environment."""
    table = data_origin or ""
    if table.startswith("odps://"):
        parts = [p for p in table[len("odps://"):].split("/") if p]
        if len(parts) < 2:
            raise ValueError(
                "odps:// origin must be odps://<project>/<table>"
                "[/<partition>], got %r" % data_origin
            )
        kwargs.setdefault("project", parts[0])
        if len(parts) > 2:
            kwargs.setdefault("partition", ",".join(parts[2:]))
        table = parts[1]
    if kwargs.get("table_client") is None:
        for key, env in (("project", "MAXCOMPUTE_PROJECT"),
                         ("access_id", "MAXCOMPUTE_AK"),
                         ("access_key", "MAXCOMPUTE_SK"),
                         ("endpoint", "MAXCOMPUTE_ENDPOINT")):
            kwargs.setdefault(key, os.environ.get(env))
        missing = [
            env for env, key in (
                ("MAXCOMPUTE_PROJECT", "project"),
                ("MAXCOMPUTE_AK", "access_id"),
                ("MAXCOMPUTE_SK", "access_key"),
            ) if not kwargs.get(key)
        ]
        if missing:
            raise ValueError(
                "table origin %r requires credentials; set %s (or "
                "pass table_client=)" % (data_origin, ", ".join(missing))
            )
        if not kwargs.get("endpoint"):
            # the SDK may find its endpoint in its own config
            logger.warning(
                "no MAXCOMPUTE_ENDPOINT set for %r; relying on the "
                "ODPS SDK default endpoint resolution", data_origin
            )
    return table or "table", kwargs


def create_data_reader(data_origin, records_per_task=None, **kwargs):
    """The reader for ``data_origin``: the table reader for a
    ``table_client=`` kwarg, an ``odps://`` origin, or a path that does
    not exist while ``MAXCOMPUTE_PROJECT``, ``_AK`` and ``_SK`` are all
    set (``parallel=True`` takes ``ParallelTableDataReader``; tasks of
    ``records_per_task`` rows); CSV for a ``.csv`` file or a directory
    holding ``.csv`` files; else RecordIO."""
    if kwargs.get("table_client") is not None or (
        data_origin and data_origin.startswith("odps://")
    ) or (
        data_origin
        and not os.path.exists(data_origin)
        # project AND credentials, or a typo'd local path would reach
        # the SDK and fail there without saying why
        and all(os.environ.get(var) for var in (
            "MAXCOMPUTE_PROJECT", "MAXCOMPUTE_AK", "MAXCOMPUTE_SK"))
    ):
        from elasticdl_tpu_torch.data.table_reader import (
            ParallelTableDataReader,
            TableDataReader,
        )

        table, kwargs = _table_kwargs(data_origin, dict(kwargs))
        cls = (ParallelTableDataReader if kwargs.pop("parallel", False)
               else TableDataReader)
        return cls(table=table, records_per_task=records_per_task, **kwargs)
    if data_origin and (
        data_origin.endswith(".csv")
        or (
            os.path.isdir(data_origin)
            and glob.glob(os.path.join(data_origin, "*.csv"))
        )
    ):
        return CSVDataReader(data_dir=data_origin, **kwargs)
    return RecordIODataReader(data_dir=data_origin, **kwargs)
