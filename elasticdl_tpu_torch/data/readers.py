"""Data readers: the contract between storage and the task system (port
of elasticdl_tpu/data/readers.py, RecordIO only).

A reader yields the raw records of a task's ``[start, end)`` range of
one shard (``read_records(task)``) and lists its shards
(``create_shards()``). RecordIO (the ``edlrec`` format of
data/recordio.py) makes one shard per file. The CSV and MaxCompute
table readers wait until a ported path reads them (ROADMAP Queue 1).
"""

import glob
import os

from elasticdl_tpu_torch.data import recordio


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


def create_data_reader(data_origin, records_per_task=None, **kwargs):
    """RecordIO for a file or directory origin. A table origin raises
    ``NotImplementedError``: its reader is not ported."""
    del records_per_task  # read only by the table reader
    if kwargs.get("table_client") is not None or (
        data_origin and data_origin.startswith("odps://")
    ):
        raise NotImplementedError(
            "table origin %r: the MaxCompute reader is not ported yet "
            "(ROADMAP Queue 1)" % (data_origin,)
        )
    return RecordIODataReader(data_dir=data_origin, **kwargs)
