"""Port's data layer against the JAX package's: record files, examples,
readers and the batching pipeline.

The record format and the Example proto are shared, so files and
payloads written by either package must be byte-identical and read in
the other; the pipeline must form the same padded batches and masks,
and treat FLUSH the same way, on the same examples (numpy, seeded).
"""

import os

import numpy as np
import pytest

from elasticdl_tpu.data import example as jax_example
from elasticdl_tpu.data import pipeline as jax_pipeline
from elasticdl_tpu.data import readers as jax_readers
from elasticdl_tpu.data import recordio as jax_recordio
from elasticdl_tpu.proto import elasticdl_tpu_pb2 as jax_pb
from elasticdl_tpu_torch.data import example as port_example
from elasticdl_tpu_torch.data import pipeline as port_pipeline
from elasticdl_tpu_torch.data import readers as port_readers
from elasticdl_tpu_torch.data import recordio as port_recordio
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as port_pb


def _payloads(n=37, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.bytes(rng.randint(0, 300)) for _ in range(n)]


def _examples(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, 32000, size=64).astype(np.int32),
             "weight": rng.normal(size=(3, 2)).astype(np.float32)}
            for _ in range(n)]


def _read_all(reader_fn, path):
    with reader_fn(path) as reader:
        return [bytes(p) for p in reader.read_range(0, len(reader))]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_record_files_are_byte_identical_both_ways(tmp_path, writer):
    payloads = _payloads()
    port_path, jax_path = str(tmp_path / "p.rec"), str(tmp_path / "j.rec")
    port_recordio.write_records(port_path, payloads)
    jax_recordio.write_records(jax_path, payloads)
    with open(port_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    path = port_path if writer == "port" else jax_path
    assert port_recordio.count_records(path) == len(payloads)
    for reader in (port_recordio.RecordReader, jax_recordio.RecordReader,
                   lambda p: port_recordio.RecordReader(p, prefer_mmap=False)):
        assert _read_all(reader, path) == payloads
    with port_recordio.RecordReader(path) as reader:
        assert reader.read(5) == payloads[5]
        assert [bytes(p) for p in reader.read_range(30, 99)] == payloads[30:]
        assert list(reader.read_range(4, 4)) == []


def test_reader_rejects_a_foreign_file(tmp_path):
    path = str(tmp_path / "garbage.rec")
    with open(path, "wb") as f:
        f.write(b"not a record file at all, long enough for a trailer")
    with pytest.raises(ValueError):
        port_recordio.RecordReader(path)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_examples_cross_packages_byte_for_byte(direction):
    for ex in _examples(3):
        port_bytes = port_example.encode_example(ex)
        jax_bytes = jax_example.encode_example(ex)
        assert port_bytes == jax_bytes
        decode = (jax_example.decode_example if direction == "port_to_jax"
                  else port_example.decode_example)
        back = decode(port_bytes if direction == "port_to_jax"
                      else jax_bytes)
        assert set(back) == set(ex)
        for key in ex:
            np.testing.assert_array_equal(back[key], ex[key])
            assert back[key].dtype == ex[key].dtype


def test_recordio_reader_shards_and_tasks_match_jax(tmp_path):
    for i in range(2):
        port_recordio.write_records(
            str(tmp_path / ("f%d.rec" % i)), _payloads(30 + i, seed=i))
    port = port_readers.create_data_reader(str(tmp_path))
    jax = jax_readers.create_data_reader(str(tmp_path))
    assert isinstance(port, port_readers.RecordIODataReader)
    assert port.create_shards() == jax.create_shards()
    for name in sorted(port.create_shards()):
        got = [bytes(r) for r in port.read_records(
            port_pb.Task(task_id=1, shard_name=name, start=10, end=20))]
        want = [bytes(r) for r in jax.read_records(
            jax_pb.Task(task_id=1, shard_name=name, start=10, end=20))]
        assert got == want and len(got) == 10


def test_reader_factory_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """A ``.csv`` origin (a file, or a directory holding one) dispatches
    to the CSV reader, as the JAX factory's does; a table origin goes to
    the table reader on both (data/table_reader.py; without credentials
    an ``odps://`` origin raises ValueError on both); an empty directory
    raises as the JAX RecordIO reader does."""
    csv_dir = tmp_path / "csv"
    csv_dir.mkdir()
    (csv_dir / "x.csv").write_text("a\n1\n")
    for origin in (str(csv_dir / "x.csv"), str(csv_dir)):
        reader = port_readers.create_data_reader(origin)
        assert isinstance(reader, port_readers.CSVDataReader)
        assert isinstance(jax_readers.create_data_reader(origin),
                          jax_readers.CSVDataReader)
        assert reader.create_shards() == {str(csv_dir / "x.csv"): (0, 1)}
    for var in ("MAXCOMPUTE_AK", "MAXCOMPUTE_SK"):
        monkeypatch.delenv(var, raising=False)
    for readers in (port_readers, jax_readers):
        with pytest.raises(ValueError, match="requires credentials"):
            readers.create_data_reader("odps://project/table")
    from elasticdl_tpu_torch.data.table_reader import TableDataReader
    assert isinstance(
        port_readers.create_data_reader("t", table_client=object()),
        TableDataReader)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for readers in (port_readers, jax_readers):
        with pytest.raises(ValueError):
            readers.create_data_reader(empty).create_shards()


def _batches(pipeline, examples, **kwargs):
    return list(pipeline.Dataset.from_list(examples).batch(4, **kwargs))


@pytest.mark.parametrize("kwargs", [{}, {"drop_remainder": True},
                                    {"pad_remainder": False}])
def test_batches_and_masks_match_jax(kwargs):
    examples = [(e["tokens"], e["tokens"]) for e in _examples(10)]
    port = _batches(port_pipeline, examples, **kwargs)
    jax = _batches(jax_pipeline, examples, **kwargs)
    assert len(port) == len(jax)
    for p, j in zip(port, jax):
        assert set(p) == set(j) == {"features", "labels", "_mask"}
        for key in p:
            np.testing.assert_array_equal(p[key], j[key])
        assert port_pipeline.batch_real_count(p) == \
            jax_pipeline.batch_real_count(j)
    if not kwargs:
        assert port[-1]["_mask"].tolist() == [1.0, 1.0, 0.0, 0.0]


def test_dict_examples_and_normalize_outputs_match_jax():
    examples = _examples(6)
    port = _batches(port_pipeline, examples)
    jax = _batches(jax_pipeline, examples)
    for p, j in zip(port, jax):
        for key in j:
            np.testing.assert_array_equal(p[key], j[key])
        real = port_pipeline.batch_real_count(p)
        for outputs in (p["weight"], {"a": p["weight"], "b": p["tokens"]}):
            got = port_pipeline.normalize_outputs(outputs, real)
            want = jax_pipeline.normalize_outputs(outputs, real)
            assert set(got) == set(want)
            for key in got:
                np.testing.assert_array_equal(got[key], want[key])


def _flush_source(flush):
    def source():
        yield from range(5)
        yield flush
        yield from range(5, 11)
        yield flush
        yield flush  # consecutive flush with an empty buffer: a no-op

    return source


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_flush_matches_jax(drop_remainder):
    """FLUSH passes through map/filter/take, drains shuffle and makes
    batch() emit (or, under drop_remainder, clear) its partial batch,
    the same way in both packages."""
    results = []
    for pipeline in (port_pipeline, jax_pipeline):
        dataset = (
            pipeline.Dataset(_flush_source(pipeline.FLUSH))
            .map(lambda x: x * 2)
            .filter(lambda x: x != 4)
            .take(100)
            .shuffle(buffer_size=2, seed=0)
            .batch(4, drop_remainder=drop_remainder)
        )
        results.append(list(dataset))
    port, jax = results
    assert [port_pipeline.batch_real_count(b) for b in port] == [
        jax_pipeline.batch_real_count(b) for b in jax]
    for p, j in zip(port, jax):
        np.testing.assert_array_equal(p["features"], j["features"])
        np.testing.assert_array_equal(p["_mask"], j["_mask"])


def test_shuffle_and_prefetch_match_jax():
    runs = []
    for pipeline in (port_pipeline, jax_pipeline):
        ds = (pipeline.Dataset.from_list(list(range(100)))
              .shuffle(buffer_size=16, seed=3).map(lambda x: x * 2)
              .prefetch(2))
        runs.append((list(ds), list(ds)))
    (port_a, port_b), (jax_a, _) = runs
    assert port_a == port_b == jax_a  # re-iterable, same seed, same order

    def broken():
        yield 1
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        list(port_pipeline.Dataset(broken).prefetch(2))


def test_zoo_dataset_fn_parses_like_jax(tmp_path):
    """The zoo TransformerLM's dataset_fn over a record file the JAX
    package wrote: the same (tokens, tokens) examples."""
    from elasticdl_tpu.models import transformer as jax_zoo
    from elasticdl_tpu_torch.models import transformer as port_zoo

    payloads = [jax_example.encode_example({"tokens": e["tokens"]})
                for e in _examples(5)]
    path = str(tmp_path / "tokens.rec")
    jax_recordio.write_records(path, payloads)
    with port_recordio.RecordReader(path) as reader:
        records = list(reader.read_range(0, len(reader)))
        port = list(port_zoo.dataset_fn(
            port_pipeline.Dataset.from_list(records)))
    jax = list(jax_zoo.dataset_fn(jax_pipeline.Dataset.from_list(payloads)))
    assert len(port) == len(jax) == 5
    for (pf, pl), (jf, jl) in zip(port, jax):
        assert pf.dtype == np.int32
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(pl, jl)
    assert os.path.getsize(path) > 0
