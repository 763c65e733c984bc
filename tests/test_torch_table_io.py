"""The port's table I/O against the JAX package's: the table reader's
shards, records, columns and parallel order on the same rows, the
factory's table routing and its errors, the gated SDK import, the
writer's round trip and error surface, per-worker prediction
partitions (tests/test_table_reader.py's ten scenarios, each run on
both packages), then an in-process iris job over a table client on the
CPU and a prediction-only job landing its rows in an
``InMemoryWritableTable``.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from elasticdl_tpu.data import readers as jax_readers
from elasticdl_tpu.data import table_reader as jax_tr
from elasticdl_tpu.data import table_writer as jax_tw
from elasticdl_tpu.data.pipeline import Dataset as JaxDataset
from elasticdl_tpu_torch.common.constants import JobType, Mode
from elasticdl_tpu_torch.common.grpc_utils import find_free_port
from elasticdl_tpu_torch.data import readers as port_readers
from elasticdl_tpu_torch.data import recordio
from elasticdl_tpu_torch.data import table_reader as port_tr
from elasticdl_tpu_torch.data import table_writer as port_tw
from elasticdl_tpu_torch.data.pipeline import Dataset, batch_real_count
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.models import iris_dnn
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.worker import master_client
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.worker import Worker

torch.set_num_threads(1)

PACKAGES = {"port": (port_tr, port_tw, port_readers),
            "jax": (jax_tr, jax_tw, jax_readers)}
COLUMNS = ["sepal_l", "sepal_w", "petal_l", "petal_w", "class"]


class _Task:
    def __init__(self, shard_name, start, end):
        self.shard_name = shard_name
        self.start = start
        self.end = end


def _rows(n=130):
    rng = np.random.RandomState(0)
    return [(float(rng.rand()), float(rng.rand()), float(rng.rand()),
             float(rng.rand()), int(rng.randint(0, 3))) for _ in range(n)]


def _both(fn):
    """``fn(tr, tw, readers)`` on each package; the two results."""
    return [fn(*PACKAGES[name]) for name in ("port", "jax")]


def test_fixed_range_shards_with_remainder():
    rows = _rows(130)
    port, ref = _both(lambda tr, tw, rd: tr.TableDataReader(
        table_client=tr.InMemoryTableClient(rows, COLUMNS), table="iris",
        records_per_task=50).create_shards())
    assert port == ref == {"iris:shard_0": (0, 50), "iris:shard_1": (50, 50),
                           "iris:shard_2": (100, 30)}


def test_read_records_range_and_columns():
    rows = _rows(20)

    def read(tr, tw, rd):
        reader = tr.TableDataReader(
            table_client=tr.InMemoryTableClient(rows, COLUMNS), table="iris",
            records_per_task=8, columns=["petal_l", "class"])
        return (list(reader.read_records(_Task("iris:shard_1", 8, 16))),
                reader.metadata.column_names)

    port, ref = _both(read)
    assert port == ref
    assert port[0] == [(r[2], r[4]) for r in rows[8:16]]
    assert port[1] == ["petal_l", "class"]


@pytest.mark.parametrize("num_parallel,page_size", [(4, 7), (1, 101),
                                                    (3, 1)])
def test_parallel_reader_preserves_order(num_parallel, page_size):
    rows = _rows(101)
    port, ref = _both(lambda tr, tw, rd: list(tr.ParallelTableDataReader(
        table_client=tr.InMemoryTableClient(rows, COLUMNS), table="iris",
        records_per_task=101, num_parallel=num_parallel,
        page_size=page_size).read_records(_Task("iris:shard_0", 0, 101))))
    assert port == ref == [tuple(r) for r in rows]


def test_parallel_reader_raises_a_failed_fetch():
    """A page read that raises surfaces in the consumer, on both."""

    def read(tr, tw, rd):
        client = tr.InMemoryTableClient(_rows(40), COLUMNS)
        original = client.read_rows

        def failing(start, end, columns=None):
            if start >= 20:
                raise IOError("tunnel down at %d" % start)
            return original(start, end, columns)

        client.read_rows = failing
        reader = tr.ParallelTableDataReader(
            table_client=client, table="iris", num_parallel=2, page_size=10)
        with pytest.raises(IOError, match="tunnel down"):
            list(reader.read_records(_Task("iris:shard_0", 0, 40)))
        return True

    assert _both(read) == [True, True]


def test_parallel_reader_stops_fetching_when_abandoned():
    """An abandoned generator (a worker stopped mid-task) reads no more
    pages from the table."""
    client = port_tr.InMemoryTableClient(_rows(1000), COLUMNS)
    calls = []
    original = client.read_rows

    def counting_read_rows(start, end, columns=None):
        calls.append((start, end))
        time.sleep(0.005)
        return original(start, end, columns)

    client.read_rows = counting_read_rows
    reader = port_tr.ParallelTableDataReader(
        table_client=client, table="iris", records_per_task=1000,
        num_parallel=2, page_size=10)  # 100 pages
    stream = reader.read_records(_Task("iris:shard_0", 0, 1000))
    next(stream)
    stream.close()
    time.sleep(0.2)
    fetched = len(calls)
    time.sleep(0.3)
    assert len(calls) == fetched, "fetches continued after abandonment"
    assert fetched < 100


def test_default_dataset_fn_last_column_is_label():
    rows = _rows(10)
    outs = []
    for (tr, _, _), dataset_cls in ((PACKAGES["port"], Dataset),
                                    (PACKAGES["jax"], JaxDataset)):
        reader = tr.TableDataReader(
            table_client=tr.InMemoryTableClient(rows, COLUMNS), table="iris")
        dataset = reader.default_dataset_fn()(
            dataset_cls(lambda r=reader: r.read_records(
                _Task("iris:shard_0", 0, 10))), None, reader.metadata)
        outs.append(list(dataset))
    port, ref = outs
    assert len(port) == len(ref) == 10
    for (pf, pl), (jf, jl) in zip(port, ref):
        assert set(pf) == set(jf) == set(COLUMNS[:-1])
        for name in pf:
            assert pf[name].dtype == np.float32
            np.testing.assert_array_equal(pf[name], jf[name])
        assert pl == jl and pl.dtype == np.float32
    assert float(port[0][1]) == float(rows[0][4])


def test_factory_routes_table_client():
    rows = _rows(10)

    def route(tr, tw, rd):
        reader = rd.create_data_reader(
            "odps://proj/iris", records_per_task=5,
            table_client=tr.InMemoryTableClient(rows, COLUMNS))
        assert isinstance(reader, tr.TableDataReader)
        assert not isinstance(reader, tr.ParallelTableDataReader)
        return reader.create_shards(), reader._kwargs

    port, ref = _both(route)
    assert port == ref
    assert port[0] == {"iris:shard_0": (0, 5), "iris:shard_1": (5, 5)}
    assert port[1] == {"project": "proj"}


@pytest.mark.parametrize("origin,table,extra", [
    ("odps://proj/iris/pt=1/region=x", "iris",
     {"project": "proj", "partition": "pt=1,region=x"}),
    ("odps://proj/iris/pt=1", "iris", {"project": "proj",
                                       "partition": "pt=1"}),
    ("not_a_path_here", "not_a_path_here", {}),
    ("", "table", {}),
])
def test_factory_parses_table_origins(origin, table, extra):
    """A ``table_client`` routes any origin to the table reader: an
    ``odps://`` origin's project, table and partition segments are
    parsed the same on both; ``parallel=True`` takes the parallel
    reader."""
    rows = _rows(12)

    def route(tr, tw, rd):
        reader = rd.create_data_reader(
            origin, records_per_task=4, parallel=True,
            table_client=tr.InMemoryTableClient(rows, COLUMNS))
        assert isinstance(reader, tr.ParallelTableDataReader)
        return reader._table, reader._kwargs, reader.create_shards()

    port, ref = _both(route)
    assert port == ref
    assert port[0] == table and port[1] == extra
    assert len(port[2]) == 3


def _clear_maxcompute(monkeypatch):
    for var in ("MAXCOMPUTE_PROJECT", "MAXCOMPUTE_AK", "MAXCOMPUTE_SK",
                "MAXCOMPUTE_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)


def test_factory_table_errors(monkeypatch):
    """An odps:// origin without a table name, and one without
    credentials (the origin gives the project), raise ValueError naming
    what is missing, on both."""
    _clear_maxcompute(monkeypatch)
    for _, _, rd in PACKAGES.values():
        with pytest.raises(ValueError, match="odps://<project>/<table>"):
            rd.create_data_reader("odps://proj", table_client=object())
        with pytest.raises(ValueError,
                           match="set MAXCOMPUTE_AK, MAXCOMPUTE_SK"):
            rd.create_data_reader("odps://proj_x/iris")


@pytest.mark.parametrize("endpoint", ["", "http://service.example:80/api"])
def test_factory_routes_maxcompute_environment(monkeypatch, tmp_path,
                                               endpoint):
    """With MAXCOMPUTE_PROJECT, _AK and _SK set, a path that does not
    exist goes to the table reader, which builds the ODPS client from
    the environment (a recording double stands in for the SDK); an
    existing path keeps its reader; with no endpoint both warn."""
    _clear_maxcompute(monkeypatch)
    monkeypatch.setenv("MAXCOMPUTE_PROJECT", "envproj")
    monkeypatch.setenv("MAXCOMPUTE_AK", "ak")
    monkeypatch.setenv("MAXCOMPUTE_SK", "sk")
    if endpoint:
        monkeypatch.setenv("MAXCOMPUTE_ENDPOINT", endpoint)
    rows = _rows(9)
    made, warned = {}, {}
    for name, (tr, _, rd) in PACKAGES.items():
        def client(table, name=name, tr=tr, **kwargs):
            made[name] = dict(kwargs, table=table)
            return tr.InMemoryTableClient(rows, COLUMNS)

        monkeypatch.setattr(tr, "ODPSTableClient", client)
        monkeypatch.setattr(rd.logger, "warning",
                            lambda *a, name=name: warned.setdefault(name, a))
        reader = rd.create_data_reader("iris_table", records_per_task=4)
        assert isinstance(reader, tr.TableDataReader)
        assert reader.create_shards() == {"iris_table:shard_0": (0, 4),
                                          "iris_table:shard_1": (4, 4),
                                          "iris_table:shard_2": (8, 1)}
        csv_path = str(tmp_path / ("%s.csv" % name))
        with open(csv_path, "w") as f:
            f.write("a\n1\n")
        assert isinstance(rd.create_data_reader(csv_path), rd.CSVDataReader)
    assert made["port"] == made["jax"] == {
        "project": "envproj", "access_id": "ak", "access_key": "sk",
        "endpoint": endpoint or None, "table": "iris_table"}
    assert set(warned) == (set() if endpoint else {"port", "jax"})


def test_factory_dispatch(tmp_path, monkeypatch):
    """tests/test_data_layer.py::test_factory_dispatch with the table
    cases: CSV, RecordIO, and the table reader for a table client, on
    both packages; without the MAXCOMPUTE_* environment a path that does
    not exist stays a RecordIO origin."""
    _clear_maxcompute(monkeypatch)
    csv_path = str(tmp_path / "x.csv")
    with open(csv_path, "w") as f:
        f.write("a\n1\n")
    rec_dir = tmp_path / "recs"
    rec_dir.mkdir()
    recordio.write_records(str(rec_dir / "f.rec"), [b"z"])
    for tr, _, rd in PACKAGES.values():
        assert isinstance(rd.create_data_reader(csv_path), rd.CSVDataReader)
        assert isinstance(rd.create_data_reader(str(rec_dir)),
                          rd.RecordIODataReader)
        assert isinstance(rd.create_data_reader(
            str(rec_dir), table_client=tr.InMemoryTableClient([], ["a"])),
            tr.TableDataReader)
        assert isinstance(rd.create_data_reader(str(tmp_path / "missing")),
                          rd.RecordIODataReader)


def test_odps_sdk_gated_import():
    """Without the SDK, building either ODPS adapter raises an
    ImportError naming it, on both packages (the SDK is installed on
    neither machine this suite runs on)."""
    try:
        import odps  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("the odps SDK is installed")
    for tr, tw, _ in PACKAGES.values():
        with pytest.raises(ImportError, match="odps"):
            tr.ODPSTableClient("p", "ak", "sk", "t")
        with pytest.raises(ImportError, match="odps"):
            tw.ODPSWritableTable("p", "ak", "sk", "t")
        with pytest.raises(ImportError, match="odps"):
            tr.TableDataReader(table="t", project="p", access_id="ak",
                               access_key="sk")


@pytest.mark.parametrize("buffer_rows,num_parallel", [(16, 3), (1, 1),
                                                      (4096, 2)])
def test_table_writer_round_trip_through_reader(buffer_rows, num_parallel):
    """Rows written through parallel writers, in uneven batches, read
    back through the parallel range reader: all there, order kept
    after sorting by row id, on both packages."""
    rows = [(float(i) / 100.0, i) for i in range(1000)]

    def round_trip(tr, tw, rd):
        sink = tw.InMemoryWritableTable(column_names=["pred", "row_id"])
        writer = tw.TableWriter(sink, worker_index=3, buffer_rows=buffer_rows,
                                num_parallel=num_parallel)
        for start in range(0, 1000, 37):
            writer.write(rows[start:start + 37])
        writer.close()
        written = sink.rows("worker=3")
        assert len(written) == 1000 and list(sink.partitions) == ["worker=3"]
        reader = tr.ParallelTableDataReader(
            table_client=tr.InMemoryTableClient(
                sorted(written, key=lambda r: r[1]), ["pred", "row_id"]),
            table="preds", records_per_task=128, num_parallel=2,
            page_size=50)
        got = []
        for _, (start, count) in sorted(reader.create_shards().items()):
            got.extend(reader.read_records(
                _Task("preds", start, start + count)))
        return got

    port, ref = _both(round_trip)
    assert port == ref == rows


def test_table_writer_dict_outputs_and_error_surface():
    def run(tr, tw, rd):
        sink = tw.InMemoryWritableTable()
        writer = tw.TableWriter(sink, worker_index=0, buffer_rows=4)
        writer.write({"output": np.array([0.1, 0.2]),
                      "id": np.array([7, 8])})
        writer.close()
        assert sink.rows("worker=0") == [(0.1, 7), (0.2, 8)]
        # a closed writer refuses more rows
        with pytest.raises(RuntimeError, match="closed"):
            writer.write([(1,)])

        class Failing(tw.WritableTable):
            def write_rows(self, rows, partition=None):
                raise IOError("tunnel down")

        bad = tw.TableWriter(Failing(), buffer_rows=1)
        bad.write([(1,)])
        with pytest.raises(RuntimeError, match="table write failed"):
            bad.close()
        # the next write after a failure surfaces it too
        later = tw.TableWriter(Failing(), buffer_rows=1, num_parallel=1)
        later.write([(1,)])
        for _ in range(200):
            if later._errors:
                break
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="table write failed"):
            later.write([(2,)])
        return True

    assert _both(run) == [True, True]


def test_prediction_processor_writes_per_worker_partitions():
    def run(tr, tw, rd):
        sink = tw.InMemoryWritableTable()

        class Processor(tw.TablePredictionOutputsProcessor):
            pass

        Processor.sink = sink
        processor = Processor()
        processor.process({"output": np.array([1.0, 2.0])}, worker_id=0)
        processor.process({"output": np.array([9.0])}, worker_id=4)
        processor.close()
        with pytest.raises(ValueError, match="needs a sink"):
            tw.TablePredictionOutputsProcessor().process(
                {"output": np.array([1.0])}, worker_id=0)
        return sink.partitions

    port, ref = _both(run)
    assert port == ref == {"worker=0": [(1.0,), (2.0,)],
                           "worker=4": [(9.0,)]}


# ---------------------------------------------------------------------------
# Jobs over a table
# ---------------------------------------------------------------------------

IRIS_ROWS = 240
PER_TASK = 16
BATCH = 16
EPOCHS = 10
STEPS = IRIS_ROWS * EPOCHS // BATCH


@pytest.fixture(autouse=True)
def _short_master_retry(monkeypatch):
    monkeypatch.setattr(master_client, "MASTER_RETRY_BUDGET_SECS", 5.0)


def _job(zoo, rows, mode, data_key, **worker_kwargs):
    """A port master and one in-process worker over an
    ``InMemoryTableClient`` of ``rows`` (the master's table client comes
    through ``data_reader_params``, as the reference's does); returns
    (master, worker, done tasks in completion order)."""
    client = port_tr.InMemoryTableClient(rows, COLUMNS)
    port = find_free_port()
    master = Master(zoo, records_per_task=PER_TASK, port=port,
                    num_epochs=EPOCHS if mode == Mode.TRAINING else 1,
                    task_timeout_secs=60.0,
                    data_reader_params={"table_client": client},
                    **{data_key: "odps://proj/iris"})
    done = []
    master.task_dispatcher.add_task_completed_callback(
        lambda t: done.append((t.type, t.shard_name, t.start, t.end)))
    master.prepare()
    try:
        reader = port_readers.create_data_reader(
            "odps://proj/iris", table_client=client)
        worker = Worker(MasterClient("localhost:%d" % port, worker_id=0),
                        zoo, reader, minibatch_size=BATCH, mode=mode,
                        wait_sleep_secs=0.1, device="cpu", **worker_kwargs)
        worker.run()
        assert master.task_dispatcher.finished()
    finally:
        master.stop()
    return master, worker, done


def test_iris_job_over_a_table_then_predictions_into_a_table(tmp_path):
    """Training: every row trained once an epoch by the dispatcher's
    books, accuracy above 0.85 on other rows. Then a prediction-only
    job over the validation table: its rows land in the processor's
    ``InMemoryWritableTable`` partition ``worker=0`` before each task is
    reported done, and read back through ``TableDataReader`` equal the
    trained state's ``eval_step`` over the same rows, bit for bit."""
    ckpt_dir = str(tmp_path / "ckpt")
    train_rows = chip_smoke.iris_records(np, IRIS_ROWS, seed=0)
    master, worker, done = _job(
        "elasticdl_tpu_torch.models.iris_dnn", train_rows, Mode.TRAINING,
        "training_data", checkpoint_dir=ckpt_dir, checkpoint_steps=STEPS)
    assert master.job_type == JobType.TRAINING_ONLY
    trained = [d for d in done if d[0] == pb.TRAINING]
    per_epoch = IRIS_ROWS // PER_TASK
    assert len(trained) == per_epoch * EPOCHS
    covered = sorted((start, end) for _, _, start, end in trained)
    assert covered == sorted((lo, lo + PER_TASK)
                             for lo in range(0, IRIS_ROWS, PER_TASK)
                             for _ in range(EPOCHS))
    assert {name for _, name, _, _ in trained} == {"iris:shard_0"}
    assert worker.model_version == STEPS
    valid_rows = chip_smoke.iris_records(np, IRIS_ROWS, seed=1)
    x = np.asarray([r[:4] for r in valid_rows], np.float32)
    labels = np.asarray([r[4] for r in valid_rows])
    logits = worker.trainer.eval_step(worker.state, {"features": x})
    assert float((logits.argmax(-1) == labels).mean()) > 0.85

    sink = port_tw.InMemoryWritableTable(column_names=["output"])
    chip_smoke.table_zoo(sink)
    master, scorer, done = _job(
        chip_smoke.TABLE_ZOO, valid_rows, Mode.PREDICTION, "prediction_data",
        checkpoint_dir_for_init=ckpt_dir)
    assert master.job_type == JobType.PREDICTION_ONLY
    assert int(scorer.state.step) == STEPS
    assert [d[0] for d in done] == [pb.PREDICTION] * (IRIS_ROWS // PER_TASK)
    assert list(sink.partitions) == ["worker=0"]
    written = sink.rows("worker=0")
    assert len(written) == IRIS_ROWS
    back = port_tr.TableDataReader(
        table_client=port_tr.InMemoryTableClient(written, ["output"]),
        table="predictions", records_per_task=IRIS_ROWS)
    (name, (start, count)), = back.create_shards().items()
    read = np.asarray([row[0] for row in back.read_records(
        _Task(name, start, start + count))], np.float32)
    # the trained state's forward over the same rows, task by task in
    # the order the tasks were done, in the worker's batches
    reader = port_tr.TableDataReader(
        table_client=port_tr.InMemoryTableClient(valid_rows, COLUMNS),
        table="iris")
    want = []
    for _, shard, lo, hi in done:
        batches = iris_dnn.dataset_fn(Dataset(
            lambda lo=lo, hi=hi: reader.read_records(_Task(shard, lo, hi))),
            Mode.PREDICTION).batch(BATCH)
        for batch in batches:
            out = worker.trainer.eval_step(worker.state, batch)
            want.append(np.asarray(out)[:batch_real_count(batch)])
    want = np.concatenate(want)
    assert read.shape == want.shape == (IRIS_ROWS, 3)
    np.testing.assert_array_equal(read, want)
