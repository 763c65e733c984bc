"""The port's TensorBoard event writer (master/tensorboard_service.py)
against the reference's, on the CPU: the CRC32C vectors, ``encode_event``
byte-equal to the reference's, the TFRecord framing, files that
``tensorboard``'s own loader reads, the port's reader (``read_events``,
CRC checked) over both packages' files, and the evaluation service
feeding the event file.
"""

import glob
import struct

import numpy as np
import pytest

from elasticdl_tpu.master import tensorboard_service as ref_tb
from elasticdl_tpu_torch.master import tensorboard_service as port_tb

SIDES = {"ref": ref_tb, "port": port_tb}


def _tensorboard_events(path):
    from tensorboard.backend.event_processing.event_file_loader import (
        RawEventFileLoader,
    )
    from tensorboard.compat.proto.event_pb2 import Event

    return [Event.FromString(raw) for raw in RawEventFileLoader(path).Load()]


def test_crc32c_known_vectors():
    assert port_tb._crc32c(b"") == 0x00000000
    assert port_tb._crc32c(b"123456789") == 0xE3069283
    assert port_tb._crc32c(b"\x00" * 32) == 0x8A9136AA
    rng = np.random.RandomState(0)
    for n in (1, 7, 64, 1000):
        data = rng.bytes(n)
        assert port_tb._crc32c(data) == ref_tb._crc32c(data)
        assert port_tb._masked_crc(data) == ref_tb._masked_crc(data)


@pytest.mark.parametrize("kwargs", [
    dict(wall_time=1.5, file_version="brain.Event:2"),
    dict(wall_time=1234567.25, step=5, scalars={"auc": 0.9,
                                                "accuracy": 0.75}),
    dict(wall_time=0.0, step=0, scalars={"loss": -2.5}),
    dict(wall_time=7.0, step=2 ** 40, scalars={"a/b": 1e-30, "z": 3e38}),
    dict(wall_time=9.0, step=-3),
])
def test_encode_event_byte_equal(kwargs):
    assert port_tb.encode_event(**kwargs) == ref_tb.encode_event(**kwargs)
    decoded = port_tb.decode_event(port_tb.encode_event(**kwargs))
    assert decoded["wall_time"] == kwargs["wall_time"]
    assert decoded["step"] == kwargs.get("step")
    assert decoded["file_version"] == kwargs.get("file_version")
    for tag, value in (kwargs.get("scalars") or {}).items():
        assert decoded["scalars"][tag] == np.float32(value)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_event_roundtrip_via_tensorboard_reader(side, tmp_path):
    tb = SIDES[side].TensorboardService(str(tmp_path))
    tb.write_eval_summary(5, {"accuracy": 0.75, "auc": 0.9})
    tb.write_eval_summary(10, {"accuracy": 0.875, "note": "skipme"})
    tb.stop()
    files = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    assert len(files) == 1
    events = _tensorboard_events(files[0])
    assert events[0].file_version == "brain.Event:2"
    scalars = {(e.step, v.tag): v.simple_value
               for e in events[1:] for v in e.summary.value}
    assert np.isclose(scalars[(5, "accuracy")], 0.75)
    assert np.isclose(scalars[(5, "auc")], 0.9)
    assert np.isclose(scalars[(10, "accuracy")], 0.875)
    assert (10, "note") not in scalars
    # the port's own reader agrees with tensorboard's on either file
    ours = port_tb.read_events(files[0])
    assert [e["step"] for e in ours] == [None, 5, 10]
    assert ours[1]["scalars"] == {
        v.tag: v.simple_value for v in events[1].summary.value}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_tfrecord_framing(side, tmp_path):
    writer = SIDES[side].EventFileWriter(str(tmp_path))
    writer.add_scalars(1, {"loss": 2.5})
    writer.close()
    with open(writer.path, "rb") as f:
        blob = f.read()
    offset = 0
    records = []
    while offset < len(blob):
        (length,) = struct.unpack_from("<Q", blob, offset)
        (len_crc,) = struct.unpack_from("<I", blob, offset + 8)
        assert len_crc == port_tb._masked_crc(blob[offset:offset + 8])
        record = blob[offset + 12:offset + 12 + length]
        (data_crc,) = struct.unpack_from("<I", blob, offset + 12 + length)
        assert data_crc == port_tb._masked_crc(record)
        records.append(record)
        offset += 12 + length + 4
    assert len(records) == 2
    assert len(port_tb.read_events(writer.path)) == 2


def test_files_byte_equal_at_the_same_clock(tmp_path, monkeypatch):
    """With the clock and host name pinned, both packages write the same
    file, name and bytes."""
    made = {}
    for side, module in SIDES.items():
        monkeypatch.setattr(module.time, "time", lambda: 1700000000.5)
        monkeypatch.setattr(module.socket, "gethostname", lambda: "h")
        tb = module.TensorboardService(str(tmp_path / side))
        for step in (3, 7, 11):
            tb.write_eval_summary(step, {"auc": step / 16.0,
                                         "logloss": 1.0 / step})
        tb.stop()
        (path,) = glob.glob(str(tmp_path / side / "events.out.tfevents.*"))
        with open(path, "rb") as f:
            made[side] = (path.rsplit("/", 1)[1], f.read())
    assert made["port"] == made["ref"]


def test_reader_rejects_a_corrupt_record(tmp_path):
    writer = port_tb.EventFileWriter(str(tmp_path))
    writer.add_scalars(4, {"loss": 1.0})
    writer.close()
    with open(writer.path, "rb") as f:
        blob = bytearray(f.read())
    blob[-6] ^= 0x01
    with open(writer.path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        port_tb.read_events(writer.path)
    with open(writer.path, "wb") as f:
        f.write(bytes(blob[:-3]))
    with pytest.raises(ValueError, match="torn"):
        port_tb.read_events(writer.path)


def test_evaluation_service_feeds_tensorboard(tmp_path):
    from elasticdl_tpu_torch.common.tensor_utils import ndarray_to_blob
    from elasticdl_tpu_torch.master.evaluation_service import (
        EvaluationService,
    )
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.train.metrics import Accuracy

    tb = port_tb.TensorboardService(str(tmp_path))
    dispatcher = TaskDispatcher(training_shards={"t": (0, 4)},
                                evaluation_shards={"e": (0, 4)},
                                records_per_task=2, num_epochs=1)
    service = EvaluationService(dispatcher, lambda: {"accuracy": Accuracy()},
                                eval_steps=10, summary_writer=tb)
    assert service.add_evaluation_task_if_needed(10)
    outputs = {"output": ndarray_to_blob(np.eye(2)[[0, 1]])}
    labels = ndarray_to_blob(np.array([0, 1]))
    while True:
        task = dispatcher.get(0)
        if task is None:
            break
        if task.type == pb.EVALUATION:
            service.report_evaluation_metrics(outputs, labels)
        dispatcher.report(task.task_id, True)
    tb.stop()
    tagged = {(e.step, v.tag): v.simple_value
              for e in _tensorboard_events(tb.event_file)
              for v in e.summary.value}
    assert np.isclose(tagged[(10, "accuracy")], 1.0)
    ours = port_tb.read_events(tb.event_file)
    assert ours[-1]["step"] == 10
    assert ours[-1]["scalars"]["accuracy"] == 1.0
