"""TensorBoard summaries from the master, with no TF dependency.

(Copy of elasticdl_tpu/master/tensorboard_service.py for the PyTorch port.)

Reference parity: TensorboardService (elasticdl/python/master/
tensorboard_service.py:21-63) — the master writes one scalar summary
per completed evaluation (keyed by model version) and optionally spawns
a ``tensorboard`` process pointed at the log dir.

The reference leans on ``tf.summary``; importing TensorFlow into the
master just to frame protobuf records is dead weight, so the
event-file format is implemented directly: TFRecord framing (length +
masked CRC32C) around hand-encoded ``Event`` protos (the three fields
TensorBoard's scalar dashboard reads: wall_time, step, and
``Summary.Value{tag, simple_value}``). Files written here load in stock
TensorBoard — tests round-trip them through tensorboard's own reader.
"""

import os
import socket
import struct
import subprocess
import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.common.log_utils import default_logger as _logger_factory

logger = _logger_factory("elasticdl_tpu_torch.master.tensorboard_service")


# ---------------------------------------------------------------- crc32c
def _make_crc32c_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _make_crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- proto encoding
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field(number: int, wire_type: int) -> bytes:
    return _varint((number << 3) | wire_type)


def _len_delimited(number: int, payload: bytes) -> bytes:
    return _field(number, 2) + _varint(len(payload)) + payload


def _encode_summary_value(tag: str, value: float) -> bytes:
    # Summary.Value: tag = field 1 (string), simple_value = field 2 (float)
    payload = _len_delimited(1, tag.encode("utf-8")) + _field(
        2, 5
    ) + struct.pack("<f", float(value))
    return payload


def encode_event(wall_time, step=None, file_version=None, scalars=None):
    """Event proto: wall_time=1 (double), step=2 (int64),
    file_version=3 (string), summary=5 (Summary{repeated Value=1})."""
    out = _field(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _field(2, 0) + _varint(int(step) & (2**64 - 1))
    if file_version is not None:
        out += _len_delimited(3, file_version.encode("utf-8"))
    if scalars:
        summary = b"".join(
            _len_delimited(1, _encode_summary_value(tag, value))
            for tag, value in sorted(scalars.items())
        )
        out += _len_delimited(5, summary)
    return out


def _read_varint(data, pos):
    shift = result = 0
    while True:
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _fields(data):
    """Yield (field number, wire type, value) of one encoded message:
    ints for varints, bytes for length-delimited and fixed fields."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire_type = key >> 3, key & 7
        if wire_type == 0:
            value, pos = _read_varint(data, pos)
        elif wire_type == 1:
            value, pos = data[pos:pos + 8], pos + 8
        elif wire_type == 2:
            size, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + size], pos + size
        elif wire_type == 5:
            value, pos = data[pos:pos + 4], pos + 4
        else:
            raise ValueError("unsupported wire type %d" % wire_type)
        yield number, wire_type, value


def decode_event(record: bytes):
    """The inverse of ``encode_event``: {"wall_time", "step",
    "file_version", "scalars": {tag: value}} of one Event proto."""
    event = {"wall_time": None, "step": None, "file_version": None,
             "scalars": {}}
    for number, _wire, value in _fields(record):
        if number == 1:
            event["wall_time"] = struct.unpack("<d", value)[0]
        elif number == 2:
            event["step"] = value - (1 << 64) if value >= 1 << 63 else value
        elif number == 3:
            event["file_version"] = value.decode("utf-8")
        elif number == 5:
            for vnum, _w, summary_value in _fields(value):
                if vnum != 1:
                    continue
                tag, simple = None, None
                for fnum, _w2, field in _fields(summary_value):
                    if fnum == 1:
                        tag = field.decode("utf-8")
                    elif fnum == 2:
                        simple = struct.unpack("<f", field)[0]
                if tag is not None and simple is not None:
                    event["scalars"][tag] = simple
    return event


def read_events(path):
    """Every Event of a TFRecord event file, decoded, with the length's
    and the payload's masked CRC32C checked; raises ValueError on a torn
    or corrupt record."""
    with open(path, "rb") as f:
        data = f.read()
    events_out = []
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("torn record header at byte %d" % pos)
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (header_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if header_crc != _masked_crc(header):
            raise ValueError("length CRC mismatch at byte %d" % pos)
        start = pos + 12
        end = start + length
        if end + 4 > len(data):
            raise ValueError("torn record at byte %d" % pos)
        record = data[start:end]
        (record_crc,) = struct.unpack("<I", data[end:end + 4])
        if record_crc != _masked_crc(record):
            raise ValueError("payload CRC mismatch at byte %d" % pos)
        events_out.append(decode_event(record))
        pos = end + 4
    return events_out


class EventFileWriter:
    """Append TFRecord-framed Event protos to an events.out.tfevents
    file, exactly the layout tf.summary.create_file_writer produces."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%d.%s" % (
            int(time.time()),
            socket.gethostname(),
        )
        self._path = os.path.join(logdir, fname)
        self._file = open(self._path, "ab")
        self._lock = threading.Lock()
        self._write(encode_event(time.time(), file_version="brain.Event:2"))
        self.flush()

    @property
    def path(self):
        return self._path

    def _write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        framed = (
            header
            + struct.pack("<I", _masked_crc(header))
            + record
            + struct.pack("<I", _masked_crc(record))
        )
        with self._lock:
            self._file.write(framed)

    def add_scalars(self, step, scalars):
        self._write(encode_event(time.time(), step=step, scalars=scalars))
        self.flush()

    def flush(self):
        with self._lock:
            self._file.flush()

    def close(self):
        with self._lock:
            self._file.close()


class TensorboardService:
    """Master-side summary sink + optional tensorboard process.

    Implements the EvaluationService ``summary_writer`` surface
    (write_eval_summary) the way the reference's service feeds
    eval metrics to tf.summary (tensorboard_service.py:40-48).
    """

    def __init__(self, logdir, master_addr="", spawn_tensorboard=None):
        self._logdir = logdir
        self._master_addr = master_addr
        if spawn_tensorboard is None:
            # opt-in: serving dashboards from the master pod only makes
            # sense where something can reach its port
            spawn_tensorboard = env_str(
                "EDL_SPAWN_TENSORBOARD", ""
            ) not in ("", "0")
        self._spawn = spawn_tensorboard
        self._writer = EventFileWriter(logdir)
        self._proc = None

    @property
    def logdir(self):
        return self._logdir

    @property
    def event_file(self):
        return self._writer.path

    def write_eval_summary(self, model_version, summary):
        scalars = {}
        for name, value in summary.items():
            try:
                scalars[name] = float(value)
            except (TypeError, ValueError):
                logger.debug("Skipping non-scalar metric %r", name)
        if scalars:
            self._writer.add_scalars(model_version, scalars)

    def add_scalars(self, step, scalars):
        self._writer.add_scalars(step, scalars)

    def start(self):
        """Spawn `tensorboard` bound to the master host (reference
        tensorboard_service.py:49-60). No-op if the binary is absent."""
        if not self._spawn:
            return
        import shutil

        if shutil.which("tensorboard") is None:
            logger.warning("tensorboard binary not found; not spawning")
            return
        host = (self._master_addr.split(":")[0] or "0.0.0.0")
        self._proc = subprocess.Popen(
            ["tensorboard", "--logdir", self._logdir, "--host", host],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        logger.info("Spawned tensorboard on %s (logdir %s)",
                    host, self._logdir)

    def stop(self):
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._proc = None
        self._writer.close()
