"""The port's device telemetry (elasticdl_tpu_torch/observability/
device.py) on the CPU, and its allocator path on the card.

- ``telemetry()`` has the reference's keys (the reference computed on
  the CPU backend exactly as its own tests run it);
- the h2d/d2h transfer counters and their ``transfer`` spans add up,
  in the totals and in ``edl_device_transfer_bytes_total``;
- on the CPU torch has no allocator view: ``source = "none"``, 0 bytes
  in use, ``EDL_HBM_LIMIT_BYTES`` as the limit, which the fleet's
  hbm_pressure detector reads;
- ``EDL_DEVICE_OBS=0`` makes every call inert and ``telemetry()``
  ``{}``;
- the xla_* fields stay 0: the port has no compiled step to count;
- ``cuda`` cases (skipped here): the caching allocator's bytes in use
  and peak, and the card's total memory as the limit.
"""

import json
import os

import pytest
import torch

from elasticdl_tpu_torch.observability import device as device_obs
from elasticdl_tpu_torch.observability import metrics, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv(device_obs.DEVICE_OBS_ENV, raising=False)
    monkeypatch.delenv(device_obs.HBM_LIMIT_ENV, raising=False)
    device_obs.reset_for_tests()
    yield
    device_obs.reset_for_tests()


def test_telemetry_keys_are_the_reference_ones():
    from elasticdl_tpu.observability import device as ref_device

    ref_device.reset_for_tests()
    try:
        ref_keys = set(ref_device.telemetry())
    finally:
        ref_device.reset_for_tests()
    port = device_obs.telemetry()
    assert set(port) == ref_keys
    assert port["xla_compiles"] == port["xla_recompiles"] == 0
    assert port["xla_compile_secs_total"] == 0.0


def test_transfer_counters_add_up(tmp_path, monkeypatch):
    monkeypatch.setenv("EDL_METRICS", "1")
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path))
    metrics.reset_default_registry()
    # the lazy counter resolves on first use, per process: bind it to
    # this test's registry
    monkeypatch.setattr(device_obs._m_transfer_bytes, "_real", None)
    trace.configure("worker-0")
    try:
        with device_obs.transfer_span("d2h", 4096):
            pass
        device_obs.record_transfer("h2d", 512)
        device_obs.record_transfer("h2d", 1024)
        device_obs.record_transfer("d2h", 0)  # nothing moved: not counted
        tel = device_obs.telemetry()
        assert tel["d2h_bytes"] == 4096 and tel["h2d_bytes"] == 1536
        counter = metrics.default_registry().get(
            "edl_device_transfer_bytes_total")
        assert counter.get("d2h") == 4096 and counter.get("h2d") == 1536
        trace.flush()
    finally:
        trace._reset_for_tests()
        metrics.reset_default_registry()
    events = []
    for name in os.listdir(tmp_path):
        with open(tmp_path / name, encoding="utf-8") as f:
            text = f.read().rstrip().rstrip(",")
        events += json.loads(text + ("" if text.endswith("]") else "]"))
    spans = [e for e in events if e.get("name") == "transfer"]
    assert len(spans) == 1
    assert spans[0]["args"] == {"direction": "d2h", "bytes": 4096}


def test_cpu_reports_no_allocator_and_honours_the_limit_knob(monkeypatch):
    # a CPU tensor does not make an allocator appear
    torch.ones(1024)
    snap = device_obs.memory_snapshot()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        pytest.skip("this process uses the card: see the cuda cases")
    assert snap == {"bytes_in_use": 0, "peak_bytes": 0, "limit_bytes": 0,
                    "live_buffers": 0, "source": "none"}
    monkeypatch.setenv(device_obs.HBM_LIMIT_ENV, "1000000")
    tel = device_obs.telemetry()
    assert tel["hbm_limit_bytes"] == 1000000
    assert tel["hbm_bytes_in_use"] == 0 and tel["device_live_buffers"] == 0


def test_the_limit_knob_feeds_hbm_pressure(monkeypatch):
    """The synthetic limit makes the fleet detector drillable on a box
    without a card: bytes in use over 90% of it fire, a 0 limit never
    does."""
    from elasticdl_tpu_torch.master.fleet import FleetMonitor
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

    monkeypatch.setenv(device_obs.HBM_LIMIT_ENV, "100")
    tel = device_obs.telemetry()
    fleet = FleetMonitor(hbm_pressure_max=0.9)
    fleet.observe(0, pb.TelemetryBlob(
        role="worker-0", hbm_bytes_in_use=95,
        hbm_limit_bytes=tel["hbm_limit_bytes"]))
    assert [a["alert"] for a in fleet.evaluate()] == ["hbm_pressure"]
    fleet.observe(0, pb.TelemetryBlob(role="worker-0", hbm_bytes_in_use=95,
                                      hbm_limit_bytes=0))
    assert fleet.evaluate() == []


def test_disabled_is_inert(monkeypatch, tmp_path):
    monkeypatch.setenv(device_obs.DEVICE_OBS_ENV, "0")
    assert device_obs.telemetry() == {}
    assert device_obs.memory_snapshot() == {}
    device_obs.record_transfer("h2d", 1024)
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path))
    trace.configure("worker-0")
    try:
        with device_obs.transfer_span("d2h", 2048):
            pass
        trace.flush()
    finally:
        trace._reset_for_tests()
    monkeypatch.delenv(device_obs.DEVICE_OBS_ENV)
    tel = device_obs.telemetry()
    assert tel["h2d_bytes"] == 0 and tel["d2h_bytes"] == 0
    for name in os.listdir(tmp_path):
        with open(tmp_path / name, encoding="utf-8") as f:
            assert '"transfer"' not in f.read()


def test_the_worker_blob_carries_the_device_section(monkeypatch):
    """The worker's blob takes telemetry()'s fields as they are, and
    none under EDL_DEVICE_OBS=0."""
    from elasticdl_tpu_torch.worker.worker import Worker

    class _Tds:
        last_task_seconds = 0.0

    class _Mc:
        worker_id = 3

    class _Stub:
        _mc, tds, _step_ewma = _Mc(), _Tds(), 0.0
        _last_examples_per_sec, _version = 0.0, 5
        trainer = object()

    monkeypatch.setenv(device_obs.HBM_LIMIT_ENV, "4096")
    device_obs.record_transfer("d2h", 64)
    blob = Worker._telemetry_blob(_Stub())
    assert blob.role == "worker-3" and blob.model_version == 5
    assert blob.hbm_limit_bytes == 4096 and blob.d2h_bytes == 64
    monkeypatch.setenv(device_obs.DEVICE_OBS_ENV, "0")
    blob = Worker._telemetry_blob(_Stub())
    assert blob.hbm_limit_bytes == 0 and blob.d2h_bytes == 0


# ---------------------------------------------------------------------------
# the allocator path, on the card


@pytest.mark.cuda
def test_allocator_bytes_and_the_card_limit():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    before = device_obs.memory_snapshot()
    block = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    snap = device_obs.memory_snapshot()
    assert snap["source"] == "allocator"
    assert snap["bytes_in_use"] >= before.get("bytes_in_use", 0) + (64 << 20)
    assert snap["peak_bytes"] >= snap["bytes_in_use"]
    assert snap["limit_bytes"] == torch.cuda.mem_get_info()[1]
    assert snap["live_buffers"] >= 1
    del block
    tel = device_obs.telemetry()
    assert tel["hbm_limit_bytes"] == torch.cuda.mem_get_info()[1]
    assert tel["hbm_peak_bytes"] >= 64 << 20


@pytest.mark.cuda
def test_allocator_limit_wins_over_the_knob(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.zeros(1, device="cuda")
    monkeypatch.setenv(device_obs.HBM_LIMIT_ENV, "123")
    assert device_obs.memory_snapshot()["limit_bytes"] == (
        torch.cuda.mem_get_info()[1])
