"""The training-health sentinels' events and metrics, on the CPU.

Mirrors the events and metrics cases of tests/test_health.py against
both packages (train/health.py imports no JAX in either): each
detection is journaled (a loss spike, a grad explosion, the first
batch of a nonfinite streak, a halt, flushed before the raise) and
counted in the ``edl_worker_*`` series; the worker's blob carries the
tracker's fields; the four health detectors raise and clear on a live
fleet monitor behind ``/alerts`` and thread through the postmortem.
Parity: one seeded stream of (loss, grad norm, nonfinite) observations
gives both trackers equal stats, journal lines and series.
"""

import importlib
import json
import os
import sys
import time
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ref": "elasticdl_tpu", "port": "elasticdl_tpu_torch"}


class Pkg:
    def __init__(self, side):
        self.side = side
        self.root = PACKAGES[side]

    def mod(self, name):
        return importlib.import_module("%s.%s" % (self.root, name))

    @property
    def health(self):
        return self.mod("train.health")

    @property
    def events(self):
        return self.mod("observability.events")

    @property
    def metrics(self):
        return self.mod("observability.metrics")


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request, tmp_path, monkeypatch):
    """One package with its journal under tmp_path and metrics on."""
    side = Pkg(request.param)
    monkeypatch.setenv(side.events.EVENTS_DIR_ENV, str(tmp_path))
    monkeypatch.setenv("EDL_METRICS", "1")
    side.metrics.reset_default_registry()
    side.events._reset_for_tests()
    side.journal = side.events.configure("worker-0")
    yield side
    side.events._reset_for_tests()
    side.metrics.reset_default_registry()


def _lines(journal):
    with open(journal.path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_spike_and_explosion_are_journaled_and_counted(pkg):
    tracker = pkg.health.HealthTracker(action="alert", spike_z=4.0,
                                       warmup_steps=5, grad_norm_max=100.0,
                                       grad_factor=0.0)
    for _ in range(30):
        tracker.observe(1.0 + np.random.RandomState(0).uniform(-0.01, 0.01),
                        0.5, False)
    tracker.observe(50.0, 0.5, False)   # loss spike
    tracker.observe(1.0, 200.0, False)  # absolute grad ceiling
    records = _lines(pkg.journal)
    assert [r["event"] for r in records][:1] == ["health_loss_spike"]
    assert records[0]["loss"] == 50.0 and records[0]["role"] == "worker-0"
    assert [r["event"] for r in records].count(
        "health_grad_explosion") == 1
    assert [r["event"] for r in records].count(
        "health_loss_spike") == tracker.loss_spikes
    reg = pkg.metrics.default_registry()
    assert reg.get("edl_worker_loss_spikes_total").get() == (
        tracker.loss_spikes)
    assert reg.get("edl_worker_grad_explosions_total").get() == 1
    text = reg.render()
    assert "edl_worker_loss_ewma" in text
    assert "edl_worker_grad_norm 200" in text


def test_nonfinite_streak_journals_its_edge_only(pkg):
    tracker = pkg.health.HealthTracker(action="skip")
    for _ in range(3):
        assert tracker.observe(float("nan"), 1.0, True) == "skip"
    tracker.observe(1.0, 1.0, False)
    tracker.observe(float("inf"), 1.0, True)
    records = [r for r in _lines(pkg.journal)
               if r["event"] == "health_nonfinite"]
    assert len(records) == 2  # one per streak, not per batch
    assert records[0]["action"] == "skip"
    reg = pkg.metrics.default_registry()
    assert reg.get("edl_worker_nonfinite_batches_total").get() == 4
    assert reg.get("edl_worker_health_skipped_batches_total").get() == 4


def test_halt_journals_and_flushes_before_the_raise(pkg):
    tracker = pkg.health.HealthTracker(action="halt")
    with pytest.raises(pkg.health.HealthSentinelError):
        tracker.observe(float("nan"), float("nan"), True)
    kinds = [r["event"] for r in _lines(pkg.journal)]
    assert kinds == ["health_nonfinite", "health_halt"]
    assert _lines(pkg.journal)[1]["streak"] == 1


def _observe_stream(pkg, seed):
    tracker = pkg.health.HealthTracker(action="alert", spike_z=3.0,
                                       warmup_steps=10, grad_norm_max=50.0,
                                       grad_factor=8.0)
    rng = np.random.RandomState(seed)
    for _ in range(300):
        kind = rng.rand()
        if kind < 0.03:
            tracker.observe(float("nan"), float("nan"), True)
        elif kind < 0.06:
            tracker.observe(float(rng.uniform(5, 50)), 1.0, False)
        elif kind < 0.09:
            tracker.observe(0.7, float(rng.uniform(60, 500)), False)
        else:
            tracker.observe(float(0.7 + rng.normal(0, 0.01)),
                            float(abs(rng.normal(1.0, 0.1))), False)
    lines = []
    for record in _lines(pkg.journal):
        record.pop("ts")
        lines.append(record)
    reg = pkg.metrics.default_registry()
    series = [line for line in reg.render().splitlines()
              if line.startswith("edl_worker_")]
    return tracker.stats(), lines, series


def test_trackers_agree_across_packages(tmp_path, monkeypatch):
    results = {}
    for side in ("ref", "port"):
        pkg = Pkg(side)
        monkeypatch.setenv(pkg.events.EVENTS_DIR_ENV, str(tmp_path / side))
        monkeypatch.setenv("EDL_METRICS", "1")
        pkg.metrics.reset_default_registry()
        pkg.events._reset_for_tests()
        pkg.journal = pkg.events.configure("worker-0")
        try:
            results[side] = _observe_stream(pkg, seed=4)
        finally:
            pkg.events._reset_for_tests()
            pkg.metrics.reset_default_registry()
    ref_stats, ref_lines, ref_series = results["ref"]
    port_stats, port_lines, port_series = results["port"]
    assert port_stats == ref_stats
    assert port_lines == ref_lines
    assert port_series == ref_series
    kinds = {r["event"] for r in port_lines}
    assert kinds == {"health_nonfinite", "health_loss_spike",
                     "health_grad_explosion"}


def test_worker_blob_carries_the_tracker_fields(monkeypatch):
    """The port worker's blob takes the tracker's stats (fields
    28-35) and they survive the wire."""
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.train.health import HealthTracker
    from elasticdl_tpu_torch.worker.worker import Worker

    tracker = HealthTracker(action="skip")
    tracker.observe(0.7, 0.5, False)
    tracker.observe(float("nan"), float("nan"), True)

    class _Trainer:
        health = tracker

    class _Tds:
        last_task_seconds = 1.5

    class _Mc:
        worker_id = 0

    class _Stub:
        _mc, tds, trainer = _Mc(), _Tds(), _Trainer()
        _step_ewma, _last_examples_per_sec, _version = 0.1, 320.0, 7

    blob = Worker._telemetry_blob(_Stub())
    wire = pb.TelemetryBlob.FromString(blob.SerializeToString())
    assert wire.health_nonfinite_batches == 1
    assert wire.health_nonfinite_streak == 1
    assert wire.health_skipped_batches == 1
    assert wire.health_loss_ewma == pytest.approx(0.7)
    assert wire.last_task_seconds == 1.5 and wire.model_version == 7


def test_four_detectors_end_to_end_alerts_and_postmortem(pkg, tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import postmortem as pm

    pb = pkg.mod("proto.elasticdl_tpu_pb2")
    pkg.events._reset_for_tests()
    pkg.events.configure("master")
    fleet = pkg.mod("master.fleet").FleetMonitor(
        dead_air_secs=600, health_alert_secs=0.25, label_shift_delta=0.1,
        id_novelty_max=0.8)
    fleet.observe(0, pb.TelemetryBlob(role="worker-0",
                                      health_nonfinite_batches=1,
                                      health_nonfinite_streak=2))
    fleet.observe(1, pb.TelemetryBlob(role="worker-1",
                                      health_loss_spikes=3,
                                      health_loss_last=9.0,
                                      health_loss_ewma=0.7))
    fleet.observe(2, pb.TelemetryBlob(role="worker-2",
                                      health_grad_explosions=1,
                                      health_grad_norm=4200.0))
    for i in range(6):
        fleet.observe_stream_window(64 * (i + 1), 0.5, 0.1)
    fleet.observe_stream_window(448, 0.9, 0.1)
    server = pkg.mod("observability.http_server").ObservabilityServer(
        "master", 0).start()
    server.add_json_handler("/alerts", fleet.alerts)
    url = "http://localhost:%d/alerts" % server.port
    try:
        body = json.loads(urllib.request.urlopen(url, timeout=5).read())
        assert {a["alert"] for a in body} == {
            "nonfinite_loss", "loss_spike", "grad_explosion", "label_shift"}
        fleet.observe(0, pb.TelemetryBlob(role="worker-0",
                                          health_nonfinite_batches=1))
        time.sleep(0.4)
        assert json.loads(urllib.request.urlopen(url, timeout=5).read()) \
            == []
    finally:
        server.stop()
        pkg.events._reset_for_tests()
    report = pm.postmortem(str(tmp_path))
    raised = {e["alert"] for e in report["timeline"]
              if e.get("event") == "alert_raised"}
    cleared = {e["alert"] for e in report["timeline"]
               if e.get("event") == "alert_cleared"}
    kinds = {"nonfinite_loss", "loss_spike", "grad_explosion",
             "label_shift"}
    assert raised == cleared == kinds
    text = pm.render_text(report["timeline"], report["summary"],
                          report["dumps"], {})
    assert "nonfinite_loss" in text
