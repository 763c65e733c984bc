"""The port's observability layer against the reference's, on the CPU.

Mirrors tests/test_observability.py: the registry and its Prometheus
exposition, the health/readiness endpoints, the gRPC interceptors on a
live master<->worker pair, the trace round trip, the events journal,
the fleet monitor's detectors, and the master's, workers' and PS's
telemetry. Every scenario whose reference module imports no JAX runs
against BOTH packages (the ``pkg`` fixture); the port's runs are the
port's tests, the reference's run exactly as its own tests run them.

Parity on top:
- exposition: one sequence of counter, gauge and histogram operations
  renders byte-equal text on both registries;
- fleet: a seeded sequence of 240 operations (random TelemetryBlobs
  over 4 workers and 2 PS, clock steps, evictions, drains, forgets,
  stream windows), ``evaluate()`` after each, leaves equal snapshots,
  alerts, transition counts and journal lines (timestamps aside), and
  reaches every detector;
- telemetry: a DeepFM job with the device tier on, the same data and
  the reference worker's initial weights carried across, gives worker
  blobs equal on the tier's tallies and the model version, and PS blobs
  equal on push and pull bytes (native store against native store);
- the knobs unset, ``build_server`` installs the same interceptors as
  before the wiring and ``build_channel`` returns the channel the
  deadline-budget interceptor gave.
"""

import importlib
import json
import os
import sys
import time
import types
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ref": "elasticdl_tpu", "port": "elasticdl_tpu_torch"}


class Pkg:
    """One package's modules by their relative name."""

    def __init__(self, side):
        self.side = side
        self.root = PACKAGES[side]

    def mod(self, name):
        return importlib.import_module("%s.%s" % (self.root, name))

    @property
    def metrics(self):
        return self.mod("observability.metrics")

    @property
    def events(self):
        return self.mod("observability.events")

    @property
    def trace(self):
        return self.mod("observability.trace")

    @property
    def http_server(self):
        return self.mod("observability.http_server")

    @property
    def grpc_metrics(self):
        return self.mod("observability.grpc_metrics")

    @property
    def fleet(self):
        return self.mod("master.fleet")

    @property
    def pb(self):
        return self.mod("proto.elasticdl_tpu_pb2")


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    side = Pkg(request.param)
    yield side
    side.events._reset_for_tests()
    side.metrics.reset_default_registry()


def _get(url):
    try:
        response = urllib.request.urlopen(url, timeout=5)
        return response.status, response.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# ---------------------------------------------------------------------------
# registry semantics


def test_counter_labels_accumulate_independently(pkg):
    reg = pkg.metrics.Registry(enabled=True)
    c = reg.counter("reqs_total", "requests", ("method", "code"))
    c.labels(method="get_task", code="OK").inc()
    c.labels(method="get_task", code="OK").inc(2)
    c.labels(method="get_task", code="UNAVAILABLE").inc()
    assert c.get("get_task", "OK") == 3
    assert c.get("get_task", "UNAVAILABLE") == 1
    with pytest.raises(ValueError):
        c.labels(method="only-one-label")


def test_counter_rejects_decrement(pkg):
    c = pkg.metrics.Registry(enabled=True).counter("ups_total", "u")
    with pytest.raises((TypeError, ValueError)):
        c.dec()


def test_gauge_set_function_reads_live_state(pkg):
    reg = pkg.metrics.Registry(enabled=True)
    state = {"depth": 0}
    reg.gauge("queue_depth", "d").set_function(lambda: state["depth"])
    state["depth"] = 7
    assert "queue_depth 7" in reg.render()


def test_histogram_buckets_are_cumulative(pkg):
    reg = pkg.metrics.Registry(enabled=True)
    h = reg.histogram("lat", "latency", ("m",), buckets=(0.1, 1.0, 10.0))
    child = h.labels(m="push")
    for value in (0.05, 0.5, 0.5, 5.0, 50.0):
        child.observe(value)
    text = reg.render()
    assert 'lat_bucket{m="push",le="0.1"} 1' in text
    assert 'lat_bucket{m="push",le="1"} 3' in text
    assert 'lat_bucket{m="push",le="10"} 4' in text
    assert 'lat_bucket{m="push",le="+Inf"} 5' in text
    assert 'lat_count{m="push"} 5' in text
    assert h.get_count("push") == 5


def test_registry_get_or_create_is_idempotent(pkg):
    reg = pkg.metrics.Registry(enabled=True)
    assert reg.counter("same", "x", ("l",)) is reg.counter("same", "x",
                                                           ("l",))
    with pytest.raises(ValueError):
        reg.counter("same", "x", ("other",))


def test_disabled_registry_is_noop(pkg):
    reg = pkg.metrics.Registry(enabled=False)
    c = reg.counter("nope_total", "n", ("l",))
    c.labels(l="x").inc()
    c.inc(5)
    g = reg.gauge("g", "g")
    g.set(3)
    reg.histogram("h", "h").observe(1.0)
    assert c is pkg.metrics.NOOP and g is pkg.metrics.NOOP
    assert reg.render() == ""


def test_metrics_disabled_without_knobs(pkg, monkeypatch):
    monkeypatch.delenv("EDL_METRICS", raising=False)
    monkeypatch.delenv("EDL_METRICS_PORT", raising=False)
    assert not pkg.metrics.metrics_enabled()
    monkeypatch.setenv("EDL_METRICS_PORT", "9090")
    assert pkg.metrics.metrics_enabled()
    monkeypatch.setenv("EDL_METRICS", "0")  # explicit off wins
    assert not pkg.metrics.metrics_enabled()


def test_exposition_format_golden(pkg):
    reg = pkg.metrics.Registry(enabled=True)
    reg.counter("edl_reqs_total", "Requests served",
                ("code",)).labels(code="OK").inc(2)
    reg.gauge("edl_depth", "Queue depth").set(3)
    reg.histogram("edl_lat_seconds", "Latency", buckets=(0.5,)).observe(0.25)
    assert reg.render() == (
        "# HELP edl_depth Queue depth\n"
        "# TYPE edl_depth gauge\n"
        "edl_depth 3\n"
        "# HELP edl_lat_seconds Latency\n"
        "# TYPE edl_lat_seconds histogram\n"
        'edl_lat_seconds_bucket{le="0.5"} 1\n'
        'edl_lat_seconds_bucket{le="+Inf"} 1\n'
        "edl_lat_seconds_sum 0.25\n"
        "edl_lat_seconds_count 1\n"
        "# HELP edl_reqs_total Requests served\n"
        "# TYPE edl_reqs_total counter\n"
        'edl_reqs_total{code="OK"} 2\n'
    )


def test_render_survives_failing_and_nonfinite_callback_gauges(pkg):
    reg = pkg.metrics.Registry(enabled=True)
    reg.gauge("broken", "b").set_function(lambda: 1 / 0)
    reg.gauge("neg_inf", "n").set(float("-inf"))
    text = reg.render()
    assert "broken NaN" in text and "neg_inf -Inf" in text


def test_label_values_are_escaped(pkg):
    reg = pkg.metrics.Registry(enabled=True)
    reg.counter("esc_total", "e", ("path",)).labels(path='a"b\\c\nd').inc()
    assert 'esc_total{path="a\\"b\\\\c\\nd"} 1' in reg.render()


def _exposition_ops(metrics_mod, seed):
    """One seeded sequence of instrument operations on a fresh enabled
    registry; returns its exposition text."""
    rng = np.random.RandomState(seed)
    reg = metrics_mod.Registry(enabled=True)
    counters = [reg.counter("edl_c%d_total" % i, "counter %d" % i,
                            ("method", "code")) for i in range(3)]
    gauges = [reg.gauge("edl_g%d" % i, "gauge %d" % i) for i in range(3)]
    live = {"v": 0.0}
    reg.gauge("edl_live", "callback").set_function(lambda: live["v"])
    hists = [
        reg.histogram("edl_h0_seconds", "latency", ("method",)),
        reg.histogram("edl_h1", "sizes", buckets=(1, 2, 4, 8, 16, 32)),
    ]
    methods = ("get_task", "push_gradients", "pull_embedding_batch")
    for _ in range(400):
        kind = rng.randint(4)
        if kind == 0:
            counters[rng.randint(3)].labels(
                method=methods[rng.randint(3)],
                code=("OK", "UNAVAILABLE")[rng.randint(2)],
            ).inc(int(rng.randint(1, 5)))
        elif kind == 1:
            gauges[rng.randint(3)].set(float(rng.randn() * 1e3))
            live["v"] = float(rng.randint(100))
        elif kind == 2:
            hists[0].labels(method=methods[rng.randint(3)]).observe(
                float(rng.exponential(0.05)))
        else:
            hists[1].observe(float(rng.randint(40)))
    return reg.render()


def test_exposition_text_is_byte_equal_across_packages():
    ref = _exposition_ops(Pkg("ref").metrics, seed=7)
    port = _exposition_ops(Pkg("port").metrics, seed=7)
    assert port.encode() == ref.encode()
    assert "edl_h0_seconds_bucket" in port and "edl_live" in port


# ---------------------------------------------------------------------------
# health endpoints and the HTTP daemon's error paths


def test_healthz_readyz_role_transitions(pkg):
    reg = pkg.metrics.Registry(enabled=True)
    server = pkg.http_server.ObservabilityServer("ps-0", 0,
                                                 registry=reg).start()
    try:
        ready = {"model": False}
        server.add_readiness_check("model_initialized",
                                   lambda: ready["model"])
        base = "http://localhost:%d" % server.port
        assert _get(base + "/healthz")[0] == 200
        status, body = _get(base + "/readyz")
        assert status == 503 and "model_initialized" in body
        ready["model"] = True
        assert _get(base + "/readyz")[0] == 200
        status, body = _get(base + "/metrics")
        assert status == 200 and 'edl_up{role="ps-0"} 1' in body
        assert _get(base + "/nope")[0] == 404
    finally:
        server.stop()


def test_raising_readiness_check_is_unready(pkg):
    server = pkg.http_server.ObservabilityServer(
        "w", 0, registry=pkg.metrics.Registry(enabled=True))
    server.add_readiness_check("boom", lambda: 1 / 0)
    ok, failing = server.readiness()
    assert not ok and failing == ["boom"]


def test_unknown_routes_answer_404_and_server_survives(pkg):
    server = pkg.http_server.ObservabilityServer(
        "w", 0, registry=pkg.metrics.Registry(enabled=True)).start()
    try:
        base = "http://localhost:%d" % server.port
        for path in ("/nope", "/metricsz", "/profilez/extra", "/"):
            assert _get(base + path)[0] == 404, path
        assert _get(base + "/healthz")[0] == 200
    finally:
        server.stop()


def test_busy_port_degrades_to_no_server(pkg):
    import socket

    holder = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    holder.bind(("0.0.0.0", 0))
    holder.listen(1)
    try:
        assert pkg.http_server.maybe_start(
            "w", cli_port=holder.getsockname()[1]) is None
    finally:
        holder.close()


def test_raising_json_handler_answers_500_and_daemon_survives(pkg):
    server = pkg.http_server.ObservabilityServer(
        "master", 0, registry=pkg.metrics.Registry(enabled=True)).start()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("snapshot source broke")
        return {"ok": calls["n"]}

    server.add_json_handler("/statusz", flaky)
    try:
        base = "http://localhost:%d" % server.port
        status, body = _get(base + "/statusz")
        assert status == 500 and "snapshot source broke" in body
        assert _get(base + "/healthz")[0] == 200
        status, body = _get(base + "/statusz")
        assert status == 200 and json.loads(body) == {"ok": 2}
        assert _get(base + "/metrics")[0] == 200
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# RPC interceptors on a live master<->worker pair


@pytest.fixture
def live_metrics(pkg, monkeypatch):
    """The package's process-global registry enabled for the test."""
    monkeypatch.setenv("EDL_METRICS", "1")
    pkg.metrics.reset_default_registry()
    monkeypatch.setattr(pkg.grpc_metrics, "_client_cache", (None, None))
    yield pkg.metrics.default_registry()
    pkg.metrics.reset_default_registry()


def test_interceptors_count_live_master_rpcs(pkg, live_metrics):
    grpc_utils = pkg.mod("common.grpc_utils")
    services = pkg.mod("proto.services")
    dispatcher = pkg.mod("master.task_dispatcher").TaskDispatcher(
        {"s": (0, 64)}, records_per_task=32)
    server = grpc_utils.build_server()
    services.add_master_servicer_to_server(
        pkg.mod("master.servicer").MasterServicer(dispatcher), server)
    port = grpc_utils.find_free_port()
    server.add_insecure_port("localhost:%d" % port)
    server.start()
    try:
        mc = pkg.mod("worker.master_client").MasterClient(
            "localhost:%d" % port, worker_id=0)
        assert mc.reset_worker() == mc.incarnation > 0
        task = mc.get_task()
        assert task.task_id != 0
        mc.report_task_result(task.task_id)
        text = live_metrics.render()
        for series in (
            'edl_grpc_server_handled_total{service="Master",'
            'method="get_task",code="OK"} 1',
            'edl_grpc_client_handled_total{service="Master",'
            'method="get_task",code="OK"} 1',
            'edl_grpc_server_latency_seconds_count{service="Master",'
            'method="get_task"} 1',
            'edl_grpc_client_latency_seconds_count{service="Master",'
            'method="get_task"} 1',
        ):
            assert series in text, series
        for method in (list(services._MASTER_METHODS)
                       + list(services._PSERVER_METHODS)):
            assert 'method="%s"' % method in text, method
    finally:
        server.stop(0)


def test_client_interceptor_counts_deadline_exceeded(pkg, live_metrics):
    import grpc

    channel = pkg.grpc_metrics.instrument_channel(
        grpc.insecure_channel("localhost:1"))  # nothing listens
    stub = pkg.mod("proto.services").MasterStub(channel)
    with pytest.raises(grpc.RpcError):
        stub.get_task(pkg.pb.GetTaskRequest(worker_id=0), timeout=0.2)
    counter = live_metrics.get("edl_grpc_client_handled_total")
    assert (counter.get("Master", "get_task", "UNAVAILABLE")
            + counter.get("Master", "get_task", "DEADLINE_EXCEEDED")) >= 1


def test_uninstrumented_channel_when_disabled(pkg, monkeypatch):
    import grpc

    monkeypatch.delenv("EDL_METRICS", raising=False)
    monkeypatch.delenv("EDL_METRICS_PORT", raising=False)
    channel = grpc.insecure_channel("localhost:1")
    assert pkg.grpc_metrics.instrument_channel(channel) is channel
    assert pkg.grpc_metrics.server_interceptors() == ()


def test_knobs_unset_leave_the_port_call_path_as_before(monkeypatch):
    """With every observability knob unset, ``build_server`` installs
    only the deadline-budget interceptors it installed before the
    observability wiring, and ``build_channel`` returns the channel of
    the deadline-budget interceptor itself (no trace or metrics
    wrapper)."""
    import grpc

    from elasticdl_tpu_torch.common import grpc_utils, overload

    for knob in ("EDL_METRICS", "EDL_METRICS_PORT", "EDL_TRACE_DIR",
                 "EDL_TRACE_SAMPLE"):
        monkeypatch.delenv(knob, raising=False)
    seen = {}
    real_server = grpc.server

    def spy_server(*args, **kwargs):
        seen["interceptors"] = kwargs.get("interceptors")
        return real_server(*args, **kwargs)

    monkeypatch.setattr(grpc, "server", spy_server)
    server = grpc_utils.build_server()
    server.stop(0)
    assert [type(i) for i in seen["interceptors"]] == [
        type(i) for i in overload.server_budget_interceptors()]
    budget_channels = []
    real_budget = overload.intercept_budget_channel

    def spy_budget(channel):
        out = real_budget(channel)
        budget_channels.append(out)
        return out

    monkeypatch.setattr(overload, "intercept_budget_channel", spy_budget)
    channel = grpc_utils.build_channel("localhost:1")
    try:
        assert channel is budget_channels[-1]
    finally:
        channel.close()
    # the knobs on: the tracing and metrics interceptors join
    monkeypatch.setenv("EDL_METRICS", "1")
    from elasticdl_tpu_torch.observability import grpc_metrics

    assert len(grpc_metrics.server_interceptors()) == 1


# ---------------------------------------------------------------------------
# cross-role trace round trip


def test_trace_merge_round_trip(pkg, tmp_path, monkeypatch):
    """Two roles' trace files, written by the package's TraceWriter,
    merge into one timeline correlated by task id."""
    trace = pkg.trace
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path))
    master = trace.TraceWriter("master", str(tmp_path), pid=1001)
    worker = trace.TraceWriter("worker-0", str(tmp_path), pid=1002)
    monkeypatch.setattr(trace, "_writer", master)
    trace.complete("dispatch", time.time() - 0.01, task_id=7, worker_id=0)
    master.flush()
    monkeypatch.setattr(trace, "_writer", worker)
    with trace.task_context(7):
        with trace.span("train_batch", version=1):
            with trace.span("ps_push", version=1):
                pass
    worker.flush()
    monkeypatch.setattr(trace, "_writer", None)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import merge_trace
    finally:
        sys.path.pop(0)
    merged, names = merge_trace.merge(str(tmp_path))
    assert len(names) == 2
    spans = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    task7 = [e for e in spans if e["args"].get("task_id") == 7]
    assert {e["name"] for e in task7} == {"dispatch", "train_batch",
                                          "ps_push"}
    assert {e["pid"] for e in task7} == {1001, 1002}
    flows = [e for e in merged["traceEvents"]
             if e.get("ph") in ("s", "t", "f")]
    assert [f["ph"] for f in flows] == ["s", "t", "f"]


def test_span_is_inert_without_trace_dir(pkg, monkeypatch):
    trace = pkg.trace
    monkeypatch.setattr(trace, "_writer", None)
    with trace.span("nothing", task_id=1):
        pass
    trace.instant("nope")
    trace.complete("nope", 0.0)
    assert not trace.enabled()


# ---------------------------------------------------------------------------
# the events journal (flight recorder)


@pytest.fixture
def journal_dir(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv(pkg.events.EVENTS_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(pkg.events.JOB_NAME_ENV, "test-job")
    yield tmp_path
    pkg.events._reset_for_tests()


def _read_journal(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_journal_is_write_through_ndjson(pkg, journal_dir):
    journal = pkg.events.configure("worker-0")
    pkg.events.emit("role_start", worker=0, epoch=7)
    pkg.events.emit("task_dispatch", task=41, worker=0)
    records = _read_journal(journal.path)
    assert [r["event"] for r in records] == ["role_start", "task_dispatch"]
    assert records[0]["role"] == "worker-0"
    assert records[0]["job"] == "test-job"
    assert records[0]["seq"] == 1 and records[0]["ts"] > 0
    assert records[1]["task"] == 41


def test_emit_unknown_event_type_raises(pkg, journal_dir):
    pkg.events.configure("worker-0")
    with pytest.raises(ValueError):
        pkg.events.emit("not_a_real_event")


def test_event_vocabulary_is_the_reference_one():
    assert Pkg("port").events.EVENT_TYPES == Pkg("ref").events.EVENT_TYPES


def test_emit_survives_reentrant_write(pkg, journal_dir):
    journal = pkg.events.configure("worker-0")
    pkg.events.emit("role_start", worker=0)

    class ReentrantFile:
        def write(self, line):
            raise RuntimeError("reentrant call inside TextIOWrapper")

        def flush(self):
            raise RuntimeError("reentrant call inside TextIOWrapper")

        def close(self):
            pass

    journal._file = ReentrantFile()
    pkg.events.emit("worker_draining", worker=0, reason="sigterm")
    assert journal._ring[-1]["event"] == "worker_draining"


def test_journal_inert_without_events_dir(pkg, monkeypatch, tmp_path):
    monkeypatch.delenv(pkg.events.EVENTS_DIR_ENV, raising=False)
    assert pkg.events.configure("worker-0") is None
    assert not pkg.events.enabled()
    pkg.events.emit("role_start")
    pkg.events.flush()
    assert pkg.events.dump("whatever") is None
    assert not list(tmp_path.iterdir())


def test_ring_dump_is_bounded_and_first_reason_wins(pkg, journal_dir):
    events = pkg.events
    journal = events.configure("ps-0")
    for i in range(events._RING_SIZE + 50):
        events.emit("round_fill", version=i, fill=1, worker=0)
    path = events.dump("sigterm")
    assert path == journal.dump_path
    assert events.dump("uncaught:RuntimeError") is None
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    assert payload["reason"] == "sigterm" and payload["role"] == "ps-0"
    assert len(payload["events"]) == events._RING_SIZE
    assert payload["events"][-1]["version"] == events._RING_SIZE + 49


def test_excepthook_dumps_ring(pkg, journal_dir, monkeypatch):
    events = pkg.events
    journal = events.configure("worker-2")
    events.emit("role_start", worker=2)
    monkeypatch.setattr(events, "_hooks_installed", False)
    calls = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: calls.append(a))
    # the SIGTERM hook too: restore whatever handler was there
    import signal

    monkeypatch.setattr(signal, "signal", lambda *a: None)
    events.install_crash_hooks()
    try:
        raise RuntimeError("boom")
    except RuntimeError:
        sys.excepthook(*sys.exc_info())
    assert calls, "the original excepthook still runs"
    with open(journal.dump_path, encoding="utf-8") as f:
        assert json.load(f)["reason"] == "uncaught:RuntimeError"


def test_crash_hook_chains_in_front_of_the_previous_sigterm_handler(
        pkg, journal_dir, monkeypatch):
    """install_crash_hooks dumps the ring and flushes, then calls the
    handler that was installed before it (the worker's drain hook)."""
    import signal

    events = pkg.events
    journal = events.configure("worker-1")
    events.emit("role_start", worker=1)
    handlers = {}
    monkeypatch.setattr(signal, "getsignal",
                        lambda sig: handlers.get(sig, signal.SIG_DFL))
    monkeypatch.setattr(signal, "signal",
                        lambda sig, fn: handlers.__setitem__(sig, fn))
    order = []
    handlers[signal.SIGTERM] = lambda signum, frame: order.append(
        os.path.exists(journal.dump_path))
    monkeypatch.setattr(events, "_hooks_installed", False)
    events.install_crash_hooks()
    handlers[signal.SIGTERM](signal.SIGTERM, None)
    assert order == [True]  # the dump landed before the drain ran


# ---------------------------------------------------------------------------
# fleet telemetry and anomaly detectors (master/fleet.py)


def _fleet(pkg, **kw):
    defaults = dict(straggler_factor=3.0, dead_air_secs=60.0,
                    stuck_round_secs=60.0, version_lag_max=100)
    defaults.update(kw)
    return pkg.fleet.FleetMonitor(**defaults)


@pytest.fixture
def alerts_on(pkg, monkeypatch):
    monkeypatch.setenv("EDL_METRICS", "1")
    pkg.metrics.reset_default_registry()
    yield lambda: pkg.metrics.default_registry().get(
        "edl_master_alerts_total")
    pkg.metrics.reset_default_registry()


def test_straggler_fires_only_against_a_fleet(pkg):
    fleet, blob = _fleet(pkg), pkg.pb.TelemetryBlob
    fleet.observe(0, blob(step_time_ewma=0.1))
    fleet.observe(1, blob(step_time_ewma=0.9))
    assert fleet.evaluate() == []
    fleet.observe(2, blob(step_time_ewma=0.1))
    firing = fleet.evaluate()
    assert [a["alert"] for a in firing] == ["straggler"]
    assert firing[0]["worker_id"] == 1
    fleet.observe(1, blob(step_time_ewma=0.12))
    assert fleet.evaluate() == []


def test_dead_air_fires_after_window_and_clears_on_forget(pkg):
    fleet = _fleet(pkg, dead_air_secs=0.05)
    fleet.observe(0, pkg.pb.TelemetryBlob(role="worker-0"))
    time.sleep(0.1)
    firing = fleet.evaluate()
    assert [a["alert"] for a in firing] == ["dead_air"]
    assert firing[0]["role"] == "worker-0"
    fleet.forget(0)
    assert fleet.evaluate() == []


def test_eviction_forces_dead_air_tombstone(pkg, alerts_on):
    fleet, blob = _fleet(pkg), pkg.pb.TelemetryBlob
    fleet.observe(1, blob(role="worker-1"))
    assert fleet.evaluate() == []
    fleet.mark_dead(1)
    firing = fleet.evaluate()
    assert [a["alert"] for a in firing] == ["dead_air"]
    assert firing[0]["evicted"] is True and firing[0]["role"] == "worker-1"
    assert alerts_on().get("dead_air") == 1
    assert fleet.evaluate(), "the tombstone does not clear by itself"
    fleet.observe(1, blob(role="worker-1"))
    assert fleet.evaluate() == []


def test_stuck_round_fires_when_fill_stalls(pkg):
    fleet, blob = _fleet(pkg, stuck_round_secs=0.05), pkg.pb.TelemetryBlob
    fleet.observe(-1, blob(role="ps-0", round_buffer_fill=2,
                           model_version=5))
    time.sleep(0.1)
    assert [a["alert"] for a in fleet.evaluate()] == ["stuck_round"]
    fleet.observe(-1, blob(role="ps-0", round_buffer_fill=0,
                           model_version=6))
    assert fleet.evaluate() == []


def test_version_lag_runaway_fires(pkg):
    fleet = _fleet(pkg, version_lag_max=10)
    fleet.observe(-1, pkg.pb.TelemetryBlob(role="ps-0", version_lag=50))
    assert [a["alert"] for a in fleet.evaluate()] == ["version_lag"]


def test_alert_transitions_bump_counter_once(pkg, alerts_on):
    fleet = _fleet(pkg, version_lag_max=10)
    fleet.observe(-1, pkg.pb.TelemetryBlob(role="ps-0", version_lag=50))
    fleet.evaluate()
    fleet.evaluate()
    assert alerts_on().get("version_lag") == 1
    assert "edl_master_alerts_firing 1" in (
        pkg.metrics.default_registry().render())


def test_alert_clear_and_reraise_cycle_counts_and_journals(
        pkg, alerts_on, monkeypatch, tmp_path):
    monkeypatch.setenv("EDL_EVENTS_DIR", str(tmp_path))
    pkg.events._reset_for_tests()
    pkg.events.configure("master")
    fleet, blob = _fleet(pkg, version_lag_max=10), pkg.pb.TelemetryBlob
    fleet.observe(-1, blob(role="ps-0", version_lag=50))
    assert [a["alert"] for a in fleet.evaluate()] == ["version_lag"]
    fleet.observe(-1, blob(role="ps-0", version_lag=0))
    assert fleet.evaluate() == []
    fleet.observe(-1, blob(role="ps-0", version_lag=80))
    assert [a["alert"] for a in fleet.evaluate()] == ["version_lag"]
    assert alerts_on().get("version_lag") == 2
    lines = []
    for path in tmp_path.glob("*.events.ndjson"):
        lines += _read_journal(path)
    edges = [(e["event"], e["alert"]) for e in lines
             if e["event"] in ("alert_raised", "alert_cleared")]
    assert edges == [("alert_raised", "version_lag"),
                     ("alert_cleared", "version_lag"),
                     ("alert_raised", "version_lag")]


def test_straggler_clear_and_reraise_cycle(pkg, alerts_on):
    fleet, blob = _fleet(pkg, straggler_factor=2.0), pkg.pb.TelemetryBlob
    for wid, ewma in ((0, 0.1), (1, 0.1), (2, 0.9)):
        fleet.observe(wid, blob(step_time_ewma=ewma))
    assert [a["alert"] for a in fleet.evaluate()] == ["straggler"]
    fleet.observe(2, blob(step_time_ewma=0.11))
    assert fleet.evaluate() == []
    fleet.observe(2, blob(step_time_ewma=0.95))
    assert [a["alert"] for a in fleet.evaluate()] == ["straggler"]
    assert alerts_on().get("straggler") == 2


def test_health_detectors_raise_and_clear(pkg, alerts_on):
    fleet, blob = _fleet(pkg, health_alert_secs=0.2), pkg.pb.TelemetryBlob
    fleet.observe(0, blob(role="worker-0", health_nonfinite_batches=1,
                          health_nonfinite_streak=1))
    fleet.observe(1, blob(role="worker-1", health_loss_spikes=1,
                          health_grad_explosions=1))
    assert {a["alert"] for a in fleet.evaluate()} == {
        "nonfinite_loss", "loss_spike", "grad_explosion"}
    time.sleep(0.3)
    fleet.observe(0, blob(role="worker-0", health_nonfinite_batches=1,
                          health_nonfinite_streak=1))
    assert {a["alert"] for a in fleet.evaluate()} == {"nonfinite_loss"}
    fleet.observe(0, blob(role="worker-0", health_nonfinite_batches=1))
    time.sleep(0.3)
    assert fleet.evaluate() == []
    fleet.observe(1, blob(role="worker-1", health_loss_spikes=2,
                          health_grad_explosions=1))
    assert [a["alert"] for a in fleet.evaluate()] == ["loss_spike"]
    counter = alerts_on()
    assert counter.get("loss_spike") == 2
    assert counter.get("nonfinite_loss") == 1
    assert counter.get("grad_explosion") == 1


def test_label_shift_detector_tags_the_window(pkg):
    fleet = _fleet(pkg, health_alert_secs=0.2, label_shift_delta=0.1,
                   id_novelty_max=0.8)
    for i in range(6):
        fleet.observe_stream_window(128 * (i + 1), 0.5, 0.2)
    assert fleet.evaluate() == []
    fleet.observe_stream_window(896, 0.85, 0.2)
    firing = fleet.evaluate()
    assert [a["alert"] for a in firing] == ["label_shift"]
    assert firing[0]["watermark"] == 896
    assert firing[0]["reason"] == "label_rate"
    time.sleep(0.3)
    assert fleet.evaluate() == []
    fleet.observe_stream_window(1024, 0.5, 0.95)
    firing = fleet.evaluate()
    assert firing and firing[0]["reason"] == "id_novelty"


def test_device_detectors_raise_and_clear(pkg):
    """recompile_storm on recompiles moving within the window,
    hbm_pressure on bytes in use over the reported limit (a 0 limit
    never fires)."""
    fleet = _fleet(pkg, recompile_storm_min=3, recompile_storm_secs=0.2,
                   hbm_pressure_max=0.9)
    blob = pkg.pb.TelemetryBlob
    fleet.observe(0, blob(role="worker-0", xla_recompiles=0,
                          hbm_bytes_in_use=95, hbm_limit_bytes=100))
    fleet.observe(1, blob(role="worker-1", hbm_bytes_in_use=10 ** 9))
    assert [a["alert"] for a in fleet.evaluate()] == ["hbm_pressure"]
    fleet.observe(0, blob(role="worker-0", xla_recompiles=4,
                          hbm_bytes_in_use=50, hbm_limit_bytes=100))
    assert [a["alert"] for a in fleet.evaluate()] == ["recompile_storm"]
    time.sleep(0.3)
    assert fleet.evaluate() == []


def test_statusz_health_section(pkg):
    fleet, blob = _fleet(pkg), pkg.pb.TelemetryBlob
    fleet.observe(0, blob(role="worker-0", health_loss_ewma=0.69,
                          health_nonfinite_batches=2,
                          health_skipped_batches=1))
    fleet.observe(-1, blob(role="ps-0", ps_row_norm_p50=0.07,
                           ps_row_norm_p99=1.2, ps_dead_row_fraction=0.25,
                           ps_exploding_rows=3))
    fleet.observe_stream_window(512, 0.4, 0.1)
    body = fleet.snapshot()
    json.dumps(body)
    health = body["health"]
    assert health["workers"]["worker-0"]["health_nonfinite_batches"] == 2
    assert health["workers"]["worker-0"]["health_skipped_batches"] == 1
    assert health["ps"]["ps-0"]["ps_exploding_rows"] == 3
    assert health["ps"]["ps-0"]["ps_dead_row_fraction"] == 0.25
    assert health["stream"]["windows"] == 1
    assert body["thresholds"]["health_alert_secs"] == 30.0


def test_snapshot_carries_fleet_and_extras(pkg):
    fleet = _fleet(pkg)
    fleet.observe(0, pkg.pb.TelemetryBlob(role="worker-0",
                                          step_time_ewma=0.25,
                                          model_version=12))
    body = fleet.snapshot(extra={"tasks": {"pending": 3}})
    json.dumps(body)
    entry = body["fleet"]["worker-0"]
    assert entry["step_time_ewma"] == pytest.approx(0.25)
    assert entry["model_version"] == 12
    assert body["tasks"] == {"pending": 3}
    assert body["thresholds"]["straggler_factor"] == 3.0


def test_drained_worker_never_alerts(pkg, alerts_on):
    fleet = _fleet(pkg, dead_air_secs=0.05)
    fleet.observe(4, pkg.pb.TelemetryBlob(role="worker-4"))
    fleet.mark_draining(4)
    time.sleep(0.1)
    assert fleet.evaluate() == []  # draining: quiet on purpose
    fleet.mark_drained(4, reason="sigterm")
    assert fleet.evaluate() == []
    assert fleet.snapshot()["drained"]["worker-4"]["reason"] == "sigterm"
    assert alerts_on().get("dead_air") == 0


def test_statusz_and_alerts_served_over_http(pkg):
    server = pkg.http_server.ObservabilityServer(
        "master", 0, registry=pkg.metrics.Registry(enabled=True)).start()
    try:
        fleet = _fleet(pkg, dead_air_secs=0.01)
        fleet.observe(3, pkg.pb.TelemetryBlob(role="worker-3"))
        server.add_json_handler("/statusz", fleet.snapshot)
        server.add_json_handler("/alerts", fleet.alerts)
        time.sleep(0.05)
        base = "http://localhost:%d" % server.port
        status, body = _get(base + "/statusz")
        assert status == 200 and "worker-3" in json.loads(body)["fleet"]
        status, body = _get(base + "/alerts")
        assert status == 200
        assert [a["alert"] for a in json.loads(body)] == ["dead_air"]
        server.add_json_handler("/boom", lambda: 1 / 0)
        assert _get(base + "/boom")[0] == 500
        assert _get(base + "/healthz")[0] == 200
    finally:
        server.stop()


class _Clock:
    def __init__(self, start):
        self.now = float(start)

    def time(self):
        return self.now

    def monotonic(self):
        return self.now

    def step(self, secs):
        self.now += secs


_FLEET_KNOBS = dict(straggler_factor=2.5, dead_air_secs=6.0,
                    stuck_round_secs=5.0, version_lag_max=40,
                    health_alert_secs=4.0, label_shift_delta=0.12,
                    id_novelty_max=0.85, recompile_storm_min=3,
                    recompile_storm_secs=5.0, hbm_pressure_max=0.9)


def _fleet_ops(seed, n_ops=240):
    """A seeded sequence of fleet operations, as plain tuples."""
    rng = np.random.RandomState(seed)
    workers, ps = [0, 1, 2, 3], [-1, -2]
    tallies = {w: dict(health_nonfinite_batches=0, health_loss_spikes=0,
                       health_grad_explosions=0, xla_recompiles=0,
                       circuit_open_count=0) for w in workers}
    ps_tallies = {p: dict(ps_overload_rejections=0, version=0)
                  for p in ps}
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(
            ["worker", "ps", "tick", "dead", "drain", "forget", "window"],
            p=[0.42, 0.2, 0.2, 0.04, 0.04, 0.03, 0.07])
        if kind == "worker":
            w = int(rng.choice(workers))
            t = tallies[w]
            for key in t:
                if rng.rand() < 0.12:
                    t[key] += int(rng.randint(1, 4))
            fields = dict(
                role="worker-%d" % w,
                step_time_ewma=float(
                    rng.choice([0.05, 0.06, 0.07, 0.5])),
                examples_per_sec=float(rng.randint(100, 1000)),
                model_version=int(rng.randint(0, 500)),
                health_nonfinite_streak=int(rng.rand() < 0.05),
                health_loss_ewma=float(rng.rand()),
                hbm_bytes_in_use=int(rng.randint(0, 100)),
                hbm_limit_bytes=int(rng.choice([0, 100])),
                tier_hits=int(rng.randint(0, 10 ** 6)),
                tier_misses=int(rng.randint(0, 10 ** 6)),
                **t)
            ops.append(("observe", w, fields))
        elif kind == "ps":
            p = int(rng.choice(ps))
            t = ps_tallies[p]
            if rng.rand() < 0.6:
                t["version"] += int(rng.randint(1, 5))
            if rng.rand() < 0.15:
                t["ps_overload_rejections"] += 1
            fields = dict(
                role="ps-%d" % (-p - 1),
                push_rate=float(rng.rand() * 50),
                pull_rate=float(rng.rand() * 50),
                version_lag=int(rng.choice([0, 3, 60])),
                model_version=t["version"],
                round_buffer_fill=int(rng.choice([0, 0, 1, 2])),
                ps_overload_rejections=t["ps_overload_rejections"],
                push_bytes=int(rng.randint(10 ** 6)),
                pull_bytes=int(rng.randint(10 ** 6)))
            ops.append(("observe", p, fields))
        elif kind == "tick":
            ops.append(("tick", float(rng.choice([0.5, 1.0, 2.5, 7.0]))))
        elif kind == "dead":
            ops.append(("mark_dead", int(rng.choice(workers))))
        elif kind == "drain":
            w = int(rng.choice(workers))
            ops.append(("mark_draining", w))
            if rng.rand() < 0.6:
                ops.append(("mark_drained", w, "sigterm"))
        elif kind == "forget":
            ops.append(("forget", int(rng.choice(workers + ps))))
        else:
            ops.append(("window", int(rng.randint(10 ** 5)),
                        float(rng.choice([0.5, 0.52, 0.48, 0.9])),
                        float(rng.choice([0.2, 0.3, 0.95]))))
    return ops


def _run_fleet(pkg, ops, journal_dir, monkeypatch):
    """Drive one package's FleetMonitor through ``ops`` under a fake
    clock; returns (alerts after each op, snapshots, counter values,
    journal lines without their timestamps)."""
    clock = _Clock(1_000_000.0)
    monkeypatch.setattr(pkg.fleet, "time", types.SimpleNamespace(
        time=clock.time, monotonic=clock.monotonic))
    monkeypatch.setenv("EDL_METRICS", "1")
    monkeypatch.setenv(pkg.events.EVENTS_DIR_ENV, str(journal_dir))
    pkg.metrics.reset_default_registry()
    pkg.events._reset_for_tests()
    journal = pkg.events.configure("master")
    fleet = pkg.fleet.FleetMonitor(**_FLEET_KNOBS)
    alerts, snaps = [], []
    for op in ops:
        if op[0] == "observe":
            fleet.observe(op[1], pkg.pb.TelemetryBlob(**op[2]))
        elif op[0] == "tick":
            clock.step(op[1])
        elif op[0] == "window":
            fleet.observe_stream_window(*op[1:])
        else:
            getattr(fleet, op[0])(*op[1:])
        alerts.append(fleet.evaluate())
        snaps.append(json.dumps(fleet.snapshot(), sort_keys=True))
    counter = pkg.metrics.default_registry().get("edl_master_alerts_total")
    counts = {kind: counter.get(kind) for kind in pkg.fleet.ALERT_KINDS}
    lines = []
    for record in _read_journal(journal.path):
        record.pop("ts")
        lines.append(record)
    pkg.events._reset_for_tests()
    pkg.metrics.reset_default_registry()
    return alerts, snaps, counts, lines


def test_fleet_monitors_agree_over_a_seeded_sequence(tmp_path, monkeypatch):
    ops = _fleet_ops(seed=11)
    assert len(ops) >= 200
    ref = _run_fleet(Pkg("ref"), ops, tmp_path / "ref", monkeypatch)
    port = _run_fleet(Pkg("port"), ops, tmp_path / "port", monkeypatch)
    ref_alerts, ref_snaps, ref_counts, ref_lines = ref
    port_alerts, port_snaps, port_counts, port_lines = port
    for i, (a, b) in enumerate(zip(ref_alerts, port_alerts)):
        assert a == b, (i, ops[i])
    for i, (a, b) in enumerate(zip(ref_snaps, port_snaps)):
        assert a == b, (i, ops[i])
    assert port_counts == ref_counts
    assert port_lines == ref_lines
    # the sequence reaches every detector
    assert set(k for k, n in port_counts.items() if n) == set(
        Pkg("port").fleet.ALERT_KINDS), port_counts
    assert {e["event"] for e in port_lines} >= {"alert_raised",
                                                "alert_cleared"}


# ---------------------------------------------------------------------------
# telemetry piggyback: the master's ingestion, the PS's production


def test_servicer_feeds_fleet_from_piggybacked_blobs(pkg):
    fleet = _fleet(pkg)
    dispatcher = pkg.mod("master.task_dispatcher").TaskDispatcher(
        {"s": (0, 64)}, records_per_task=32)
    servicer = pkg.mod("master.servicer").MasterServicer(
        dispatcher, fleet_monitor=fleet)
    servicer.get_task(pkg.pb.GetTaskRequest(
        worker_id=0, telemetry=pkg.pb.TelemetryBlob(role="worker-0",
                                                    step_time_ewma=0.5)))
    servicer.report_task_result(
        pkg.pb.ReportTaskResultRequest(task_id=1, worker_id=5))
    snap = fleet.snapshot()
    assert snap["fleet"]["worker-0"]["step_time_ewma"] == pytest.approx(0.5)
    assert "worker-5" in snap["fleet"]


def test_deregister_folds_the_final_blob_and_leaves_no_alert(pkg):
    fleet = _fleet(pkg, dead_air_secs=0.05)
    dispatcher = pkg.mod("master.task_dispatcher").TaskDispatcher(
        {"s": (0, 64)}, records_per_task=32)
    servicer = pkg.mod("master.servicer").MasterServicer(
        dispatcher, fleet_monitor=fleet)
    servicer.get_task(pkg.pb.GetTaskRequest(worker_id=2))
    servicer.deregister_worker(pkg.pb.DeregisterWorkerRequest(
        worker_id=2, reason="sigterm",
        telemetry=pkg.pb.TelemetryBlob(role="worker-2", model_version=9)))
    time.sleep(0.1)
    assert fleet.evaluate() == []
    assert "worker-2" not in fleet.snapshot()["fleet"]


def _sync_ps_servicer(pkg, grads_to_wait=2):
    store = pkg.mod("ps.embedding_store").create_store(
        seed=0, prefer_native=False)
    store.set_optimizer("sgd", lr=0.1)
    store.create_table("emb", 4, init_scale=0.05)
    return pkg.mod("ps.servicer").PserverServicer(
        store, use_async=False, grads_to_wait=grads_to_wait)


def _push_request(pkg, version, worker_id=None):
    request = pkg.pb.PushGradientsRequest()
    request.gradients.version = version
    slices = request.gradients.embedding_tables["emb"]
    pkg.mod("common.tensor_utils").ndarray_to_blob(
        np.ones((2, 4), np.float32), slices.concat_tensors)
    slices.ids.extend([0, 1])
    if worker_id is not None:
        request.worker_id = worker_id
    return request


def test_ps_telemetry_blob_reports_rates_and_fill(pkg):
    servicer = _sync_ps_servicer(pkg)
    first = servicer.telemetry_blob()
    assert first.role == "ps-0" and first.push_rate == 0.0
    servicer.push_gradients(_push_request(pkg, version=0, worker_id=1))
    blob = servicer.telemetry_blob()
    assert blob.round_buffer_fill == 1
    assert blob.push_rate > 0 and blob.model_version == 0


def _ps_ops(pkg):
    """One operation sequence on an async PS (numpy store): table
    registration, pulls (single and fused), pushes, a writeback."""
    servicer = _sync_ps_servicer(pkg, grads_to_wait=1)
    pb = pkg.pb
    tensor_utils = pkg.mod("common.tensor_utils")
    infos = pb.Model()
    infos.embedding_table_infos.add(name="emb2", dim=8, initializer="0.05")
    servicer.push_embedding_table_infos(infos)
    rng = np.random.RandomState(3)
    for step in range(6):
        ids = np.unique(rng.randint(0, 50, size=12)).astype(np.int64)
        servicer.pull_embedding_vectors(pb.PullEmbeddingVectorsRequest(
            name="emb", ids_blob=ids.astype("<i8").tobytes()))
        batch = pb.BatchedSlices()
        batch.tables["emb2"].ids_blob = ids.astype("<i8").tobytes()
        servicer.pull_embedding_batch(batch)
        request = pb.PushGradientsRequest()
        request.gradients.version = step
        slices = request.gradients.embedding_tables["emb"]
        tensor_utils.ndarray_to_blob(
            rng.randn(ids.size, 4).astype(np.float32),
            slices.concat_tensors)
        slices.ids_blob = ids.astype("<i8").tobytes()
        servicer.push_gradients(request)
    rows = pb.Model()
    slices = rows.embedding_tables["emb2"]
    tensor_utils.ndarray_to_blob(np.ones((3, 8), np.float32),
                                 slices.concat_tensors)
    slices.ids_blob = np.arange(3, dtype="<i8").tobytes()
    servicer.push_embedding_rows(rows)
    return servicer.telemetry_blob()


def test_ps_telemetry_blob_agrees_across_packages():
    ref, port = _ps_ops(Pkg("ref")), _ps_ops(Pkg("port"))
    for field in ("push_bytes", "pull_bytes", "model_version",
                  "version_lag", "round_buffer_fill", "ps_native_store",
                  "ps_overload_rejections", "ps_pending_applies"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.push_bytes > 0 and port.pull_bytes > 0


def test_sync_round_lifecycle_is_journaled(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv(pkg.events.EVENTS_DIR_ENV, str(tmp_path))
    journal = pkg.events.configure("ps-0")
    servicer = _sync_ps_servicer(pkg)
    servicer.push_gradients(_push_request(pkg, version=0, worker_id=0))
    servicer.push_gradients(_push_request(pkg, version=0, worker_id=1))
    servicer.push_gradients(_push_request(pkg, version=0, worker_id=0))
    assert [r["event"] for r in _read_journal(journal.path)] == [
        "round_open", "round_fill", "round_fill", "round_close",
        "stale_push_rejected"]


def test_ps_checkpoint_series_and_event(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("EDL_METRICS", "1")
    monkeypatch.setenv("EDL_CKPT_ASYNC", "0")
    monkeypatch.setenv(pkg.events.EVENTS_DIR_ENV, str(tmp_path / "ev"))
    pkg.metrics.reset_default_registry()
    journal = pkg.events.configure("ps-0")
    store = pkg.mod("ps.embedding_store").create_store(
        seed=0, prefer_native=False)
    store.set_optimizer("sgd", lr=0.1)
    store.create_table("emb", 4, init_scale=0.05)
    saver = pkg.mod("ps.checkpoint").SparseCheckpointSaver(
        str(tmp_path / "ckpt"), shard_id=0, shard_num=1)
    servicer = pkg.mod("ps.servicer").PserverServicer(
        store, checkpoint_saver=saver, checkpoint_steps=2, use_async=True)
    for version in range(4):
        servicer.push_gradients(_push_request(pkg, version=version))
    text = pkg.metrics.default_registry().render()
    assert 'edl_ps_checkpoint_seconds_count{kind="full"} 1' in text
    assert 'edl_ps_checkpoint_seconds_count{kind="delta"} 1' in text
    assert "edl_ps_ckpt_chain_len 1" in text
    saved = [r for r in _read_journal(journal.path)
             if r["event"] == "checkpoint_saved"]
    assert [(r["version"], r["mode"]) for r in saved] == [
        (2, "full"), (4, "delta")]
    blob = servicer.telemetry_blob()
    assert blob.ps_ckpt_chain_len == 1 and blob.ps_ckpt_dirty_rows >= 1


def test_ps_model_initialized_transitions(pkg):
    store = pkg.mod("ps.embedding_store").create_store(
        seed=0, prefer_native=False)
    store.set_optimizer("sgd", lr=1.0)
    servicer = pkg.mod("ps.servicer").PserverServicer(store, use_async=True)
    assert not servicer.model_initialized()
    infos = pkg.pb.Model()
    infos.embedding_table_infos.add(name="emb", dim=4, initializer="0.05")
    servicer.push_embedding_table_infos(infos)
    assert servicer.model_initialized()


def test_ps_dense_init_also_flips_ready(pkg):
    store = pkg.mod("ps.embedding_store").create_store(
        seed=0, prefer_native=False)
    store.set_optimizer("sgd", lr=1.0)
    servicer = pkg.mod("ps.servicer").PserverServicer(store, use_async=True)
    assert not servicer.model_initialized()
    request = pkg.pb.Model(version=0)
    pkg.mod("common.tensor_utils").ndarray_to_blob(
        np.ones((2, 2), np.float32), request.dense_parameters["w"])
    servicer.push_model(request)
    assert servicer.model_initialized()


def test_dispatcher_stats_track_lifecycle(pkg):
    dispatcher = pkg.mod("master.task_dispatcher").TaskDispatcher(
        {"s": (0, 64)}, records_per_task=32)
    stats = dispatcher.stats()
    assert stats["pending"] == {"training": 2}
    assert stats["queue_depth"] == {"training": 2, "evaluation": 0}
    task = dispatcher.get(worker_id=0)
    stats = dispatcher.stats()
    assert stats["pending"] == {"training": 1}
    assert stats["doing"] == {"training": 1}
    dispatcher.report(task.task_id, success=True, worker_id=0)
    stats = dispatcher.stats()
    assert stats["done"] == {"training": 1} and stats["doing"] == {}


def test_timing_bridge_feeds_phase_metrics(pkg, monkeypatch):
    monkeypatch.setenv("EDL_METRICS", "1")
    monkeypatch.delenv("EDL_TIMING", raising=False)
    pkg.metrics.reset_default_registry()
    timing = pkg.mod("common.timing_utils").Timing()
    assert not timing.enabled
    t0 = timing.start()
    timing.end_record("batch_process", t0)
    assert timing.last_seconds["batch_process"] >= 0
    text = pkg.metrics.default_registry().render()
    assert 'edl_phase_seconds_count{phase="batch_process"} 1' in text
    assert "edl_step_time_seconds" in text


def test_master_serves_statusz_alerts_and_task_gauges(tmp_path, monkeypatch):
    """The port's Master with a metrics port: /statusz carries the
    fleet snapshot and the task queue, /alerts the firing detectors,
    /metrics the task gauges; role_start and role_stop are journaled."""
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.observability import events, metrics
    from tests.test_utils import create_ctr_recordio

    train = tmp_path / "train"
    train.mkdir()
    create_ctr_recordio(str(train / "f0.rec"), num_records=64,
                        num_features=4, seed=0)
    monkeypatch.setenv("EDL_EVENTS_DIR", str(tmp_path / "ev"))
    metrics_port = find_free_port()
    # what the constructor would publish, undone with the test
    monkeypatch.setenv("EDL_METRICS_PORT", str(metrics_port))
    metrics.reset_default_registry()
    master = Master("elasticdl_tpu_torch.models.deepfm",
                    training_data=str(train), records_per_task=32,
                    port=find_free_port(), task_timeout_secs=5.0,
                    metrics_port=metrics_port)
    try:
        master.prepare()
        master.fleet_monitor.observe(
            0, Pkg("port").pb.TelemetryBlob(role="worker-0",
                                            step_time_ewma=0.2))
        base = "http://localhost:%d" % metrics_port
        status, body = _get(base + "/statusz")
        snap = json.loads(body)
        assert status == 200 and "worker-0" in snap["fleet"]
        assert snap["tasks"]["pending"] == {"training": 2}
        status, body = _get(base + "/alerts")
        assert status == 200 and json.loads(body) == []
        status, body = _get(base + "/metrics")
        assert ('edl_master_tasks{state="pending",type="training"} 2'
                in body)
        assert _get(base + "/readyz")[0] == 200
    finally:
        master.stop()
        metrics.reset_default_registry()
    journal = next((tmp_path / "ev").glob("*.events.ndjson"))
    kinds = [r["event"] for r in _read_journal(journal)]
    assert kinds[0] == "role_start" and kinds[-1] == "role_stop"
    events._reset_for_tests()


# ---------------------------------------------------------------------------
# the worker's telemetry: one DeepFM job with the device tier on, per
# package, the reference worker's initial weights carried across

TIER_ENV = {"EDL_DEVICE_TIER": "1", "EDL_DEVICE_TIER_ROWS": "96",
            "EDL_DEVICE_TIER_PROMOTE": "1", "EDL_DEVICE_TIER_STAGE": "64",
            "EDL_DEVICE_TIER_TTL": "4"}


def _tier_job(side, train_dir, flat_params):
    """One DeepFM job over two in-process gRPC PS (native stores, seed =
    ps_id, adam eps 1e-3) and one sequential worker with the tier on;
    returns (the worker's blob, the PS servicers' blobs, the tier's
    stats)."""
    from tests import test_torch_job as job

    ref = side == "ref"
    pkg = Pkg(side)
    reader_cls = pkg.mod("data.readers").RecordIODataReader
    dispatcher = pkg.mod("master.task_dispatcher").TaskDispatcher(
        training_shards=reader_cls(data_dir=train_dir).create_shards(),
        records_per_task=64, num_epochs=1, seed=0)
    services = pkg.mod("proto.services")
    servers, ps_addrs, ps_servicers = [], [], []
    master, addr = job._serve(
        services.add_master_servicer_to_server,
        pkg.mod("master.servicer").MasterServicer(dispatcher))
    servers.append(master)
    for ps_id in range(2):
        store = pkg.mod("ps.embedding_store").NativeEmbeddingStore(
            seed=ps_id)
        store.set_optimizer("adam", lr=0.01, epsilon=job.ADAM_EPS)
        ps = pkg.mod("ps.servicer").PserverServicer(store, ps_id=ps_id)
        server, ps_addr = job._serve(
            services.add_pserver_servicer_to_server, ps)
        servers.append(server)
        ps_addrs.append(ps_addr)
        ps_servicers.append(ps)
    opt = pkg.mod("train.optimizers").create_optimizer(
        "Adam", learning_rate=0.001, epsilon=job.ADAM_EPS)

    def factory(model, loss_fn, optimizer, specs, ps_client, **kw):
        if not ref:
            model.load_state_dict(
                job.deepfm.params_from_flax(flat_params))
        return pkg.mod("train.sparse").SparseTrainer(
            model=model, loss_fn=loss_fn, optimizer=opt, specs=specs,
            ps_client=ps_client, health=False, **kw)

    kwargs = dict(minibatch_size=32, wait_sleep_secs=0.1,
                  ps_addrs=ps_addrs, trainer_factory=factory)
    if not ref:
        kwargs["device"] = "cpu"
    zoo = "elasticdl_tpu.models.deepfm" if ref else job.PORT_ZOO
    try:
        client = pkg.mod("worker.master_client").MasterClient(
            addr, worker_id=0)
        worker = pkg.mod("worker.worker").Worker(
            client, zoo, reader_cls(data_dir=train_dir), **kwargs)
        worker.run()
        assert dispatcher.finished() and worker.model_version == 8
        blob = worker._telemetry_blob()
        stats = worker.trainer.device_tier.stats()
        ps_blobs = [ps.telemetry_blob() for ps in ps_servicers]
    finally:
        for server in servers:
            server.stop(None)
    return blob, ps_blobs, stats


def test_worker_and_ps_telemetry_agree_across_packages(tmp_path,
                                                       monkeypatch):
    from tests import test_torch_job as job

    for key, value in TIER_ENV.items():
        monkeypatch.setenv(key, value)
    train_dir, _ = job._ctr_dirs(tmp_path)
    flat = job._ref_initial_params(train_dir)
    ref_blob, ref_ps, ref_stats = _tier_job("ref", train_dir, flat)
    port_blob, port_ps, port_stats = _tier_job("port", train_dir, flat)
    for field in ("tier_hits", "tier_misses", "tier_evictions",
                  "model_version"):
        assert getattr(port_blob, field) == getattr(ref_blob, field), field
    assert port_blob.tier_hits > 0 and port_blob.tier_evictions > 0
    assert port_blob.tier_hits + port_blob.tier_misses == (
        port_stats["hits"] + port_stats["misses"])
    assert port_blob.role == ref_blob.role == "worker-0"
    for ref_b, port_b in zip(ref_ps, port_ps):
        assert port_b.push_bytes == ref_b.push_bytes > 0
        assert port_b.pull_bytes == ref_b.pull_bytes > 0
        assert port_b.model_version == ref_b.model_version
    # the port worker's blob carries the device section: the CPU path
    # has no allocator, so 0 bytes; the tier's own bytes are known
    assert port_blob.hbm_bytes_in_use == 0
    assert port_blob.tier_hbm_bytes > 0
    assert port_blob.d2h_bytes > 0


def test_worker_telemetry_reaches_the_fleet_and_metrics(tmp_path,
                                                         monkeypatch):
    """A port job with the tier on and metrics collection enabled: the
    master's fleet view holds the worker's and both PS's blobs, and
    the worker's tier series equal its tier's tallies."""
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.data.readers import RecordIODataReader
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.observability import metrics
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.worker import Worker
    from tests import test_torch_job as job

    for key, value in TIER_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("EDL_METRICS", "1")
    metrics.reset_default_registry()
    train_dir, _ = job._ctr_dirs(tmp_path)
    master = Master(job.PORT_ZOO, training_data=train_dir,
                    records_per_task=64, port=find_free_port(), seed=0,
                    task_timeout_secs=30.0).prepare()
    servers, ps_addrs = job._ps_pair()
    try:
        addr = "localhost:%d" % master._port
        for shard, ps_addr in enumerate(ps_addrs):
            # the PS's master poll, as ps/server.py makes it
            poll = MasterClient(addr, worker_id=-(shard + 1))
            poll.get_comm_info()
            poll.close()
        worker = Worker(MasterClient(addr, worker_id=0), job.PORT_ZOO,
                        RecordIODataReader(data_dir=train_dir),
                        minibatch_size=32, wait_sleep_secs=0.1,
                        ps_addrs=ps_addrs, device="cpu")
        worker.run()
        snap = master.fleet_monitor.snapshot()
        entry = snap["fleet"]["worker-0"]
        stats = worker.trainer.device_tier.stats()
        assert entry["model_version"] == worker.model_version == 8
        assert entry["step_time_ewma"] > 0 and entry["examples_per_sec"] > 0
        assert entry["tier_hits"] + entry["tier_misses"] == (
            stats["hits"] + stats["misses"])
        assert "ps-0" in snap["fleet"] and "ps-1" in snap["fleet"]
        reg = metrics.default_registry()
        hits = reg.get("edl_device_tier_hits_total")
        misses = reg.get("edl_device_tier_misses_total")
        tables = ("deepfm_emb", "deepfm_linear")
        assert sum(hits.get(t) + misses.get(t) for t in tables) == (
            stats["hits"] + stats["misses"])
        assert reg.get("edl_worker_model_version").get() == 8
    finally:
        master.stop()
        for server in servers:
            server.stop(None)
        metrics.reset_default_registry()
