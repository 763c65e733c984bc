"""The port's host stack sampler against the reference's, on the CPU.

Mirrors tests/test_profiler.py: the disabled sampler is inert, samples
land on hot frames and never on the sampler itself, the ring and its
buckets stay bounded, samples inside trace spans carry the span's
segment and trace id, ``/profilez`` serves the ring, a window capture
and the collapsed text, and a capture is journaled. Each scenario runs
against both packages (``pkg``): the module imports no JAX. The
reference's ``test_sampler_never_samples_itself`` samples for a fixed
0.4 s; this mirror waits for a sample count under a deadline instead.
The report scripts read the port's captures as they read the
reference's.
"""

import importlib
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import critical_path  # noqa: E402
import profile_report  # noqa: E402

PACKAGES = {"ref": "elasticdl_tpu", "port": "elasticdl_tpu_torch"}


class Pkg:
    def __init__(self, side):
        self.side = side
        self.root = PACKAGES[side]

    def mod(self, name):
        return importlib.import_module("%s.%s" % (self.root, name))

    @property
    def profiler(self):
        return self.mod("observability.profiler")

    @property
    def trace(self):
        return self.mod("observability.trace")

    @property
    def metrics(self):
        return self.mod("observability.metrics")

    def server(self, role):
        return self.mod("observability.http_server").ObservabilityServer(
            role, 0)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request, monkeypatch):
    """One package, no EDL_PROF_HZ inherited, no sampler left after."""
    side = Pkg(request.param)
    monkeypatch.delenv(side.profiler.HZ_ENV, raising=False)
    yield side
    side.profiler._reset_for_tests()
    side.trace._reset_for_tests()


def _get(url):
    try:
        response = urllib.request.urlopen(url, timeout=5)
        return response.status, response.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _burn_thread(trace, stop, span_names=()):
    """A busy thread with a recognizable hot frame, optionally inside
    (nested) trace spans; numpy releases the GIL so samples land."""

    def burn_hot_loop(a):
        return np.linalg.svd(a)[0]

    def run():
        a = np.random.rand(150, 150)
        while not stop.is_set():
            if span_names:
                with trace.root_span(span_names[0], role="worker"):
                    if len(span_names) > 1:
                        with trace.span(span_names[1], role="ps"):
                            burn_hot_loop(a)
                    else:
                        burn_hot_loop(a)
            else:
                burn_hot_loop(a)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def _wait_for_samples(sampler, minimum=5, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        snap = sampler.snapshot()
        if snap["samples"] >= minimum:
            return snap
        time.sleep(0.05)
    return sampler.snapshot()


# ---------------------------------------------------------------------------
# disabled = provably inert


def test_disabled_is_provably_inert(pkg):
    profiler = pkg.profiler
    assert profiler.configured_hz() == 0.0
    assert profiler.maybe_start("worker-0") is None
    assert profiler.sampler() is None and not profiler.enabled()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("edl-prof") and t.is_alive()]


def test_profilez_404_when_disabled(pkg):
    server = pkg.server("worker-0").start()
    try:
        status, body = _get("http://localhost:%d/profilez" % server.port)
        assert status == 404
        assert "disabled" in body and "EDL_PROF_HZ" in body
    finally:
        server.stop()


def test_bad_hz_values_disable(pkg, monkeypatch):
    for bad in ("banana", "-3", "0"):
        monkeypatch.setenv(pkg.profiler.HZ_ENV, bad)
        assert pkg.profiler.configured_hz() == 0.0
        assert pkg.profiler.maybe_start("x") is None


# ---------------------------------------------------------------------------
# sampling


def test_sampler_collects_hot_frames(pkg):
    sampler = pkg.profiler.StackSampler("worker-0", hz=200)
    sampler.start()
    stop = threading.Event()
    thread = _burn_thread(pkg.trace, stop)

    def hot(snap):
        return any("burn_hot_loop" in f
                   for e in snap["stacks"] for f in e["stack"])

    try:
        # wait for what is asserted: the first five samples may all
        # predate the burn thread's first call under a loaded host
        deadline = time.time() + 10.0
        snap = _wait_for_samples(sampler)
        while not hot(snap) and time.time() < deadline:
            time.sleep(0.05)
            snap = sampler.snapshot()
    finally:
        stop.set()
        thread.join()
        sampler.stop()
    assert snap["samples"] >= 5
    assert snap["role"] == "worker-0" and snap["hz"] == 200
    frames = [f for e in snap["stacks"] for f in e["stack"]]
    assert any("burn_hot_loop" in f for f in frames), frames


def test_sampler_never_samples_itself(pkg):
    """Samples of the (sleeping) test thread accumulate up to a count
    under a deadline, read off the buckets' tallies so the wait itself
    runs no profiler code; none of the samples is of the sampler's own
    thread (its loop). The test thread may be caught inside ``stop()``
    while the sampler takes its last sample: that frame is the test
    thread's, not the sampler's."""
    sampler = pkg.profiler.StackSampler("w", hz=400)
    sampler.start()
    try:
        deadline = time.time() + 20.0
        while time.time() < deadline:
            buckets = list(sampler._ring) + [sampler._current]
            if sum(agg.samples for agg in buckets) >= 40:
                break
            time.sleep(0.02)
    finally:
        sampler.stop()
    snap = sampler.snapshot()
    assert snap["samples"] >= 40
    for entry in snap["stacks"]:
        assert not any(
            "observability.profiler:StackSampler._run" in frame
            or "observability.profiler:StackSampler._sample_once" in frame
            for frame in entry["stack"]), entry
        # outside the start/stop calls the test thread ran no profiler
        # code either
        inside = [f for f in entry["stack"]
                  if "observability.profiler" in f]
        assert all(f.endswith((":StackSampler.stop",
                               ":StackSampler.start")) for f in inside), (
            entry)


def test_stop_joins_the_thread(pkg):
    sampler = pkg.profiler.StackSampler("w", hz=100)
    sampler.start()
    assert sampler.running()
    sampler.stop()
    assert not sampler.running()
    assert not [t for t in threading.enumerate()
                if t.name == "edl-prof-w" and t.is_alive()]


def test_samples_metric_and_overhead_gauge(pkg, monkeypatch):
    monkeypatch.setenv("EDL_METRICS", "1")
    pkg.metrics.reset_default_registry()
    try:
        sampler = pkg.profiler.StackSampler("worker-0", hz=200)
        sampler.start()
        stop = threading.Event()
        thread = _burn_thread(pkg.trace, stop)
        try:
            _wait_for_samples(sampler)
        finally:
            stop.set()
            thread.join()
            sampler.stop()
        registry = pkg.metrics.default_registry()
        assert registry.get("edl_prof_samples_total").get("worker-0") >= 5
        text = registry.render()
        assert 'edl_prof_samples_total{role="worker-0"}' in text
        assert 'edl_prof_overhead_ratio{role="worker-0"}' in text
        assert 0.0 <= sampler.overhead_ratio() < 0.5
    finally:
        pkg.metrics.reset_default_registry()


# ---------------------------------------------------------------------------
# bounded memory under churn


def test_bucket_is_bounded_under_stack_churn(pkg):
    agg = pkg.profiler._Agg()
    for i in range(1000):
        agg.add((None, ("mod:fn_%d" % i,)), None, 16)
    assert len(agg.stacks) == 16
    assert agg.samples == 1000 and agg.overflow == 1000 - 16


def test_ring_rotates_and_stays_bounded(pkg, monkeypatch):
    profiler = pkg.profiler
    monkeypatch.setattr(profiler, "_BUCKET_SECS", 0.05)
    sampler = profiler.StackSampler("w", hz=250, ring_secs=0.2,
                                    max_stacks=8)
    assert sampler._ring.maxlen == 4
    sampler.start()
    stop = threading.Event()
    thread = _burn_thread(pkg.trace, stop)
    try:
        time.sleep(1.0)  # many bucket lifetimes
        with sampler._lock:
            assert len(sampler._ring) <= 4
    finally:
        stop.set()
        thread.join()
        sampler.stop()
    assert sampler.snapshot()["window_secs"] < 0.75


def test_collapsed_rendering_folds_segment_and_overflow(pkg):
    snap = {
        "stacks": [
            {"stack": ["a:f", "b:g"], "count": 3, "segment": "apply",
             "trace_id": "t1"},
            {"stack": ["a:f"], "count": 2, "segment": None,
             "trace_id": None},
        ],
        "overflow": 5,
    }
    assert pkg.profiler.collapsed(snap).splitlines() == [
        "[apply];a:f;b:g 3", "a:f 2", "(overflow) 5"]


def test_collapsed_text_is_byte_equal_across_packages():
    snap = {
        "stacks": [
            {"stack": ["t:run", "w:step"], "count": 7,
             "segment": "compute", "trace_id": "ab"},
            {"stack": ["g:h", "s:apply"], "count": 4, "segment": "apply",
             "trace_id": None},
            {"stack": ["idle:poll"], "count": 2, "segment": None,
             "trace_id": None},
        ],
        "overflow": 3,
    }
    assert Pkg("port").profiler.collapsed(snap) == (
        Pkg("ref").profiler.collapsed(snap))


# ---------------------------------------------------------------------------
# span correlation


def test_segment_mapping_mirrors_critical_path(pkg):
    segment_of_span = pkg.profiler.segment_of_span
    for name, segment in critical_path._SEGMENT_BY_NAME.items():
        assert segment_of_span(name) == segment
    assert segment_of_span("train_batch") == "compute"
    assert segment_of_span("Pserver/push_gradients") == "apply"
    assert segment_of_span("Pserver/pull_embedding_batch") == "pull"
    assert segment_of_span("Master/get_task") == "queue_wait"
    assert segment_of_span("whatever_else") == "other"


def test_samples_inside_spans_are_tagged(pkg, tmp_path, monkeypatch):
    trace = pkg.trace
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path))
    trace.configure("worker-0")
    sampler = pkg.profiler.StackSampler("worker-0", hz=250)
    sampler.start()
    stop = threading.Event()
    thread = _burn_thread(trace, stop,
                          span_names=("train_batch", "ps_apply_push"))
    try:
        deadline = time.time() + 10.0
        segments = set()
        while time.time() < deadline:
            snap = sampler.snapshot()
            segments = {e["segment"] for e in snap["stacks"]}
            if "apply" in segments:
                break
            time.sleep(0.1)
    finally:
        stop.set()
        thread.join()
        sampler.stop()
    assert "apply" in segments, segments
    tagged = [e for e in snap["stacks"] if e["segment"] == "apply"]
    assert any(e["trace_id"] for e in tagged)
    assert trace.profiled_spans() == {}


def test_unmapped_nested_span_inherits_enclosing_publication(
        pkg, tmp_path, monkeypatch):
    trace = pkg.trace
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path))
    trace.configure("worker-0")
    sampler = pkg.profiler.StackSampler("worker-0", hz=5)
    sampler.start()
    ident = threading.get_ident()
    try:
        with trace.root_span("train_batch"):
            with trace.span("ps_push"):
                with trace.span("rpc_attempt", attempt=1):
                    assert trace.profiled_spans()[ident][1] == "ps_push"
            with trace.span("Pserver/push_gradients"):
                with trace.span("ps_apply_round"):
                    published = trace.profiled_spans()[ident]
                    assert published[1] == "Pserver/push_gradients"
                    assert pkg.profiler.segment_of_span(
                        published[1]) == "apply"
            assert trace.profiled_spans()[ident][1] == "train_batch"
    finally:
        sampler.stop()
    assert trace.profiled_spans() == {}


def test_stopped_sampler_freezes_overhead_gauge(pkg, monkeypatch):
    monkeypatch.setenv("EDL_METRICS", "1")
    pkg.metrics.reset_default_registry()
    try:
        sampler = pkg.profiler.StackSampler("w", hz=100)
        sampler.start()
        time.sleep(0.1)
        sampler.stop()
        gauge = pkg.metrics.default_registry().get(
            "edl_prof_overhead_ratio")
        frozen = gauge.get("w")
        assert frozen == sampler.overhead_ratio()
        time.sleep(0.1)
        assert gauge.get("w") == frozen
    finally:
        pkg.metrics.reset_default_registry()


def test_unsampled_spans_are_not_published(pkg, tmp_path, monkeypatch):
    trace = pkg.trace
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(trace.SAMPLE_ENV, "0")
    trace.configure("worker-0")
    trace._profiler_attach()
    try:
        with trace.root_span("train_batch"):
            assert trace.profiled_spans() == {}
    finally:
        trace._profiler_detach()


def test_publication_inert_without_profiler(pkg, tmp_path, monkeypatch):
    trace = pkg.trace
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path))
    trace.configure("worker-0")
    with trace.root_span("train_batch"):
        with trace.span("ps_apply_push"):
            assert trace.profiled_spans() == {}


# ---------------------------------------------------------------------------
# /profilez on every role's daemon


@pytest.mark.parametrize("role", ["master", "ps-0", "worker-0", "serve-0"])
def test_profilez_capture_matches_ring_for_role(pkg, role, monkeypatch):
    profiler = pkg.profiler
    monkeypatch.setenv(profiler.HZ_ENV, "250")
    sampler = profiler.maybe_start(role)
    assert sampler is not None
    server = pkg.server(role).start()
    stop = threading.Event()
    thread = _burn_thread(pkg.trace, stop)
    base = "http://localhost:%d" % server.port
    try:
        _wait_for_samples(sampler)
        status, body = _get(base + "/profilez?seconds=0.4")
        assert status == 200
        capture = json.loads(body)
        status, body = _get(base + "/profilez")
        assert status == 200
        ring = json.loads(body)
    finally:
        stop.set()
        thread.join()
        server.stop()
        profiler.stop()
    for snap in (capture, ring):
        assert snap["role"] == role and snap["hz"] == 250
        assert {"samples", "window_secs", "stacks"} <= set(snap)

    def hot(snap):
        return any("burn_hot_loop" in f
                   for e in snap["stacks"] for f in e["stack"])

    assert hot(capture) and hot(ring)
    assert capture["samples"] <= ring["samples"]


def test_profilez_collapsed_format_and_bad_params(pkg, monkeypatch):
    profiler = pkg.profiler
    monkeypatch.setenv(profiler.HZ_ENV, "250")
    profiler.maybe_start("worker-0")
    server = pkg.server("worker-0").start()
    stop = threading.Event()
    thread = _burn_thread(pkg.trace, stop)
    base = "http://localhost:%d" % server.port
    try:
        _wait_for_samples(profiler.sampler())
        status, text = _get(base + "/profilez?format=collapsed")
        assert status == 200
        stack, count = text.splitlines()[0].rsplit(" ", 1)
        assert ";" in stack and int(count) >= 1
        assert _get(base + "/profilez?seconds=nope")[0] == 400
        assert _get(base + "/profilez?format=xml")[0] == 400
    finally:
        stop.set()
        thread.join()
        server.stop()
        profiler.stop()


def test_capture_journals_profile_captured(pkg, tmp_path, monkeypatch):
    events = pkg.mod("observability.events")
    monkeypatch.setenv(events.EVENTS_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(pkg.profiler.HZ_ENV, "100")
    journal = events.configure("worker-0")
    try:
        pkg.profiler.maybe_start("worker-0").capture(0.05)
    finally:
        pkg.profiler.stop()
        events._reset_for_tests()
    with open(journal.path, encoding="utf-8") as f:
        kinds = [json.loads(line)["event"] for line in f if line.strip()]
    assert kinds == ["profiler_started", "profile_captured"]


# ---------------------------------------------------------------------------
# the report tooling over a capture of the package's sampler


def test_profile_report_reads_a_capture_of_the_package(pkg, tmp_path):
    sampler = pkg.profiler.StackSampler("worker-0", hz=250)
    sampler.start()
    stop = threading.Event()
    thread = _burn_thread(pkg.trace, stop)
    try:
        snap = _wait_for_samples(sampler, minimum=10)
    finally:
        stop.set()
        thread.join()
        sampler.stop()
    with open(tmp_path / "worker-0.profile.json", "w") as f:
        json.dump(snap, f)
    captures = profile_report.load_captures(
        profile_report.discover([str(tmp_path)]))
    assert len(captures) == 1
    top = profile_report.per_role_top(captures, top=5)
    assert top["worker-0"]["samples"] == snap["samples"]
    merged = profile_report.merge_collapsed(captures)
    assert sum(merged.values()) >= snap["samples"] - snap["overflow"]
    assert profile_report.main([str(tmp_path)]) == 0
    assert (tmp_path / "merged.collapsed.txt").exists()
