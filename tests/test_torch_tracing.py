"""The port's cross-role tracing against the reference's, on the CPU.

Mirrors tests/test_tracing.py. Every scenario of a reference module
that imports no JAX runs against both packages (the ``pkg`` fixture):
the traceparent format, head sampling (``EDL_TRACE_SAMPLE=0`` inert,
``sampled=0`` propagating), tail keeping, server handlers adopting a
propagated context, context propagation over real gRPC, retry attempts
as sibling spans, histogram exemplars and the exposition's content
negotiation, the trace scripts over the package's files, and the
entropy pool. Port-side scenarios: a DeepFM local run gives one trace
per step with PS-side children, a served predict reaches a real PS
inside its trace, the serve drain flushes the trace, and traceparent
crosses a live port master -> worker -> PS chain.

Parity: the same nested spans, instants and completes give the same
tree (names, parents, args) in both packages' trace files; the ids are
random by design, so the trees are compared by structure.
"""

import importlib
import json
import os
import sys
import tempfile
import time

import grpc
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
    def trace(self):
        return self.mod("observability.trace")

    @property
    def metrics(self):
        return self.mod("observability.metrics")

    @property
    def pb(self):
        return self.mod("proto.elasticdl_tpu_pb2")


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return Pkg(request.param)


def _scripts():
    path = os.path.join(REPO, "scripts")
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def traced(pkg, tmp_path, monkeypatch):
    """EDL_TRACE_DIR armed and a configured writer; module state reset
    afterwards."""
    trace = pkg.trace
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path))
    monkeypatch.delenv(trace.SAMPLE_ENV, raising=False)
    monkeypatch.delenv(trace.TAIL_KEEP_ENV, raising=False)
    trace.configure("tracetest")
    yield tmp_path
    trace._reset_for_tests()


def _spans(trace_mod, trace_dir):
    _scripts()
    import merge_trace

    trace_mod.flush()
    merged, _names = merge_trace.merge(str(trace_dir))
    return [e for e in merged["traceEvents"] if e.get("ph") == "X"]


class _FixedRng:
    def __init__(self, value):
        self._value = value

    def random(self):
        return self._value


class _Details:
    method = "/elasticdl_tpu.Master/get_task"
    timeout = 1.0
    metadata = None
    credentials = None
    wait_for_ready = None
    compression = None


# ---------------------------------------------------------------------------
# context format


def test_traceparent_round_trip(pkg):
    trace = pkg.trace
    ctx = trace.SpanContext("ab" * 16, "cd" * 8, True)
    parsed = trace.parse_traceparent(ctx.to_traceparent())
    assert (parsed.trace_id, parsed.span_id) == (ctx.trace_id, ctx.span_id)
    assert parsed.sampled
    unsampled = trace.SpanContext("ab" * 16, "cd" * 8, False)
    assert unsampled.to_traceparent().endswith("-00")
    assert not trace.parse_traceparent(unsampled.to_traceparent()).sampled


def test_traceparent_is_the_same_on_the_wire():
    ref = Pkg("ref").trace.SpanContext("ab" * 16, "cd" * 8, True)
    port = Pkg("port").trace.SpanContext("ab" * 16, "cd" * 8, True)
    assert port.to_traceparent() == ref.to_traceparent()
    assert Pkg("port").trace.METADATA_KEY == Pkg("ref").trace.METADATA_KEY
    parsed = Pkg("port").trace.parse_traceparent(ref.to_traceparent())
    assert parsed.trace_id == ref.trace_id


@pytest.mark.parametrize("garbage", [
    "", "banana", "00-zz-cd-01", "00-" + "a" * 31 + "-" + "c" * 16 + "-01",
    "00-%s-%s" % ("a" * 32, "c" * 16), None,
])
def test_traceparent_garbage_is_none(pkg, garbage):
    assert pkg.trace.parse_traceparent(garbage) is None


def test_extract_context_reads_metadata(pkg):
    trace = pkg.trace
    ctx = trace.SpanContext("ab" * 16, "cd" * 8, True)
    metadata = (("other", "x"), (trace.METADATA_KEY, ctx.to_traceparent()))
    assert trace.extract_context(metadata).trace_id == ctx.trace_id
    assert trace.extract_context((("other", "x"),)) is None
    assert trace.extract_context(None) is None


# ---------------------------------------------------------------------------
# sampling


def test_sample_zero_yields_no_context_and_no_events(pkg, traced,
                                                     monkeypatch):
    trace = pkg.trace
    monkeypatch.setenv(trace.SAMPLE_ENV, "0")
    with trace.root_span("train_batch") as ctx:
        assert ctx is None and trace.current_context() is None
        with trace.span("ps_pull"):  # a legacy span still records
            pass
    spans = _spans(trace, traced)
    assert [e["name"] for e in spans] == ["ps_pull"]
    assert "trace_id" not in spans[0]["args"]


def test_sample_zero_builds_uninstrumented_channel(pkg, traced,
                                                   monkeypatch):
    monkeypatch.setenv(pkg.trace.SAMPLE_ENV, "0")
    overload = pkg.mod("common.overload")
    monkeypatch.setenv(overload.DEADLINE_BUDGET_ENV, "0")
    channel = pkg.mod("common.grpc_utils").build_channel("localhost:1")
    assert "_interceptor" not in type(channel).__module__
    channel.close()


def test_trace_disabled_builds_uninstrumented_channel(pkg, monkeypatch):
    monkeypatch.delenv(pkg.trace.TRACE_DIR_ENV, raising=False)
    monkeypatch.setenv(pkg.mod("common.overload").DEADLINE_BUDGET_ENV, "0")
    channel = pkg.mod("common.grpc_utils").build_channel("localhost:1")
    assert "_interceptor" not in type(channel).__module__
    channel.close()


def test_client_interceptor_injects_traceparent(pkg, traced):
    trace = pkg.trace
    propagation = pkg.mod("observability.trace_propagation")
    captured = {}

    def continuation(details, request):
        captured["metadata"] = details.metadata
        return "outcome"

    interceptor = propagation.TraceContextClientInterceptor()
    assert interceptor.intercept_unary_unary(
        continuation, _Details(), None) == "outcome"
    assert captured["metadata"] is None  # outside any trace: untouched
    with trace.root_span("step") as ctx:
        interceptor.intercept_unary_unary(continuation, _Details(), None)
    sent = trace.extract_context(captured["metadata"])
    assert sent.trace_id == ctx.trace_id and sent.sampled


def test_unsampled_context_propagates_flag_without_recording(
        pkg, traced, monkeypatch):
    trace = pkg.trace
    propagation = pkg.mod("observability.trace_propagation")
    monkeypatch.setenv(trace.SAMPLE_ENV, "0.5")
    monkeypatch.setattr(trace, "_rng", _FixedRng(0.9))  # draw > rate
    captured = {}

    def continuation(details, request):
        captured["metadata"] = details.metadata
        return "outcome"

    interceptor = propagation.TraceContextClientInterceptor()
    with trace.root_span("step") as ctx:
        assert ctx is not None and not ctx.sampled
        with trace.span("ps_pull"):
            pass
        interceptor.intercept_unary_unary(continuation, _Details(), None)
    sent = trace.extract_context(captured["metadata"])
    assert sent.trace_id == ctx.trace_id and not sent.sampled
    assert _spans(trace, traced) == []


def test_tail_keep_retains_slow_unsampled_trace(pkg, traced, monkeypatch):
    trace = pkg.trace
    monkeypatch.setenv(trace.SAMPLE_ENV, "0.01")
    monkeypatch.setenv(trace.TAIL_KEEP_ENV, "20")
    monkeypatch.setattr(trace, "_rng", _FixedRng(0.9))
    with trace.root_span("train_batch") as fast:
        with trace.span("ps_pull"):
            pass
    with trace.root_span("train_batch") as slow:
        with trace.span("ps_pull"):
            time.sleep(0.05)
    spans = _spans(trace, traced)
    trace_ids = {e["args"].get("trace_id") for e in spans}
    assert slow.trace_id in trace_ids and fast.trace_id not in trace_ids
    root = next(e for e in spans if e["name"] == "train_batch")
    assert root["args"]["tail_kept"] is True
    child = next(e for e in spans if e["name"] == "ps_pull")
    assert child["args"]["parent_id"] == root["args"]["span_id"]


def test_tail_kept_trace_keeps_late_bound_spans(pkg, traced, monkeypatch):
    trace = pkg.trace
    monkeypatch.setenv(trace.SAMPLE_ENV, "0.01")
    monkeypatch.setenv(trace.TAIL_KEEP_ENV, "20")
    monkeypatch.setattr(trace, "_rng", _FixedRng(0.9))

    def push():
        with trace.span("ps_push"):
            pass

    with trace.root_span("train_batch") as kept:
        late_push = trace.bind_context(push)
        time.sleep(0.05)
    late_push()
    with trace.root_span("train_batch") as dropped:
        dropped_push = trace.bind_context(push)
    dropped_push()
    spans = _spans(trace, traced)
    late = [e for e in spans if e["name"] == "ps_push"]
    assert [e["args"]["trace_id"] for e in late] == [kept.trace_id]
    assert not any(e["args"].get("trace_id") == dropped.trace_id
                   for e in spans)


def test_sampled_zero_metadata_suppresses_server_handler(pkg, traced):
    trace = pkg.trace
    calls = []

    def handler(request, context):
        with trace.span("ps_apply_push"):
            calls.append(1)
        return "resp"

    wrapped = trace.traced_handler(handler, "Pserver", "push_gradients")

    class Ctx:
        def __init__(self, sampled):
            self._sampled = sampled

        def invocation_metadata(self):
            parent = trace.SpanContext("ef" * 16, "12" * 8, self._sampled)
            return ((trace.METADATA_KEY, parent.to_traceparent()),)

    assert wrapped("req", Ctx(sampled=False)) == "resp"
    assert _spans(trace, traced) == []
    assert wrapped("req", Ctx(sampled=True)) == "resp"
    spans = _spans(trace, traced)
    assert {e["name"] for e in spans} == {"Pserver/push_gradients",
                                          "ps_apply_push"}
    server = next(e for e in spans if e["name"] == "Pserver/push_gradients")
    assert server["args"]["trace_id"] == "ef" * 16
    assert server["args"]["parent_id"] == "12" * 8
    apply = next(e for e in spans if e["name"] == "ps_apply_push")
    assert apply["args"]["parent_id"] == server["args"]["span_id"]
    assert calls == [1, 1]


def test_annotate_merges_into_open_span(pkg, traced):
    trace = pkg.trace
    with pytest.raises(RuntimeError):
        with trace.root_span("serve_predict") as ctx:
            trace.annotate(code="RESOURCE_EXHAUSTED", rows=4)
            raise RuntimeError("bare abort")
    root = next(e for e in _spans(trace, traced)
                if e["name"] == "serve_predict")
    assert root["args"]["trace_id"] == ctx.trace_id
    assert root["args"]["code"] == "RESOURCE_EXHAUSTED"
    assert root["args"]["rows"] == 4
    assert root["args"]["error"] == "RuntimeError"
    trace.annotate(code="X")  # inert outside any span


def test_serve_shed_root_span_records_status_code(pkg, traced):
    trace = pkg.trace
    batcher_mod = pkg.mod("serve.batcher")
    servicer_mod = pkg.mod("serve.servicer")

    class Engine:
        loaded = True

        class batcher:
            max_batch = 32
            default_deadline_secs = 1.0

        @staticmethod
        def predict(features, rows, deadline_secs):
            raise batcher_mod.QueueFull("at depth")

    class Ctx:
        code = None

        def invocation_metadata(self):
            return ()

        def time_remaining(self):
            return 5.0

        def abort(self, code, detail):
            self.code = code
            raise Exception(detail)  # grpc's abort: bare, code-less

    request = pkg.pb.PredictRequest()
    pkg.mod("common.tensor_utils").ndarray_to_blob(
        np.ones((2, 4), np.float32), request.features["ids"])
    context = Ctx()
    with pytest.raises(Exception):
        servicer_mod.ServeServicer(Engine()).predict(request, context)
    assert context.code == grpc.StatusCode.RESOURCE_EXHAUSTED
    root = next(e for e in _spans(trace, traced)
                if e["name"] == "serve_predict")
    assert root["args"]["code"] == "RESOURCE_EXHAUSTED"
    _scripts()
    import critical_path

    report = critical_path.build_report(
        critical_path.load_events(str(traced)))
    assert "shed" in report["predict"]["segments"]


# ---------------------------------------------------------------------------
# propagation over real gRPC and retry attempt spans


def _master_server(pkg):
    grpc_utils = pkg.mod("common.grpc_utils")
    dispatcher = pkg.mod("master.task_dispatcher").TaskDispatcher(
        {"s": (0, 64)}, records_per_task=32)
    server = grpc_utils.build_server()
    pkg.mod("proto.services").add_master_servicer_to_server(
        pkg.mod("master.servicer").MasterServicer(dispatcher), server)
    port = grpc_utils.find_free_port()
    server.add_insecure_port("localhost:%d" % port)
    server.start()
    return server, port


def test_context_propagates_through_real_grpc(pkg, traced):
    trace = pkg.trace
    server, port = _master_server(pkg)
    try:
        mc = pkg.mod("worker.master_client").MasterClient(
            "localhost:%d" % port, worker_id=0)
        with trace.root_span("train_batch", role="worker") as ctx:
            assert mc.get_task() is not None
    finally:
        server.stop(0)
    ours = [e for e in _spans(trace, traced)
            if e["args"].get("trace_id") == ctx.trace_id]
    by_name = {e["name"]: e for e in ours}
    assert {"train_batch", "rpc_attempt", "Master/get_task"} <= set(by_name)
    root, attempt = by_name["train_batch"], by_name["rpc_attempt"]
    handler = by_name["Master/get_task"]
    assert "parent_id" not in root["args"]
    assert attempt["args"]["parent_id"] == root["args"]["span_id"]
    assert handler["args"]["parent_id"] == attempt["args"]["span_id"]
    assert handler["args"]["kind"] == "grpc_server"


class _Unavailable(grpc.RpcError):
    def code(self):
        return grpc.StatusCode.UNAVAILABLE


def test_retry_attempts_are_distinct_failed_child_spans(pkg, traced):
    """Two UNAVAILABLE attempts then a real call: each retry_call
    attempt is its own child span, the failed ones carry error and
    code args, and the root ends once."""
    trace = pkg.trace
    grpc_utils = pkg.mod("common.grpc_utils")
    server, port = _master_server(pkg)
    failures = [2]
    try:
        stub = pkg.mod("proto.services").MasterStub(
            grpc_utils.build_channel("localhost:%d" % port))

        def call():
            if failures[0]:
                failures[0] -= 1
                raise _Unavailable()
            return stub.get_task(pkg.pb.GetTaskRequest(worker_id=0),
                                 timeout=5)

        with trace.root_span("train_batch") as ctx:
            grpc_utils.retry_call(call, "get_task", budget_secs=30.0,
                                  base_delay=0.01)
    finally:
        server.stop(0)
    spans = [e for e in _spans(trace, traced)
             if e["args"].get("trace_id") == ctx.trace_id]
    attempts = sorted((e for e in spans if e["name"] == "rpc_attempt"),
                      key=lambda e: e["args"]["attempt"])
    assert [a["args"]["attempt"] for a in attempts] == [1, 2, 3]
    assert [a["args"].get("code") for a in attempts] == [
        "UNAVAILABLE", "UNAVAILABLE", None]
    roots = [e for e in spans if e["name"] == "train_batch"]
    assert len(roots) == 1
    assert all(a["args"]["parent_id"] == roots[0]["args"]["span_id"]
               for a in attempts)
    span_ids = [e["args"]["span_id"] for e in spans]
    assert len(span_ids) == len(set(span_ids))


# ---------------------------------------------------------------------------
# histogram exemplars and the exposition's content negotiation


def test_histogram_exemplar_tracks_slowest_sampled_observation(pkg, traced):
    trace = pkg.trace
    reg = pkg.metrics.Registry(enabled=True)
    hist = reg.histogram("lat_seconds", "l", buckets=(0.1, 1.0))
    hist.observe(0.9)  # outside any trace: no exemplar
    assert "# {" not in reg.render(exemplars=True)
    with trace.root_span("step") as slow_ctx:
        hist.observe(0.5)
    with trace.root_span("step"):
        hist.observe(0.05)
    assert "# {" not in reg.render()
    text = reg.render(exemplars=True)
    assert '# {trace_id="%s"} 0.5' % slow_ctx.trace_id in text
    line = next(l for l in text.splitlines() if "# {" in l)
    assert line.startswith('lat_seconds_bucket{le="1"}')


def test_exemplar_window_admits_fresh_trace(pkg, traced, monkeypatch):
    trace = pkg.trace
    reg = pkg.metrics.Registry(enabled=True)
    hist = reg.histogram("lat_seconds", "l", buckets=(10.0,))
    with trace.root_span("step"):
        hist.observe(5.0)
    monkeypatch.setattr(pkg.metrics, "EXEMPLAR_WINDOW_SECS", 0.0)
    with trace.root_span("step") as fresh:
        hist.observe(0.5)
    assert 'trace_id="%s"' % fresh.trace_id in reg.render(exemplars=True)


def test_metrics_endpoint_content_negotiation(pkg, traced, monkeypatch):
    import urllib.request

    trace, metrics = pkg.trace, pkg.metrics
    monkeypatch.delenv(metrics.EXEMPLARS_ENV, raising=False)
    reg = metrics.Registry(enabled=True)
    hist = reg.histogram("edl_lat_seconds", "l", buckets=(1.0,))
    with trace.root_span("step"):
        hist.observe(0.5)
    server = pkg.mod("observability.http_server").ObservabilityServer(
        "w", 0, registry=reg).start()
    try:
        base = "http://localhost:%d/metrics" % server.port
        plain = urllib.request.urlopen(base, timeout=5)
        body = plain.read().decode()
        assert "# {" not in body and "# EOF" not in body
        assert "version=0.0.4" in plain.headers["Content-Type"]
        negotiated = urllib.request.urlopen(urllib.request.Request(
            base, headers={"Accept": "application/openmetrics-text"}),
            timeout=5)
        om_body = negotiated.read().decode()
        assert "# {trace_id=" in om_body and om_body.endswith("# EOF\n")
        assert "openmetrics-text" in negotiated.headers["Content-Type"]
        stock = urllib.request.urlopen(urllib.request.Request(
            base, headers={
                "Accept": "application/openmetrics-text;version=1.0.0,"
                "text/plain;version=0.0.4;q=0.5,*/*;q=0.1"}), timeout=5)
        stock_body = stock.read().decode()
        assert "# {" not in stock_body and "# EOF" not in stock_body
        monkeypatch.setenv(metrics.EXEMPLARS_ENV, "1")
        gated = urllib.request.urlopen(base, timeout=5).read().decode()
        assert "# {trace_id=" in gated and "# EOF" not in gated
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the same span tree on both sides


def _tree_ops(trace_mod):
    """Nested roots, spans, completes, instants and a bound callable
    run on another thread."""
    import threading

    with trace_mod.task_context(5):
        with trace_mod.root_span("train_batch", role="worker", version=3):
            with trace_mod.span("ps_pull_batch", tables=2):
                with trace_mod.span("rpc_attempt", what="pull",
                                    attempt=1):
                    pass
            trace_mod.instant("task_reported", task_id=5, success=True)
            trace_mod.complete("dispatch", time.time(), task_id=5,
                               worker_id=0)
            def push():
                with trace_mod.span("ps_push", version=3):
                    pass

            worker = threading.Thread(target=trace_mod.bind_context(push))
            worker.start()
            worker.join()
    with trace_mod.root_span("serve_predict", role="serve"):
        with trace_mod.span("serve_batch_run", requests=1, rows=4):
            pass
    with trace_mod.span("legacy", task_id=9):
        pass


def _tree(trace_mod, trace_dir):
    """Events as (name, phase, parent name, args without ids), sorted."""
    events = []
    for path in sorted(os.listdir(trace_dir)):
        with open(os.path.join(trace_dir, path), encoding="utf-8") as f:
            text = f.read().rstrip().rstrip(",")
        if not text.endswith("]"):
            text += "]"
        events += [e for e in json.loads(text) if e.get("ph") != "M"]
    names = {e["args"].get("span_id"): e["name"] for e in events
             if e["args"].get("span_id")}
    tree = []
    for e in events:
        args = {k: v for k, v in e["args"].items()
                if k not in ("trace_id", "span_id", "parent_id")}
        tree.append((e["name"], e["ph"],
                     names.get(e["args"].get("parent_id")),
                     bool(e["args"].get("trace_id")),
                     json.dumps(args, sort_keys=True)))
    return sorted(tree)


def test_span_trees_agree_across_packages(tmp_path, monkeypatch):
    trees = {}
    for side in ("ref", "port"):
        trace = Pkg(side).trace
        trace_dir = tmp_path / side
        monkeypatch.setenv(trace.TRACE_DIR_ENV, str(trace_dir))
        monkeypatch.setenv(trace.SAMPLE_ENV, "1")
        trace.configure("worker-0")
        try:
            _tree_ops(trace)
            trace.flush()
        finally:
            trace._reset_for_tests()
        trees[side] = _tree(trace, str(trace_dir))
    assert trees["port"] == trees["ref"]
    names = {t[0] for t in trees["port"]}
    assert {"train_batch", "ps_pull_batch", "rpc_attempt", "dispatch",
            "task_reported", "serve_batch_run", "legacy"} <= names


# ---------------------------------------------------------------------------
# the trace scripts over the package's own files


def test_merge_and_critical_path_read_the_package_files(pkg, traced):
    """merge_trace threads the package's spans by trace context and
    critical_path attributes the step's segments."""
    trace = pkg.trace
    with trace.root_span("train_batch", role="worker"):
        with trace.span("ps_pull"):
            time.sleep(0.002)
        with trace.span("ps_apply_push", role="ps"):
            time.sleep(0.002)
    spans = _spans(trace, traced)
    assert {e["name"] for e in spans} == {"train_batch", "ps_pull",
                                          "ps_apply_push"}
    _scripts()
    import critical_path

    report = critical_path.build_report(
        critical_path.load_events(str(traced)))
    assert report["step"]["count"] == 1
    assert {"pull", "apply"} <= set(report["step"]["segments"])


# ---------------------------------------------------------------------------
# the entropy pool


def test_entropy_pool_id_shapes_and_uniqueness(pkg):
    trace = pkg.trace
    span_ids = {trace._new_span_id() for _ in range(10_000)}
    assert len(span_ids) == 10_000 and all(len(s) == 16 for s in span_ids)
    trace_ids = {trace._new_trace_id() for _ in range(1_000)}
    assert len(trace_ids) == 1_000 and all(len(t) == 32 for t in trace_ids)
    int(next(iter(span_ids)), 16)


def test_entropy_pool_refills_and_resets(pkg):
    pool = pkg.trace._EntropyPool(size=32)
    taken = [pool.take(8) for _ in range(20)]
    assert all(len(t) == 8 for t in taken) and len(set(taken)) == 20
    pool.reset()
    assert pool._buf == b"" and pool._pos == 0
    assert len(pool.take(8)) == 8


def test_entropy_pool_concurrent_takes_are_distinct(pkg):
    import threading

    out = [None] * 8

    def draw(i):
        out[i] = [pkg.trace._new_span_id() for _ in range(2_000)]

    threads = [threading.Thread(target=draw, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    merged = [s for chunk in out for s in chunk]
    assert len(set(merged)) == len(merged)


# ---------------------------------------------------------------------------
# the port's runs: DeepFM locally, a served predict, the serve drain, the
# master -> worker -> PS chain


@pytest.fixture(scope="module")
def deepfm_traced_run():
    """One traced DeepFM local run of the port (3 steps)."""
    import torch

    from elasticdl_tpu_torch.observability import trace
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor
    from tests.test_utils import create_ctr_recordio

    torch.set_num_threads(1)
    tmp = tempfile.mkdtemp(prefix="edl-torch-tracing-")
    trace_dir = os.path.join(tmp, "traces")
    create_ctr_recordio(tmp + "/f0.rec", num_records=96, seed=0)
    previous = {key: os.environ.get(key)
                for key in (trace.TRACE_DIR_ENV, trace.SAMPLE_ENV)}
    os.environ[trace.TRACE_DIR_ENV] = trace_dir
    os.environ[trace.SAMPLE_ENV] = "1"
    try:
        executor = LocalExecutor("elasticdl_tpu_torch.models.deepfm",
                                 training_data=tmp, minibatch_size=32,
                                 num_epochs=1, device="cpu")
        executor.train()
        executor.trainer.join_pushes()
        trace.flush()
    finally:
        for key, value in previous.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        trace._reset_for_tests()
    return executor, trace_dir


def test_deepfm_local_run_yields_one_trace_per_step_with_ps_children(
        deepfm_traced_run):
    from elasticdl_tpu_torch.observability import trace

    _executor, trace_dir = deepfm_traced_run
    spans = _spans(trace, trace_dir)
    by_trace = {}
    for event in spans:
        tid = event["args"].get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(event)
    roots = [e for e in spans if e["name"] == "train_batch"]
    assert len(roots) == 3
    assert len({r["args"]["trace_id"] for r in roots}) == 3
    for trace_spans in by_trace.values():
        root = next(e for e in trace_spans if "parent_id" not in e["args"])
        assert root["name"] == "train_batch"
        assert root["args"]["role"] == "worker"
        ps_children = [e for e in trace_spans
                       if e["args"].get("role") == "ps"]
        assert ps_children, trace_spans
        span_ids = {e["args"]["span_id"] for e in trace_spans}
        assert all(e["args"]["parent_id"] in span_ids for e in ps_children)
        assert any(e["name"] == "ps_apply_push" for e in ps_children)


def test_critical_path_report_on_deepfm_run(deepfm_traced_run):
    _scripts()
    import critical_path

    _executor, trace_dir = deepfm_traced_run
    step = critical_path.build_report(
        critical_path.load_events(trace_dir))["step"]
    assert step["count"] == 3
    assert step["multi_role_traces"] == step["count"]
    assert {"worker", "ps"} <= set(step["roles"])
    assert {"compute", "pull", "apply"} <= set(step["segments"])
    for stats in step["segments"].values():
        assert stats["p99_ms"] >= stats["p50_ms"] >= 0.0


def test_serve_predict_trace_reaches_real_ps(tmp_path, monkeypatch,
                                             deepfm_traced_run):
    """client -> serve batcher -> model -> PS client -> a real PS, one
    trace: the PS handler's span is a descendant of the serve root,
    through the batcher's thread hand-off and the gRPC hop."""
    from elasticdl_tpu_torch.common.grpc_utils import (
        build_server,
        find_free_port,
    )
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.observability import trace
    from elasticdl_tpu_torch.proto.services import (
        add_pserver_servicer_to_server,
        add_serve_servicer_to_server,
    )
    from elasticdl_tpu_torch.ps.embedding_store import create_store
    from elasticdl_tpu_torch.ps.servicer import PserverServicer
    from elasticdl_tpu_torch.serve.client import ServeClient
    from elasticdl_tpu_torch.serve.engine import ServingEngine
    from elasticdl_tpu_torch.serve.servicer import ServeServicer
    from elasticdl_tpu_torch.train.export import export_train_state
    from elasticdl_tpu_torch.worker.ps_client import PSClient

    executor, _ = deepfm_traced_run
    export_dir = str(tmp_path / "export")
    export_train_state(executor.state, export_dir)
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path / "traces"))
    monkeypatch.setenv(trace.SAMPLE_ENV, "1")
    trace.configure("servetest")
    store = create_store(seed=0, prefer_native=False)
    store.set_optimizer("adam", lr=0.001)
    ps_server = build_server()
    add_pserver_servicer_to_server(PserverServicer(store, use_async=True),
                                   ps_server)
    ps_port = find_free_port()
    ps_server.add_insecure_port("localhost:%d" % ps_port)
    ps_server.start()
    engine = serve_server = client = None
    try:
        ps_client = PSClient(["localhost:%d" % ps_port])
        specs = deepfm.sparse_embedding_specs(batch_size=32)
        ps_client.push_embedding_table_infos(
            [(s.name, s.dim, str(float(s.init_scale))) for s in specs])
        engine = ServingEngine(
            "elasticdl_tpu_torch.models.deepfm", export_dir,
            ps_client=ps_client, max_batch=32, max_delay_ms=2.0,
            deadline_ms=60000.0, device="cpu").start(block=True)
        serve_server = build_server()
        add_serve_servicer_to_server(ServeServicer(engine), serve_server)
        serve_port = find_free_port()
        serve_server.add_insecure_port("localhost:%d" % serve_port)
        serve_server.start()
        client = ServeClient("localhost:%d" % serve_port)
        ids = np.random.RandomState(3).randint(
            0, 1000, size=(4, 10)).astype(np.int64)
        outputs, _step, _stamp = client.predict({"ids": ids},
                                                deadline_secs=120)
        assert np.isfinite(outputs["output"].numpy()).all()
    finally:
        if client is not None:
            client.close()
        if serve_server is not None:
            serve_server.stop(0)
        if engine is not None:
            engine.drain(timeout=5)
        ps_server.stop(0)
        trace.flush()
        trace._reset_for_tests()
    spans = _spans(trace, tmp_path / "traces")
    roots = [e for e in spans if e["name"] == "serve_predict"]
    assert len(roots) == 1
    tid = roots[0]["args"]["trace_id"]
    ours = {e["args"]["span_id"]: e for e in spans
            if e["args"].get("trace_id") == tid}
    ps_handler = next((e for e in ours.values()
                       if e["name"].startswith("Pserver/pull")), None)
    assert ps_handler is not None, sorted(e["name"] for e in ours.values())
    assert ps_handler["args"]["kind"] == "grpc_server"
    node, hops = ps_handler, []
    while "parent_id" in node["args"]:
        hops.append(node["name"])
        node = ours[node["args"]["parent_id"]]
    assert node is roots[0], hops
    assert "serve_batch_run" in hops


def test_serve_batches_stamp_their_number_on_every_request(tmp_path,
                                                          monkeypatch):
    """Every request's admitting span carries the number of the batch
    that served it, and that batch's assemble and run spans carry the
    same number: each request, not only a batch's head, finds its
    batch in the trace. (A long formation window: each batch closes
    full, at 2 rows.)"""
    import threading

    import torch

    from elasticdl_tpu_torch.observability import metrics, trace
    from elasticdl_tpu_torch.serve.batcher import MicroBatcher

    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path / "traces"))
    monkeypatch.setenv(trace.SAMPLE_ENV, "1")
    trace.configure("batchtest")

    def runner(features, rows):
        return {"output": features * 2}, 1, 0

    batcher = MicroBatcher(runner, max_batch=2, max_delay_ms=30000,
                           queue_depth=16, default_deadline_ms=60000,
                           registry=metrics.Registry())
    answers = {}

    def one(i):
        with trace.root_span("serve_predict", role="serve"):
            answers[i] = batcher.submit(torch.full((1, 3), float(i)), 1)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        batcher.stop()
    try:
        spans = _spans(trace, tmp_path / "traces")
    finally:
        trace._reset_for_tests()
    assert sorted(answers) == list(range(6))
    for i, (outputs, step, _) in answers.items():
        assert torch.equal(outputs["output"], torch.full((1, 3), 2.0 * i))
    roots = [e for e in spans if e["name"] == "serve_predict"]
    assert sorted(e["args"]["batch"] for e in roots) == [0, 0, 1, 1, 2, 2]
    for name in ("serve_batch_assemble", "serve_batch_run"):
        assert {e["args"]["batch"]: e["args"]["requests"] for e in spans
                if e["name"] == name} == {0: 2, 1: 2, 2: 2}


def test_serve_drain_flushes_trace_and_journals_event(
        tmp_path, monkeypatch, deepfm_traced_run):
    from elasticdl_tpu_torch.observability import events, trace
    from elasticdl_tpu_torch.serve.main import ServeRole, parse_serve_args
    from elasticdl_tpu_torch.train.export import export_train_state

    executor, _ = deepfm_traced_run
    export_dir = str(tmp_path / "export")
    export_train_state(executor.state, export_dir)
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path / "traces"))
    monkeypatch.setenv(events.EVENTS_DIR_ENV, str(tmp_path / "events"))
    trace.configure("serve-0")
    journal = events.configure("serve-0")
    try:
        role = ServeRole(parse_serve_args([
            "--model_zoo", "elasticdl_tpu_torch.models.deepfm",
            "--export_dir", export_dir, "--device", "cpu",
        ]))
        with trace.span("serve_smoke"):
            pass
        role.drain(reason="test")
        names = [r["event"] for r in map(json.loads, open(
            journal.path, encoding="utf-8")) if r]
        assert "trace_flushed" in names
        assert names.index("trace_flushed") < names.index("serve_drained")
        assert any(e["name"] == "serve_smoke"
                   for e in _spans(trace, tmp_path / "traces"))
        role.drain(reason="test")  # idempotent: no second event
        again = [r["event"] for r in map(json.loads, open(
            journal.path, encoding="utf-8")) if r]
        assert again.count("trace_flushed") == 1
    finally:
        events._reset_for_tests()
        trace._reset_for_tests()


def test_traceparent_crosses_a_live_master_worker_ps_chain(tmp_path,
                                                          monkeypatch):
    """A port master and two PS servers behind real gRPC, one port
    worker training DeepFM with tracing on: a training step's trace id
    is in the worker's root span, in a PS handler's span and in the
    master's task-report handler span, each a child through the
    propagated context."""
    import torch

    from elasticdl_tpu_torch.data.readers import RecordIODataReader
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.observability import trace
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.worker import Worker
    from tests import test_torch_job as job

    torch.set_num_threads(1)
    monkeypatch.setenv(trace.TRACE_DIR_ENV, str(tmp_path / "traces"))
    monkeypatch.setenv(trace.SAMPLE_ENV, "1")
    trace.configure("worker-0")
    train_dir, _ = job._ctr_dirs(tmp_path)
    master = Master(job.PORT_ZOO, training_data=train_dir,
                    records_per_task=64, port=find_free_port(), seed=0,
                    task_timeout_secs=30.0).prepare()
    servers, ps_addrs = job._ps_pair()
    try:
        worker = Worker(
            MasterClient("localhost:%d" % master._port, worker_id=0),
            job.PORT_ZOO, RecordIODataReader(data_dir=train_dir),
            minibatch_size=32, wait_sleep_secs=0.1, ps_addrs=ps_addrs,
            device="cpu")
        worker.run()
        assert worker.model_version == 8
    finally:
        master.stop()
        for server in servers:
            server.stop(None)
        trace.flush()
        trace._reset_for_tests()
    spans = _spans(trace, tmp_path / "traces")
    roots = {e["args"]["trace_id"]: e for e in spans
             if e["name"] == "train_batch"}
    assert len(roots) == 8
    by_trace = {}
    for e in spans:
        if e["args"].get("trace_id") in roots:
            by_trace.setdefault(e["args"]["trace_id"], []).append(e)
    reports = [e for group in by_trace.values() for e in group
               if e["name"] == "Master/report_task_result"]
    # every task's report rides the trace of the step that finished it
    assert len(reports) == 5  # 160 + 96 records, 64 a task
    full = [
        tid for tid, group in by_trace.items()
        if any(e["name"] == "Master/report_task_result" for e in group)
        and any(e["name"].startswith("Pserver/") for e in group)
    ]
    assert full
    group = {e["args"]["span_id"]: e for e in by_trace[full[0]]}
    for name in ("Master/report_task_result", "Pserver/"):
        handler = next(e for e in group.values()
                       if e["name"].startswith(name))
        node = handler
        while "parent_id" in node["args"]:
            node = group[node["args"]["parent_id"]]
        assert node is roots[full[0]]
        assert handler["args"]["kind"] == "grpc_server"
