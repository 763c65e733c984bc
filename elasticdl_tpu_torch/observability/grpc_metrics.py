"""gRPC server/client interceptors feeding the metrics registry.

(Copy of elasticdl_tpu/observability/grpc_metrics.py for the PyTorch port.)

Per-method request counters (labeled by status code), and latency
histograms for every Master and Pserver RPC. The deadline
discipline put a ``timeout=`` on every stub call; these interceptors
make the misses visible — a DEADLINE_EXCEEDED is a counted series on
the client graph, not just a log line.

Series (all labeled ``service``, ``method``; counters also ``code``):

- ``edl_grpc_server_handled_total`` / ``edl_grpc_server_latency_seconds``
- ``edl_grpc_client_handled_total`` / ``edl_grpc_client_latency_seconds``

Known method series are pre-registered at interceptor construction so
``/metrics`` exposes every RPC's histogram at zero before first
traffic (probes and dashboards see a stable series set).

Installed by ``common/grpc_utils.build_server`` (server side, via
``server_interceptors()``) and the worker/PS channel builders
(``instrument_channel``). When metrics are disabled (EDL_METRICS=0)
both helpers are no-ops: no interceptor sits on the hot path at all.
"""

import time

import grpc

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.observability import metrics
from elasticdl_tpu_torch.observability import trace


def _split_method(full_method):
    """"/elasticdl_tpu.Master/get_task" -> ("Master", "get_task")."""
    try:
        _, service, method = full_method.split("/")
        return service.rsplit(".", 1)[-1], method
    except ValueError:
        return "unknown", full_method


def _known_methods():
    """[(service short name, method name)] for every RPC we serve."""
    from elasticdl_tpu_torch.proto import services

    return [
        ("Master", name) for name in services._MASTER_METHODS
    ] + [
        ("Pserver", name) for name in services._PSERVER_METHODS
    ] + [
        ("Serve", name) for name in services._SERVE_METHODS
    ]


class ServerMetricsInterceptor(grpc.ServerInterceptor):
    """Counts + times every unary-unary RPC a server handles."""

    def __init__(self, registry=None, preregister=None):
        reg = registry or metrics.default_registry()
        self._handled = reg.counter(
            "edl_grpc_server_handled_total",
            "RPCs handled by this server, by method and status code",
            ("service", "method", "code"),
        )
        self._latency = reg.histogram(
            "edl_grpc_server_latency_seconds",
            "Server-side RPC handling latency",
            ("service", "method"),
        )
        for service, method in (
            _known_methods() if preregister is None else preregister
        ):
            self._handled.labels(service=service, method=method, code="OK")
            self._latency.labels(service=service, method=method)

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None or not handler.unary_unary:
            return handler  # only unary-unary RPCs exist in this proto
        service, method = _split_method(handler_call_details.method)
        inner = handler.unary_unary
        handled = self._handled
        latency = self._latency

        def wrapped(request, context):
            start = time.perf_counter()
            code = "OK"
            try:
                return inner(request, context)
            except BaseException:
                # an abort() raises after set_code; a servicer bug
                # surfaces as UNKNOWN on the wire — count it as such
                code = "UNKNOWN"
                raise
            finally:
                latency.labels(service=service, method=method).observe(
                    time.perf_counter() - start
                )
                handled.labels(
                    service=service, method=method, code=code
                ).inc()

        traced = trace.traced_handler(wrapped, service, method)
        return grpc.unary_unary_rpc_method_handler(
            traced,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


class ClientMetricsInterceptor(grpc.UnaryUnaryClientInterceptor):
    """Counts + times every unary-unary RPC a channel issues. The
    status-code label is where deadline misses become visible:
    ``code="DEADLINE_EXCEEDED"`` is a graphable series."""

    def __init__(self, registry=None, preregister=None):
        reg = registry or metrics.default_registry()
        self._handled = reg.counter(
            "edl_grpc_client_handled_total",
            "RPCs issued by this process, by method and status code",
            ("service", "method", "code"),
        )
        self._latency = reg.histogram(
            "edl_grpc_client_latency_seconds",
            "Client-side RPC latency (includes retries' individual calls)",
            ("service", "method"),
        )
        for service, method in (
            _known_methods() if preregister is None else preregister
        ):
            self._handled.labels(service=service, method=method, code="OK")
            self._latency.labels(service=service, method=method)

    def intercept_unary_unary(self, continuation, client_call_details,
                              request):
        service, method = _split_method(client_call_details.method)
        start = time.perf_counter()
        outcome = continuation(client_call_details, request)
        elapsed = time.perf_counter() - start
        try:
            code = outcome.code()
            code_name = code.name if code is not None else "OK"
        # a future-like outcome without a synchronous code() must not
        # break the RPC; the counter degrades to UNKNOWN
        except Exception:  # edlint: disable=ft-swallowed-except
            code_name = "UNKNOWN"
        self._latency.labels(service=service, method=method).observe(
            elapsed
        )
        self._handled.labels(
            service=service, method=method, code=code_name
        ).inc()
        return outcome


# ---------------------------------------------------------------------------
# install helpers (the only API the wiring code uses)

# (registry, interceptor): rebuilt when the default registry is reset
# (tests flip collection on/off within one process)
_client_cache = (None, None)


class TraceServerInterceptor(grpc.ServerInterceptor):
    """Span-only interceptor for trace-without-metrics runs (the
    metrics interceptor already traces; this keeps EDL_TRACE_DIR
    useful when metrics collection is off)."""

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None or not handler.unary_unary:
            return handler
        service, method = _split_method(handler_call_details.method)
        return grpc.unary_unary_rpc_method_handler(
            trace.traced_handler(handler.unary_unary, service, method),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


def server_interceptors(registry=None):
    """Interceptor tuple for grpc.server(); empty when both metrics
    and tracing are disabled."""
    if registry is None and not metrics.metrics_enabled():
        if env_str(trace.TRACE_DIR_ENV, ""):
            return (TraceServerInterceptor(),)
        return ()
    return (ServerMetricsInterceptor(registry=registry),)


def instrument_channel(channel, registry=None):
    """Wrap a channel with the client metrics interceptor (shared
    process-wide so counters aggregate across stubs); returns the
    channel untouched when metrics are disabled."""
    global _client_cache
    if registry is not None:
        return grpc.intercept_channel(
            channel, ClientMetricsInterceptor(registry=registry)
        )
    if not metrics.metrics_enabled():
        return channel
    default = metrics.default_registry()
    cached_registry, interceptor = _client_cache
    if interceptor is None or cached_registry is not default:
        interceptor = ClientMetricsInterceptor()
        _client_cache = (default, interceptor)
    return grpc.intercept_channel(channel, interceptor)
