"""Client-side trace-context propagation over gRPC metadata.

(Copy of elasticdl_tpu/observability/trace_propagation.py
for the PyTorch port.)

The worker's train-step root span (or the serve tier's per-request
root span) lives in a thread-local (``observability/trace.py``); this
interceptor serializes the active ``SpanContext`` as W3C-traceparent
text under the ``edl-traceparent`` metadata key on every outgoing
unary-unary RPC, so the server handler (``trace.traced_handler``) can
open a child span of the exact RPC attempt that reached it. Wired
through ``common/grpc_utils.build_channel`` — the same seam the fault
injector uses — so every stub in the repo propagates without per-call
plumbing.

**Provably inert when off**: ``intercept_trace_channel`` returns the
channel object it was given when ``EDL_TRACE_DIR`` is unset or
``EDL_TRACE_SAMPLE`` is 0 — no wrapper, no per-call branch, and
therefore no metadata on the wire.
The only steady-state cost is one env read per channel BUILD. With the
interceptor installed, a call outside any trace pays a single
thread-local read.
"""

import collections

import grpc

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.observability import trace


class _CallDetails(
    collections.namedtuple(
        "_CallDetails",
        ("method", "timeout", "metadata", "credentials",
         "wait_for_ready", "compression"),
    ),
    grpc.ClientCallDetails,
):
    """ClientCallDetails replacement carrying amended metadata (the
    stock namedtuple recipe from the grpc interceptor docs)."""


class TraceContextClientInterceptor(grpc.UnaryUnaryClientInterceptor):
    """Injects the active span context; adds nothing when the calling
    thread is outside any trace. The ``sampled=0`` flag propagates too:
    a head-unsampled trace must tell remote roles NOT to record, or
    tail-keep decisions made at the root would disagree with orphaned
    remote spans."""

    def intercept_unary_unary(self, continuation, client_call_details,
                              request):
        ctx = trace.current_context()
        if ctx is None:
            return continuation(client_call_details, request)
        metadata = list(client_call_details.metadata or ())
        metadata.append((trace.METADATA_KEY, ctx.to_traceparent()))
        details = _CallDetails(
            client_call_details.method,
            client_call_details.timeout,
            metadata,
            getattr(client_call_details, "credentials", None),
            getattr(client_call_details, "wait_for_ready", None),
            getattr(client_call_details, "compression", None),
        )
        return continuation(details, request)


def intercept_trace_channel(channel):
    """The channel itself when tracing is disabled or head sampling is
    0 (no trace can ever need propagation); a context-propagating
    wrapper otherwise."""
    if not env_str(trace.TRACE_DIR_ENV, ""):
        return channel
    if trace.sample_rate() <= 0.0:
        return channel
    return grpc.intercept_channel(channel, TraceContextClientInterceptor())
