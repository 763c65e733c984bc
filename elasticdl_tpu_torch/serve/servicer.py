"""gRPC surface of the serving role: the ``elasticdl_tpu.Serve`` service
(port of elasticdl_tpu/serve/servicer.py). Admission outcomes map 1:1
onto status codes:

- bounded queue at depth        -> RESOURCE_EXHAUSTED (shed)
- deadline expired while queued -> DEADLINE_EXCEEDED (never served late)
- SIGTERM drain in progress     -> UNAVAILABLE
- no model loaded yet           -> FAILED_PRECONDITION (mirrors /readyz)

Each predict is the ``serve_predict`` root span, opened at admission
(queue wait, batch formation and the forward become its children), and
counts in ``edl_serve_requests_total{code}``; a served one also in the
``edl_serve_request_seconds`` histogram.
"""

import time

import grpc

from elasticdl_tpu_torch.common.tensor_utils import (
    blob_to_tensor,
    tensor_to_blob,
)
from elasticdl_tpu_torch.observability import metrics, trace
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.serve import batcher as batcher_mod
from elasticdl_tpu_torch.serve.model import SINGLE_INPUT_KEY


class ServeServicer:
    def __init__(self, engine, registry=None):
        self._engine = engine
        reg = registry or metrics.default_registry()
        self._m_latency = reg.histogram(
            "edl_serve_request_seconds",
            "End-to-end predict latency (admission queue + batch "
            "formation + forward), successful requests",
        )
        self._m_requests = reg.counter(
            "edl_serve_requests_total",
            "Predict RPCs by outcome",
            ("code",),
        )
        for code in ("OK", "RESOURCE_EXHAUSTED", "DEADLINE_EXCEEDED",
                     "UNAVAILABLE", "INVALID_ARGUMENT"):
            self._m_requests.labels(code=code)

    def _abort(self, context, code, detail):
        self._m_requests.labels(code=code.name).inc()
        # grpc's abort raises a bare Exception carrying no status: stamp
        # the code onto the open serve_predict root span here
        trace.annotate(code=code.name)
        context.abort(code, detail)

    def predict(self, request, context):
        # the serve-side trace root, opened at admission; a caller's
        # propagated context makes it a child span instead
        with trace.root_span("serve_predict", role="serve"):
            return self._predict(request, context)

    def _predict(self, request, context):
        start = time.perf_counter()
        if not self._engine.loaded:
            self._abort(
                context, grpc.StatusCode.FAILED_PRECONDITION,
                "no model loaded yet (see /readyz)",
            )
        features = {
            name: blob_to_tensor(blob)
            for name, blob in request.features.items()
        }
        if not features:
            self._abort(
                context, grpc.StatusCode.INVALID_ARGUMENT,
                "request has no features",
            )
        if any(v.dim() == 0 for v in features.values()):
            self._abort(
                context, grpc.StatusCode.INVALID_ARGUMENT,
                "features must have a leading batch dimension "
                "(got a 0-d tensor)",
            )
        rows_set = {int(v.shape[0]) for v in features.values()}
        if set(features) == {SINGLE_INPUT_KEY}:
            features = features[SINGLE_INPUT_KEY]
        if len(rows_set) != 1:
            self._abort(
                context, grpc.StatusCode.INVALID_ARGUMENT,
                "features disagree on the batch dimension: %s"
                % sorted(rows_set),
            )
        rows = rows_set.pop()
        if rows < 1 or rows > self._engine.batcher.max_batch:
            self._abort(
                context, grpc.StatusCode.INVALID_ARGUMENT,
                "request rows %d outside [1, max_batch=%d]"
                % (rows, self._engine.batcher.max_batch),
            )
        # latency budget: the TIGHTER of the RPC deadline and the
        # in-message budget -- or, with no in-message budget, the server
        # default, which still caps a client's loose transport timeout
        deadline_secs = context.time_remaining()
        budget = (
            request.deadline_ms / 1e3 if request.deadline_ms > 0
            else self._engine.batcher.default_deadline_secs
        )
        if budget > 0:
            deadline_secs = (
                budget if deadline_secs is None
                else min(deadline_secs, budget)
            )
        try:
            outputs, step, stamp = self._engine.predict(
                features, rows, deadline_secs
            )
        except batcher_mod.QueueFull as e:
            self._abort(context, grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except batcher_mod.DeadlineExpired as e:
            self._abort(context, grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except batcher_mod.Draining as e:
            self._abort(context, grpc.StatusCode.UNAVAILABLE, str(e))
        response = pb.PredictResponse(model_step=step, model_stamp=stamp)
        for name, value in outputs.items():
            tensor_to_blob(value, response.outputs[name])
        self._m_latency.observe(time.perf_counter() - start)
        self._m_requests.labels(code="OK").inc()
        return response

    def model_info(self, request, context):
        info = self._engine.model_info()
        return pb.ModelInfoResponse(
            loaded=info["loaded"],
            step=max(info["step"], 0),
            stamp=info["stamp"],
            model_zoo=info["model_zoo"],
            max_batch=info["max_batch"],
        )
