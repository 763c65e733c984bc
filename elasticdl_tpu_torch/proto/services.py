"""gRPC bindings for the ``elasticdl_tpu.Master``,
``elasticdl_tpu.Pserver`` and ``elasticdl_tpu.Serve`` services.

Port of elasticdl_tpu/proto/services.py, trimmed to the master, PS and
serving surfaces. The service and method names are the JAX package's, and
``elasticdl_tpu_pb2`` is a verbatim copy of its generated module, so a
client of either package talks to a server of either package.
"""

import grpc

from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

_MASTER_SERVICE = "elasticdl_tpu.Master"
_PSERVER_SERVICE = "elasticdl_tpu.Pserver"
_SERVE_SERVICE = "elasticdl_tpu.Serve"

# method name -> (request class, response class)
_MASTER_METHODS = {
    "get_task": (pb.GetTaskRequest, pb.Task),
    "report_task_result": (pb.ReportTaskResultRequest, pb.Empty),
    "report_evaluation_metrics": (pb.ReportEvaluationMetricsRequest, pb.Empty),
    "report_version": (pb.ReportVersionRequest, pb.Empty),
    "get_comm_info": (pb.GetCommInfoRequest, pb.CommInfo),
    # fresh-incarnation declaration: requeue everything still assigned
    # to this worker_id and answer its master-assigned relaunch epoch,
    # the incarnation the worker stamps on its gradient pushes
    "reset_worker": (pb.GetTaskRequest, pb.ResetWorkerResponse),
    # the graceful-drain ack: a worker that finished draining (task
    # reported, async push joined, device-tier rows flushed) leaves, and
    # the master forgets it with no requeue
    "deregister_worker": (pb.DeregisterWorkerRequest, pb.Empty),
}
_PSERVER_METHODS = {
    "push_model": (pb.Model, pb.Empty),
    "push_embedding_table_infos": (pb.Model, pb.Empty),
    "pull_dense_parameters": (
        pb.PullDenseParametersRequest,
        pb.PullDenseParametersResponse,
    ),
    "pull_embedding_vectors": (pb.PullEmbeddingVectorsRequest, pb.TensorBlob),
    # fused multi-table pull: every table's ids for this shard ride one
    # RPC (ids-only IndexedSlicesProto in, per-table row blobs out)
    "pull_embedding_batch": (pb.BatchedSlices, pb.PullEmbeddingBatchResponse),
    "push_gradients": (pb.PushGradientsRequest, pb.PushGradientsResponse),
    # device-tier writeback: raw row VALUES overwriting the store (no
    # optimizer math, no version bump), in the Model message
    "push_embedding_rows": (pb.Model, pb.PushGradientsResponse),
}

_SERVE_METHODS = {
    "predict": (pb.PredictRequest, pb.PredictResponse),
    "model_info": (pb.Empty, pb.ModelInfoResponse),
}


class _Stub:
    """Unary-unary callables for each method of a service."""

    def __init__(self, channel, service_name, methods):
        for name, (req_cls, resp_cls) in methods.items():
            setattr(
                self,
                name,
                channel.unary_unary(
                    "/%s/%s" % (service_name, name),
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString,
                ),
            )


class MasterStub(_Stub):
    def __init__(self, channel):
        super().__init__(channel, _MASTER_SERVICE, _MASTER_METHODS)


class PserverStub(_Stub):
    def __init__(self, channel):
        super().__init__(channel, _PSERVER_SERVICE, _PSERVER_METHODS)


class ServeStub(_Stub):
    def __init__(self, channel):
        super().__init__(channel, _SERVE_SERVICE, _SERVE_METHODS)


def _add_service(server, servicer, service_name, methods):
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
        for name, (req_cls, resp_cls) in methods.items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service_name, handlers),)
    )


def add_master_servicer_to_server(servicer, server):
    _add_service(server, servicer, _MASTER_SERVICE, _MASTER_METHODS)


def add_pserver_servicer_to_server(servicer, server):
    _add_service(server, servicer, _PSERVER_SERVICE, _PSERVER_METHODS)


def add_serve_servicer_to_server(servicer, server):
    _add_service(server, servicer, _SERVE_SERVICE, _SERVE_METHODS)
