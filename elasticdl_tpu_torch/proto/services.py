"""gRPC bindings for the ``elasticdl_tpu.Serve`` service.

Port of elasticdl_tpu/proto/services.py, trimmed to the serving surface.
The service and method names are the JAX package's, and
``elasticdl_tpu_pb2`` is a verbatim copy of its generated module, so a
client of either package talks to a server of either package.
"""

import grpc

from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

_SERVE_SERVICE = "elasticdl_tpu.Serve"

# method name -> (request class, response class)
_SERVE_METHODS = {
    "predict": (pb.PredictRequest, pb.PredictResponse),
    "model_info": (pb.Empty, pb.ModelInfoResponse),
}


class ServeStub:
    def __init__(self, channel):
        for name, (req_cls, resp_cls) in _SERVE_METHODS.items():
            setattr(
                self,
                name,
                channel.unary_unary(
                    "/%s/%s" % (_SERVE_SERVICE, name),
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString,
                ),
            )


def add_serve_servicer_to_server(servicer, server):
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
        for name, (req_cls, resp_cls) in _SERVE_METHODS.items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVE_SERVICE, handlers),)
    )
