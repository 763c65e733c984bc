"""Client for the ``elasticdl_tpu.Serve`` service (port of
elasticdl_tpu/serve/client.py). Talks to a server of either package."""

from elasticdl_tpu_torch.common.constants import GRPC
from elasticdl_tpu_torch.common.grpc_utils import build_channel
from elasticdl_tpu_torch.common.tensor_utils import (
    blob_to_tensor,
    tensor_to_blob,
)
from elasticdl_tpu_torch.observability.grpc_metrics import instrument_channel
from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
from elasticdl_tpu_torch.proto.services import ServeStub
from elasticdl_tpu_torch.serve.model import SINGLE_INPUT_KEY


class ServeClient:
    def __init__(self, addr):
        self._channel = instrument_channel(build_channel(addr))
        self._stub = ServeStub(self._channel)

    def predict(self, features, deadline_secs=None, deadline_ms=0,
                affinity_key=0):
        """``features``: dict of batch-leading tensors or arrays, or one
        bare tensor/array (single-input models). Returns (outputs dict
        of CPU tensors, model step, model stamp). ``deadline_secs`` sets
        the gRPC deadline; ``deadline_ms`` rides in-message, and the
        server sheds a request that outlives the tighter of the two."""
        request = pb.PredictRequest(
            deadline_ms=int(deadline_ms),
            affinity_key=int(affinity_key),
        )
        if not isinstance(features, dict):
            features = {SINGLE_INPUT_KEY: features}
        for name, value in features.items():
            tensor_to_blob(value, request.features[name])
        response = self._stub.predict(
            request,
            timeout=(
                deadline_secs if deadline_secs is not None
                else GRPC.DEFAULT_RPC_TIMEOUT_SECS
            ),
        )
        outputs = {
            name: blob_to_tensor(blob)
            for name, blob in response.outputs.items()
        }
        return outputs, response.model_step, response.model_stamp

    def model_info(self):
        response = self._stub.model_info(
            pb.Empty(), timeout=GRPC.DEFAULT_RPC_TIMEOUT_SECS
        )
        return {
            "loaded": response.loaded,
            "step": response.step,
            "stamp": response.stamp,
            "model_zoo": response.model_zoo,
            "max_batch": response.max_batch,
        }

    def close(self):
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
