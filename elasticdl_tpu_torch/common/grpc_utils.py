"""gRPC channel/server helpers (port of elasticdl_tpu/common/grpc_utils.py,
trimmed to build_server, build_channel and find_free_port)."""

import socket
from concurrent import futures

import grpc

from elasticdl_tpu_torch.common.constants import GRPC

_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", GRPC.MAX_SEND_MESSAGE_LENGTH),
    ("grpc.max_receive_message_length", GRPC.MAX_RECEIVE_MESSAGE_LENGTH),
    # grpc's default reconnect backoff grows to 120 s; cap the gap so a
    # relaunched peer is reached within seconds
    ("grpc.max_reconnect_backoff_ms", 10000),
]


def build_channel(addr: str) -> grpc.Channel:
    return grpc.insecure_channel(addr, options=_CHANNEL_OPTIONS)


def build_server(max_workers: int = 64) -> grpc.Server:
    return grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        # so_reuseport=0: one process per port. With SO_REUSEPORT a
        # SIGKILLed predecessor's lingering socket can keep receiving
        # (and black-holing) a share of incoming connections after a
        # same-port relaunch binds.
        options=_CHANNEL_OPTIONS + [("grpc.so_reuseport", 0)],
    )


def find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]
