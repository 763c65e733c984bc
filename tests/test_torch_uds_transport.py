"""The port's local transport: gRPC over unix-domain sockets.

Under EDL_PS_UDS_DIR a PS binds a socket named by its TCP port beside
the TCP listener, and ``build_channel`` to a LOCAL host:port prefers
that socket when it exists. The cases of tests/test_uds_transport.py,
held on the port's ``grpc_utils``, ``ps/server.py`` and ``PSClient``:

- a server bound ONLY on the socket still serves a client built from
  its host:port address, for each pairing of the two packages' clients
  and servicers, with pulls bit-equal to the reference pairing's;
- the address rewrite declines (env unset, socket absent, remote host)
  exactly as the reference's does, and TCP then serves;
- a ``python -m elasticdl_tpu_torch.ps.server`` process under UDS is
  SIGKILLed and relaunched on the SAME socket path: the relaunch
  unlinks the stale socket and rebinds it, the surviving client's
  channel reconnects without a rebuild and fires ``resync_hook``, and a
  SIGTERM drain unlinks the socket.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from elasticdl_tpu.common import grpc_utils as ref_grpc_utils
from elasticdl_tpu.proto import services as ref_services
from elasticdl_tpu.ps import embedding_store as ref_store
from elasticdl_tpu.ps import servicer as ref_servicer
from elasticdl_tpu.worker import ps_client as ref_ps_client
from elasticdl_tpu_torch.common import grpc_utils
from elasticdl_tpu_torch.proto import services
from elasticdl_tpu_torch.ps import embedding_store as port_store
from elasticdl_tpu_torch.ps import servicer as port_servicer
from elasticdl_tpu_torch.worker import ps_client as port_ps_client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "ref": dict(store=ref_store, servicer=ref_servicer.PserverServicer,
                client=ref_ps_client.PSClient, services=ref_services,
                grpc_utils=ref_grpc_utils),
    "port": dict(store=port_store, servicer=port_servicer.PserverServicer,
                 client=port_ps_client.PSClient, services=services,
                 grpc_utils=grpc_utils),
}
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port"), ("ref", "ref")]
PAIR_IDS = ["%s-client-%s-ps" % p for p in PAIRS]
IDS = np.arange(6, dtype=np.int64)


def _serve(pkg, address):
    """A server of package ``pkg`` (numpy store, seed 0, sgd lr 0.1,
    async) bound on ``address`` only."""
    spec = PKGS[pkg]
    store = spec["store"].NumpyEmbeddingStore(seed=0)
    store.set_optimizer("sgd", lr=0.1)
    server = spec["grpc_utils"].build_server(max_workers=8)
    spec["services"].add_pserver_servicer_to_server(
        spec["servicer"](store, use_async=True), server)
    assert server.add_insecure_port(address)
    server.start()
    return server, store


def _exchange(client_pkg, addr):
    """Register, pull, push once and pull again through a client of
    ``client_pkg``; returns the two pulls."""
    client = PKGS[client_pkg]["client"]([addr])
    client.push_embedding_table_infos([("t", 4, "0.05")])
    rows = client.pull_embedding_batch({"t": IDS})["t"]
    result = client.push_gradients(
        {"t": (np.ones((len(IDS), 4), np.float32), IDS)})
    assert result[0] and result[1] == 1
    return rows, client.pull_embedding_batch({"t": IDS})["t"]


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=PAIR_IDS)
def test_channel_rides_uds_when_socket_exists(client_pkg, server_pkg,
                                              tmp_path, monkeypatch):
    monkeypatch.setenv("EDL_PS_UDS_DIR", str(tmp_path))
    port = grpc_utils.find_free_port()
    path = grpc_utils.uds_socket_path(port)
    assert path == ref_grpc_utils.uds_socket_path(port)
    # NO TCP listener on `port`: an RPC succeeding proves UDS carried it
    server, store = _serve(server_pkg, "unix:" + path)
    try:
        addr = "localhost:%d" % port
        assert grpc_utils.maybe_uds_addr(addr) == "unix:" + path
        assert ref_grpc_utils.maybe_uds_addr(addr) == "unix:" + path
        before, after = _exchange(client_pkg, addr)
        assert store.table_names() == ["t"]
    finally:
        server.stop(0)
    # the reference pairing over its own socket gives the same bits
    ref_port = grpc_utils.find_free_port()
    server, _ = _serve("ref", "unix:" + grpc_utils.uds_socket_path(ref_port))
    try:
        want = _exchange("ref", "localhost:%d" % ref_port)
    finally:
        server.stop(0)
    np.testing.assert_array_equal(before, want[0])
    np.testing.assert_array_equal(after, want[1])
    np.testing.assert_allclose(after, before - np.float32(0.1), rtol=1e-6)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_rewrite_declines_without_env(pkg, monkeypatch):
    utils = PKGS[pkg]["grpc_utils"]
    monkeypatch.delenv("EDL_PS_UDS_DIR", raising=False)
    assert utils.maybe_uds_addr("localhost:50002") is None
    assert utils.uds_socket_path(50002) is None


def test_rewrite_declines_for_remote_host_and_missing_socket(
    tmp_path, monkeypatch
):
    monkeypatch.setenv("EDL_PS_UDS_DIR", str(tmp_path))
    addrs = ["localhost:50002", "127.0.0.1:50002", "[::1]:50002",
             "ps-pod-7.svc.cluster.local:50002", "localhost:http",
             "50002"]

    def rewrites():
        got = [grpc_utils.maybe_uds_addr(a) for a in addrs]
        assert got == [ref_grpc_utils.maybe_uds_addr(a) for a in addrs]
        return got

    # no socket file yet -> TCP even though the env is set
    assert rewrites() == [None] * len(addrs)
    # a remote host or a named port never rewrites, socket or not; a
    # bare port is a local address
    path = grpc_utils.uds_socket_path(50002)
    with open(path, "w"):
        pass
    uds = "unix:" + path
    assert rewrites() == [uds, uds, uds, None, None, uds]


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=PAIR_IDS)
def test_tcp_fallback_serves_when_env_unset(client_pkg, server_pkg,
                                            monkeypatch):
    """The same topology with the knob unset works over plain TCP."""
    monkeypatch.delenv("EDL_PS_UDS_DIR", raising=False)
    port = grpc_utils.find_free_port()
    server, store = _serve(server_pkg, "localhost:%d" % port)
    try:
        before, after = _exchange(client_pkg, "localhost:%d" % port)
        assert store.table_names() == ["t"]
    finally:
        server.stop(0)
    np.testing.assert_allclose(after, before - np.float32(0.1), rtol=1e-6)


# ---------------------------------------------------------------------------
# SIGKILL the port's PS under UDS, relaunch on the same socket path


def _spawn_ps(port, uds_dir):
    return subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.ps.server",
         "--ps_id", "0", "--num_ps_pods", "1", "--port", str(port),
         "--opt_type", "sgd", "--opt_args", "lr=0.1",
         "--use_async", "true", "--use_native_store", "0"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                           EDL_PS_UDS_DIR=uds_dir),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_ps_sigkill_relaunch_same_socket(tmp_path, monkeypatch):
    uds_dir = str(tmp_path / "uds")
    monkeypatch.setenv("EDL_PS_UDS_DIR", uds_dir)
    port = grpc_utils.find_free_port()
    path = grpc_utils.uds_socket_path(port)
    ps = _spawn_ps(port, uds_dir)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(path):
            assert ps.poll() is None and time.monotonic() < deadline, \
                "PS never bound its socket"
            time.sleep(0.1)
        # the channel rides UDS: the socket existed at build time
        assert grpc_utils.maybe_uds_addr("localhost:%d" % port) == \
            "unix:" + path
        client = port_ps_client.PSClient(["localhost:%d" % port])
        client.push_embedding_table_infos([("t", 4, "zeros")])
        grads = np.ones((len(IDS), 4), np.float32)
        for step in range(1, 4):
            result = client.push_gradients({"t": (grads, IDS)})
            assert result.accepted and result.version == step
        np.testing.assert_array_equal(
            client.pull_embedding_batch({"t": IDS})["t"],
            np.full((len(IDS), 4), -0.3, np.float32))

        ps.send_signal(signal.SIGKILL)
        ps.wait(timeout=30)
        # the socket file lingers after SIGKILL; the relaunch unlinks
        # and rebinds the SAME path
        assert os.path.exists(path)
        ps = _spawn_ps(port, uds_dir)
        resynced = []
        client.resync_hook = resynced.append
        # the surviving client (no channel rebuild) reconnects through
        # its retry loop and re-creates the table on the fresh store
        client.push_embedding_table_infos([("t", 4, "zeros")])
        result = client.push_gradients({"t": (grads, IDS)})
        # the fresh store's version regressed from 3 to 1: resync
        assert result.accepted and result.version == 1
        assert resynced == [0]
        np.testing.assert_array_equal(
            client.pull_embedding_batch({"t": IDS})["t"],
            np.full((len(IDS), 4), -0.1, np.float32))

        # an orderly SIGTERM drain must UNLINK the socket: a lingering
        # file would hijack later channels to a reused local port
        ps.send_signal(signal.SIGTERM)
        assert ps.wait(timeout=30) == 0
        assert not os.path.exists(path), "drained PS left its socket"
        assert grpc_utils.maybe_uds_addr("localhost:%d" % port) is None
    finally:
        if ps.poll() is None:
            ps.kill()
            ps.wait(timeout=30)
    out = ps.stdout.read()
    assert "also serving on %s" % path in out, out
