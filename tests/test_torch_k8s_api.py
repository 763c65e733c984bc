"""The port's ``K8sApi`` (``elasticdl_tpu_torch/k8s/api.py``) against the
JAX package's, over a local plain-HTTP server that records what each
client sends and answers as an API server would.

Every method sends the same verb, path, query, headers that matter and
body; a chunked ``?watch=true`` stream parses to the same events; an
error status raises ``K8sApiError`` with the status; the in-cluster
construction reads the same environment.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import pytest

from elasticdl_tpu.k8s import api as ref_api
from elasticdl_tpu_torch.k8s import api as port_api

WATCH_EVENTS = [
    {"type": "ADDED", "object": {"metadata": {"name": "p0"},
                                 "status": {"phase": "Pending"}}},
    {"type": "MODIFIED", "object": {"metadata": {"name": "p0"},
                                    "status": {"phase": "Running",
                                               "startTime": "t0"}}},
    {"type": "DELETED", "object": {"metadata": {"name": "p0"}}},
]


class _Recorder(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _handle(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        url = urlsplit(self.path)
        self.server.requests.append({
            "method": self.command,
            "path": url.path,
            "query": parse_qs(url.query),
            "content_type": self.headers.get("Content-Type"),
            "authorization": self.headers.get("Authorization"),
            "body": json.loads(body) if body else None,
        })
        if url.path.endswith("/missing"):
            self._json(404, {"kind": "Status", "reason": "NotFound"})
        elif parse_qs(url.query).get("watch") == ["true"]:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for event in WATCH_EVENTS:
                # one event a chunk, a blank keep-alive line between
                for line in (json.dumps(event) + "\n", "\n"):
                    data = line.encode()
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.write(b"0\r\n\r\n")
        else:
            self._json(200, {"kind": "Pod", "echo": self.path})

    def _json(self, status, obj):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    do_GET = do_POST = do_PATCH = do_DELETE = _handle


@pytest.fixture
def server(monkeypatch):
    # the clients reach 127.0.0.1 directly, never through a proxy
    for name in ("HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY", "http_proxy",
                 "https_proxy", "all_proxy"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
    httpd.requests = []
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()


POD = {"apiVersion": "v1", "kind": "Pod",
       "metadata": {"name": "elasticdl-j-worker-0",
                    "labels": {"elasticdl-tpu-job-name": "j"}},
       "spec": {"containers": [{"name": "main", "command": ["true"]}]}}
SERVICE = {"apiVersion": "v1", "kind": "Service",
           "metadata": {"name": "elasticdl-j-worker-0"},
           "spec": {"clusterIP": "None",
                    "ports": [{"port": 3333, "targetPort": 3333}]}}

CALLS = {
    "create_pod": lambda api: api.create_pod(POD),
    "delete_pod": lambda api: api.delete_pod("elasticdl-j-worker-0"),
    "delete_pod_grace": lambda api: api.delete_pod(
        "elasticdl-j-worker-0", grace_period_seconds=30),
    # the pod's own termination grace (a scale-down's delete)
    "delete_pod_own_grace": lambda api: api.delete_pod(
        "elasticdl-j-worker-0", grace_period_seconds=None),
    "get_pod": lambda api: api.get_pod("elasticdl-j-master"),
    "patch_pod_labels": lambda api: api.patch_pod_labels(
        "elasticdl-j-master", {"status": "Finished"}),
    "create_service": lambda api: api.create_service(SERVICE),
    "delete_service": lambda api: api.delete_service("elasticdl-j-ps-1"),
    "watch_pods": lambda api: list(api.watch_pods(
        label_selector="elasticdl-tpu-job-name=j", timeout_seconds=60)),
    "watch_pods_bare": lambda api: list(api.watch_pods()),
}


def _client(module, server, **kwargs):
    kwargs.setdefault("token", "tok")
    kwargs.setdefault("namespace", "ns1")
    return module.K8sApi(
        base_url="http://127.0.0.1:%d" % server.server_address[1],
        verify=False, **kwargs)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_each_method_sends_the_reference_request(server, call):
    answers = []
    for module in (ref_api, port_api):
        answers.append(CALLS[call](_client(module, server)))
    ref_request, port_request = server.requests
    assert port_request == ref_request
    assert answers[1] == answers[0]
    assert port_request["authorization"] == "Bearer tok"
    assert port_request["path"].startswith("/api/v1/namespaces/ns1/")
    if call.startswith("watch"):
        assert answers[1] == [(e["type"], e["object"]) for e in WATCH_EVENTS]
        assert port_request["query"]["watch"] == ["true"]


def test_error_status_raises_with_the_status(server):
    for module in (ref_api, port_api):
        api = _client(module, server)
        with pytest.raises(module.K8sApiError) as err:
            api.get_pod("missing")
        assert err.value.status == 404
        with pytest.raises(module.K8sApiError):
            api.delete_pod("missing")
    assert [r["method"] for r in server.requests] == ["GET", "DELETE"] * 2


def test_in_cluster_construction_reads_the_same_environment(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    for module in (ref_api, port_api):
        with pytest.raises(RuntimeError, match="KUBERNETES_SERVICE_HOST"):
            module.K8sApi()
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    made = [module.K8sApi(token="t") for module in (ref_api, port_api)]
    assert [a.base_url for a in made] == ["https://10.0.0.1:6443"] * 2
    assert [a.namespace for a in made] == ["default"] * 2
    assert made[1]._url("pods", "p") == made[0]._url("pods", "p")
    assert made[1]._verify == made[0]._verify
    assert (made[1]._session.headers["Authorization"]
            == made[0]._session.headers["Authorization"] == "Bearer t")
