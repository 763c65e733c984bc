"""A Kubernetes REST client for one namespace's pods and Services (port
of elasticdl_tpu/k8s/api.py).

It speaks the REST API over ``requests`` and authenticates the way
in-cluster clients do: the service account's bearer token and the
cluster CA under /var/run/secrets/kubernetes.io/serviceaccount/, the
API server from KUBERNETES_SERVICE_HOST/PORT (or ``base_url``). Watches
are the ``?watch=true`` chunked-JSON stream.

Everything above this module (``Client``, ``InstanceManager``,
``K8sPodManager``) takes the api object by injection, so tests and
``chip_smoke.py`` drive them with a double of the same surface.
"""

import json
import os

import requests

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class K8sApiError(RuntimeError):
    def __init__(self, status, message):
        super().__init__("K8s API %s: %s" % (status, message))
        self.status = status


class K8sApi:
    """Pods + services in one namespace."""

    def __init__(
        self, base_url=None, token=None, namespace=None, verify=None
    ):
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.base_url = base_url or (
            "https://%s:%s" % (host, port) if host else None
        )
        if self.base_url is None:
            raise RuntimeError(
                "Not in a cluster (no KUBERNETES_SERVICE_HOST) and no "
                "base_url given"
            )
        if token is None and os.path.exists(os.path.join(SA_DIR, "token")):
            with open(os.path.join(SA_DIR, "token")) as f:
                token = f.read().strip()
        self._token = token
        ca_path = os.path.join(SA_DIR, "ca.crt")
        if verify is None:
            verify = ca_path if os.path.exists(ca_path) else True
        self._verify = verify
        if namespace is None:
            ns_path = os.path.join(SA_DIR, "namespace")
            if os.path.exists(ns_path):
                with open(ns_path) as f:
                    namespace = f.read().strip()
        self.namespace = namespace or "default"
        self._session = requests.Session()
        if self._token:
            self._session.headers["Authorization"] = (
                "Bearer " + self._token
            )

    # ------------------------------------------------------------------
    def _url(self, kind, name=None):
        url = "%s/api/v1/namespaces/%s/%s" % (
            self.base_url,
            self.namespace,
            kind,
        )
        return url + "/" + name if name else url

    def _check(self, resp):
        if resp.status_code >= 300:
            raise K8sApiError(resp.status_code, resp.text[:500])
        return resp.json()

    # ------------------------------------------------------------------
    def create_pod(self, manifest):
        return self._check(
            self._session.post(
                self._url("pods"), json=manifest, verify=self._verify
            )
        )

    def delete_pod(self, name, grace_period_seconds=0):
        return self._check(
            self._session.delete(
                self._url("pods", name),
                json={"gracePeriodSeconds": grace_period_seconds},
                verify=self._verify,
            )
        )

    def get_pod(self, name):
        return self._check(
            self._session.get(
                self._url("pods", name), verify=self._verify
            )
        )

    def patch_pod_labels(self, name, labels):
        return self._check(
            self._session.patch(
                self._url("pods", name),
                json={"metadata": {"labels": labels}},
                headers={
                    "Content-Type": "application/strategic-merge-patch+json"
                },
                verify=self._verify,
            )
        )

    def create_service(self, manifest):
        return self._check(
            self._session.post(
                self._url("services"), json=manifest, verify=self._verify
            )
        )

    def delete_service(self, name):
        return self._check(
            self._session.delete(
                self._url("services", name), verify=self._verify
            )
        )

    def watch_pods(self, label_selector=None, timeout_seconds=None):
        """Yield (event_type, pod_dict) from a chunked watch stream."""
        params = {"watch": "true"}
        if label_selector:
            params["labelSelector"] = label_selector
        if timeout_seconds:
            params["timeoutSeconds"] = str(timeout_seconds)
        with self._session.get(
            self._url("pods"),
            params=params,
            stream=True,
            verify=self._verify,
        ) as resp:
            if resp.status_code >= 300:
                raise K8sApiError(resp.status_code, resp.text[:500])
            for line in resp.iter_lines():
                if not line:
                    continue
                event = json.loads(line)
                yield event.get("type"), event.get("object", {})
