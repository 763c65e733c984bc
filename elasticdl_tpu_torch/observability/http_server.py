"""Metrics exposition + liveness/readiness endpoints for every role.

(Copy of elasticdl_tpu/observability/http_server.py for the PyTorch port.)

A stdlib ``http.server`` daemon thread serving:

- ``GET /metrics`` — Prometheus text format 0.0.4 from the registry
- ``GET /healthz`` — liveness: 200 while the process serves at all
- ``GET /readyz``  — readiness: 200 only when every registered
  role-specific check passes (master → servicer started; PS → model
  initialized; worker → master channel ready), else 503 listing the
  failing checks — the pod manager's signal to hold traffic, not
  restart.
- ``GET /profilez`` — the continuous profiler: the rolling
  ring snapshot by default, ``?seconds=N`` for an on-demand window
  capture, ``&format=collapsed`` for flamegraph-ready text instead of
  JSON. Answers 404 when the profiler is disabled (``EDL_PROF_HZ``
  unset) — the disabled state must be visible, not an empty profile.
- role-registered JSON endpoints (``add_json_handler``): the master
  mounts ``/statusz`` (full fleet telemetry snapshot) and ``/alerts``
  (firing anomaly detectors) here — see master/fleet.py.

Knobs: ``--metrics_port`` on each role's CLI, falling back to
``EDL_METRICS_PORT``; 0 (the default) starts nothing, so tests/CI and
benchmarks are unaffected unless they opt in.
"""

import http.server
import json
import threading
import urllib.parse

from elasticdl_tpu_torch.common.env_utils import env_int, env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import metrics as metrics_mod

logger = _logger_factory("elasticdl_tpu_torch.observability.http_server")

PORT_ENV = metrics_mod.PORT_ENV

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)
EXEMPLARS_ENV = metrics_mod.EXEMPLARS_ENV


def resolve_port(cli_port=None):
    """Effective metrics port: CLI flag wins, then EDL_METRICS_PORT,
    then 0 (disabled)."""
    if cli_port:
        return int(cli_port)
    return env_int(PORT_ENV, 0)


class ObservabilityServer:
    """Daemon-thread HTTP server for one role's /metrics + probes."""

    def __init__(self, role, port, registry=None):
        self.role = role
        self.port = int(port)
        self.registry = registry or metrics_mod.default_registry()
        self._checks = []  # [(name, callable -> bool)]
        self._json_handlers = {}  # path -> callable -> JSON-able obj
        self._httpd = None
        self._thread = None
        self.registry.gauge(
            "edl_up", "1 while the role's process is serving", ("role",)
        ).labels(role=role).set(1)

    def add_readiness_check(self, name, check):
        """``check()`` -> truthy when this aspect of the role is ready.
        A check that raises counts as not ready."""
        self._checks.append((name, check))

    def add_json_handler(self, path, fn):
        """Serve ``fn()`` (any JSON-serializable object) on GET
        ``path``. A raising handler answers 500 with the error text —
        a broken snapshot source must not take the whole server down."""
        self._json_handlers[path] = fn

    def readiness(self):
        """(ready, [failing check names])."""
        failing = []
        for name, check in self._checks:
            try:
                ok = bool(check())
            except Exception as e:
                logger.warning("readiness check %s raised: %s", name, e)
                ok = False
            if not ok:
                failing.append(name)
        return not failing, failing

    # ------------------------------------------------------------------
    def start(self):
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    # exemplars ride only the content-
                    # negotiated OpenMetrics path or the explicit env
                    # opt-in. Negotiation is deliberately EXCLUSIVE: a
                    # stock Prometheus advertises openmetrics AND a
                    # text/plain fallback in its default Accept, and
                    # switching it onto this pragmatic exposition
                    # (0.0.4 naming + exemplar suffixes) would regress
                    # a consumer that parsed fine yesterday — so any
                    # client offering a text/plain fallback gets plain
                    # 0.0.4, and only a deliberate openmetrics-only
                    # Accept (an operator chasing an exemplar) switches.
                    accept = self.headers.get("Accept", "") or ""
                    negotiated = (
                        "application/openmetrics-text" in accept
                        and "text/plain" not in accept
                    )
                    env_gated = env_str(
                        EXEMPLARS_ENV, ""
                    ) not in ("", "0")
                    text = server.registry.render(
                        exemplars=negotiated or env_gated
                    )
                    content_type = CONTENT_TYPE
                    if negotiated:
                        text += "# EOF\n"
                        content_type = OPENMETRICS_CONTENT_TYPE
                    self._reply(200, text.encode("utf-8"), content_type)
                elif path == "/healthz":
                    self._reply(200, b"ok\n")
                elif path == "/readyz":
                    ready, failing = server.readiness()
                    if ready:
                        self._reply(200, b"ready\n")
                    else:
                        self._reply(
                            503,
                            ("unready: %s\n" % ",".join(failing)).encode(),
                        )
                elif path == "/profilez":
                    self._serve_profilez()
                elif path in server._json_handlers:
                    try:
                        body = json.dumps(
                            server._json_handlers[path]()
                        ).encode("utf-8")
                    except Exception as e:
                        # a broken snapshot source degrades to a 500,
                        # never takes the probe server down
                        logger.warning("%s handler failed: %s", path, e)
                        self._reply(
                            500, ("error: %s\n" % e).encode("utf-8")
                        )
                        return
                    self._reply(200, body, "application/json")
                else:
                    self._reply(404, b"not found\n")

            def _serve_profilez(self):
                # imported lazily: the probe server must not pull the
                # profiler module in for roles that never profile
                from elasticdl_tpu_torch.observability import profiler

                sampler = profiler.sampler()
                if sampler is None:
                    self._reply(
                        404,
                        b"profiler disabled (set EDL_PROF_HZ)\n",
                    )
                    return
                query = urllib.parse.parse_qs(
                    urllib.parse.urlsplit(self.path).query
                )
                try:
                    seconds = float(query.get("seconds", ["0"])[0] or 0)
                except ValueError:
                    self._reply(400, b"bad seconds parameter\n")
                    return
                fmt = query.get("format", ["json"])[0]
                if fmt not in ("json", "collapsed"):
                    self._reply(
                        400, b"format must be json or collapsed\n"
                    )
                    return
                try:
                    # a window capture blocks only THIS handler thread
                    # (ThreadingHTTPServer); probes keep answering
                    snap = (
                        sampler.capture(seconds)
                        if seconds > 0
                        else sampler.snapshot()
                    )
                except Exception as e:
                    logger.warning("/profilez failed: %s", e)
                    self._reply(
                        500, ("error: %s\n" % e).encode("utf-8")
                    )
                    return
                if fmt == "collapsed":
                    self._reply(
                        200, profiler.collapsed(snap).encode("utf-8")
                    )
                else:
                    self._reply(
                        200,
                        json.dumps(snap).encode("utf-8"),
                        "application/json",
                    )

            def _reply(self, status, body, content_type="text/plain"):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # probe traffic must not spam the job log

        self._httpd = http.server.ThreadingHTTPServer(
            ("0.0.0.0", self.port), Handler
        )
        self._httpd.daemon_threads = True
        # port may have been 0-adjacent (tests pass an ephemeral 0 via
        # explicit Server construction); record what the OS gave us
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="edl-observability-%s" % self.role,
            daemon=True,
        )
        self._thread.start()
        logger.info(
            "%s observability on :%d (/metrics /healthz /readyz)",
            self.role, self.port,
        )
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def maybe_start(role, cli_port=None, registry=None):
    """Start an ObservabilityServer when a port is configured; None
    otherwise. The single call every role entry point makes."""
    port = resolve_port(cli_port)
    if port <= 0:
        return None
    try:
        return ObservabilityServer(role, port, registry=registry).start()
    except OSError as e:
        # a busy port must not kill the job — telemetry is best-effort
        logger.warning(
            "could not start %s observability server on :%d: %s",
            role, port, e,
        )
        return None
