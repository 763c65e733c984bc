"""Serving-router role entry point (port of
elasticdl_tpu/serve/router_main.py).

Usage: python -m elasticdl_tpu_torch.serve.router_main --port=50060 \
    [--min_replicas=2 --max_replicas=8 \
     --export_root=/artifacts/exports \
     --replica_args="--model_zoo=... --device=cuda"]

One process, two gRPC surfaces (``serve/router.py``): clients point
``--serving_addr`` here exactly as they would at a single serve pod;
replicas register/heartbeat/deregister on the Router surface. The 1 Hz
control loop expires silent replicas, advances the canary state
machine, and, when a scaler is available, runs the
``ReplicaAutoscaler``. With ``--replica_args`` the router manages its
own local replica subprocesses (``elasticdl_tpu_torch.serve.main
--router_addr``); without it the replica set is whatever registers.
The router itself runs on the host and touches no device.

Observability: ``--metrics_port`` (or ``EDL_METRICS_PORT``) serves
``/metrics``, ``/healthz``, ``/readyz`` (ready = at least one routable
replica) and ``/routerz`` (registry, ring, in-flight and canary view,
plus the autoscaler's state); ``EDL_EVENTS_DIR`` journals the replica
lifecycle, scale and canary decisions; SIGTERM drains (the server
stops, self-managed replicas drain through their own path).

Not ported yet: the fault injector's role tag (``faults.set_role``).
"""

import argparse
import os
import shlex
import signal
import sys
import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_int
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.serve.router_main")

ROUTER_PORT_ENV = "EDL_ROUTER_PORT"


def parse_router_args(argv=None):
    parser = argparse.ArgumentParser("elasticdl_tpu_torch serve router")
    parser.add_argument("--router_id", type=int, default=0)
    parser.add_argument(
        "--port", type=int, default=0,
        help="client+replica gRPC port (0 = EDL_ROUTER_PORT or 50060)",
    )
    parser.add_argument(
        "--min_replicas", type=int, default=-1,
        help="autoscaler floor (<0 = EDL_SERVE_MIN_REPLICAS or 1)",
    )
    parser.add_argument(
        "--max_replicas", type=int, default=-1,
        help="autoscaler ceiling (<0 = EDL_SERVE_MAX_REPLICAS or 8)",
    )
    parser.add_argument(
        "--export_root", default="",
        help="versioned export root replicas load from; required for "
        "--replica_args self-managed replicas",
    )
    parser.add_argument(
        "--replica_args", default="",
        help="extra serve.main args for self-managed replica "
        "subprocesses (e.g. \"--model_zoo=... --ps_addrs=...\"); "
        "empty = replicas are managed externally and only register",
    )
    parser.add_argument(
        "--replica_log_dir", default="",
        help="per-replica log files for self-managed replicas "
        "(default: inherit this process's stdio)",
    )
    parser.add_argument("--metrics_port", type=int, default=0)
    return parser.parse_args(argv)


class RouterRole:
    def __init__(self, args):
        self.args = args
        self.port = args.port or env_int(ROUTER_PORT_ENV, 50060)
        self.servicer = None
        self.autoscaler = None
        self.scaler = None
        self.server = None
        self.observability = None
        self._drained = threading.Event()
        # SIGTERM arrival marker — flag-only, like every role: the
        # handler must not drain while the interrupted thread may hold
        # registry/journal locks; run() polls and drains off-signal
        self._term_flag = False
        self._term_previous = None

    # ------------------------------------------------------------------
    def prepare(self):
        from elasticdl_tpu_torch.common.grpc_utils import build_server
        from elasticdl_tpu_torch.observability import (
            events,
            http_server,
            profiler,
            trace,
        )
        from elasticdl_tpu_torch.proto.services import (
            add_router_servicer_to_server,
            add_serve_servicer_to_server,
        )
        from elasticdl_tpu_torch.serve.fleet import (
            ReplicaAutoscaler,
            SubprocessReplicaScaler,
        )
        from elasticdl_tpu_torch.serve.router import RouterServicer

        role = "router-%d" % self.args.router_id
        trace.configure(role)
        events.configure(role)
        events.emit("role_start", port=self.port)
        profiler.maybe_start(role)
        self.servicer = RouterServicer()
        if self.args.replica_args:
            if not self.args.export_root:
                raise SystemExit(
                    "--replica_args needs --export_root (the versioned "
                    "export directory replicas load from)"
                )
            self.scaler = SubprocessReplicaScaler(
                "127.0.0.1:%d" % self.port,
                self.args.export_root,
                extra_args=shlex.split(self.args.replica_args),
                log_dir=self.args.replica_log_dir or None,
            )
        if self.scaler is not None:
            self.autoscaler = ReplicaAutoscaler(
                self.servicer.registry,
                self.scaler,
                min_replicas=(
                    self.args.min_replicas
                    if self.args.min_replicas >= 0 else None
                ),
                max_replicas=(
                    self.args.max_replicas
                    if self.args.max_replicas >= 0 else None
                ),
            )
        self.server = build_server()
        add_serve_servicer_to_server(self.servicer, self.server)
        add_router_servicer_to_server(self.servicer, self.server)
        self.server.add_insecure_port("[::]:%d" % self.port)
        self.server.start()
        self.observability = http_server.maybe_start(
            role, cli_port=self.args.metrics_port
        )
        if self.observability is not None:
            # ready = the tier can answer a predict at all
            self.observability.add_readiness_check(
                "routable_replica",
                lambda: bool(self.servicer.registry.routable_ids()),
            )
            self.observability.add_json_handler(
                "/routerz", self._routerz
            )
        self._install_sigterm_drain()
        logger.info("router %d on :%d", self.args.router_id, self.port)
        return self

    def _routerz(self):
        state = self.servicer.state()
        if self.autoscaler is not None:
            state["autoscaler"] = self.autoscaler.state()
        return state

    def _install_sigterm_drain(self):
        self._term_previous = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            self._term_flag = True  # flag-only; run() drains

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            logger.warning(
                "not on main thread; router SIGTERM drain not installed"
            )

    def _finish_term(self):
        self.drain(reason="sigterm")
        previous = self._term_previous
        if callable(previous):
            previous(signal.SIGTERM, None)
        return 0

    def drain(self, reason="shutdown"):
        """Stop the server; self-managed replicas are SIGTERMed too
        (they drain through their own path and ack). Externally
        managed replicas are left running — a router restart must not
        take the tier down with it."""
        from elasticdl_tpu_torch.observability import events, trace

        if self._drained.is_set():
            return
        self._drained.set()
        try:
            if self.server is not None:
                self.server.stop(grace=2.0).wait(timeout=5.0)
        except Exception:
            logger.exception("server stop at drain failed")
        if self.scaler is not None:
            try:
                self.scaler.stop_all()
            except Exception:
                logger.exception("replica stop at drain failed")
        trace.flush()
        if trace.enabled():
            events.emit("trace_flushed", reason=reason)
        events.emit("role_stop", reason=reason)
        events.flush()
        if self.observability is not None:
            self.observability.stop()
            self.observability = None

    def run(self, tick_secs=1.0):
        """The control loop: replica expiry, canary state machine,
        autoscaler — one pass a second until stopped."""
        while not self._drained.is_set():
            time.sleep(tick_secs)
            if self._term_flag:
                return self._finish_term()
            try:
                self.servicer.tick()
                if self.scaler is not None:
                    self.scaler.reap()
                if self.autoscaler is not None:
                    self.autoscaler.tick()
            except Exception:
                logger.exception("router tick failed")
        return 0


def main(argv=None):
    args = parse_router_args(argv)
    from elasticdl_tpu_torch.testing import faults

    # before any channel or server is built: fault specs match on role
    faults.set_role("router-%d" % args.router_id)
    if args.metrics_port:
        from elasticdl_tpu_torch.observability import http_server

        # publish before any instrument is constructed: the registry
        # decides enabled/no-op at first touch
        os.environ[http_server.PORT_ENV] = str(args.metrics_port)
    from elasticdl_tpu_torch.observability import events

    events.install_crash_hooks()
    return RouterRole(args).prepare().run()


if __name__ == "__main__":
    sys.exit(main())
