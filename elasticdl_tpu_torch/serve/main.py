"""Serving role entry point (port of elasticdl_tpu/serve/main.py).

Usage: python -m elasticdl_tpu_torch.serve.main --model_zoo=... \
    --export_dir=/artifacts/model --port=50052 [--device cuda|cpu] \
    [--ps_addrs=host:port,host:port] [--cache_ttl_secs=2] \
    [--router_addr=host:port [--advertise_addr=host:port]]

A model with sparse embedding tables (DeepFM) serves its export's dense
params beside the training job's PS, given by ``--ps_addrs``, through a
row cache of ``--cache_ttl_secs`` that a PS relaunch drops.

Runs on ``cuda`` unless ``--device cpu`` is given; with ``cuda`` and no
card it raises rather than fall back. SIGTERM drains gracefully: stop
admitting, flush the queue, stop the server, exit 0.

Fleet mode (``--router_addr``): the replica registers with the serving
router (``serve/router_main.py``) and heartbeats its telemetry blob and
its loaded / newest available export versions; ``--export_dir`` then
names the versioned export root (one subdirectory per bundle) and the
router directs which version the replica loads (``target_export``).
A ``drain`` directive takes the SIGTERM drain path; every drain ends
with the exactly-once ``deregister_replica`` ack.

Observability: ``--metrics_port`` (or ``EDL_METRICS_PORT``) serves
``/metrics``, ``/healthz`` and ``/readyz`` (503 until the model is
loaded); ``EDL_EVENTS_DIR`` and ``EDL_TRACE_DIR`` turn on the journal
(``role_start``, ``trace_flushed``, ``serve_drained``, ``role_stop``) and
the trace of role ``serve-<id>``; ``--master_addr`` piggybacks the
replica's telemetry blob (queries/s, queue depth, sheds, the cache's hit
rate and ``observability/device.py``'s memory view) on a poll of the
master's ``get_comm_info``.
"""

import argparse
import os
import signal
import sys
import threading
import time

from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import (
    events,
    http_server,
    profiler,
    trace,
)

logger = _logger_factory("elasticdl_tpu_torch.serve.main")


def parse_serve_args(argv=None):
    parser = argparse.ArgumentParser("elasticdl_tpu_torch serve")
    parser.add_argument("--serve_id", type=int, default=0)
    parser.add_argument("--port", type=int, default=50052)
    parser.add_argument("--model_zoo", required=True)
    parser.add_argument("--model_def", default="")
    parser.add_argument("--model_params", default="")
    parser.add_argument(
        "--export_dir", required=True,
        help="export bundle directory (watched for new versions; "
        "hot-swapped with zero request failures)",
    )
    parser.add_argument(
        "--ps_addrs", default="",
        help="comma-separated PS addresses for sparse-embedding models",
    )
    parser.add_argument(
        "--master_addr", default="",
        help="optional: piggyback serving telemetry on the master's "
        "fleet view (/statusz)",
    )
    parser.add_argument(
        "--router_addr", default="",
        help="fleet mode: register with the serving router at this "
        "address and heartbeat telemetry + export versions; "
        "--export_dir then names the VERSIONED export root (one "
        "subdirectory per bundle) and the router directs which "
        "version this replica loads",
    )
    parser.add_argument(
        "--advertise_addr", default="",
        help="address the router should reach this replica at "
        "(default 127.0.0.1:<port>, the local-subprocess topology)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to serve on (cuda, cuda:N or cpu); cuda "
        "without a card raises",
    )
    # must match the training job's compute dtype for prediction parity
    parser.add_argument("--compute_dtype", default="")
    parser.add_argument(
        "--max_batch", type=int, default=0,
        help="rows per formed batch (0 = EDL_SERVE_MAX_BATCH or 32)",
    )
    parser.add_argument(
        "--max_delay_ms", type=float, default=-1.0,
        help="batch formation window (<0 = EDL_SERVE_MAX_DELAY_MS or 5)",
    )
    parser.add_argument(
        "--queue_depth", type=int, default=0,
        help="admission bound; beyond it requests shed "
        "(0 = EDL_SERVE_QUEUE_DEPTH or 256)",
    )
    parser.add_argument(
        "--deadline_ms", type=float, default=-1.0,
        help="default per-request budget when the RPC carries none "
        "(<0 = EDL_SERVE_DEADLINE_MS or 1000)",
    )
    parser.add_argument(
        "--cache_ttl_secs", type=float, default=-1.0,
        help="embedding row cache TTL (<0 = EDL_SERVE_CACHE_TTL_SECS "
        "or 2; 0 disables the cache)",
    )
    parser.add_argument(
        "--watch_secs", type=float, default=-1.0,
        help="export watch interval (<0 = EDL_SERVE_WATCH_SECS or 2)",
    )
    # observability: /metrics + /healthz + /readyz on this port
    # (0/unset = disabled; falls back to EDL_METRICS_PORT)
    parser.add_argument("--metrics_port", type=int, default=0)
    return parser.parse_args(argv)


class ServeRole:
    def __init__(self, args):
        from elasticdl_tpu_torch.serve.engine import ServingEngine

        self.args = args
        self.ps_client = None
        if args.ps_addrs:
            from elasticdl_tpu_torch.worker.ps_client import PSClient

            self.ps_client = PSClient(args.ps_addrs)
        self.engine = ServingEngine(
            args.model_zoo,
            args.export_dir,
            ps_client=self.ps_client,
            model_def=args.model_def,
            model_params=args.model_params,
            compute_dtype=args.compute_dtype or None,
            max_batch=args.max_batch or None,
            max_delay_ms=(
                args.max_delay_ms if args.max_delay_ms >= 0 else None
            ),
            queue_depth=args.queue_depth or None,
            deadline_ms=(
                args.deadline_ms if args.deadline_ms >= 0 else None
            ),
            cache_ttl_secs=(
                args.cache_ttl_secs if args.cache_ttl_secs >= 0 else None
            ),
            watch_secs=args.watch_secs if args.watch_secs >= 0 else None,
            device=args.device,
            directed=bool(args.router_addr),
        )
        self._master_client = None
        if args.master_addr:
            from elasticdl_tpu_torch.worker.master_client import MasterClient

            # a negative id below the PS's -(ps_id + 1): the serve role
            # is neither a worker nor a mesh member
            self._master_client = MasterClient(
                args.master_addr, worker_id=-(1000 + args.serve_id),
            )
            if env_str("EDL_TELEMETRY", "") != "0":
                self._master_client.telemetry_provider = self.telemetry_blob
        self.server = None
        self.observability = None
        self._observing = False
        # the fleet link: register/heartbeat with the router
        self.replica_id = "serve-%d-%d" % (args.serve_id, os.getpid())
        self._advertise_addr = (
            args.advertise_addr or "127.0.0.1:%d" % args.port
        )
        self._router_stub = None
        self._fleet_thread = None
        self._registered = False
        self._drain_reason = "sigterm"
        self._drained = threading.Event()
        # SIGTERM arrival marker: a plain bool write is all the signal
        # handler does; run() polls it and drains (_finish_term)
        self._term_flag = False
        self._term_previous = None
        self._qps_window = (time.monotonic(), 0)  # (ts, served_total)

    def telemetry_blob(self):
        """The replica's piggyback payload: queries/s since the last
        blob, queue depth, sheds, the row cache's hit rate and the
        device's memory view."""
        from elasticdl_tpu_torch.observability import device as device_obs
        from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

        batcher = self.engine.batcher
        now = time.monotonic()
        last_ts, last_served = self._qps_window
        served = batcher.served_total
        elapsed = max(now - last_ts, 1e-6)
        self._qps_window = (now, served)
        info = self.engine.model_info()
        blob = pb.TelemetryBlob(
            role="serve-%d" % self.args.serve_id,
            serve_qps=(served - last_served) / elapsed,
            serve_queue_depth=batcher.pending_count(),
            serve_shed_total=batcher.shed_total,
            model_version=max(info["step"], 0),
            tier_hit_rate=(
                self.engine.cache.hit_rate()
                if self.engine.cache is not None
                else 0.0
            ),
        )
        return device_obs.fill_blob(blob)

    def prepare(self):
        from elasticdl_tpu_torch.common.grpc_utils import build_server
        from elasticdl_tpu_torch.proto.services import (
            add_serve_servicer_to_server,
        )
        from elasticdl_tpu_torch.serve.servicer import ServeServicer

        self.start_observability()
        self.engine.start()
        self.server = build_server()
        add_serve_servicer_to_server(ServeServicer(self.engine), self.server)
        self.server.add_insecure_port("[::]:%d" % self.args.port)
        self.server.start()
        self._install_sigterm_drain()
        if self.args.router_addr:
            self._start_fleet_link()
        logger.info(
            "serve %d on :%d (export %s, device %s)",
            self.args.serve_id, self.args.port, self.args.export_dir,
            self.engine.device,
        )
        return self

    def start_observability(self):
        """The role's trace, journal (``role_start``), host sampler and
        probes, before the model loads: ``/readyz`` answers 503 until it
        has. ``prepare`` calls it; idempotent."""
        if self._observing:
            return self
        self._observing = True
        role = "serve-%d" % self.args.serve_id
        trace.configure(role)
        events.configure(role)
        events.emit("role_start", port=self.args.port)
        # the host stack sampler: on when EDL_PROF_HZ is set, served as
        # /profilez on the observability port below
        profiler.maybe_start(role)
        self.observability = http_server.maybe_start(
            role, cli_port=self.args.metrics_port
        )
        if self.observability is not None:
            self.observability.add_readiness_check(
                "model_loaded", lambda: self.engine.loaded
            )
        return self

    # -- the fleet link ---------------------------------------------------
    def _start_fleet_link(self):
        from elasticdl_tpu_torch.common.grpc_utils import build_channel
        from elasticdl_tpu_torch.proto import services

        self._router_stub = services.RouterStub(
            build_channel(self.args.router_addr)
        )
        self._fleet_thread = threading.Thread(
            target=self._fleet_loop, name="edl-serve-fleet", daemon=True
        )
        self._fleet_thread.start()

    def _fleet_loop(self):
        """Register with the router, then heartbeat until drained.

        Heartbeats carry telemetry and the loaded / newest available
        export versions up and directives down: ``target_export`` steers
        the directed engine (canary, promote, rollback) and ``drain``
        routes this replica through the SIGTERM drain path (stop
        admitting, flush, deregister, exit 0): the run loop sees the
        same flag the signal handler sets."""
        from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
        from elasticdl_tpu_torch.serve.fleet import scan_export_versions

        heartbeat_secs = 2.0
        while not (self._drained.is_set() or self._term_flag):
            try:
                if not self._registered:
                    resp = self._router_stub.register_replica(
                        pb.RegisterReplicaRequest(
                            replica_id=self.replica_id,
                            addr=self._advertise_addr,
                            max_batch=self.engine.batcher.max_batch,
                            model_stamp=self.engine.model_info()["stamp"],
                            telemetry=self.telemetry_blob(),
                        ),
                        timeout=5.0,
                    )
                    if resp.heartbeat_secs > 0:
                        heartbeat_secs = resp.heartbeat_secs
                    if resp.target_export:
                        self.engine.set_target(resp.target_export)
                    self._registered = True
                    logger.info(
                        "registered with router %s as %s",
                        self.args.router_addr, self.replica_id,
                    )
                else:
                    versions = scan_export_versions(self.args.export_dir)
                    newest = versions[-1] if versions else ("", 0, "")
                    info = self.engine.model_info()
                    resp = self._router_stub.heartbeat_replica(
                        pb.ReplicaHeartbeatRequest(
                            replica_id=self.replica_id,
                            loaded_export=self.engine.loaded_export,
                            loaded_stamp=info["stamp"],
                            available_export=newest[0],
                            available_stamp=newest[2],
                            draining=self._term_flag,
                            telemetry=self.telemetry_blob(),
                        ),
                        timeout=5.0,
                    )
                    if not resp.known:
                        # the router restarted (or expired us while
                        # partitioned): re-register from scratch
                        self._registered = False
                        continue
                    if resp.target_export:
                        self.engine.set_target(resp.target_export)
                    if resp.drain:
                        self._drain_reason = "router_drain"
                        self._term_flag = True
                        return
            except Exception:
                # router unreachable: keep trying -- the tier outlives
                # a router restart, and re-registration is idempotent
                logger.debug("router link hiccup", exc_info=True)
            time.sleep(heartbeat_secs if self._registered else 1.0)

    def _deregister(self, reason):
        """The exactly-once drain ack (fleet mode): tell the router the
        queue is flushed so it forgets this replica with no
        ``replica_lost`` alert. Best-effort: with the router gone the
        heartbeat timeout journals the loss instead."""
        if self._router_stub is None or not self._registered:
            return
        self._registered = False
        from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

        try:
            self._router_stub.deregister_replica(
                pb.DeregisterReplicaRequest(
                    replica_id=self.replica_id,
                    reason=reason,
                    served=self.engine.batcher.served_total,
                    shed=self.engine.batcher.shed_total,
                ),
                timeout=5.0,
            )
        except Exception:
            logger.warning(
                "drain ack to router failed (router gone?)", exc_info=True
            )

    def _install_sigterm_drain(self):
        self._term_previous = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            # Flag-only: the handler interrupts the main thread, which
            # may hold the batcher's locks -- draining here would
            # self-deadlock. run() sees the flag within one poll tick.
            self._term_flag = True

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            logger.warning(
                "not on main thread; serve SIGTERM drain not installed"
            )

    def _finish_term(self):
        """The deferred SIGTERM drain, on the run loop with no lock
        held; then chains any handler installed before ours. A router
        drain directive funnels through the same flag with its own
        reason."""
        self.drain(reason=self._drain_reason)
        previous = self._term_previous
        if callable(previous):
            previous(signal.SIGTERM, None)
        return 0

    def drain(self, reason="shutdown"):
        """Stop admitting, flush the queue, stop the server. Idempotent."""
        if self._drained.is_set():
            return
        self._drained.set()
        flushed = self.engine.drain()
        # the drain ack after the flush (its counts are final) and
        # before the server stops: the router already stopped routing
        # here when it directed the drain
        self._deregister(reason)
        # every request span is final once the queue flushed
        trace.flush()
        if trace.enabled():
            events.emit("trace_flushed", reason=reason)
        if self.server is not None:
            self.server.stop(grace=2.0).wait(timeout=5.0)
        if self.ps_client is not None:
            self.ps_client.close()
        logger.info(
            "serve drained (%s): flushed %d, served %d, shed %d",
            reason, flushed, self.engine.batcher.served_total,
            self.engine.batcher.shed_total,
        )
        events.emit(
            "serve_drained", reason=reason, flushed=flushed,
            served=self.engine.batcher.served_total,
            shed=self.engine.batcher.shed_total,
        )
        events.emit("role_stop", reason=reason)
        events.flush()
        if self.observability is not None:
            self.observability.stop()
            self.observability = None

    def run(self, poll_secs=1.0):
        """Serve until stopped; a SIGTERM flag is noticed within one
        poll and drains. With ``--master_addr`` every fifth poll also
        carries the telemetry blob to the master."""
        polls = 0
        while self.server.wait_for_termination(timeout=poll_secs):
            if self._term_flag:
                return self._finish_term()
            polls += 1
            if self._master_client is not None and polls % 5 == 0:
                try:
                    self._master_client.get_comm_info()
                except Exception:
                    logger.debug("telemetry poll failed (master gone?)")
        return 0


def main(argv=None):
    args = parse_serve_args(argv)
    if args.metrics_port:
        # publish before any instrument is constructed: the registry
        # decides enabled/no-op at first touch
        os.environ[http_server.PORT_ENV] = str(args.metrics_port)
    # SIGTERM chain order: the crash hooks first; prepare()'s handler
    # registers last and only flags, run() drains off the signal path
    # and chains into the ring dump and exit 0
    events.install_crash_hooks()
    return ServeRole(args).prepare().run()


if __name__ == "__main__":
    sys.exit(main())
