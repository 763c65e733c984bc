"""Serving role entry point (port of elasticdl_tpu/serve/main.py).

Usage: python -m elasticdl_tpu_torch.serve.main --model_zoo=... \
    --export_dir=/artifacts/model --port=50052 [--device cuda|cpu] \
    [--ps_addrs=host:port,host:port] [--cache_ttl_secs=2]

A model with sparse embedding tables (DeepFM) serves its export's dense
params beside the training job's PS, given by ``--ps_addrs``, through a
row cache of ``--cache_ttl_secs`` that a PS relaunch drops.

Runs on ``cuda`` unless ``--device cpu`` is given; with ``cuda`` and no
card it raises rather than fall back. SIGTERM drains gracefully: stop
admitting, flush the queue, stop the server, exit 0.

Not ported yet: master telemetry, the router (fleet) link, the
/metrics, /healthz and /readyz endpoints, the flight-recorder journal
and the profiler.
"""

import argparse
import signal
import sys
import threading

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
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
        )
        self.server = None
        self._drained = threading.Event()
        # SIGTERM arrival marker: a plain bool write is all the signal
        # handler does; run() polls it and drains (_finish_term)
        self._term_flag = False
        self._term_previous = None

    def prepare(self):
        from elasticdl_tpu_torch.common.grpc_utils import build_server
        from elasticdl_tpu_torch.proto.services import (
            add_serve_servicer_to_server,
        )
        from elasticdl_tpu_torch.serve.servicer import ServeServicer

        self.engine.start()
        self.server = build_server()
        add_serve_servicer_to_server(ServeServicer(self.engine), self.server)
        self.server.add_insecure_port("[::]:%d" % self.args.port)
        self.server.start()
        self._install_sigterm_drain()
        logger.info(
            "serve %d on :%d (export %s, device %s)",
            self.args.serve_id, self.args.port, self.args.export_dir,
            self.engine.device,
        )
        return self

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
        held; then chains any handler installed before ours."""
        self.drain(reason="sigterm")
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
        if self.server is not None:
            self.server.stop(grace=2.0).wait(timeout=5.0)
        if self.ps_client is not None:
            self.ps_client.close()
        logger.info(
            "serve drained (%s): flushed %d, served %d, shed %d",
            reason, flushed, self.engine.batcher.served_total,
            self.engine.batcher.shed_total,
        )

    def run(self, poll_secs=1.0):
        """Serve until stopped; a SIGTERM flag is noticed within one
        poll and drains."""
        while self.server.wait_for_termination(timeout=poll_secs):
            if self._term_flag:
                return self._finish_term()
        return 0


def main(argv=None):
    args = parse_serve_args(argv)
    return ServeRole(args).prepare().run()


if __name__ == "__main__":
    sys.exit(main())
