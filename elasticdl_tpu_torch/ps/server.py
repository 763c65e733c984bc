"""Parameter server process (port of elasticdl_tpu/ps/server.py).

Serves the Pserver gRPC service over one shard's embedding store (the
native store unless ``--use_native_store 0`` or it cannot be built).
The PS runs on the host: it touches no card, in this package as in the
reference, which runs it with ``JAX_PLATFORMS=cpu``.

    python -m elasticdl_tpu_torch.ps.server --ps_id 0 --num_ps_pods 2 \\
        --port 50002 --opt_type adam --opt_args lr=0.001 \\
        [--master_addr host:port] [--checkpoint_dir DIR \\
        --checkpoint_steps N [--keep_checkpoint_max 3]] \\
        [--checkpoint_dir_for_init DIR]

Checkpoints (ps/checkpoint.py): with ``--checkpoint_dir`` the PS saves
its shard every ``--checkpoint_steps`` versions (a full base, then
deltas of the changed rows), keeping ``--keep_checkpoint_max`` chains.
At boot it restores by itself: ``--checkpoint_dir_for_init`` if given
(warm start from another job's directory), else the newest complete
checkpoint in ``--checkpoint_dir``. The store's version clock is set to
the restored version, and every push and pull response carries it, so a
worker sees a relaunched PS and resyncs. A SIGKILLed PS relaunched with
the same flags therefore loses only the versions after its newest
checkpoint.

With ``--master_addr`` the PS follows the master: it polls
``get_comm_info`` every 5 seconds (at most half the grace), and once
the master has not answered for ``EDL_PS_MASTER_GONE_SECS`` (90, long
enough to ride out a master relaunch) it stops serving and exits 0.
Without it, it serves until it is stopped.

SIGTERM drains: the server stops taking RPCs, a buffered partial sync
round is applied and a final full checkpoint saved
(``PserverServicer.graceful_stop``), and the process exits 0. The
master-gone exit and the end of a masterless run drain the checkpoint
thread first.

Observability: ``--metrics_port`` (or ``EDL_METRICS_PORT``) serves
``/metrics``, ``/healthz`` and ``/readyz`` (ready once a table or the
dense init exists); ``EDL_EVENTS_DIR`` and ``EDL_TRACE_DIR`` turn on
the journal (``role_start``, ``ps_restored``, checkpoints, ``role_stop``)
and the trace of role ``ps-<id>``. With ``--master_addr`` each poll
carries the servicer's ``telemetry_blob`` to the master's fleet monitor
(``EDL_TELEMETRY=0`` opts out).

The embedding lifecycle (stream/lifecycle.py) is on when an
``EDL_EMB_*`` policy knob is set (``EDL_EMB_ADMIT_K``,
``EDL_EMB_MAX_ROWS`` or ``EDL_EMB_TTL_SECS``): the run loop is its
clock, sweeping every ``EDL_EMB_SWEEP_SECS`` (5), and after a restore
it re-anchors on the restored rows. With ``EDL_STREAM_CHECKPOINT_EVERY``
and ``--master_addr`` the PS polls the master at every loop tick
(0.5 s) and saves a sparse checkpoint each time the master's record
watermark crosses a boundary of that many records. The run loop also
runs the table-health scan (``EDL_HEALTH_SCAN_SECS``). With
``--master_addr`` the PS reports every version it reaches to the master
(the evaluation service's version trigger).
"""

import argparse
import os
import signal
import sys
import time

from elasticdl_tpu_torch.common.args import add_bool_argument
from elasticdl_tpu_torch.common.env_utils import env_float, env_int, env_str
from elasticdl_tpu_torch.common.grpc_utils import build_server, uds_socket_path
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import (
    events,
    http_server,
    profiler,
    trace,
)
from elasticdl_tpu_torch.proto.services import add_pserver_servicer_to_server
from elasticdl_tpu_torch.ps.checkpoint import SparseCheckpointSaver
from elasticdl_tpu_torch.ps.embedding_store import create_store
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.stream.lifecycle import EmbeddingLifecycle
from elasticdl_tpu_torch.testing import faults
from elasticdl_tpu_torch.train.optimizers import parse_opt_args

logger = _logger_factory("elasticdl_tpu_torch.ps.server")


def parse_ps_args(argv=None):
    parser = argparse.ArgumentParser("elasticdl_tpu_torch ps")
    parser.add_argument("--ps_id", type=int, default=0)
    parser.add_argument("--num_ps_pods", type=int, default=1)
    parser.add_argument("--port", type=int, default=50002)
    parser.add_argument("--master_addr", default="")
    parser.add_argument("--opt_type", default="sgd")
    parser.add_argument(
        "--opt_args", default="", help="k=v;k=v (e.g. lr=0.01;momentum=0.9)"
    )
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--checkpoint_steps", type=int, default=0)
    parser.add_argument("--keep_checkpoint_max", type=int, default=3)
    parser.add_argument("--checkpoint_dir_for_init", default="")
    parser.add_argument("--use_native_store", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    # sync-SGD controls
    add_bool_argument(parser, "--use_async", default=0)
    parser.add_argument("--grads_to_wait", type=int, default=1)
    parser.add_argument("--sync_version_tolerance", type=int, default=0)
    # async-mode staleness LR modulation lr /= max(1, version_diff)
    add_bool_argument(parser, "--lr_staleness_modulation", default=0)
    # benchmarking knob: sleep this long at the top of every RPC handler
    # to emulate worker<->PS network RTT (a localhost PS measures ~0)
    parser.add_argument("--inject_rpc_delay_ms", type=float, default=0.0)
    # observability: /metrics + /healthz + /readyz on this port
    # (0/unset = disabled; falls back to EDL_METRICS_PORT)
    parser.add_argument("--metrics_port", type=int, default=0)
    return parser.parse_args(argv)


class _DelayedServicer:
    """Wraps a servicer so every RPC handler sleeps ``delay_ms`` first:
    an injectable stand-in for worker<->PS network latency."""

    def __init__(self, servicer, delay_ms):
        self._servicer = servicer
        self._delay = delay_ms / 1e3

    def __getattr__(self, name):
        attr = getattr(self._servicer, name)
        if not callable(attr) or name.startswith("_"):
            return attr
        delay = self._delay

        def delayed(*args, **kwargs):
            time.sleep(delay)
            return attr(*args, **kwargs)

        return delayed


class ParameterServer:
    def __init__(self, args):
        self.args = args
        # SIGTERM arrival marker: the handler only sets it; run() polls
        # it and drains (_finish_term)
        self._term_flag = False
        self.store = create_store(
            seed=args.seed + args.ps_id,
            prefer_native=bool(args.use_native_store),
        )
        opt_args = {
            k: float(v) for k, v in parse_opt_args(args.opt_args).items()
        }
        self.store.set_optimizer(args.opt_type, **opt_args)
        saver = None
        if args.checkpoint_dir:
            saver = SparseCheckpointSaver(
                args.checkpoint_dir, shard_id=args.ps_id,
                shard_num=args.num_ps_pods,
                keep_max=args.keep_checkpoint_max)
        # restore by itself: the explicit init directory wins, else the
        # newest complete checkpoint of this PS's own directory
        self.restored_version = None
        restore_t0 = time.monotonic()
        if args.checkpoint_dir_for_init:
            self.restored_version = SparseCheckpointSaver(
                args.checkpoint_dir_for_init, shard_id=args.ps_id,
                shard_num=args.num_ps_pods).restore(self.store)
        elif saver is not None:
            self.restored_version = saver.restore(self.store)
        if self.restored_version is not None:
            # the version clock restarts at the checkpoint, so staleness
            # checks and the workers' version accounting line up with
            # the restored state
            self.store.set_version(self.restored_version)
            logger.info(
                "PS %d auto-restored checkpoint version %d (%d rows, "
                "%.3f s)", args.ps_id, self.restored_version,
                sum(self.store.table_size(name)
                    for name in self.store.table_names()),
                time.monotonic() - restore_t0)
        # the admission/eviction policy of the EDL_EMB_* knobs (None when
        # none is set), built before the servicer so its gates hold from
        # the first RPC
        self.lifecycle = EmbeddingLifecycle.maybe_create(self.store)
        if self.lifecycle is not None and self.restored_version is not None:
            # a restore already made tables and rows: register them (the
            # model's push_embedding_table_infos brings the real
            # initializer later) and re-anchor: every restored row
            # admitted, the sketch empty
            for name in self.store.table_names():
                self.lifecycle.register_table(name,
                                              self.store.table_dim(name))
            self.lifecycle.adopt_store()
        self._master_client = None
        if args.master_addr:
            from elasticdl_tpu_torch.worker.master_client import MasterClient

            # a negative id: the master never waits for a PS, and a PS
            # joins no mesh
            self._master_client = MasterClient(
                args.master_addr, worker_id=-(args.ps_id + 1)
            )
        self.servicer = PserverServicer(
            self.store,
            ps_id=args.ps_id,
            master_client=self._master_client,
            lifecycle=self.lifecycle,
            checkpoint_saver=saver,
            checkpoint_steps=args.checkpoint_steps,
            use_async=bool(args.use_async),
            grads_to_wait=args.grads_to_wait,
            sync_version_tolerance=args.sync_version_tolerance,
            staleness_modulation=bool(args.lr_staleness_modulation),
            restored_version=self.restored_version,
        )
        if (self._master_client is not None
                and env_str("EDL_TELEMETRY", "") != "0"):
            # this PS's push/pull rates, version lag and round fill ride
            # the liveness poll the run loop already makes, for the
            # master's stuck-round and version-lag detectors
            self._master_client.telemetry_provider = (
                self.servicer.telemetry_blob
            )
        self.server = None
        self._uds_path = None
        self.observability = None

    def prepare(self):
        self.server = build_server()
        servicer = self.servicer
        if self.args.inject_rpc_delay_ms:
            servicer = _DelayedServicer(servicer,
                                        self.args.inject_rpc_delay_ms)
            logger.info("Injecting %.1f ms per-RPC delay",
                        self.args.inject_rpc_delay_ms)
        add_pserver_servicer_to_server(servicer, self.server)
        try:
            self.server.add_insecure_port("[::]:%d" % self.args.port)
        except RuntimeError:
            # a relaunch whose port another process took meanwhile: exit
            # non-zero now, with the reason, rather than serve nowhere
            logger.error("PS %d cannot bind port %d (in use by another "
                         "process); exiting", self.args.ps_id,
                         self.args.port)
            raise
        # local transport: under EDL_PS_UDS_DIR also serve on a unix
        # socket named by this TCP port; a stale socket of a SIGKILLed
        # predecessor is unlinked first
        self._uds_path = uds_socket_path(self.args.port)
        if self._uds_path is not None:
            try:
                os.makedirs(os.path.dirname(self._uds_path), exist_ok=True)
                try:
                    os.unlink(self._uds_path)
                except FileNotFoundError:
                    pass
                if self.server.add_insecure_port("unix:" + self._uds_path):
                    logger.info("PS %d also serving on %s", self.args.ps_id,
                                self._uds_path)
                else:
                    logger.warning("could not bind %s; serving TCP only",
                                   self._uds_path)
                    self._uds_path = None
            except OSError as e:
                logger.warning("UDS bind failed (%s); serving TCP only", e)
                self._uds_path = None
        self.server.start()
        role = "ps-%d" % self.args.ps_id
        trace.configure(role)
        events.configure(role)
        events.emit("role_start", port=self.args.port)
        # the host stack sampler: on when EDL_PROF_HZ is set, served as
        # /profilez on the observability port below
        profiler.maybe_start(role)
        if self.restored_version is not None:
            events.emit(
                "ps_restored", version=self.restored_version,
                ps=self.args.ps_id,
            )
        self.observability = http_server.maybe_start(
            role, cli_port=self.args.metrics_port
        )
        if self.observability is not None:
            # readiness milestone: the dense init arrived or a table
            # exists; before either a pull serves nothing
            self.observability.add_readiness_check(
                "model_initialized", self.servicer.model_initialized
            )
        self._install_sigterm_stop()
        logger.info("PS %d/%d serving on :%d (%s store, %s)",
                    self.args.ps_id, self.args.num_ps_pods, self.args.port,
                    type(self.store).__name__,
                    "async" if self.args.use_async else
                    "sync, grads_to_wait %d" % self.args.grads_to_wait)
        return self

    def _cleanup_uds(self):
        """Unlink this PS's unix socket on an orderly stop: a later
        channel to a reused local port would otherwise ride the dead
        socket."""
        path, self._uds_path = self._uds_path, None
        if path is None:
            return
        try:
            os.unlink(path)
        except OSError:
            pass

    def _install_sigterm_stop(self):
        def _on_term(signum, frame):
            # flag only: run() drains between waits, with no servicer
            # lock held by this thread
            self._term_flag = True

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            # not the main thread (embedded use): no SIGTERM drain
            logger.warning("not on main thread; PS SIGTERM drain not "
                           "installed")

    def _finish_term(self):
        """The SIGTERM drain: stop taking RPCs (in-flight handlers
        finish), apply a buffered partial round, save the final full
        checkpoint, exit 0."""
        try:
            self.server.stop(grace=1.0).wait()
        except Exception:
            logger.exception("server stop at SIGTERM failed")
        self._cleanup_uds()
        self.servicer.graceful_stop()
        logger.info("PS %d stopped on SIGTERM", self.args.ps_id)
        self._stop_observability("sigterm_drain")
        return 0

    def _stop_observability(self, reason):
        events.emit("role_stop", reason=reason)
        events.flush()
        trace.flush()
        if self.observability is not None:
            self.observability.stop()
            self.observability = None

    def run(self, poll_secs=0.5):
        """Serve until SIGTERM (drained, 0), until the master is gone
        (0), or until the server is stopped otherwise (0). grpc's
        wait_for_termination(timeout) returns True on timeout (still
        serving)."""
        gone_secs = env_float("EDL_PS_MASTER_GONE_SECS", 90.0)
        # at least two polls inside the grace
        master_poll_secs = min(5.0, gone_secs / 2)
        stream_ckpt_every = env_int("EDL_STREAM_CHECKPOINT_EVERY", 0)
        if stream_ckpt_every > 0:
            # the watermark is the stream checkpoint's clock: read it at
            # every tick, so no boundary passes between two polls
            master_poll_secs = poll_secs
        sweep_secs = env_float("EDL_EMB_SWEEP_SECS", 5.0)
        next_sweep = time.monotonic() + sweep_secs
        gone_since = None
        next_poll = time.monotonic() + master_poll_secs
        while self.server.wait_for_termination(timeout=poll_secs):
            if self._term_flag:
                return self._finish_term()
            if self.lifecycle is not None and time.monotonic() >= next_sweep:
                next_sweep = time.monotonic() + sweep_secs
                self.servicer.lifecycle_tick()
            # rate-limited inside (EDL_HEALTH_SCAN_SECS); its aggregates
            # ride the next telemetry blob
            self.servicer.table_health_scan()
            if self._master_client is None or time.monotonic() < next_poll:
                continue
            polled_at = time.monotonic()
            info = self._master_client.get_comm_info()
            next_poll = time.monotonic() + master_poll_secs
            if info.mesh_epoch >= 0:
                gone_since = None
                if stream_ckpt_every > 0:
                    self.servicer.maybe_stream_checkpoint(
                        info.stream_watermark, stream_ckpt_every)
                continue
            # gone since the first unanswered poll began (the failed
            # call itself retries for seconds)
            if gone_since is None:
                gone_since = polled_at
            if time.monotonic() - gone_since >= gone_secs:
                self.server.stop(grace=1.0).wait()
                logger.info("Master gone; PS %d exiting at store version "
                            "%d", self.args.ps_id, self.store.version)
                break
        if self._master_client is not None:
            self._master_client.close()
        self._cleanup_uds()
        # an orderly exit: an enqueued save lands before the process
        # ends, or a relaunch restores without the last pushes
        self.servicer.finish_checkpoints()
        self._stop_observability(
            "master_gone" if self._master_client is not None else "stopped"
        )
        return 0


def main(argv=None):
    args = parse_ps_args(argv)
    # before any channel or server is built: fault specs match on role
    faults.set_role("ps-%d" % args.ps_id)
    if args.metrics_port:
        # publish the knob before any instrument is constructed: the
        # registry decides enabled/no-op at first touch
        os.environ[http_server.PORT_ENV] = str(args.metrics_port)
    # uncaught exceptions dump the event ring; prepare() then puts the
    # graceful SIGTERM drain (final checkpoint, role_stop) in front
    events.install_crash_hooks()
    return ParameterServer(args).prepare().run()


if __name__ == "__main__":
    sys.exit(main())
