"""gRPC channel/server helpers and the shared jittered retry policy
(port of elasticdl_tpu/common/grpc_utils.py). Channels carry the
trace-context interceptor and servers the metrics/trace interceptors
when their knobs are set; both carry the fault-injection interceptors
(testing/faults.py) when ``EDL_FAULT_SPEC`` names them. With the knobs
unset the call path is the uninstrumented one. Under a trace each
``retry_call`` attempt is an ``rpc_attempt`` span."""

import os
import random
import socket
import time
from concurrent import futures

import grpc

from elasticdl_tpu_torch.common import overload
from elasticdl_tpu_torch.common.constants import GRPC
from elasticdl_tpu_torch.common.env_utils import env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import trace as _trace

logger = _logger_factory("elasticdl_tpu_torch.common.grpc_utils")

_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", GRPC.MAX_SEND_MESSAGE_LENGTH),
    ("grpc.max_receive_message_length", GRPC.MAX_RECEIVE_MESSAGE_LENGTH),
    # grpc's default reconnect backoff grows to 120 s; cap the gap so a
    # relaunched peer is reached within seconds
    ("grpc.max_reconnect_backoff_ms", 10000),
]

# connection-shaped failures worth retrying: the peer is relaunching
# (UNAVAILABLE) or wedged past its deadline; anything else (bad
# request, server logic error) surfaces at once
RETRYABLE_CODES = (
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.DEADLINE_EXCEEDED,
)


def _await_reconnect(channel, timeout_secs):
    """Drive the channel's reconnection for up to ``timeout_secs``;
    True when it went READY.

    Load-bearing: a fail-fast RPC against a TRANSIENT_FAILURE channel
    fails at once without scheduling a new connection attempt, so a
    retry loop that only sleeps can burn its whole budget while the
    relaunched peer is serving. ``channel_ready_future`` subscribes a
    watcher that does schedule attempts and unsubscribes when done.
    """
    future = grpc.channel_ready_future(channel)
    try:
        future.result(timeout=timeout_secs)
        return True
    except grpc.FutureTimeoutError:
        return False
    finally:
        future.cancel()


def retry_call(fn, what, budget_secs, retryable=RETRYABLE_CODES,
               base_delay=0.5, max_delay=10.0, rng=None, channel=None,
               target=None, fail_fast_when_open=False):
    """Call ``fn`` with FULL-JITTER exponential backoff on retryable
    gRPC errors, up to ``budget_secs`` of wall clock.

    Each backoff is uniform in [0, ceiling), the ceiling doubling per
    attempt up to ``max_delay``: workers that all hit one relaunching
    PS must not retry in lockstep. ``rng`` (tests) replaces the module
    RNG. With ``channel`` the backoff drives the channel's reconnection
    (``_await_reconnect``) instead of only sleeping.

    With ``target`` (the peer's address) the overload machinery
    engages (common/overload.py):

    - ``budget_secs`` is capped by the thread's deadline budget, and the
      loop runs inside that budget;
    - a RESOURCE_EXHAUSTED with the server's ``edl-retry-after-ms`` hint
      is retried at the server's pace: the hint seeds the wait, full
      jitter rides on top, consecutive pushbacks double it (at most 8x);
    - each retry spends a per-target retry-budget token; an empty
      bucket raises ``RetryBudgetExhausted``;
    - the per-(target, method class) circuit breaker paces attempts:
      open = wait out the probe window inside the budget, or raise
      ``CircuitOpenError`` at once with ``fail_fast_when_open`` (pulls
      with a degraded fallback). Pushback does not feed the breaker.
    """
    jitter = (rng or random).uniform
    budget_secs = overload.rpc_timeout(budget_secs)
    deadline = time.monotonic() + budget_secs
    breaker = (
        overload.breaker_for(target, overload.method_class(what))
        if target is not None else None
    )
    retry_budget = (
        overload.retry_budget_for(target) if target is not None else None
    )
    ceiling = base_delay
    attempt = 0
    pushback_streak = 0
    with overload.budget(budget_secs):
        while True:
            if breaker is not None:
                wait = breaker.admit_delay()
                if wait > 0:
                    if fail_fast_when_open or (
                        time.monotonic() + wait > deadline
                    ):
                        raise overload.CircuitOpenError(
                            breaker.target, breaker.kind
                        )
                    time.sleep(wait)
                    continue
            attempt += 1
            try:
                # each attempt is its own child span: a retried RPC
                # shows as sibling spans (the failed ones carry error
                # and code args), and the parent the server sees is the
                # attempt that reached it
                if _trace.enabled():
                    with _trace.span("rpc_attempt", what=what,
                                     attempt=attempt):
                        result = fn()
                else:
                    result = fn()
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                pushback = overload.retry_after_hint(e)
                if breaker is not None and code in RETRYABLE_CODES:
                    breaker.record_failure()
                if pushback is not None and (
                    code == grpc.StatusCode.RESOURCE_EXHAUSTED
                ):
                    # the server's hint seeds the pacing, with full
                    # jitter on top and doubling on consecutive
                    # pushbacks: waiters polling at the bare hint in
                    # lockstep race each freed slot and mostly miss
                    delay = (
                        pushback * (1.0 + jitter(0.0, 1.0))
                        * (1 << min(pushback_streak, 3))
                    )
                    pushback_streak += 1
                else:
                    pushback = None
                    pushback_streak = 0
                    delay = jitter(0.0, ceiling)
                    if code not in retryable:
                        raise
                if time.monotonic() + delay > deadline:
                    raise
                if retry_budget is not None and not retry_budget.spend():
                    overload.note_budget_exhausted(target)
                    logger.warning(
                        "%s: retry budget for %s exhausted; failing "
                        "fast", what, target,
                    )
                    raise overload.RetryBudgetExhausted(target, code) from e
                if pushback is not None:
                    overload.note_pushback_wait(target)
                    logger.warning(
                        "%s pushed back by %s; retrying in %.2fs",
                        what, target or "peer", delay,
                    )
                    time.sleep(delay)
                    continue
                logger.warning(
                    "%s unavailable (%s); retrying in %.2fs", what, code,
                    delay,
                )
                if channel is not None:
                    if _await_reconnect(channel, delay):
                        # peer is back: a small residual jitter keeps a
                        # fleet whose ready-futures completed together
                        # from arriving in unison
                        time.sleep(jitter(0.0, min(0.25, delay)))
                else:
                    time.sleep(delay)
                ceiling = min(ceiling * 2, max_delay)
            else:
                if breaker is not None:
                    breaker.record_success()
                if retry_budget is not None:
                    retry_budget.record_success()
                return result


# Local transport: under EDL_PS_UDS_DIR a PS also binds a unix-domain
# socket named by its TCP port, and a client building a channel to a
# LOCAL host:port prefers that socket when it exists (TCP stays the
# fallback: knob unset, socket absent, or a remote host).
UDS_DIR_ENV = "EDL_PS_UDS_DIR"


def uds_socket_path(port, uds_dir=None):
    """The socket path a PS serving on ``port`` binds under
    EDL_PS_UDS_DIR, or None when the knob is unset."""
    directory = uds_dir or env_str(UDS_DIR_ENV, "")
    if not directory:
        return None
    return os.path.join(
        os.path.abspath(directory), "edl-ps-%d.sock" % int(port)
    )


def _is_local_host(host):
    host = host.strip("[]")
    if host in ("localhost", "127.0.0.1", "::1", ""):
        return True
    try:
        return host == socket.gethostname()
    except OSError:
        return False


def maybe_uds_addr(addr):
    """``host:port`` -> ``unix:<path>`` when EDL_PS_UDS_DIR names a live
    socket for that port and the host is this machine, else None.
    Checked at channel-build time only: afterwards the channel owns the
    path, so a same-path PS relaunch reconnects without a rebuild."""
    host, _, port = addr.rpartition(":")
    if not port.isdigit() or not _is_local_host(host):
        return None
    path = uds_socket_path(int(port))
    if path and os.path.exists(path):
        return "unix:" + path
    return None


def build_channel(addr: str) -> grpc.Channel:
    """An insecure channel to ``addr`` (its local socket when there is
    one), with the deadline-budget interceptor unless
    EDL_DEADLINE_BUDGET=0, and the trace-context interceptor when
    EDL_TRACE_DIR is set with a nonzero sample rate (otherwise the
    identity), outermost the fault interceptor when EDL_FAULT_SPEC names
    this role's client calls: an injected client fault fails before
    sending, so it must not reach the wire-facing layers."""
    uds = maybe_uds_addr(addr)
    if uds is not None:
        logger.info("channel to %s riding the local socket %s", addr, uds)
        addr = uds
    channel = grpc.insecure_channel(addr, options=_CHANNEL_OPTIONS)
    channel = overload.intercept_budget_channel(channel)
    from elasticdl_tpu_torch.observability.trace_propagation import (
        intercept_trace_channel,
    )
    from elasticdl_tpu_torch.testing.faults import intercept_client_channel

    return intercept_client_channel(intercept_trace_channel(channel))


def build_server(max_workers: int = 64) -> grpc.Server:
    """A gRPC server with the metrics interceptor installed when metrics
    collection is enabled (observability/grpc_metrics.py; with the
    knobs unset ``server_interceptors()`` is empty and the call path is
    the uninstrumented one) and whose handlers adopt a caller's deadline
    budget (unless EDL_DEADLINE_BUDGET=0). The fault interceptor
    (testing/faults.py) sits between them; it is the empty tuple unless
    EDL_FAULT_SPEC is set."""
    from elasticdl_tpu_torch.observability.grpc_metrics import (
        server_interceptors,
    )
    from elasticdl_tpu_torch.testing.faults import (
        server_interceptors as fault_interceptors,
    )

    interceptors = (tuple(server_interceptors())
                    + fault_interceptors()
                    + overload.server_budget_interceptors())
    return grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        # so_reuseport=0: one process per port. With SO_REUSEPORT a
        # SIGKILLed predecessor's lingering socket can keep receiving
        # (and black-holing) a share of incoming connections after a
        # same-port relaunch binds.
        options=_CHANNEL_OPTIONS + [("grpc.so_reuseport", 0)],
        interceptors=interceptors,
    )


def find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def reserve_port():
    """``(socket, port)``: a free port held by a bound, never-listening
    SO_REUSEADDR socket. A server of this module (SO_REUSEADDR, no
    SO_REUSEPORT) still binds and listens on it, while every other
    ``bind`` to port 0 and every outgoing connection's ephemeral port
    skips it, so a server relaunched on the same port (a PS after a
    kill) cannot lose it to another process in between. Close the
    socket once no relaunch is to come."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("localhost", 0))
    return sock, sock.getsockname()[1]
