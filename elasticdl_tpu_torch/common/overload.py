"""Overload discipline for the training plane: deadline budgets, retry
budgets, circuit breakers and server pushback (port of
elasticdl_tpu/common/overload.py). Breaker transitions, exhausted retry
budgets and pushback waits feed the ``edl_circuit_*`` and ``edl_retry_*``
series and the ``circuit_<state>`` events.

Four cooperating pieces, all inert until their knob is set or the
caller opts in:

- **Deadline-budget propagation.** ``with budget(secs):`` caps every
  nested RPC in the thread by the REMAINING wall clock. The channel
  interceptor (installed by ``build_channel``) caps each attempt's
  ``timeout=`` by the remainder and carries it to the peer in an
  ``edl-deadline-budget`` metadata header; the server interceptor
  (installed by ``build_server``) re-opens the budget around the
  handler. Budgets carry remaining seconds, never absolute deadlines:
  peer clocks are not trusted. ``bind_budget`` carries the budget into
  executor threads.
- **Retry budgets.** A per-target token bucket: each success earns
  ``EDL_RETRY_BUDGET_RATIO`` tokens (0.1), each retry spends one, and an
  empty bucket fails fast instead of multiplying an overloaded peer's
  load.
- **Circuit breakers.** Closed/open/half-open per (target, method
  class): ``EDL_CIRCUIT_FAILURES`` (5) consecutive connection-shaped
  failures open it; after ``EDL_CIRCUIT_RESET_SECS`` (5 s) one probe is
  admitted and its outcome closes or re-opens it.
- **Server pushback.** An overloaded PS answers RESOURCE_EXHAUSTED with
  an ``edl-retry-after-ms`` trailer; ``retry_after_hint`` reads it and
  ``retry_call`` paces by the server's hint.

State lookups are one dict get under a short lock, and the disabled
paths (``EDL_DEADLINE_BUDGET=0``, no ``target=`` passed) add nothing to
a call.
"""

import collections
import threading
import time

import grpc

from elasticdl_tpu_torch.common.env_utils import env_float, env_int, env_str
from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)
from elasticdl_tpu_torch.observability import events
from elasticdl_tpu_torch.observability import metrics as obs_metrics

logger = _logger_factory("elasticdl_tpu_torch.common.overload")

# remaining-seconds metadata header (metadata keys must be lowercase)
METADATA_KEY = "edl-deadline-budget"
# server pushback trailer: how long the client should wait before the
# retry, in milliseconds (a trailer because it rides the error status)
RETRY_AFTER_KEY = "edl-retry-after-ms"

DEADLINE_BUDGET_ENV = "EDL_DEADLINE_BUDGET"
RETRY_BUDGET_TOKENS_ENV = "EDL_RETRY_BUDGET_TOKENS"
RETRY_BUDGET_RATIO_ENV = "EDL_RETRY_BUDGET_RATIO"
CIRCUIT_FAILURES_ENV = "EDL_CIRCUIT_FAILURES"
CIRCUIT_RESET_SECS_ENV = "EDL_CIRCUIT_RESET_SECS"
# consecutive overload-class push failures after which the trainer drops
# a batch's push instead of wedging the step loop; 0 (the default)
# disables the degraded mode, and pulls then never fail fast either
BROWNOUT_SKIP_AFTER_ENV = "EDL_BROWNOUT_SKIP_AFTER"


def brownout_skip_after():
    return env_int(BROWNOUT_SKIP_AFTER_ENV, 0)


def brownout_enabled():
    return brownout_skip_after() > 0


def circuit_reset_secs():
    """The breaker's open -> half-open window, also the deadline budget
    a browned-out trainer grants each probe push (train/sparse.py)."""
    return env_float(CIRCUIT_RESET_SECS_ENV, 5.0)


_state = threading.local()
_lock = threading.Lock()


class OverloadError(grpc.RpcError):
    """A failure decided locally (no wire attempt was made). Answers
    code()/details() so every ``except grpc.RpcError`` handler treats it
    as the transport error it stands in for."""

    def __init__(self, code, details):
        super().__init__(details)
        self._code = code
        self._details = details

    def code(self):
        return self._code

    def details(self):
        return self._details


class CircuitOpenError(OverloadError):
    def __init__(self, target, kind):
        super().__init__(
            grpc.StatusCode.UNAVAILABLE,
            "circuit open for %s/%s" % (target, kind),
        )
        self.target = target
        self.kind = kind


class RetryBudgetExhausted(OverloadError):
    def __init__(self, target, code):
        super().__init__(code, "retry budget exhausted for %s" % target)
        self.target = target


# overload-class status codes a brownout may absorb: the transport is
# down (UNAVAILABLE, CircuitOpenError included), the budget ran out
# (DEADLINE_EXCEEDED, RetryBudgetExhausted included), or the PS pushed
# back and stayed overloaded (RESOURCE_EXHAUSTED); anything else raises
BROWNOUT_CODES = (
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.DEADLINE_EXCEEDED,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
)


def is_overload_failure(exc):
    """True when a brownout path may absorb ``exc``: any OverloadError,
    or a transport error with an overload-class status (a retry loop
    that exhausts its deadline re-raises the last RAW RpcError)."""
    if isinstance(exc, OverloadError):
        return True
    code = getattr(exc, "code", None)
    return callable(code) and code() in BROWNOUT_CODES


# ---------------------------------------------------------------------------
# deadline budget (thread-local remaining wall clock)


class budget:
    """``with budget(secs):`` caps every nested RPC in this thread by
    the remaining wall clock. Nested budgets tighten, never loosen;
    ``secs=None`` is a no-op scope."""

    def __init__(self, secs):
        self._secs = secs
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_state, "deadline", None)
        if self._secs is not None:
            deadline = time.monotonic() + float(self._secs)
            if self._prev is not None:
                deadline = min(deadline, self._prev)
            _state.deadline = deadline
        return self

    def __exit__(self, *exc):
        _state.deadline = self._prev
        return False


def remaining():
    """Seconds left in this thread's budget (floored at 0.0), or None
    when no budget is open."""
    deadline = getattr(_state, "deadline", None)
    if deadline is None:
        return None
    return max(0.0, deadline - time.monotonic())


def rpc_timeout(default):
    """The timeout an RPC attempt should carry: ``default`` capped by
    the thread's remaining budget."""
    rem = remaining()
    if rem is None:
        return default
    return min(float(default), rem) if default is not None else rem


def bind_budget(fn):
    """``fn`` wrapped to run under this thread's budget (if any) in
    whatever thread runs it: executor fan-outs lose thread-locals."""
    deadline = getattr(_state, "deadline", None)
    if deadline is None:
        return fn

    def bound(*args, **kwargs):
        prev = getattr(_state, "deadline", None)
        _state.deadline = deadline if prev is None else min(deadline, prev)
        try:
            return fn(*args, **kwargs)
        finally:
            _state.deadline = prev

    return bound


def propagation_enabled():
    return env_str(DEADLINE_BUDGET_ENV, "") != "0"


class _CallDetails(
    collections.namedtuple(
        "_CallDetails",
        ("method", "timeout", "metadata", "credentials",
         "wait_for_ready", "compression"),
    ),
    grpc.ClientCallDetails,
):
    pass


class DeadlineBudgetClientInterceptor(grpc.UnaryUnaryClientInterceptor):
    """Cap each outgoing attempt's timeout by the thread's remaining
    budget and carry the remainder to the peer as metadata. No active
    budget: the call details pass untouched."""

    def intercept_unary_unary(self, continuation, client_call_details,
                              request):
        rem = remaining()
        if rem is None:
            return continuation(client_call_details, request)
        timeout = client_call_details.timeout
        timeout = rem if timeout is None else min(float(timeout), rem)
        metadata = list(client_call_details.metadata or ())
        metadata.append((METADATA_KEY, "%.3f" % rem))
        details = _CallDetails(
            method=client_call_details.method,
            timeout=timeout,
            metadata=metadata,
            credentials=getattr(client_call_details, "credentials", None),
            wait_for_ready=getattr(
                client_call_details, "wait_for_ready", None
            ),
            compression=getattr(client_call_details, "compression", None),
        )
        return continuation(details, request)


def intercept_budget_channel(channel):
    """``build_channel``'s seam: the budget interceptor, or the channel
    itself under EDL_DEADLINE_BUDGET=0."""
    if not propagation_enabled():
        return channel
    return grpc.intercept_channel(channel, DeadlineBudgetClientInterceptor())


class _BudgetServerInterceptor(grpc.ServerInterceptor):
    """Adopt an incoming ``edl-deadline-budget`` header as the handler
    thread's budget."""

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None or handler.unary_unary is None:
            return handler
        secs = None
        for key, value in handler_call_details.invocation_metadata or ():
            if key == METADATA_KEY:
                try:
                    secs = float(value)
                except ValueError:
                    secs = None
                break
        if secs is None:
            return handler
        inner = handler.unary_unary

        def budgeted(request, context):
            with budget(secs):
                return inner(request, context)

        return grpc.unary_unary_rpc_method_handler(
            budgeted,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


def server_budget_interceptors():
    """``build_server``'s seam: () unless propagation is on."""
    if not propagation_enabled():
        return ()
    return (_BudgetServerInterceptor(),)


# ---------------------------------------------------------------------------
# server pushback


def retry_after_hint(rpc_error):
    """Seconds the server asked this client to wait (the
    ``edl-retry-after-ms`` trailer on a RESOURCE_EXHAUSTED pushback), or
    None when the error carries no hint."""
    trailing = getattr(rpc_error, "trailing_metadata", None)
    if trailing is None:
        return None
    try:
        metadata = trailing() or ()
    except Exception:
        # a half-constructed RpcError (test doubles, client-side
        # aborts) has no trailers: no hint, not an error
        return None
    for entry in metadata:
        key = getattr(entry, "key", None) or entry[0]
        value = getattr(entry, "value", None) or entry[1]
        if key == RETRY_AFTER_KEY:
            try:
                return max(0.0, float(value) / 1000.0)
            except (TypeError, ValueError):
                return None
    return None


# ---------------------------------------------------------------------------
# retry budget (per-target token bucket)


class RetryBudget:
    """Token bucket bounding retry amplification toward one target:
    starts full (``max_tokens``), a retry spends 1.0, a success earns
    ``ratio`` (capped at full); ``spend`` at empty returns False."""

    def __init__(self, max_tokens=None, ratio=None):
        self.max_tokens = float(
            max_tokens if max_tokens is not None
            else env_int(RETRY_BUDGET_TOKENS_ENV, 100)
        )
        self.ratio = float(
            ratio if ratio is not None
            else env_float(RETRY_BUDGET_RATIO_ENV, 0.1)
        )
        self._tokens = self.max_tokens
        self._lock = threading.Lock()
        self.exhausted = 0  # cumulative fail-fast decisions

    def record_success(self):
        with self._lock:
            self._tokens = min(self.max_tokens, self._tokens + self.ratio)

    def spend(self):
        """Take one retry token; False = exhausted, fail fast."""
        with self._lock:
            if self._tokens < 1.0:
                self.exhausted += 1
                return False
            self._tokens -= 1.0
            return True

    def tokens(self):
        with self._lock:
            return self._tokens


# ---------------------------------------------------------------------------
# circuit breaker (per target + method class)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Closed/open/half-open breaker for one (target, method class).

    ``admit_delay()`` is the client-side gate: 0.0 = attempt now
    (closed, or this caller won the half-open probe), else seconds
    until the next probe window. Connection-shaped failures count
    toward opening; server pushback (RESOURCE_EXHAUSTED) does not: a
    server that pushes back is alive.
    """

    def __init__(self, target, kind, failures=None, reset_secs=None):
        self.target = target
        self.kind = kind
        self.failure_threshold = (
            failures if failures is not None
            else env_int(CIRCUIT_FAILURES_ENV, 5)
        )
        self.reset_secs = (
            reset_secs if reset_secs is not None
            else env_float(CIRCUIT_RESET_SECS_ENV, 5.0)
        )
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.open_count = 0  # cumulative closed/half_open -> open

    def state(self):
        with self._lock:
            return self._state

    def admit_delay(self, now=None):
        """0.0 = go; > 0 = seconds until this caller may probe."""
        now = time.monotonic() if now is None else now
        transition = None
        with self._lock:
            if self._state == CLOSED:
                return 0.0
            wait = self._opened_at + self.reset_secs - now
            if wait > 0:
                return wait
            # probe window: admit exactly one caller; the rest keep
            # pacing on the window
            if self._probe_inflight:
                delay = self.reset_secs
            else:
                transition = self._transition_locked(HALF_OPEN)
                self._probe_inflight = True
                delay = 0.0
        self._log(transition)
        return delay

    def record_success(self, now=None):
        transition = None
        with self._lock:
            self._consecutive_failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                transition = self._transition_locked(CLOSED)
        self._log(transition)

    def record_failure(self, now=None):
        now = time.monotonic() if now is None else now
        transition = None
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                # failed probe: back to open, restart the window
                self._probe_inflight = False
                self._opened_at = now
                transition = self._transition_locked(OPEN)
            elif (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._opened_at = now
                transition = self._transition_locked(OPEN)
        self._log(transition)

    def _transition_locked(self, state):
        """Flip the state under the lock; returns the (prev, new,
        failures) tuple the caller logs after releasing it."""
        prev, self._state = self._state, state
        if state == OPEN:
            self.open_count += 1
        return (prev, state, self._consecutive_failures)

    def _log(self, transition):
        if transition is None:
            return
        prev, state, failures = transition
        _m_circuit_transitions.labels(state=state).inc()
        _m_circuit_state.labels(
            target=self.target, kind=self.kind
        ).set(_STATE_VALUE[state])
        logger.warning(
            "circuit %s -> %s for %s/%s (failures=%d)",
            prev, state, self.target, self.kind, failures,
        )
        if events.enabled():
            events.emit(
                "circuit_%s" % state, target=self.target,
                method_class=self.kind, previous=prev,
                consecutive_failures=failures,
                reset_secs=self.reset_secs,
            )


# LAZY instruments: this module reaches every role through
# common.grpc_utils at import time, before main() publishes
# EDL_METRICS_PORT; an eager counter() here would freeze the process
# registry disabled and blank /metrics for the whole role
_m_circuit_transitions = obs_metrics.lazy_counter(
    "edl_circuit_transitions_total",
    "Circuit-breaker state transitions", ("state",),
)
_m_circuit_state = obs_metrics.lazy_gauge(
    "edl_circuit_state",
    "Breaker state per target/method-class "
    "(0 closed, 1 open, 2 half-open)",
    ("target", "kind"),
)
_m_retry_budget_exhausted = obs_metrics.lazy_counter(
    "edl_retry_budget_exhausted_total",
    "Retries refused because the per-target token bucket ran dry",
    ("target",),
)
_m_pushback_waits = obs_metrics.lazy_counter(
    "edl_retry_pushback_waits_total",
    "Retries paced by a server edl-retry-after-ms hint", ("target",),
)
_STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


# process-wide registries: breakers and budgets are per-TARGET state
# shared by every stub talking to that target
_breakers = {}
_retry_budgets = {}

# process-wide degraded-mode tallies
_counters = {
    "degraded_pulls": 0,
    "brownout_skipped_pushes": 0,
    "pushback_waits": 0,
}


def breaker_for(target, kind):
    key = (target, kind)
    with _lock:
        breaker = _breakers.get(key)
        if breaker is None:
            breaker = _breakers[key] = CircuitBreaker(target, kind)
        return breaker


def retry_budget_for(target):
    with _lock:
        bucket = _retry_budgets.get(target)
        if bucket is None:
            bucket = _retry_budgets[target] = RetryBudget()
        return bucket


def method_class(what):
    """Breakers are per method CLASS: every pull variant shares one
    read-path breaker, the non-idempotent push path has its own."""
    lowered = (what or "").lower()
    if "pull" in lowered or "get" in lowered or "info" in lowered:
        return "read"
    return "write"


def note_degraded_pull(count=1):
    with _lock:
        _counters["degraded_pulls"] += int(count)


def note_brownout_skip():
    with _lock:
        _counters["brownout_skipped_pushes"] += 1


def note_pushback_wait(target):
    _m_pushback_waits.labels(target=target).inc()
    with _lock:
        _counters["pushback_waits"] += 1


def note_budget_exhausted(target):
    _m_retry_budget_exhausted.labels(target=target).inc()


def client_stats():
    """Cumulative overload tallies of this process's client side."""
    with _lock:
        stats = dict(_counters)
        breakers = list(_breakers.items())
        budgets = list(_retry_budgets.values())
    stats["circuit_open_count"] = sum(b.open_count for _, b in breakers)
    stats["retry_budget_exhausted"] = sum(b.exhausted for b in budgets)
    stats["circuits_not_closed"] = sorted(
        "%s/%s" % key for key, b in breakers if b.state() != CLOSED
    )
    return stats


def _reset_for_tests():
    with _lock:
        _breakers.clear()
        _retry_budgets.clear()
        for key in _counters:
            _counters[key] = 0
